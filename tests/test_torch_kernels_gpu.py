"""The CUDA kernels K1-K19 of the PyTorch port against their plain
PyTorch versions on the card, on shapes and inputs the main path does
not reach: image sizes that are no multiple of the 16-px cell, flat images
where every key ties, empty keypoint and row sets, a single column, fully
masked rows, duplicated descriptors and unaligned views; stereo keypoints
on and beyond the image border, SAD ties and best offsets at both ends of
the sweep; remap coordinates exactly on the last row and column and just
outside; K1 over all levels of an image in one call (480x752, 512x512,
37x53, a blank image, top levels of fewer cell slots than n_keep and
levels with n_keep 0) against the plain composition and the per-level
launches, and its refusals; pose problems of 0, 1, 31, 1200, 2000 and
16384 observations (below and above K5's register cap), zero rounds, all
invalid, partly behind the camera, mono, mixed and all stereo; vocabulary
descents with
tied children, no valid descriptor and other branchings and depths; L1
scores over widths that are no multiple of 4, masked rows and batches of
queries; BA assemblies (K4) of an empty window, one observation, repeated
(landmark, keyframe) pairs and both tangent modes, bitwise repeatable,
and in its per-observation mode; the implicit Schur passes (K14) with
segment lengths that are no multiple of 32, landmarks and a keyframe with
no observation, every observation masked and nothing optimized, bitwise
repeatable, K14's whole solve on the same problems against the plain CG
loop after 0, 1, 2 and 40 iterations and bitwise equal at grids of 1, 7 and the co-resident maximum of
blocks, and the PCG LM loop over both kernels;
preintegrations (K11) of an all-padding batch, one sample, fresh and
continued frame batches and a keyframe buffer, bitwise repeatable, a
previous result passed through as `init` bitwise equal to a packed copy; inertial pose problems
(K12) of 0-4096 observations with a near-identity edge, no visual rows,
mono and mixed stereo; K2 over all levels of an image in one launch
(752x480, 512x512 and 384x288, a level without keypoints) against the
per-level launches, and its refusal of levels that are no views of one
buffer; the
inertial assembly of a VI-BA step (K13) over windows of 1, 14 and 32
slots with invalid slots, a chain that skips a slot and no bias prior,
and the LM loop over it; the pose-graph normal equations (K15) of graphs
with zero-weight edges, padding nodes and both parametrizations, and
the Gauss-Newton loop over them; the pyramid and blur (K6) at the main
path's shapes, odd and tiny sizes and levels that are no views of one
buffer; the two-camera match (K16) on KB8 and radtan rigs of 1, 64, 333
and 1200 features, partly invalid, with tied descriptors and an empty
left set, and with E = 0 (every pair gated in) so that 41 descriptors
tie both ways beside an all-BIG row and column; the IMU-init system (K17) at 256, 40 and 4 slots with the
scale free and fixed, 9 live edges of 256 slots, a recycled slot and a
slot that precedes two edges (nothing written outside the live edges'
blocks), and the whole `inertial_only_optimize` over it;
the guided Sim(3) verification (K18) with inliers and outliers, no
pair, one pair and 257 features, and its refinement (a cluster of 8
blocks) on one feature, 300, no active pair, backward pairs alone and
2,000 features; K7's one launch (the sweep and the median filter) of 1,
333, 1,200 and 4,000 keypoints, none or one matched, tied SADs at the
median and disparities at 0 and max_d; and every new wrapper refusing bad
dtypes and shapes; K19 (the whole Hamming matrix on the int8 tensor
cores) at 4096x1200 and at sizes that are no multiple of its tile, and the
observation-sharded PCG of `parallel/` on one nccl rank.

Marked `gpu`: each test skips without a CUDA card. On a machine with one
(and without JAX, so without tests/conftest.py):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: K1 (each field of the image-wide call too) and K3 exact; K2 angles within 1e-4 rad and descriptor bits
>= 99.9% identical (the kernel sums the moments in another order); K7 on
integer-valued images: best offset and SAD exact, refined x within 1e-5 px,
on non-integer images within 1e-3 px; K7's whole launch
(`refine_and_filter`: u_right, depth, valid) bitwise equal to the plain
composition on integer-valued images (exact SADs, the same roundings of
the parabola and of the depth, an exact median), and empty with no launch
for no keypoint; K8 exact (same rounding,
no FMA); K5
R and t within 1e-4 and the inlier count within 1% (the kernel sums the
normal equations in another order, so a row whose chi2 sits at its gate
may flip), chi2 as residual norms within 1e-6; K9 exact (integer work); K10 within 1e-5 (float sums in another
order), masked rows exactly -1; K4 blocks within 1e-4 of each block
tensor's max-abs and bit-identical across two launches, its LM loop with
the plain loop's accepts, R within 1e-5, t within 1e-4, the final cost
within 1e-3 relative and the landmarks within 1e-2 chi2 units; K11 dR, dV, dP and
the Jacobians within 1e-5, C within 1e-5 of its max-abs; K12 R and t
within 1e-5, v and bias within 1e-4, the same inlier count, H_marg within
1e-4 of its max-abs; K2 over all levels bitwise equal to the per-level
launches (the same per-keypoint code); K14 within
1e-5 of each output entry's term magnitude (the same sums over absolute
values: the back-substitution's bl - B^T x cancels, so the rounding of
its sums is bounded by the terms, not the result), its whole solve's dxp
and dxl within `testing.PCG_TOL` (5e-3) of the plain solve's max-abs
after 40 CG iterations summed in other orders and within
`testing.PCG_TOL_FIRST` (1e-3) after 0, 1 and 2; K13 and K15 H within
1e-5 under Jacobi scaling (|dH_ij| / sqrt(H_ii H_jj)), b within 1e-5 of
its scaled max-abs, the cost within 1e-5 relative, both bitwise repeatable
(the plain K13 Jacobian carries some tangents in float64, the kernel's
dual numbers float32), their loops with states within 1e-4 and costs
within 1e-3 relative; K16's matches and valid flags equal outside the
rows at a gate margin (`testing.general_margins`), depth within 1e-4
relative; K17's H, g and cost within 1e-4 of each entry's term magnitude,
bitwise repeatable, its optimize's R_wg and s within 1e-4, biases and
velocities within 1e-3 of their size; K18's indices exact, (s, R, t)
bitwise equal to the plain version's (both float64, the same operations
in the same order), the same n_good, bitwise repeatable (NaN included:
one pair leaves directions to the damping alone); K6's blur bitwise equal to the
plain blur (the same
adds, no FMA), its pyramid within 1e-3 grey levels of the plain pyramid
(cuBLAS sums the dense product in another order; ~5e-5 seen), and
`extract_orb` with the kernel and with the plain K6 in agreement on >= 99%
of (yx, octave) slots and >= 99.9% of the descriptor bits there.
"""
import math

import numpy as np
import pytest
import torch

from morb_slam_tpu_torch import frontend, imu, lie, testing
from morb_slam_tpu_torch.ops import (fast, hamming, image, orb_descriptor,
                                     rectify, stereo)
from morb_slam_tpu_torch.optim import ba, pose_opt, vi_ba
from morb_slam_tpu_torch.vocab import tree

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _image(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        img = rng.integers(0, 256, shape)
    else:                                   # flat blocks: keys tie everywhere
        blocks = rng.integers(0, 3, (shape[0] // 8 + 1, shape[1] // 8 + 1))
        img = np.kron(blocks, np.ones((8, 8)))[:shape[0], :shape[1]] * 60
    return img.astype(np.float32)


@pytest.mark.parametrize("kind", ["noise", "blocks"])
@pytest.mark.parametrize("shape", [(16, 16), (37, 53), (100, 130),
                                   (480, 752)])
def test_fast_select_exact(cuda, shape, kind):
    img = torch.from_numpy(_image(shape, kind)).to(cuda)
    got = fast.fast_select(img, 7.0, 20.0)
    want = fast.fast_select_plain(img, 7.0, 20.0)
    for name, g, w in zip(("key", "index", "score"), got, want):
        assert torch.equal(g, w), (name, int((g != w).sum()))


def _textured(shape, seed=0):
    """Blurred noise with grain: corners at every scale."""
    rng = np.random.default_rng(seed)
    img = image.gaussian_blur(torch.from_numpy(_image(shape, "noise", seed)))
    return image.gaussian_blur(img) + torch.from_numpy(
        rng.normal(0, 4, shape).astype(np.float32))


# shape, n_features, levels, image kind, explicit per-level n_keep
LEVEL_CASES = {
    "480x752": ((480, 752), 1200, 8, "textured", None),
    "512x512": ((512, 512), 1200, 8, "textured", None),
    "37x53, no whole cells": ((37, 53), 120, 8, "noise", None),
    "blank": ((120, 160), 300, 4, "blank", None),
    "top levels under n_keep": ((96, 128), 300, 8, "textured", None),
    "n_keep 0": ((100, 130), 0, 5, "textured", [0, 60, 0, 0, 25]),
    # level 0 of 8,280 cells, above the 8,192 that shared memory held
    # before its selection could spill to global memory
    "8,280 cells": ((1440, 1472), 1200, 2, "textured", None),
    # level 0 of 30,832 cells: its selection needs more shared memory than
    # an H100 block may take, so it works in global memory
    "global-memory level": ((2624, 3008), 1200, 2, "textured", None),
}
H100_SMEM_OPTIN = 232448        # bytes of shared memory a block may take


@pytest.mark.parametrize("case", sorted(LEVEL_CASES))
def test_fast_select_levels_exact(cuda, case):
    """K1 over all levels of an image in one call: every field bitwise
    equal to the plain composition (on the card and on the CPU) and to the
    per-level cell-stage launches followed by torch's selection; one
    launch counted."""
    shape, n_feat, n_lv, kind, counts = LEVEL_CASES[case]
    if kind == "textured":
        img = _textured(shape, seed=len(case))
    elif kind == "blank":
        img = torch.zeros(shape)
    else:
        img = torch.from_numpy(_image(shape, kind, seed=3))
    cfg = frontend.OrbConfig(n_features=max(n_feat, 1), n_levels=n_lv)
    counts = counts or cfg.per_level_counts()
    levels = image.build_pyramid(img.to(cuda), n_lv, cfg.scale)
    before = dict(fast.LAUNCHES)
    got = fast.fast_select_levels(levels, counts, cfg)
    assert fast.LAUNCHES == {"kernel": before["kernel"] + 1,
                             "plain": before["plain"]}
    if case == "top levels under n_keep":
        assert got.kept[-1] < counts[-1]
    if case == "global-memory level":
        h, w = levels[0].shape
        assert 8 * got.kept[0] + 4 * 2 * (h // 16) * (w // 16) > \
            H100_SMEM_OPTIN
    assert got.yx.shape == (sum(got.kept), 2)
    want = fast.fast_select_levels_plain(levels, counts, cfg)
    per = fast.select_levels(levels, counts, cfg, cells=fast.fast_select)
    cpu = fast.fast_select_levels_plain([l.cpu() for l in levels], counts,
                                        cfg)
    assert got.kept == want.kept == per.kept == cpu.kept
    for name, g, w, p, c in zip(fast.SLOT_FIELDS, got, want, per, cpu):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, int((g != w).sum()))
        assert torch.equal(g, p), (name, int((g != p).sum()))
        assert torch.equal(g.cpu(), c), (name, int((g.cpu() != c).sum()))
    if kind == "blank":
        assert not bool(got.valid.any())
        assert bool(torch.isinf(got.key).all())
    else:
        assert bool(got.valid.any())


def test_fast_select_levels_refuses(cuda):
    """fast_select_levels takes only consecutive contiguous views of one
    buffer, as many counts as levels and float32 levels; it raises instead
    of falling back."""
    img = _textured((120, 160)).to(cuda)
    cfg = frontend.OrbConfig(n_features=200, n_levels=3)
    levels = image.build_pyramid(img, 3, 1.2)
    counts = cfg.per_level_counts()
    before = dict(fast.LAUNCHES)
    for lv, n in (([l.clone() for l in levels], counts),
                  (levels[::-1], counts), (levels, counts[:2]),
                  ([l.double() for l in levels], counts),
                  (levels, [counts[0], -1, counts[2]])):
        with pytest.raises(ValueError):
            fast.fast_select_levels(lv, n, cfg)
    assert fast.LAUNCHES == before


@pytest.mark.parametrize("n", [0, 7, 300])
def test_orb_describe_close(cuda, n):
    h, w = 133, 211
    rng = np.random.default_rng(n)
    img = image.gaussian_blur(torch.from_numpy(_image((h, w), "noise")))
    img = img.contiguous().to(cuda)
    blur = image.gaussian_blur(img).contiguous()
    yx = np.stack([rng.integers(16, h - 16, n), rng.integers(16, w - 16, n)],
                  axis=-1).astype(np.int32).reshape(n, 2)
    if n >= 7:                              # the extreme admissible corners
        yx[:4] = [[16, 16], [16, w - 17], [h - 17, 16], [h - 17, w - 17]]
    yx = torch.from_numpy(yx).to(cuda)
    ang, desc = orb_descriptor.orb_describe(img, blur, yx)
    ang0 = orb_descriptor.compute_orientations(img, yx)
    desc0 = orb_descriptor.compute_descriptors(blur, yx, ang0)
    assert ang.shape == ang0.shape and desc.shape == desc0.shape == (n, 8)
    if n == 0:
        return
    dang = torch.remainder(ang - ang0 + math.pi, 2 * math.pi) - math.pi
    assert float(dang.abs().max()) < 1e-4
    bits = orb_descriptor.unpack_bits(desc) != orb_descriptor.unpack_bits(
        desc0)
    assert int(bits.sum()) <= max(1, 1e-3 * bits.numel()), int(bits.sum())


@pytest.mark.parametrize("shape,n_features", [((480, 752), 1200),
                                              ((512, 512), 1200),
                                              ((288, 384), 3)])
def test_orb_describe_levels_matches_per_level(cuda, shape, n_features):
    """K2 over all 8 levels of one image in one launch: bitwise equal to
    the eight per-level launches (the 3-feature budget leaves levels 2-6
    without keypoints), one launch counted."""
    rng = np.random.default_rng(sum(shape))
    img = image.gaussian_blur(torch.from_numpy(_image(shape, "noise")))
    img = (image.gaussian_blur(img) + torch.from_numpy(
        rng.normal(0, 4, shape).astype(np.float32))).to(cuda)
    cfg = frontend.OrbConfig(n_features=n_features, n_levels=8)
    counts = cfg.per_level_counts()
    levels = image.build_pyramid(img, cfg.n_levels, cfg.scale)
    blurred = image.blur_levels(levels)
    yxs = fast.fast_select_levels(levels, counts, cfg).level_yx()
    assert 0 in counts or n_features > 3
    before = dict(orb_descriptor.LAUNCHES)
    ang, desc = orb_descriptor.orb_describe_levels(levels, blurred, yxs)
    assert orb_descriptor.LAUNCHES["kernel"] == before["kernel"] + 1
    assert orb_descriptor.LAUNCHES["plain"] == before["plain"]
    per = [orb_descriptor.orb_describe(l, b, yx)
           for l, b, yx in zip(levels, blurred, yxs)]
    assert ang.shape == (sum(counts),) and desc.shape == (sum(counts), 8)
    assert torch.equal(ang, torch.cat([p[0] for p in per]))
    assert torch.equal(desc, torch.cat([p[1] for p in per]))
    # and the plain version's gates
    a0, d0 = orb_descriptor.orb_describe_levels(
        [l.cpu() for l in levels], [b.cpu() for b in blurred],
        [yx.cpu() for yx in yxs])
    dang = torch.remainder(ang.cpu() - a0 + math.pi, 2 * math.pi) - math.pi
    assert float(dang.abs().max()) < 1e-4
    bits = orb_descriptor.unpack_bits(desc.cpu()) != \
        orb_descriptor.unpack_bits(d0)
    assert float(bits.float().mean()) <= 1e-3


def test_orb_describe_levels_refuses_unpacked_levels(cuda):
    """orb_describe_levels takes only consecutive contiguous views of one
    buffer for the levels and for the blurred levels."""
    img = torch.from_numpy(_image((120, 160), "noise")).to(cuda)
    levels = image.build_pyramid(img, 3, 1.2)
    blurred = image.blur_levels(levels)
    yxs = [torch.full((4, 2), 30, dtype=torch.int32, device=cuda)
           for _ in levels]
    before = dict(orb_descriptor.LAUNCHES)
    for lv, bl in (([l.clone() for l in levels], blurred),
                   (levels, [b.clone() for b in blurred]),
                   (levels[::-1], blurred[::-1]),
                   (levels, blurred[:2]),
                   (levels, [blurred[0], blurred[1][:, 1:], blurred[2]])):
        with pytest.raises(ValueError):
            orb_descriptor.orb_describe_levels(lv, bl, yxs[:len(lv)])
    with pytest.raises(ValueError):
        orb_descriptor.orb_describe_levels(levels, blurred,
                                           [yxs[0].long(), *yxs[1:]])
    assert orb_descriptor.LAUNCHES == before


def _desc(rng, n):
    return torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64).astype(
            np.int32))


CASES = {
    "no rows": (0, 5, 0.5),
    "one column": (9, 1, 0.5),
    "partial chunk": (13, 1000, 0.3),
    "full mask": (1200, 1200, 1.0),
    "empty mask": (40, 300, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hamming_top2_exact(cuda, case):
    n, m, density = CASES[case]
    rng = np.random.default_rng(len(case))
    a = _desc(rng, n).to(cuda)
    b = _desc(rng, m).to(cuda)
    mask = torch.from_numpy(rng.random((n, m)) < density).to(cuda)
    got = hamming.hamming_top2(a, b, mask)
    want = hamming.hamming_top2_plain(a, b, mask)
    for name, g, w in zip(("best", "index", "second"), got, want):
        assert torch.equal(g, w), (name, int((g != w).sum()))


def test_hamming_top2_ties_and_unaligned_views(cuda):
    rng = np.random.default_rng(3)
    b = _desc(rng, 300).to(cuda)
    b[150:] = b[:150]                       # every best distance ties twice
    flat = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda),
                      b[rng.integers(0, 300, 77)].reshape(-1)])
    a = flat[1:].view(77, 8)                # 4-byte offset: not 16-aligned
    assert a.data_ptr() % 16 != 0
    big = torch.from_numpy(rng.random((77, 301)) < 0.7).to(cuda)
    mask = big[:, 1:]                       # a strided view
    got = hamming.hamming_top2(a, b, mask)
    want = hamming.hamming_top2_plain(a, b, mask)
    for name, g, w in zip(("best", "index", "second"), got, want):
        assert torch.equal(g, w), (name, int((g != w).sum()))
    assert int((got[0] == 0).sum()) > 0     # some rows found their copy


def _gated_case(dev, mode, n, m, seed=0, nan_rows=0.0, cols_off=False,
                rows_off=False):
    """K3's gated inputs on the card: rows near columns (so many pairs pass
    and twins of every column descriptor make ties), NaN / inf rows, the
    octave at 0 and 7, and optionally every column or row flag off."""
    rng = np.random.default_rng(seed)
    b = _desc(rng, m)
    b[m // 2:] = b[:m - m // 2].clone()
    a = b[torch.from_numpy(rng.integers(0, m, n))].clone()
    a ^= torch.from_numpy(((rng.random((n, 8)) < 0.3)
                           << rng.integers(0, 31, (n, 8))).astype(np.int32))
    col_uv = rng.uniform(0, 752, (m, 2)).astype(np.float32)
    col_uv[:, 1] *= 480 / 752
    row_uv = (col_uv[rng.integers(0, m, n)] + rng.normal(0, 4, (n, 2))
              ).astype(np.float32)
    bad = rng.random(n) < nan_rows
    row_uv[bad] = rng.choice([np.nan, np.inf, -np.inf], (int(bad.sum()), 2))
    row_uv[bad & (rng.random(n) < 0.5), 0] = 5.0
    row_oct = rng.integers(0, 8, n).astype(np.int32)
    row_oct[:min(n, 2)] = 0
    row_oct[2:min(n, 4)] = 7
    if mode == "row_band":
        near = rng.integers(0, m, n)
        row_uv[:, 1] = np.where(rng.random(n) < 0.5, col_uv[near, 1],
                                row_uv[:, 1])
        row_uv[:, 0] = np.where(bad, row_uv[:, 0], col_uv[near, 0]
                                + rng.uniform(-5, 60, n)).astype(np.float32)
    sf = (1.2 ** np.arange(8)).astype(np.float32)
    row_r = (np.float32(2.0 if mode == "row_band" else 4.0)
             * sf[row_oct]).astype(np.float32)
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    row_ok = rng.random(n) < (0.0 if rows_off else 0.85)
    col_ok = rng.random(m) < (0.0 if cols_off else 0.9)
    col_oct = rng.integers(0, 8, m).astype(np.int32)
    if n == m == 1:                       # the one pair passes
        row_uv[0] = col_uv[0] + np.float32([2.0, 0.0])
        col_oct[0], row_ok[0], col_ok[0] = row_oct[0], True, True
    return (a.to(dev), b.to(dev), f(row_uv), f(row_r), f(row_oct), f(row_ok),
            f(col_uv), f(col_oct), f(col_ok))


GATED_CASES = {
    "1200x1200": dict(n=1200, m=1200, nan_rows=0.05),
    "4096x1200": dict(n=4096, m=1200, nan_rows=0.05),
    "4500x300 (one warp a row)": dict(n=4500, m=300, nan_rows=0.05),
    "odd 37x45": dict(n=37, m=45, nan_rows=0.2),
    "odd 333x1031 (two column chunks)": dict(n=333, m=1031),
    "one row, one column": dict(n=1, m=1),
    "NaN rows": dict(n=100, m=300, nan_rows=1.0),
    "all columns off": dict(n=300, m=200, cols_off=True),
    "all rows off": dict(n=300, m=200, rows_off=True),
}


@pytest.mark.parametrize("mode", sorted(hamming.GATE_MODES))
@pytest.mark.parametrize("case", sorted(GATED_CASES))
def test_hamming_top2_gated_bitwise(cuda, mode, case):
    """K3's gated mode against its plain version (the dense gate, then
    hamming_top2_plain) and against the masked kernel on the same gate:
    best, index and second bitwise equal, one launch a call."""
    args = _gated_case(cuda, mode, seed=len(case), **GATED_CASES[case])
    max_d = 120.0
    n0 = hamming.LAUNCHES["kernel"]
    got = hamming.hamming_top2_gated(*args, mode, max_d=max_d)
    assert hamming.LAUNCHES["kernel"] == n0 + 1
    want = hamming.hamming_top2_gated_plain(*args, mode, max_d=max_d)
    masked = hamming.hamming_top2(args[0], args[1], hamming.gate_mask(
        *args[2:], mode, max_d=max_d))
    for name, g, w, k in zip(("best", "index", "second"), got, want, masked):
        assert torch.equal(g, w), (name, int((g != w).sum()))
        assert torch.equal(g, k), (name, int((g != k).sum()))


def test_hamming_top2_gated_refuses_bad_inputs(cuda):
    args = list(_gated_case(cuda, "window", 20, 30))
    before = dict(hamming.LAUNCHES)
    bad = [(0, args[0].long()), (1, args[1][:, :4]), (2, args[2].double()),
           (3, args[3][:-1]), (4, args[4].long()), (5, args[5].int()),
           (6, args[6][:, :1]), (7, args[7][:-1]), (8, args[8].float())]
    for i, t in bad:
        a = list(args)
        a[i] = t
        with pytest.raises(ValueError):
            hamming.hamming_top2_gated(*a, "window")
    with pytest.raises(ValueError):
        hamming.hamming_top2_gated(*args, "box")
    empty = list(args)
    empty[1], empty[6], empty[7], empty[8] = (x[:0] for x in
                                              (args[1], args[6], args[7],
                                               args[8]))
    with pytest.raises(ValueError):
        hamming.hamming_top2_gated(*empty, "window")
    assert hamming.LAUNCHES == before


def test_wrappers_refuse_bad_inputs_on_the_card(cuda):
    before = [dict(m.LAUNCHES) for m in (fast, orb_descriptor, hamming)]
    img = torch.zeros((48, 64), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        fast.fast_select(img, 7.0, 20.0)
    with pytest.raises(ValueError):
        orb_descriptor.orb_describe(img.float(), img.float(), torch.zeros(
            (3, 2), dtype=torch.int64, device=cuda))
    d = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        hamming.hamming_top2(d, d[:0], torch.zeros((4, 0), dtype=torch.bool,
                                                   device=cuda))
    assert [dict(m.LAUNCHES) for m in (fast, orb_descriptor, hamming)] == \
        before


def test_extract_orb_level0_matches_cpu(cuda):
    """The whole frontend on the card (K1, K2, the pyramid and blur) keeps
    the CPU run's level-0 keypoints, angles and descriptors."""
    rng = np.random.default_rng(5)
    img = image.gaussian_blur(torch.from_numpy(_image((240, 320), "noise")))
    img = image.gaussian_blur(img) + torch.from_numpy(
        rng.normal(0, 4, (240, 320)).astype(np.float32))
    cfg = frontend.OrbConfig(n_features=500, n_levels=4)
    n0 = cfg.per_level_counts()[0]
    got = frontend.extract_orb(img.to(cuda), cfg)
    want = frontend.extract_orb(img, cfg)
    assert torch.equal(got.uv[:n0].cpu(), want.uv[:n0])
    assert torch.equal(got.valid[:n0].cpu(), want.valid[:n0])
    ok = want.valid[:n0]
    dang = torch.remainder(got.angle[:n0].cpu() - want.angle[:n0] + math.pi,
                           2 * math.pi) - math.pi
    assert float(dang[ok].abs().max()) < 1e-4
    bits = orb_descriptor.unpack_bits(got.desc[:n0].cpu()[ok]) != \
        orb_descriptor.unpack_bits(want.desc[:n0][ok])
    assert float(bits.float().mean()) <= 1e-3


def _sad_pair(cuda, kind, shift=0, seed=7, shape=(120, 160)):
    rng = np.random.default_rng(seed)
    if kind == "flat":
        left = np.full(shape, 90.0, np.float32)
    else:
        left = rng.integers(0, 256, shape).astype(np.float32)
    right = np.roll(left, -shift, axis=1)
    if kind == "noise":
        right = right + rng.normal(0, 0.7, shape).astype(np.float32)
    return (torch.from_numpy(left).to(cuda),
            torch.from_numpy(np.ascontiguousarray(right)).to(cuda))


def _sad_check(cuda, left, right, uv, u0, integer):
    got = stereo.sad_refine(left, right, uv.to(cuda), u0.to(cuda))
    want = stereo.sad_refine_plain(left, right, uv.to(cuda), u0.to(cuda))
    if integer:
        assert torch.equal(got[2], want[2])
        assert torch.equal(got[1], want[1])
    tol = 1e-5 if integer else 1e-3
    assert bool(torch.all((got[0] - want[0]).abs() <= tol))
    return got


def test_sad_refine_border_and_outside(cuda):
    h, w = 120, 160
    left, right = _sad_pair(cuda, "int", shift=3)
    uv = torch.tensor([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1],
                       [0.5, 2.5], [w - 1.5, h - 0.5], [-7, 3], [w + 30, h + 9],
                       [4, 60], [w - 5, 60]], dtype=torch.float32)
    u0 = torch.clamp(uv[:, 0] - 3, min=-20)
    _, sad, k = _sad_check(cuda, left, right, uv, u0, integer=True)
    assert int((k == 5).sum()) >= 1 and float(sad.min()) == 0.0


def test_sad_refine_ties_pick_first_offset(cuda):
    left, right = _sad_pair(cuda, "flat")
    uv = torch.tensor([[40.0, 40.0], [80.0, 60.0], [0.0, 0.0]])
    ur, sad, k = _sad_check(cuda, left, right, uv, uv[:, 0], integer=True)
    assert torch.equal(k.cpu(), torch.zeros(3, dtype=torch.int32))
    assert torch.equal(sad.cpu(), torch.zeros(3))
    assert torch.equal(ur.cpu(), uv[:, 0] - 5)      # 0 at the sweep's end


@pytest.mark.parametrize("offset", [-5, 5])
def test_sad_refine_best_at_sweep_ends(cuda, offset):
    left, right = _sad_pair(cuda, "int", shift=7)
    rng = np.random.default_rng(11)
    uv = torch.from_numpy(np.stack([rng.uniform(20, 140, 200),
                                    rng.uniform(10, 110, 200)], -1).astype(
        np.float32))
    uv = torch.round(uv)
    u0 = uv[:, 0] - 7 - offset              # true match at u0 + offset
    ur, _, k = _sad_check(cuda, left, right, uv, u0, integer=True)
    assert bool(torch.all(k == 5 + offset))
    assert torch.equal(ur.cpu(), uv[:, 0] - 7)      # delta 0 at the ends


@pytest.mark.parametrize("n", [0, 1, 9, 1200])
def test_sad_refine_non_integer(cuda, n):
    left, right = _sad_pair(cuda, "noise", shift=4, shape=(480, 752))
    rng = np.random.default_rng(n)
    uv = torch.from_numpy(np.stack([rng.uniform(0, 751, n),
                                    rng.uniform(0, 479, n)], -1).astype(
        np.float32).reshape(n, 2))
    u0 = uv[:, 0] - 4 + torch.from_numpy(rng.integers(-3, 4, n).astype(
        np.float32))
    got = _sad_check(cuda, left, right, uv, u0, integer=False)
    assert got[0].shape == (n,)


def _k7_case(cuda, case):
    """Inputs of K7's whole launch on integer-valued images: (img_l, img_r,
    uv_l, uv_r, best_idx, matched, bf, max_d)."""
    rng = np.random.default_rng(K7_CASES.index(case))
    n = dict(n1=1, n333=333, n4000=4000).get(case, 1200)
    kind = "flat" if case in ("flat_ties", "disparity_edges") else "int"
    left, right = _sad_pair(cuda, kind, shift=6, shape=(480, 752))
    uv_l = np.stack([rng.integers(0, 752, n), rng.integers(0, 480, n)],
                    -1).astype(np.float32)
    nr = max(n, 16)
    uv_r = np.stack([rng.uniform(-10, 760, nr), rng.uniform(0, 480, nr)],
                    -1).astype(np.float32)
    best = rng.integers(0, nr, n).astype(np.int32)
    # most rows matched to a right keypoint near the true shift
    near = rng.uniform(size=n) < 0.8
    uv_r[best[near], 0] = uv_l[near, 0] - 6 + rng.integers(-3, 4, near.sum())
    matched = rng.uniform(size=n) < 0.7
    bf, max_d = 48.0, 40.0
    if case == "unmatched":
        matched[:] = False
    elif case == "one_matched":
        matched[:] = False
        matched[n // 2] = True
    elif case == "sad_ties":
        # a block of duplicated keypoints: equal SADs around the median
        uv_l[n // 3:] = uv_l[n // 3]
        best[n // 3:] = best[n // 3]
    elif case == "disparity_edges":
        # flat images: every SAD 0, offset 0, so ur_ref = u0 - 5 exactly;
        # disparities 0, max_d, just inside both and negative
        best = np.arange(n, dtype=np.int32) % nr
        disp = np.resize(np.float32([0.0, max_d, 0.5, max_d - 0.5, -2.0,
                                     max_d + 1.0, 17.0]), n)
        uv_r[best, 0] = uv_l[:, 0] - disp + 5.0
    f = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=cuda)
    return (left, right, f(uv_l), f(uv_r), f(best, torch.int32),
            f(matched, torch.bool), bf, max_d)


K7_CASES = ["n1", "n333", "unmatched", "one_matched", "sad_ties",
            "flat_ties", "disparity_edges", "n4000"]


@pytest.mark.parametrize("case", K7_CASES)
def test_refine_and_filter_bitwise_equal_plain(cuda, case):
    """K7's one launch (the sweep, the disparity gate, the median filter
    and the depth) against the plain composition on integer images: every
    output bit for bit, twice (the last block's ticket is reset)."""
    args = _k7_case(cuda, case)
    n0 = stereo.LAUNCHES["kernel"]
    got = stereo.refine_and_filter(*args)
    again = stereo.refine_and_filter(*args)
    want = stereo.refine_and_filter_plain(*args)
    assert stereo.LAUNCHES["kernel"] == n0 + 2
    for a, b, c in zip(got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(a, c), (case, int((a != c).sum()))
        assert torch.equal(b, c)
    if case == "unmatched":
        assert not bool(got.valid.any())
    if case == "one_matched":
        assert int(got.valid.sum()) <= 1
    if case == "disparity_edges":
        m = args[5]
        disp = args[2][:, 0] - (args[3][args[4].long(), 0] - 5.0)
        inside = m & (disp > 0) & (disp < args[7])
        assert torch.equal(got.valid, inside)
        assert int((m & (disp == 0)).sum()) > 0
        assert int((m & (disp == args[7])).sum()) > 0


@pytest.mark.parametrize("nr", [0, 16])
def test_refine_and_filter_no_keypoint(cuda, nr):
    """N == 0: both routes return empty matches, and the kernel route
    neither launches nor counts a launch."""
    img = torch.zeros((48, 64), device=cuda)
    args = (img, img, torch.zeros((0, 2), device=cuda),
            torch.zeros((nr, 2), device=cuda),
            torch.zeros(0, dtype=torch.int32, device=cuda),
            torch.zeros(0, dtype=torch.bool, device=cuda), 48.0, 40.0)
    n0 = stereo.LAUNCHES["kernel"]
    got = stereo.refine_and_filter(*args)
    sweep = stereo.sad_refine(img, img, args[2], torch.zeros(0, device=cuda))
    assert stereo.LAUNCHES["kernel"] == n0
    want = stereo.refine_and_filter_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape == (0,)
        assert a.device == img.device
    assert [t.shape for t in sweep] == [(0,)] * 3


def _remap_case(cuda, hs, ws, h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 255, (hs, ws)).astype(
        np.float32)).to(cuda)
    mp = np.stack([rng.uniform(-1.5, ws + 0.5, (h, w)),
                   rng.uniform(-1.5, hs + 0.5, (h, w))], -1).astype(np.float32)
    edge = [[ws - 1, hs - 1], [ws - 1, 0], [0, hs - 1], [0, 0],
            [np.nextafter(np.float32(ws - 1), np.float32(ws)), 3],
            [3, np.nextafter(np.float32(hs - 1), np.float32(hs))],
            [np.nextafter(np.float32(0), np.float32(-1)), 3],
            [3, -1e-7], [np.nan, 3], [1e9, -1e9]]
    n = min(len(edge), h * w)
    mp.reshape(-1, 2)[:n] = edge[:n]
    return img, torch.from_numpy(mp).to(cuda)


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (7, 9, 5, 3),
                                   (480, 752, 480, 752), (200, 300, 31, 517)])
def test_remap_bilinear_exact(cuda, shape):
    img, mp = _remap_case(cuda, *shape)
    got = rectify.remap_bilinear(img, mp)
    want = rectify.remap_bilinear_plain(img[None], mp[None])[0]
    assert torch.equal(got, want), float((got - want).abs().max())
    hs, ws = shape[:2]
    flat = got.reshape(-1).cpu()
    if flat.numel() >= 10:
        assert float(flat[0]) == float(img[hs - 1, ws - 1])   # last pixel
        assert bool(torch.all(flat[4:10] == 0))     # just outside, NaN, huge


def test_remap_bilinear_batch_and_views(cuda):
    img, mp = _remap_case(cuda, 480, 752, 480, 752, seed=3)
    pair = torch.stack([img, img.flip(0)])
    maps = torch.stack([mp, mp.flip(1)])
    got = rectify.remap_bilinear(pair, maps)
    for b in range(2):
        assert torch.equal(got[b], rectify.remap_bilinear_plain(
            pair[b:b + 1], maps[b:b + 1])[0])
    # a non-contiguous map view is copied, not misread
    view = torch.cat([mp, mp], dim=1)[:, ::2]
    assert torch.equal(rectify.remap_bilinear(img, view),
                       rectify.remap_bilinear_plain(img[None],
                                                    view[None])[0])


def test_k7_k8_refuse_bad_inputs_on_the_card(cuda):
    before = [dict(m.LAUNCHES) for m in (stereo, rectify)]
    img = torch.zeros((48, 64), device=cuda)
    with pytest.raises(ValueError):
        stereo.sad_refine(img.double(), img.double(),
                          torch.zeros((3, 2), device=cuda),
                          torch.zeros(3, device=cuda))
    with pytest.raises(ValueError):
        stereo.sad_refine(img, img[:, :32], torch.zeros((3, 2), device=cuda),
                          torch.zeros(3, device=cuda))
    uv = torch.zeros((3, 2), device=cuda)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    ok = torch.ones(3, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        stereo.refine_and_filter(img, img, uv, uv, idx.long(), ok, 48.0,
                                 40.0)
    with pytest.raises(ValueError):
        stereo.refine_and_filter(img, img, uv, uv, idx, ok.float(), 48.0,
                                 40.0)
    with pytest.raises(ValueError):
        stereo.refine_and_filter(img, img, uv, uv[:, :1], idx, ok, 48.0,
                                 40.0)
    with pytest.raises(ValueError):
        stereo.refine_and_filter(img.double(), img.double(), uv, uv, idx,
                                 ok, 48.0, 40.0)
    with pytest.raises(ValueError):
        rectify.remap_bilinear(img, torch.zeros((8, 8, 3), device=cuda))
    with pytest.raises(ValueError):
        rectify.remap_bilinear(img, torch.zeros((8, 8, 2)))
    assert [dict(m.LAUNCHES) for m in (stereo, rectify)] == before


# ---------------------------------------------------------------------------
# K5 pose_opt
# ---------------------------------------------------------------------------

def _pose_problem(cuda, n, stereo_share=0.0, behind=0.0, valid_share=0.95,
                  seed=0):
    """n points seen from a perturbed pose: 0.5 px noise, 10% outliers,
    optionally a share of stereo rows and of points behind the camera."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(2, 8, n)], -1)
    X[rng.random(n) < behind, 2] *= -1
    uv = X[:, :2] / X[:, 2:] + rng.normal(0, 0.5 / 460.0, (n, 2))
    bad = rng.random(n) < 0.1
    uv[bad] += rng.uniform(-0.05, 0.05, (int(bad.sum()), 2))
    ur = np.full(n, np.nan)
    st = rng.random(n) < stereo_share
    ur[st] = ((X[st, 0] - 0.11) / X[st, 2]
              + rng.normal(0, 0.5 / 460.0, int(st.sum())))
    info = 460.0 ** 2 * 1.2 ** (-2.0 * rng.integers(0, 8, n))
    valid = rng.random(n) < valid_share
    dR, dt = lie.se3_exp(torch.tensor([0.05, -0.03, 0.04, 0.02, -0.01, 0.015]))
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=cuda)
    return (dR.to(cuda), dt.to(cuda), f(X), f(uv), f(info),
            torch.from_numpy(valid).to(cuda),
            f(ur) if stereo_share > 0 else None)


def _chi2_close(got, want, info):
    """chi2 = |r|^2 info; compare the residual norms |r| in normalized
    units: both versions transform the points with float32 products in
    their own order, so |r| agrees to ~1e-7 x |x / z|, not chi2 to a fixed
    relative tolerance (a small residual is a difference of two ~1 terms)."""
    d = (torch.sqrt(got / info) - torch.sqrt(want / info)).abs()
    assert float(d.max()) <= 1e-6, float(d.max())


def _pose_check(got, want, n_valid):
    assert torch.allclose(got.R, want.R, atol=1e-4), (got.R, want.R)
    assert torch.allclose(got.t, want.t, atol=1e-4), (got.t, want.t)
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= \
        max(0.01 * n_valid, 0), (int(got.n_inliers), int(want.n_inliers))
    assert got.inliers.dtype == torch.bool and got.chi2.shape == want.chi2.shape
    assert int(got.n_inliers) == int(got.inliers.sum())


@pytest.mark.parametrize("rounds,iters", [(0, 0), (2, 8), (3, 10)])
@pytest.mark.parametrize("n,stereo_share", [(0, 0.0), (31, 0.6), (1200, 0.0),
                                            (1200, 0.6), (1200, 1.0),
                                            (2000, 0.6), (16384, 0.3)])
def test_pose_opt_matches_plain(cuda, n, stereo_share, rounds, iters):
    """K5 against its plain version; 2000 and 16384 rows pass the
    kernel's register cap (1536 rows), 0 x 0 only evaluates."""
    args = _pose_problem(cuda, n, stereo_share=stereo_share, seed=n)
    ur = args[6]
    kw = dict(obs_ur=ur, baseline=0.11 if ur is not None else 0.0,
              n_rounds=rounds, n_iters=iters)
    got = pose_opt.optimize_pose(*args[:6], **kw)
    want = pose_opt.optimize_pose_plain(*args[:6], **kw)
    _pose_check(got, want, int(args[5].sum()))
    if n > 0 and rounds > 0:   # it converged: most valid rows are inliers
        assert int(got.n_inliers) > 0.7 * int(args[5].sum())
    if rounds == 0:
        assert torch.equal(got.R, args[0]) and torch.equal(got.t, args[1])
        if n > 0:
            _chi2_close(got.chi2, want.chi2, args[4])
        assert torch.equal(got.inliers, want.inliers)


@pytest.mark.parametrize("rounds,iters", [(2, 8), (3, 10)])
def test_pose_opt_single_observation(cuda, rounds, iters):
    """One row constrains 2 of the 6 pose directions: the other 4 see only
    the 1e-6 damping, so both versions' steps there are float32 rounding
    amplified ~1e6 times and are not comparable. What holds: the launch
    runs, the pose stays a finite rotation, and the returned chi2, inlier
    flag and count are those of the returned pose (the plain version
    evaluated there with no step)."""
    R0, t0, X, uv, info, _, _ = _pose_problem(cuda, 1, seed=1)
    valid = torch.ones(1, dtype=torch.bool, device=cuda)
    got = pose_opt.optimize_pose(R0, t0, X, uv, info, valid,
                                 n_rounds=rounds, n_iters=iters)
    assert bool(torch.isfinite(got.R).all() and torch.isfinite(got.t).all())
    eye = torch.eye(3, device=cuda)
    assert torch.allclose(got.R @ got.R.T, eye, atol=1e-4)
    at = pose_opt.optimize_pose_plain(got.R, got.t, X, uv, info, valid,
                                      n_rounds=0, n_iters=0)
    _chi2_close(got.chi2, at.chi2, info)
    assert torch.equal(got.inliers, at.inliers)
    assert int(got.n_inliers) == int(at.n_inliers)
    # zero rounds: the kernel only evaluates, as the plain version does
    got0 = pose_opt.optimize_pose(R0, t0, X, uv, info, valid, n_rounds=0,
                                  n_iters=0)
    want0 = pose_opt.optimize_pose_plain(R0, t0, X, uv, info, valid,
                                         n_rounds=0, n_iters=0)
    assert torch.equal(got0.R, R0) and torch.equal(got0.t, t0)
    _chi2_close(got0.chi2, want0.chi2, info)
    assert torch.equal(got0.inliers, want0.inliers)


def test_pose_opt_all_invalid_and_behind(cuda):
    R0, t0, X, uv, info, valid, _ = _pose_problem(cuda, 500, behind=0.3)
    none = torch.zeros_like(valid)
    got = pose_opt.optimize_pose(R0, t0, X, uv, info, none, n_rounds=3,
                                 n_iters=10)
    assert torch.equal(got.R, R0) and torch.equal(got.t, t0)
    assert int(got.n_inliers) == 0 and not bool(got.inliers.any())
    want = pose_opt.optimize_pose_plain(R0, t0, X, uv, info, none,
                                        n_rounds=3, n_iters=10)
    _chi2_close(got.chi2, want.chi2, info)
    # 30% of the points behind the camera contribute nothing
    got = pose_opt.optimize_pose(R0, t0, X, uv, info, valid, n_rounds=3,
                                 n_iters=10)
    want = pose_opt.optimize_pose_plain(R0, t0, X, uv, info, valid,
                                        n_rounds=3, n_iters=10)
    _pose_check(got, want, int(valid.sum()))


def test_pose_opt_strided_observations(cuda):
    R0, t0, X, uv, info, valid, _ = _pose_problem(cuda, 700, seed=4)
    xn = torch.cat([uv, torch.ones_like(uv[:, :1])], -1)[:, :2]
    assert not xn.is_contiguous()
    got = pose_opt.optimize_pose(R0, t0, X, xn, info, valid, n_rounds=2,
                                 n_iters=8)
    want = pose_opt.optimize_pose_plain(R0, t0, X, uv, info, valid,
                                        n_rounds=2, n_iters=8)
    _pose_check(got, want, int(valid.sum()))


# ---------------------------------------------------------------------------
# K9 vocab_transform
# ---------------------------------------------------------------------------

def _vocab(cuda, k, depth, seed=0, tie_every=0):
    rng = np.random.default_rng(seed)
    centers = []
    for level in range(depth):
        c = _desc(rng, k ** (level + 1))
        if tie_every:
            # children j and j + 1 of a node identical: argmin takes j
            c = c.reshape(-1, k, 8)
            c[:, 1::tie_every] = c[:, 0::tie_every][:, :c[:, 1::tie_every]
                                                   .shape[1]]
            c = c.reshape(-1, 8)
        centers.append(c.to(cuda))
    return tree.Vocabulary(centers=tuple(centers),
                           weights=torch.ones(k ** depth, device=cuda), k=k)


@pytest.mark.parametrize("k,depth", [(10, 4), (3, 6), (16, 3), (8, 5),
                                     (40, 2), (5, 1)])
def test_vocab_transform_exact(cuda, k, depth):
    voc = _vocab(cuda, k, depth, seed=k)
    rng = np.random.default_rng(depth)
    d = _desc(rng, 1200).to(cuda)
    valid = torch.from_numpy(rng.random(1200) < 0.8).to(cuda)
    got = tree.transform(voc, d, valid)
    want = tree.transform_plain(voc, d, valid)
    assert torch.equal(got, want), int((got != want).sum())
    assert torch.equal(tree.transform(voc, d), tree.transform_plain(voc, d))
    assert bool((got[~valid] == -1).all())


def test_vocab_transform_ties_and_invalid(cuda):
    voc = _vocab(cuda, 10, 4, seed=1, tie_every=2)
    rng = np.random.default_rng(9)
    # descriptors equal to centers: ties at distance 0 in every level
    d = torch.cat([voc.centers[-1][rng.integers(0, 10 ** 4, 300)],
                   _desc(rng, 300).to(cuda)])
    got = tree.transform(voc, d)
    assert torch.equal(got, tree.transform_plain(voc, d))
    # a copied leaf center ties with its original: the first child wins
    assert int((got[:300] % 2).sum()) == 0
    none = torch.zeros(600, dtype=torch.bool, device=cuda)
    assert bool((tree.transform(voc, d, none) == -1).all())
    empty = tree.transform(voc, d[:0], none[:0])
    assert empty.shape == (0,)


# ---------------------------------------------------------------------------
# K10 bow_l1
# ---------------------------------------------------------------------------

def _bows(cuda, n, W, seed):
    rng = np.random.default_rng(seed)
    v = rng.random((n, W)) * (rng.random((n, W)) < 0.05)
    v /= np.maximum(v.sum(1, keepdims=True), 1e-12)
    return torch.from_numpy(v.astype(np.float32)).to(cuda)


@pytest.mark.parametrize("B,K,W", [(1, 256, 10 ** 4), (3, 256, 10 ** 4 + 3),
                                   (2, 7, 1001), (1, 1, 5), (4, 300, 216)])
def test_bow_l1_matches_plain(cuda, B, K, W):
    db = _bows(cuda, K, W, seed=K)
    q = _bows(cuda, B, W, seed=W)
    rng = np.random.default_rng(B)
    ok = torch.from_numpy(rng.random(K) < 0.7).to(cuda)
    for qq in (q, q[0]):
        for mask in (None, ok):
            got = tree.l1_score(qq, db, mask)
            want = tree.l1_score_plain(qq, db, mask)
            assert got.shape == want.shape
            assert torch.allclose(got, want, atol=1e-5), \
                float((got - want).abs().max())
            if mask is not None:
                assert bool((got[..., ~mask] == -1).all())
    # a query scores 1 against itself
    assert abs(float(tree.l1_score(db[0], db)[0]) - 1.0) < 1e-5


def test_new_wrappers_refuse_bad_inputs_on_the_card(cuda):
    counts = [pose_opt.LAUNCHES, tree.LAUNCHES["vocab_transform"],
              tree.LAUNCHES["bow_l1"]]
    before = [dict(c) for c in counts]
    R0, t0, X, uv, info, valid, _ = _pose_problem(cuda, 20)
    with pytest.raises(ValueError):
        pose_opt.optimize_pose(R0, t0, X.double(), uv, info, valid)
    with pytest.raises(ValueError):
        pose_opt.optimize_pose(R0, t0, X, uv, info, valid[:5])
    with pytest.raises(ValueError):
        pose_opt.optimize_pose(R0, t0, X, uv, info, valid.float())
    with pytest.raises(ValueError):
        pose_opt.optimize_pose(R0.cpu(), t0, X, uv, info, valid)
    voc = _vocab(cuda, 4, 2)
    d = torch.zeros((5, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tree.transform(voc, d.long())
    with pytest.raises(ValueError):
        tree.transform(voc, d[:, :4])
    with pytest.raises(ValueError):
        tree.transform(voc.to("cpu"), d)
    with pytest.raises(ValueError):
        tree.transform(voc, d, torch.ones(4, dtype=torch.bool, device=cuda))
    db = torch.zeros((3, 16), device=cuda)
    with pytest.raises(ValueError):
        tree.l1_score(torch.zeros(15, device=cuda), db)
    with pytest.raises(ValueError):
        tree.l1_score(torch.zeros(16, device=cuda), db.double())
    with pytest.raises(ValueError):
        tree.l1_score(torch.zeros(16, device=cuda), db,
                      torch.ones(2, dtype=torch.bool, device=cuda))
    assert [dict(c) for c in counts] == before


# ---------------------------------------------------------------------------
# K4 ba_assemble
# ---------------------------------------------------------------------------

def _ba_problem(cuda, K, L, per_kf, seed=0, stereo_share=0.3, dup=0.05):
    """K keyframes looking at L landmarks, per_kf observations each (some
    repeated (landmark, keyframe) pairs, masked rows, fixed landmarks)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                  rng.uniform(3, 9, L)], -1)
    R = np.stack([lie.so3_exp(torch.tensor(rng.normal(0, 0.05, 3),
                                           dtype=torch.float32)).numpy()
                  for _ in range(K)])
    t = rng.normal(0, 0.2, (K, 3))
    O = K * per_kf
    obs_kf = np.repeat(np.arange(K), per_kf)
    obs_lm = rng.integers(0, max(L, 1), O)
    rep = rng.random(O) < dup
    obs_lm[1:][rep[1:]] = obs_lm[:-1][rep[1:]]
    obs_kf[1:][rep[1:]] = obs_kf[:-1][rep[1:]]
    Xc = np.einsum('oij,oj->oi', R[obs_kf], X[obs_lm]) + t[obs_kf]
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 2.0 / 460, (O, 2))
    ur = np.where(rng.random(O) < stereo_share,
                  (Xc[:, 0] - 0.11) / Xc[:, 2], np.nan)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=cuda)
    i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                  device=cuda)
    b = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.bool,
                                  device=cuda)
    return ba.make_problem(
        R=f(R), t=f(t), X=f(X), obs_kf=i(obs_kf), obs_lm=i(obs_lm),
        obs_uv=f(uv), obs_info=f(460.0 ** 2 * 1.2 ** (-2.0 * rng.integers(
            0, 8, O))), obs_mask=b(rng.random(O) < 0.9),
        kf_opt=b(np.arange(K) >= 2), lm_opt=b(rng.random(L) < 0.85),
        obs_ur=f(ur), baseline=0.11)


def _blocks_close(got, want, tol=1e-4):
    for name, a, b in zip(ba.BlockSums._fields, got, want):
        scale = max(float(b.abs().max()) if b.numel() else 0.0, 1e-30)
        d = float((a - b).abs().max()) / scale if b.numel() else 0.0
        assert d <= tol, (name, d)


def _k4_special(p, case):
    """`all_masked`: every observation masked; `lm_masked`: the first 5
    landmarks' observations all masked (and landmarks 5-9 fixed)."""
    if case == "all_masked":
        return p._replace(obs_mask=torch.zeros_like(p.obs_mask))
    if case == "lm_masked":
        return p._replace(obs_mask=p.obs_mask & (p.obs_lm >= 5),
                          lm_opt=p.lm_opt & ((torch.arange(
                              p.X.shape[0], device=p.X.device) < 5) |
                              (torch.arange(p.X.shape[0],
                                            device=p.X.device) >= 10)))
    return p


# (K, L, per_kf, case): the stereo path's size; a few landmarks; one
# observation; no observation; 7 landmarks seen ~170 times each (many
# repeated (landmark, keyframe) pairs); K = 1 with L = 333, no multiple of
# 32; every observation masked; landmarks whose observations are all masked
K4_CASES = [(18, 6144, 1200, None), (3, 40, 30, None), (1, 1, 1, None),
            (4, 50, 0, None), (40, 7, 30, None), (1, 333, 500, None),
            (6, 100, 40, "all_masked"), (6, 70, 40, "lm_masked")]


@pytest.mark.parametrize("body", [False, True])
@pytest.mark.parametrize("K,L,per_kf,case", K4_CASES)
def test_ba_assemble_matches_plain_and_repeats(cuda, K, L, per_kf, case,
                                               body):
    p = _k4_special(_ba_problem(cuda, K, L, per_kf, seed=K), case)
    order = ba.obs_order(p)
    got = ba.assemble(p, p.R, p.t, p.X, order, body=body)
    want = ba.assemble_plain(p, p.R, p.t, p.X, body=body)
    _blocks_close(got, want)
    again = ba.assemble(p, p.R, p.t, p.X, order, body=body)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_ba_solve_kernel_matches_plain(cuda):
    """The LM loop over K4: the same accept sequence, R within 1e-5, t
    within 1e-4, the final cost within 1e-3 relative and the landmarks
    within 1e-2 chi2 units (dX^T Hll dX) of the plain assembly's loop. Landmarks
    seen once are barely constrained in depth: float32 rounding of their
    blocks moves them by ~1e-3 m, in the plain loop too when its sums run
    in float64."""
    p = _ba_problem(cuda, 6, 400, 300, seed=3, dup=0.0)
    dR = lie.so3_exp(torch.tensor([0.01, -0.01, 0.005], device=cuda))
    p = p._replace(R=dR @ p.R, t=p.t + 0.02)
    got = ba.ba_solve(p, n_iters=5)
    orig = ba.assemble
    try:
        ba.assemble = lambda p, R, t, X, order=None, body=False: \
            ba.assemble_plain(p, R, t, X, body)
        want = ba.ba_solve(p, n_iters=5)
    finally:
        ba.assemble = orig
    assert torch.equal(got[3]["accepted"], want[3]["accepted"])
    assert torch.allclose(got[0], want[0], atol=1e-5)
    assert torch.allclose(got[1], want[1], atol=1e-4)
    cost, cost_p = got[3]["costs"][-1], want[3]["costs"][-1]
    assert float((cost - cost_p).abs() / cost_p.abs()) <= 1e-3
    Hll = ba.assemble_plain(p, *want[:3]).Hll
    dX = got[2] - want[2]
    assert float(torch.einsum('li,lij,lj->l', dX, Hll, dX).max()) <= 1e-2


# ---------------------------------------------------------------------------
# K4 per-observation mode and K14 schur_pcg
# ---------------------------------------------------------------------------

def _pcg_problem(cuda, case):
    """Problems for the global BA's kernels: `odd` segment lengths (no
    multiple of 32, landmarks with no observation), `empty_kf` (a keyframe
    whose observations are all masked, one with none at all),
    `all_masked`, `none_opt` (kf_opt and lm_opt all False) and `large`
    (the loop phase's K and L with 700 observations per keyframe)."""
    if case == "large":
        p = _ba_problem(cuda, 40, 8000, 700, seed=11)
    else:
        p = _ba_problem(cuda, 7, 300, 45, seed=5)
    if case == "empty_kf":
        p = p._replace(obs_mask=p.obs_mask & (p.obs_kf != 2))
        keep = p.obs_kf != 4
        p = p._replace(**{f: getattr(p, f)[keep] for f in (
            "obs_kf", "obs_lm", "obs_uv", "obs_ur", "obs_info",
            "obs_mask")})
    elif case == "all_masked":
        p = p._replace(obs_mask=torch.zeros_like(p.obs_mask))
    elif case == "none_opt":
        p = p._replace(kf_opt=torch.zeros_like(p.kf_opt),
                       lm_opt=torch.zeros_like(p.lm_opt))
    return p


def _rel(a, b):
    scale = max(float(b.abs().max()) if b.numel() else 0.0, 1e-30)
    return float((a - b).abs().max()) / scale if b.numel() else 0.0


PCG_CASES = ["odd", "empty_kf", "all_masked", "none_opt", "large"]


@pytest.mark.parametrize("body", [False, True])
@pytest.mark.parametrize("case", PCG_CASES + ["dense_lm", "k1"])
def test_ba_assemble_per_obs_matches_plain_and_repeats(cuda, case, body):
    """Also `dense_lm` (7 landmarks seen ~170 times each, slots no multiple
    of 32) and `k1` (one keyframe, L = 333): Wpl allocated uninitialized,
    the kernel writes every slot (masked ones as zeros)."""
    if case == "dense_lm":
        p = _ba_problem(cuda, 40, 7, 31, seed=7)
    elif case == "k1":
        p = _ba_problem(cuda, 1, 333, 501, seed=1)
    else:
        p = _pcg_problem(cuda, case)
    order = ba.obs_order(p)
    got = ba.assemble(p, p.R, p.t, p.X, order, body=body, per_obs=True)
    want = ba.assemble_obs_plain(p, p.R, p.t, p.X, body=body)
    for name, a, b in zip(ba.ObsBlocks._fields, got, want):
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))
    assert not bool(got.Wpl[~p.obs_mask].any())
    again = ba.assemble(p, p.R, p.t, p.X, order, body=body, per_obs=True)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def _schur_uses(p, ob, Hpp, Hll_inv, bl, x, order):
    """K14's three uses, each as (kernel call, plain call, the magnitude
    of the summed terms: the same sums over absolute values; -|x| makes
    the back-substitution's c - W^T x add its terms)."""
    W, Wa, xa, Ha = ob.Wpl, ob.Wpl.abs(), x.abs(), Hll_inv.abs()
    kf = p.kf_opt.float()[:, None]
    y0 = torch.einsum('lab,lb->la', Hll_inv, bl)
    ya = ba.schur_lm_pass_plain(p, Wa, xa, Ha)
    return [
        (lambda: ba.schur_matvec(p, W, Hpp, Hll_inv, x, order),
         lambda: ba.schur_kf_pass_plain(
             p, W, ba.schur_lm_pass_plain(p, W, x, Hll_inv), Hpp=Hpp, x=x),
         -ba.schur_kf_pass_plain(p, Wa, ya, a=-torch.einsum(
             'kab,kb->ka', Hpp.abs(), xa * kf))),
        (lambda: ba.schur_kf_pass(p, W, y0, order, a=ob.bp),
         lambda: ba.schur_kf_pass_plain(p, W, y0, a=ob.bp),
         -ba.schur_kf_pass_plain(p, Wa, y0.abs(), a=-ob.bp.abs())),
        (lambda: ba.schur_lm_pass(p, W, x, Hll_inv, order, c=bl),
         lambda: ba.schur_lm_pass_plain(p, W, x, Hll_inv, c=bl),
         ba.schur_lm_pass_plain(p, Wa, -xa, Ha, c=bl.abs()))]


def _err_by_magnitude(got, want, mag):
    """max |got - want| over the magnitude of each entry's summed terms:
    the float32 rounding of a sum is bounded by its terms, not its value
    (the back-substitution's bl - B^T x cancels)."""
    return float(((got - want).abs() / mag.clamp(min=1e-30)).max()) \
        if got.numel() else 0.0


@pytest.mark.parametrize("case", PCG_CASES)
def test_schur_pcg_matches_plain_and_repeats(cuda, case):
    """K14's two passes in each of their uses (S x, the right-hand side,
    the back-substitution) against the plain passes on the same blocks,
    within 1e-5 of each entry's term magnitude; two launches bitwise
    equal."""
    from morb_slam_tpu_torch.optim import linalg
    p = _pcg_problem(cuda, case)
    order = ba.obs_order(p)
    ob = ba.assemble_obs_plain(p, p.R, p.t, p.X)
    lam = torch.tensor(1e-3, device=cuda)
    Hpp = ba._damp(ob.Hpp, lam)
    Hll_inv = linalg.inv3x3(torch.where(
        p.lm_opt[:, None, None], ba._damp(ob.Hll, lam),
        torch.eye(3, device=cuda).expand(ob.Hll.shape)))
    bl = ob.bl * p.lm_opt.float()[:, None]
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(p.R.shape[0], 6, device=cuda, generator=g)
    uses = _schur_uses(p, ob, Hpp, Hll_inv, bl, x, order)
    for kernel, plain, mag in uses:
        got, want = kernel(), plain()
        err = _err_by_magnitude(got, want, mag)
        assert err <= 1e-5, err
        assert torch.equal(got, kernel())
    if case == "none_opt":
        assert not bool(uses[0][0]().any())


def _pcg_args(cuda, p):
    """One LM step's solve inputs (lambda 1e-3) on the plain blocks."""
    return ba.pcg_args(p, ba.assemble_obs_plain(p, p.R, p.t, p.X),
                       torch.tensor(1e-3, device=cuda), ba.obs_order(p))


@pytest.mark.parametrize("case", PCG_CASES)
def test_pcg_solve_matches_plain(cuda, case):
    """K14's whole solve (one cooperative launch) against the plain CG loop
    on the same inputs; nothing optimized gives exact zeros."""
    args = _pcg_args(cuda, _pcg_problem(cuda, case))
    n0 = ba.PCG_LAUNCHES["kernel"]
    got = ba.pcg_solve(*args, 40)
    assert ba.PCG_LAUNCHES["kernel"] == n0 + 1
    want = ba.pcg_solve_plain(*args, 40)
    for a, b in zip(got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert _rel(a, b) <= testing.PCG_TOL, _rel(a, b)
    if case == "none_opt":
        assert not bool(got[0].any()) and not bool(got[1].any())


@pytest.mark.parametrize("case", PCG_CASES)
@pytest.mark.parametrize("cg_iters", [0, 1, 2])
def test_pcg_solve_first_iterations_match_plain(cuda, case, cg_iters):
    """K14's solve after 0, 1 and 2 CG iterations, before CG has
    converged onto the same answer whatever its alpha, beta and
    preconditioner: within rounding of the plain CG loop."""
    args = _pcg_args(cuda, _pcg_problem(cuda, case))
    got = ba.pcg_solve(*args, cg_iters)
    want = ba.pcg_solve_plain(*args, cg_iters)
    for a, b in zip(got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert _rel(a, b) <= testing.PCG_TOL_FIRST, _rel(a, b)
    if cg_iters == 0:
        assert not bool(got[0].any())


@pytest.mark.parametrize("case", ["odd", "empty_kf", "large"])
@pytest.mark.parametrize("cg_iters", [0, 1, 40])
def test_pcg_solve_same_bits_at_any_grid(cuda, case, cg_iters):
    """The solve's dot products reduce per-keyframe partials in one fixed
    order, never per block: the same bits on two launches and at grids of
    the co-resident maximum, 1 and 7 blocks."""
    args = _pcg_args(cuda, _pcg_problem(cuda, case))
    got = ba.pcg_solve(*args, cg_iters)
    for grid in (0, 1, 7):
        again = ba._pcg_launch(*args, cg_iters, grid=grid)
        for a, b in zip(got, again):
            assert torch.equal(a, b), grid


def test_ba_solve_pcg_kernels_match_plain(cuda, monkeypatch):
    """The PCG LM loop over K4 (per-observation) and K14's solve against the
    loop over their plain versions: the same accepts, costs within 1e-3
    relative; one solve launch an LM step."""
    p = _ba_problem(cuda, 8, 600, 300, seed=7, dup=0.0)
    dR = lie.so3_exp(torch.tensor([0.01, -0.01, 0.005], device=cuda))
    p = p._replace(R=dR @ p.R, t=p.t + 0.02)
    n0 = dict(ba.PCG_LAUNCHES), dict(ba.SCHUR_LAUNCHES)
    got = ba.ba_solve_pcg(p, n_iters=4, cg_iters=40)
    assert ba.PCG_LAUNCHES == {"kernel": n0[0]["kernel"] + 4,
                               "plain": n0[0]["plain"]}
    assert ba.SCHUR_LAUNCHES == n0[1]
    monkeypatch.setattr(ba, "assemble", lambda p_, R, t, X, order=None,
                        body=False, per_obs=False:
                        ba.assemble_obs_plain(p_, R, t, X))
    monkeypatch.setattr(ba, "pcg_solve", ba.pcg_solve_plain)
    want = ba.ba_solve_pcg(p, n_iters=4, cg_iters=40)
    assert ba.PCG_LAUNCHES["kernel"] == n0[0]["kernel"] + 4
    assert torch.equal(got[3]["accepted"], want[3]["accepted"])
    assert _rel(got[3]["costs"], want[3]["costs"]) <= 1e-3


def test_k14_refuses_bad_inputs_on_the_card(cuda):
    p = _pcg_problem(cuda, "odd")
    order = ba.obs_order(p)
    ob = ba.assemble_obs_plain(p, p.R, p.t, p.X)
    Hi = torch.eye(3, device=cuda).expand(p.X.shape[0], 3, 3)
    x = torch.zeros(p.R.shape[0], 6, device=cuda)
    with pytest.raises(ValueError):
        ba.schur_lm_pass(p, ob.Wpl.double(), x, Hi, order)
    with pytest.raises(ValueError):
        ba.schur_lm_pass(p, ob.Wpl, x[:, :3], Hi, order)
    with pytest.raises(ValueError):
        ba.schur_lm_pass(p, ob.Wpl, x, Hi, None)
    with pytest.raises(ValueError):
        ba.schur_kf_pass(p, ob.Wpl, torch.zeros(p.X.shape[0], 3,
                                                device=cuda), order)
    args = list(_pcg_args(cuda, p))
    before = dict(ba.PCG_LAUNCHES)
    for i, bad in ((1, args[1].double()), (3, args[3][:, :5]),
                   (5, args[5].cpu()), (6, args[6][:-1]), (7, None),
                   (0, p._replace(obs_kf=p.obs_kf.long()))):
        with pytest.raises(ValueError):
            ba.pcg_solve(*args[:i], bad, *args[i + 1:], 40)
    with pytest.raises(ValueError):
        ba.pcg_solve(*args, -1)
    with pytest.raises(RuntimeError):      # more blocks than fit at once
        ba._pcg_launch(*args, 40, grid=10 ** 6)
    assert ba.PCG_LAUNCHES == before


# ---------------------------------------------------------------------------
# K11 preintegrate
# ---------------------------------------------------------------------------

def _calib(cuda):
    return imu.make_calib(np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5,
                          3e-3, 200.0, device=cuda)


def _imu_batch(cuda, n, n_valid, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=cuda)
    acc = rng.normal(0, 1.5, (n, 3)) + [0, 0, 9.81]
    gyr = rng.normal(0, 0.5, (n, 3))
    dts = np.where(np.arange(n) < n_valid, 0.005, 0.0)
    return (f(acc), f(gyr), f(dts), torch.arange(n, device=cuda) < n_valid,
            f(rng.normal(0, 0.01, 6)))


def _pre_close(got, want):
    for name in ("dR", "dV", "dP", "J_Rg", "J_Vg", "J_Va", "J_Pg", "J_Pa",
                 "avg_a", "avg_w", "bias", "dt"):
        a, b = getattr(got, name), getattr(want, name)
        assert torch.allclose(a, b, atol=1e-5), (name, a, b)
    scale = max(float(want.C.abs().max()), 1e-30)
    assert float((got.C - want.C).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("n,n_valid", [(64, 0), (64, 1), (64, 10), (64, 64),
                                       (768, 512)])
def test_preintegrate_matches_plain(cuda, n, n_valid):
    acc, gyr, dts, mask, bias = _imu_batch(cuda, n, n_valid, seed=n_valid)
    calib = _calib(cuda)
    got = imu.preintegrate(acc, gyr, dts, mask, bias, calib)
    want = imu.preintegrate_plain(acc, gyr, dts, mask, bias, calib)
    _pre_close(got, want)
    # continued by a second frame batch
    acc2, gyr2, dts2, mask2, _ = _imu_batch(cuda, 64, 9, seed=n + 1)
    _pre_close(imu.preintegrate(acc2, gyr2, dts2, mask2, bias, calib,
                                init=got),
               imu.preintegrate_plain(acc2, gyr2, dts2, mask2, bias, calib,
                                      init=want))


@pytest.mark.parametrize("n,n_valid", [(64, 10), (768, 512), (96, 33)])
def test_preintegrate_repeats_and_passes_init_through(cuda, n, n_valid):
    """Two launches give the same bits; a previous result's packed buffer
    passed through as `init` gives the bits of a packed copy of it."""
    acc, gyr, dts, mask, bias = _imu_batch(cuda, n, n_valid, seed=3)
    calib = _calib(cuda)
    got = imu.preintegrate(acc, gyr, dts, mask, bias, calib)
    assert torch.equal(imu.pack(got),
                       imu.pack(imu.preintegrate(acc, gyr, dts, mask, bias,
                                                 calib)))
    assert imu.packed_buffer(got) is not None
    copy = imu.Preintegrated(*(t.clone() for t in got))
    assert imu.packed_buffer(copy) is None
    acc2, gyr2, dts2, mask2, _ = _imu_batch(cuda, 64, 9, seed=4)
    a = imu.preintegrate(acc2, gyr2, dts2, mask2, bias, calib, init=got)
    b = imu.preintegrate(acc2, gyr2, dts2, mask2, bias, calib, init=copy)
    assert torch.equal(imu.pack(a), imu.pack(b))


def test_preintegrate_all_padding_is_identity(cuda):
    acc, gyr, dts, mask, bias = _imu_batch(cuda, 64, 0)
    got = imu.preintegrate(acc, gyr, dts, mask, bias, _calib(cuda))
    assert float(got.dt) == 0.0
    assert torch.equal(got.dR, torch.eye(3, device=cuda))
    assert not bool(got.C.any())


# ---------------------------------------------------------------------------
# K12 optimize_pose_inertial
# ---------------------------------------------------------------------------

def _pose_inertial_problem(cuda, n, stereo_share, seed=0, edge_dt=0.05):
    """The current frame perturbed from a constant-velocity truth, the
    anchor keyframe edge_dt earlier, its preintegration from noiseless
    samples, n visual rows (10% outliers)."""
    R0, t0, X, uv, info, valid, ur = _pose_problem(
        cuda, n, stereo_share=stereo_share, seed=seed)
    calib = _calib(cuda)
    m = max(int(round(edge_dt / 0.005)), 1)
    acc = torch.tensor([[0.0, 0.0, 9.81]], device=cuda).expand(m, 3)
    pre = imu.preintegrate_plain(acc.contiguous(),
                                 torch.zeros((m, 3), device=cuda),
                                 torch.full((m,), edge_dt / m, device=cuda),
                                 torch.ones(m, dtype=torch.bool,
                                            device=cuda),
                                 torch.zeros(6, device=cuda), calib)
    v = torch.tensor([0.3, 0.0, 0.1], device=cuda)
    R_a = torch.eye(3, device=cuda)
    p_a = -v * pre.dt
    eye9 = torch.eye(9, device=cuda)
    info9 = vi_ba.floor_info(torch.linalg.inv(pre.C[:9, :9] + 1e-9 * eye9))
    rw = 1.0 / torch.clamp(torch.diagonal(pre.C[9:, 9:]), min=1e-12)
    if ur is None:
        ur = torch.full((n,), float("nan"), device=cuda)
    z6 = torch.zeros(6, device=cuda)
    return (R0, t0, v + 0.1, z6, X, uv, info, valid, ur,
            torch.tensor(0.11, device=cuda), R_a, p_a, v, z6, pre.dt, pre.dR,
            pre.dV, pre.dP, pre.J_Rg, pre.J_Vg, pre.J_Va, pre.J_Pg, pre.J_Pa,
            info9, pre.bias, rw)


@pytest.mark.parametrize("n,stereo_share,edge_dt", [
    (1200, 0.6, 0.05), (1200, 0.0, 0.05), (300, 0.3, 0.005), (0, 0.0, 0.05),
    (1, 0.0, 0.05), (20, 0.0, 0.05), (20, 0.6, 0.05), (4096, 0.0, 0.05),
    (4096, 0.6, 0.05)])
def test_pose_inertial_matches_plain(cuda, n, stereo_share, edge_dt):
    args = _pose_inertial_problem(cuda, n, stereo_share, seed=n,
                                  edge_dt=edge_dt)
    got = vi_ba.optimize_pose_inertial(*args, n_iters=6)
    want = vi_ba.optimize_pose_inertial_plain(*args, n_iters=6)
    assert torch.allclose(got.R_cw, want.R_cw, atol=1e-5), (got.R_cw,
                                                             want.R_cw)
    assert torch.allclose(got.t_cw, want.t_cw, atol=1e-5), (got.t_cw,
                                                             want.t_cw)
    assert torch.allclose(got.v, want.v, atol=1e-4)
    assert torch.allclose(got.bias, want.bias, atol=1e-4)
    assert int(got.n_inliers) == int(want.n_inliers) == \
        int(got.inliers.sum())
    assert bool(torch.isfinite(got.H_marg).all())
    assert got.H_marg.shape == want.H_marg.shape == (15, 15)
    scale = float(want.H_marg.abs().max())
    assert float((got.H_marg - want.H_marg).abs().max()) <= 1e-4 * scale


def test_k4_k11_k12_refuse_bad_inputs_on_the_card(cuda):
    p = _ba_problem(cuda, 3, 40, 30)
    with pytest.raises(ValueError):
        ba.assemble(p._replace(obs_kf=p.obs_kf.long()), p.R, p.t, p.X)
    with pytest.raises(ValueError):
        ba.assemble(p, p.R.double(), p.t, p.X)
    acc, gyr, dts, mask, bias = _imu_batch(cuda, 8, 8)
    with pytest.raises(ValueError):
        imu.preintegrate(acc, gyr, dts, mask.to(torch.uint8), bias,
                         _calib(cuda))
    with pytest.raises(ValueError):
        imu.preintegrate(acc[:, :2], gyr, dts, mask, bias, _calib(cuda))
    args = list(_pose_inertial_problem(cuda, 20, 0.0))
    with pytest.raises(ValueError):
        vi_ba.optimize_pose_inertial(*args[:4], args[4].double(), *args[5:])
    with pytest.raises(ValueError):
        vi_ba.optimize_pose_inertial(*args[:23], args[23][:8], *args[24:])


# ---------------------------------------------------------------------------
# K13 vi_edges, K15 pose_graph
# ---------------------------------------------------------------------------

def _vi_window(dev, W, seed=0, skip=None, invalid=(), prior=1.0,
               noise=None, neg_prev=False):
    """A W-slot inertial window (no visual rows): random body states, a
    chain of edges (slot 0 and the `invalid` slots without one, slot `skip`
    chained to skip - 2), preintegration constants of plausible size and
    information near the floor_info scale (1e4-1e8); K4-shaped visual pose
    blocks Hpp (W, 6, 6) at the 1e5 scale and bp. With `neg_prev`, e_prev
    is -1 where there is no edge (as the map leaves it) and slot 0 holds a
    valid edge with e_prev -1 (clamped to 0: an edge from slot 0 to
    itself). With `noise`, the preintegrations are those of the states
    (zero residual at bias0) and the states are then perturbed by
    `noise`."""
    from morb_slam_tpu_torch.optim import vi_ba as v
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, sc=1.0):
        return (torch.randn(*shape, generator=g) * sc).to(dev)
    prev = torch.arange(W) - 1
    valid = prev >= 0
    if skip is not None:
        prev[skip] = skip - 2
    for k in invalid:
        valid[k] = False
    prev = torch.where(valid, prev, torch.full_like(prev, -1) if neg_prev
                       else torch.zeros_like(prev))
    if neg_prev:
        valid[0] = True
    A = rn(W, 9, 9)
    info = v.floor_info(A @ A.transpose(1, 2) * 1e6 +
                        1e4 * torch.eye(9, device=dev))
    f = torch.zeros(0, dtype=torch.float32, device=dev)
    i32 = torch.zeros(0, dtype=torch.int32, device=dev)
    p = v.VIBAProblem(
        R_wb=lie.so3_exp(rn(W, 3, sc=0.5)), p_wb=rn(W, 3), v=rn(W, 3),
        bias=rn(W, 6, sc=0.01),
        fix_pose=torch.arange(W, device=dev) == 0,
        fix_vb=torch.zeros(W, dtype=torch.bool, device=dev),
        X=torch.zeros((1, 3), device=dev),
        lm_opt=torch.zeros(1, dtype=torch.bool, device=dev), obs_kf=i32,
        obs_lm=i32, obs_uv=f.reshape(0, 2), obs_ur=f, obs_info=f,
        obs_mask=torch.zeros(0, dtype=torch.bool, device=dev),
        baseline=torch.tensor(0.0, device=dev), e_valid=valid.to(dev),
        e_prev=prev.to(torch.int32).to(dev),
        e_dt=(0.1 + 0.4 * torch.rand(W, generator=g)).to(dev),
        e_dR=lie.so3_exp(rn(W, 3, sc=0.1)), e_dV=rn(W, 3), e_dP=rn(W, 3),
        e_JRg=rn(W, 3, 3, sc=0.1), e_JVg=rn(W, 3, 3, sc=0.1),
        e_JVa=rn(W, 3, 3, sc=0.1), e_JPg=rn(W, 3, 3, sc=0.1),
        e_JPa=rn(W, 3, 3, sc=0.1), e_info=info, e_bias0=rn(W, 6, sc=0.01),
        e_rw_info=(1e6 * (1 + torch.rand(W, 6, generator=g))).to(dev),
        prior_bias_info=torch.full((W, 6), float(prior), device=dev))
    if noise is not None:
        pv = p.e_prev.long()
        Ri, dt = p.R_wb[pv], p.e_dt[:, None]
        gv = torch.tensor([0.0, 0.0, -9.81], device=dev)
        RiT = Ri.transpose(1, 2)
        p = p._replace(
            e_dR=lie.matmat(RiT, p.R_wb), e_bias0=p.bias[pv],
            e_dV=lie.matvec(RiT, p.v - p.v[pv] - gv * dt),
            e_dP=lie.matvec(RiT, p.p_wb - p.p_wb[pv] - p.v[pv] * dt
                            - 0.5 * gv * dt * dt),
            R_wb=lie.matmat(p.R_wb, lie.so3_exp(rn(W, 3, sc=noise))),
            p_wb=p.p_wb + rn(W, 3, sc=noise), v=p.v + rn(W, 3, sc=noise))
    B = rn(W, 6, 6)
    Hpp = 1e5 * (B @ B.transpose(1, 2) + torch.eye(6, device=dev))
    return p, Hpp, rn(W, 6, sc=1e3)


def _scaled_errs(H, b, H0, b0):
    """Jacobi-scaled gaps: max |dH_ij| / sqrt(H_ii H_jj) and max |db_i| /
    sqrt(H_ii) over max |b_i| / sqrt(H_ii), with the reference's diagonal
    (entries whose diagonal is 0 must match exactly)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H0), min=0.0))
    zero = d == 0
    ds = torch.where(zero, torch.ones_like(d), d)
    eH = ((H - H0).abs() / ds[:, None] / ds[None, :]).max()
    bs = b0 / ds
    eb = ((b - b0).abs() / ds).max() / bs.abs().max().clamp(min=1e-30)
    assert bool(((H - H0)[zero].abs() == 0).all())
    return float(eH), float(eb)


@pytest.mark.parametrize("W,skip,invalid,prior,neg_prev", [
    (14, None, (), 1.0, False), (14, 6, (9,), 1e4, False),
    (32, 5, (3, 17, 31), 1.0, False), (32, None, (), 0.0, False),
    (1, None, (), 1.0, False), (2, None, (), 1.0, False),
    (2, None, (), 1.0, True), (14, 6, (4, 9), 1.0, True),
    (32, None, (8,), 1.0, True), (1, None, (), 1.0, True)])
def test_vi_edges_match_plain_and_repeat(cuda, W, skip, invalid, prior,
                                         neg_prev):
    """inertial_terms (H, b and the cost in one call) against the plain
    composition, and two calls bitwise equal; every block of H that no
    valid edge links exactly zero."""
    p, Hpp, bp = _vi_window(cuda, W, seed=W, skip=skip, invalid=invalid,
                            prior=prior, neg_prev=neg_prev)
    st = (p.R_wb, p.p_wb, p.v, p.bias)
    before = dict(vi_ba.INERTIAL_LAUNCHES)
    H, b, c = vi_ba.inertial_terms(p, *st, Hpp, bp)
    H2, b2, c2 = vi_ba.inertial_terms(p, *st, Hpp, bp)
    assert vi_ba.INERTIAL_LAUNCHES["kernel"] - before["kernel"] == 2
    H0, b0, c0 = vi_ba.inertial_terms_plain(p, *st, Hpp, bp)
    assert torch.equal(H, H2) and torch.equal(b, b2) and torch.equal(c, c2)
    eH, eb = _scaled_errs(H, b, H0, b0)
    assert eH < 1e-5 and eb < 1e-5, (eH, eb)
    assert abs(float(c) - float(c0)) <= 1e-5 * abs(float(c0)), (c, c0)
    # a 15 x 15 block that no valid edge links (off the diagonal) is zero
    prev = p.e_prev.clamp(min=0).long()
    live = torch.eye(W, dtype=torch.bool, device=cuda)
    live[prev[p.e_valid], torch.arange(W, device=cuda)[p.e_valid]] = True
    live = live | live.T
    dead = ~live.repeat_interleave(15, 0).repeat_interleave(15, 1)
    assert bool((H[dead] == 0).all()) and bool((H0[dead] == 0).all())


def test_vi_ba_lm_step_kernel_matches_plain(cuda, monkeypatch):
    """One LM step of vi_ba_solve over K13 against the step over its plain
    version (K4 in both) on a consistent window perturbed by 0.01, with
    visual rows of the unperturbed states: the stepped states within 1e-4,
    the solve's first cost within 1e-5 and its first iteration's within
    1e-4 relative; the 6-iteration solves end within 2% of each other's
    cost, at the pixel-noise floor. (A state 1e-4 away moves this cost by
    ~0.5% through the 4,200 visual rows at information 1e5, so later
    iterations' accept decisions, and their costs, part between any two
    float32 roundings: on an H100 the two solves' costs were 7946.23 /
    7946.16 after one iteration, 2624.1 / 2607.3 after two, 2423.6 /
    2444.1 at the end.)"""
    from morb_slam_tpu_torch.optim import ba as ba_mod
    W, L = 14, 300
    p0, _, _ = _vi_window(cuda, W, seed=3, skip=7, invalid=(11,), noise=0.0)
    p, _, _ = _vi_window(cuda, W, seed=3, skip=7, invalid=(11,), noise=0.01)
    g = torch.Generator().manual_seed(5)
    R_cw, t_cw = lie.se3_inv(p0.R_wb, p0.p_wb)
    Xc = torch.rand(L, 3, generator=g).to(cuda) * torch.tensor(
        [4.0, 3.0, 6.0], device=cuda) + torch.tensor([-2.0, -1.5, 3.0],
                                                     device=cuda)
    X = lie.se3_apply(p0.R_wb[0], p0.p_wb[0], Xc)
    kf = torch.arange(W, device=cuda).repeat_interleave(L)
    lm = torch.arange(L, device=cuda).repeat(W)
    Xk = lie.se3_apply(R_cw[kf], t_cw[kf], X[lm])
    uv = Xk[:, :2] / Xk[:, 2:3]
    p = p._replace(X=X, lm_opt=torch.ones(L, dtype=torch.bool, device=cuda),
                   obs_kf=kf.to(torch.int32), obs_lm=lm.to(torch.int32),
                   obs_uv=uv + 0.002 * torch.randn(uv.shape, generator=g)
                   .to(cuda), obs_ur=torch.full((W * L,), float("nan"),
                                                device=cuda),
                   obs_info=torch.full((W * L,), 1e5, device=cuda),
                   obs_mask=Xk[:, 2] > 0.5)
    bap = vi_ba._ba_problem(p)
    R_cw, t_cw = lie.se3_inv(p.R_wb, p.p_wb)
    vis = ba_mod.assemble(bap, R_cw, t_cw, p.X, ba_mod.obs_order(bap),
                          body=True)
    lam = torch.tensor(1e-3, device=cuda)
    st = (p.R_wb, p.p_wb, p.v, p.bias, p.X)
    H, b, _ = vi_ba.inertial_terms(p, *st[:4], vis.Hpp, vis.bp)
    Hc, bc = H.clone(), b.clone()
    step = vi_ba._lm_step(p, *st, lam, vis, H, b)
    assert torch.equal(H, Hc) and torch.equal(b, bc)
    before = vi_ba.INERTIAL_LAUNCHES["kernel"]
    got = vi_ba.vi_ba_solve(p, n_iters=6)
    assert vi_ba.INERTIAL_LAUNCHES["kernel"] - before == 7
    monkeypatch.setattr(vi_ba, "inertial_terms", vi_ba.inertial_terms_plain)
    H0, b0, _ = vi_ba.inertial_terms_plain(p, *st[:4], vis.Hpp, vis.bp)
    step0 = vi_ba._lm_step(p, *st, lam, vis, H0, b0)
    want = vi_ba.vi_ba_solve(p, n_iters=6)
    for a, b_ in zip(step, step0):
        assert torch.allclose(a, b_, atol=1e-4), (a - b_).abs().max()
    costs = (got[5]["costs"], want[5]["costs"])
    assert torch.allclose(got[5]["cost0"], want[5]["cost0"], rtol=1e-5)
    assert torch.allclose(costs[0][0], costs[1][0], rtol=1e-4), costs
    assert torch.allclose(costs[0][-1], costs[1][-1], rtol=2e-2), costs


def _graph(dev, K, n_valid, seed=0, zero_share=0.5):
    """A pose graph of K nodes (n_valid on a drifting path, the rest
    identity padding): the chain, random covisibility edges (zero_share of
    them at weight 0, as the essential graph's masked slots), a loop edge of
    weight 20 with a drifted measurement, node 0 fixed; an edge from a node
    to itself has weight 0, as in the essential graph."""
    from morb_slam_tpu_torch.optim import pose_graph as pg
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, sc=1.0):
        return torch.randn(*shape, generator=g) * sc
    s = torch.ones(K)
    R = torch.eye(3).repeat(K, 1, 1)
    t = torch.zeros(K, 3)
    R[:n_valid] = lie.so3_exp(rn(n_valid, 3, sc=0.6))
    t[:n_valid] = rn(n_valid, 3, sc=2.0)
    s[:n_valid] = torch.exp(rn(n_valid, sc=0.05))
    ar = torch.arange(K)
    ei = [ar, torch.randint(0, K, (K * 4,), generator=g),
          torch.tensor([n_valid - 1])]
    ej = [torch.clamp(ar - 1, min=0), torch.randint(0, K, (K * 4,),
                                                    generator=g),
          torch.tensor([0])]
    w = [((ar < n_valid) & (ar > 0)).float(),
         (torch.rand(K * 4, generator=g) > zero_share).float() * 0.5,
         torch.tensor([20.0])]
    ei, ej, w = torch.cat(ei), torch.cat(ej), torch.cat(w)
    w = torch.where(ei == ej, torch.zeros_like(w), w)     # no self-loops
    sij, Rij, tij = pg.relative_sim3(s[ei], R[ei], t[ei], s[ej], R[ej],
                                     t[ej])
    drift = lie.so3_exp(rn(ei.shape[0], 3, sc=0.02))
    Rij = lie.matmat(drift, Rij)
    tij = tij + rn(ei.shape[0], 3, sc=0.05)
    return pg.PoseGraph(
        s=s.to(dev), R=R.to(dev), t=t.to(dev),
        edge_i=ei.to(torch.int32).to(dev), edge_j=ej.to(torch.int32).to(dev),
        edge_s=sij.to(dev), edge_R=Rij.to(dev), edge_t=tij.to(dev),
        edge_w=w.to(dev), fixed=(ar == 0).to(dev))


@pytest.mark.parametrize("K,n_valid,four_dof", [
    (40, 40, False), (40, 40, True), (512, 34, True), (512, 120, False),
    (3, 1, False)])
def test_pose_graph_normal_equations_match_plain(cuda, K, n_valid, four_dof):
    from morb_slam_tpu_torch.optim import pose_graph as pg
    g = _graph(cuda, K, n_valid, seed=K + n_valid)
    H, b, c = pg.normal_equations(g, g.s, g.R, g.t, four_dof)
    H2, b2, c2 = pg.normal_equations(g, g.s, g.R, g.t, four_dof,
                                     pg.block_order(g))
    H0, b0, c0 = pg.normal_equations_plain(g, g.s, g.R, g.t, four_dof)
    assert torch.equal(H, H2) and torch.equal(b, b2) and torch.equal(c, c2)
    eH, eb = _scaled_errs(H, b, H0, b0)
    assert eH < 1e-5 and eb < 1e-5, (eH, eb)
    assert abs(float(c) - float(c0)) <= 1e-5 * abs(float(c0)), (c, c0)


@pytest.mark.parametrize("four_dof", [False, True])
def test_pose_graph_optimize_kernel_matches_plain(cuda, monkeypatch,
                                                  four_dof):
    from morb_slam_tpu_torch.optim import pose_graph as pg
    g = _graph(cuda, 64, 48, seed=11)
    before = dict(pg.LAUNCHES)
    got = pg.optimize(g, n_iters=8, four_dof=four_dof)
    assert pg.LAUNCHES["kernel"] - before["kernel"] == 8
    assert pg.LAUNCHES["plain"] == before["plain"]
    monkeypatch.setattr(pg, "normal_equations",
                        lambda g, s, R, t, f, order=None:
                        pg.normal_equations_plain(g, s, R, t, f))
    want = pg.optimize(g, n_iters=8, four_dof=four_dof)
    for a, b_ in zip(got[:3], want[:3]):
        assert torch.allclose(a, b_, atol=1e-4), (a - b_).abs().max()
    assert torch.allclose(got[3], want[3], rtol=1e-3)


def test_k13_k15_refuse_bad_inputs_on_the_card(cuda):
    from morb_slam_tpu_torch.optim import pose_graph as pg
    before = (dict(vi_ba.INERTIAL_LAUNCHES), dict(pg.LAUNCHES))
    p, Hpp, bp = _vi_window(cuda, 6)
    st = (p.R_wb, p.p_wb, p.v, p.bias)
    with pytest.raises(ValueError):
        vi_ba.inertial_terms(p, p.R_wb.double(), *st[1:], Hpp, bp)
    with pytest.raises(ValueError):
        vi_ba.inertial_terms(p, *st, Hpp[:, :5], bp)
    with pytest.raises(ValueError):
        vi_ba.inertial_terms(p._replace(e_valid=p.e_valid.int()), *st,
                             Hpp, bp)
    with pytest.raises(ValueError):
        vi_ba.inertial_terms(p._replace(e_info=p.e_info[:, :8]), *st, Hpp,
                             bp, system=False)
    g = _graph(cuda, 8, 8)
    with pytest.raises(ValueError):
        pg.normal_equations(g._replace(edge_i=g.edge_i.long()), g.s, g.R,
                            g.t)
    with pytest.raises(ValueError):
        pg.normal_equations(g, g.s, g.R.double(), g.t)
    assert (vi_ba.INERTIAL_LAUNCHES, pg.LAUNCHES) == before


@pytest.mark.parametrize("shape,n_levels", [((480, 752), 8), ((288, 384), 4),
                                            ((131, 97), 5), ((7, 5), 2),
                                            ((1, 1), 1)])
def test_k6_pyramid_and_blur(cuda, shape, n_levels):
    rng = np.random.default_rng(sum(shape))
    img = image.gaussian_blur_plain(torch.from_numpy(
        rng.integers(0, 256, shape).astype(np.float32))).to(cuda)
    before = dict(image.LAUNCHES)
    got = image.build_pyramid(img, n_levels, 1.2)
    blurred = image.blur_levels(got)
    assert image.LAUNCHES["kernel"] == before["kernel"] + n_levels
    assert image.LAUNCHES["plain"] == before["plain"]
    want = image.build_pyramid_plain(img, n_levels, 1.2)
    assert torch.equal(got[0], img)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        assert float((g - w).abs().max()) < 1e-3
    for b, g in zip(blurred, got):
        assert torch.equal(b, image.gaussian_blur_plain(g))
    # bitwise repeatable
    again = image.build_pyramid(img, n_levels, 1.2)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


K6_FUSED = [((480, 752), 8), ((480, 640), 8), ((512, 512), 8),
            ((131, 97), 1), ((131, 97), 4), ((131, 97), 8), ((7, 5), 2)]


@pytest.mark.parametrize("shape,n_levels", K6_FUSED)
def test_k6_one_launch_bitwise_equal_per_level_path(cuda, shape, n_levels):
    """pyramid_blur: one launch an image, its levels and blurred levels
    consecutive contiguous views of one buffer each, bitwise equal to the
    per-level chain (build_pyramid) and to blur_levels, and the blur
    bitwise equal to the plain blur of its own levels."""
    rng = np.random.default_rng(sum(shape) + n_levels)
    img = image.gaussian_blur_plain(torch.from_numpy(
        rng.integers(0, 256, shape).astype(np.float32))).to(cuda)
    before = dict(image.LAUNCHES)
    levels, blurred = image.pyramid_blur(img, n_levels, 1.2)
    assert image.LAUNCHES == {"kernel": before["kernel"] + 1,
                              "plain": before["plain"]}
    assert len(levels) == len(blurred) == n_levels
    for views in (levels, blurred):
        at = views[0].data_ptr()
        for v in views:
            assert v.is_contiguous() and v.data_ptr() == at
            at += 4 * v.numel()
    per = image.build_pyramid(img, n_levels, 1.2)
    per_blur = image.blur_levels(per)
    for a, b in zip(levels, per):
        assert a.shape == b.shape and torch.equal(a, b)
    for a, b in zip(blurred, per_blur):
        assert torch.equal(a, b)
    for a, l in zip(blurred, levels):
        assert torch.equal(a, image.gaussian_blur_plain(l))
    for a, b in zip(levels, image.build_pyramid_plain(img, n_levels, 1.2)):
        assert float((a - b).abs().max()) < 1e-3
    again = image.pyramid_blur(img, n_levels, 1.2)
    assert all(torch.equal(a, b) for a, b in zip(again[0] + again[1],
                                                  levels + blurred))


def test_k6_one_launch_refuses_bad_inputs(cuda):
    before = dict(image.LAUNCHES)
    for img, n in ((torch.zeros((8, 8), dtype=torch.float64, device=cuda), 2),
                   (torch.zeros((2, 8, 8), device=cuda), 2),
                   (torch.zeros((64, 64), device=cuda), 17),
                   (torch.zeros((64, 64), device=cuda), 0),
                   (torch.zeros((64, 64), dtype=torch.uint8, device=cuda), 3)):
        with pytest.raises(ValueError):
            image.pyramid_blur(img, n, 1.2)
    assert image.LAUNCHES == before


def test_k6_blur_refuses_unpacked_levels(cuda):
    """blur_levels takes only consecutive contiguous views of one buffer;
    gaussian_blur blurs a strided view as its contiguous copy."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0, 255, (40, 70)).astype(
        np.float32)).to(cuda)
    b = torch.from_numpy(rng.uniform(0, 255, (33, 64)).astype(
        np.float32)).to(cuda)[:, ::2]
    before = dict(image.LAUNCHES)
    for levels in ([a, b.contiguous()], [b]):
        with pytest.raises(ValueError):
            image.blur_levels(levels)
    assert image.LAUNCHES == before
    assert torch.equal(image.gaussian_blur(b),
                       image.gaussian_blur_plain(b.contiguous()))


def test_k6_refuses_bad_inputs(cuda):
    before = dict(image.LAUNCHES)
    with pytest.raises(ValueError):
        image.build_pyramid(torch.zeros((8, 8), dtype=torch.float64,
                                        device=cuda), 2, 1.2)
    with pytest.raises(ValueError):
        image.build_pyramid(torch.zeros((2, 8, 8), device=cuda), 2, 1.2)
    with pytest.raises(ValueError):
        image.build_pyramid(torch.zeros((64, 64), device=cuda), 17, 1.2)
    with pytest.raises(ValueError):
        image.blur_levels([torch.zeros((8, 8), dtype=torch.int32,
                                       device=cuda)])
    assert image.LAUNCHES == before


def test_k6_extract_orb_agrees_with_plain(cuda, monkeypatch):
    """extract_orb on a 480x752 frame with the K6 kernel and with the plain
    K6 forced: >= 99% of the (yx, octave) slots and >= 99.9% of their
    descriptor bits agree."""
    rng = np.random.default_rng(11)
    img = image.gaussian_blur_plain(torch.from_numpy(
        _image((480, 752), "noise")))
    img = image.gaussian_blur_plain(img) + torch.from_numpy(
        rng.normal(0, 4, (480, 752)).astype(np.float32))
    img = img.to(cuda)
    cfg = frontend.OrbConfig(n_features=1200, n_levels=8)
    got = frontend.extract_orb(img, cfg)
    monkeypatch.setattr(image, "pyramid_blur", testing.plain_pyramid_blur)
    want = frontend.extract_orb(img, cfg)
    same = (got.uv == want.uv).all(-1) & (got.octave == want.octave) & \
        (got.valid == want.valid)
    assert float(same.float().mean()) >= 0.99
    ok = same & want.valid
    assert int(ok.sum()) > 600
    bits = orb_descriptor.unpack_bits(got.desc[ok]) != \
        orb_descriptor.unpack_bits(want.desc[ok])
    assert float(bits.float().mean()) <= 1e-3


# ---------------------------------------------------------------------------
# K16 (stereo_general), K17 (inertial_init), K18 (sim3_verify)
# ---------------------------------------------------------------------------

def _rig_features(dev, n, seed=0, kind=1, n_valid=None, dup=0):
    """Two feature sets of a two-camera rig (0.10 m baseline, 1 degree
    about y): n points 0.5-6 m ahead projected into both cameras with
    0.3 px noise, descriptors with 0-12 flipped bits between the views,
    octaves 0-3, every fifth right feature a stranger; `dup` repeats the
    first right descriptor (ties), `n_valid` flags only the first ones."""
    from morb_slam_tpu_torch import cameras, frontend as fe
    rng = np.random.default_rng(seed)
    if kind == 1:
        cam_l = cameras.kannala_brandt8(190.978, 190.973, 254.932, 256.897,
                                        0.00348238, 0.000715034,
                                        -0.00205323, 0.000202936)
        cam_r = cameras.kannala_brandt8(190.442, 190.437, 252.597, 254.917,
                                        0.00340372, 0.000714185,
                                        -0.00201631, 0.000193335)
    else:
        cam_l = cameras.pinhole(300.0, 300.0, 192.0, 144.0,
                                (-0.2, 0.05, 1e-3, -1e-3))
        cam_r = cameras.pinhole(301.0, 300.5, 193.0, 143.0,
                                (-0.21, 0.05, 1e-3, -1e-3))
    a = np.deg2rad(1.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    t = -R @ np.array([0.10, 0.0, 0.0])
    d = rng.uniform(0.5, 6.0, n)
    ang = rng.uniform(-0.9, 0.9, (n, 2)) * (1.0 if kind == 1 else 0.45)
    X = np.stack([np.tan(ang[:, 0]), np.tan(ang[:, 1]), np.ones(n)], -1) * \
        d[:, None]
    Xr = X @ R.T + t
    f32 = lambda v: torch.tensor(np.asarray(v), dtype=torch.float32)
    uv_l = cameras.project_distorted(cam_l, f32(X)) + f32(
        rng.normal(0, 0.3, (n, 2)))
    uv_r = cameras.project_distorted(cam_r, f32(Xr)) + f32(
        rng.normal(0, 0.3, (n, 2)))
    perm = rng.permutation(n)
    uv_r = uv_r[perm]
    words = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64)
    flips = np.zeros((n, 256), np.uint8)
    for i in range(n):
        flips[i, rng.choice(256, rng.integers(0, 13), replace=False)] = 1
    fw = np.packbits(flips, axis=1, bitorder="little").view(np.uint32)
    desc_l = words.astype(np.uint32)
    desc_r = (desc_l ^ fw)[perm]
    desc_r[::5] = rng.integers(0, 2 ** 32, desc_r[::5].shape,
                               dtype=np.uint64).astype(np.uint32)
    if dup:
        desc_r[1:1 + dup] = desc_r[0]
        desc_l[1:1 + dup] = desc_l[0]
    oct_l = rng.integers(0, 4, n).astype(np.int32)
    oct_r = np.clip(oct_l[perm] + rng.integers(-1, 2, n), 0, 3).astype(
        np.int32)
    valid = np.arange(n) < (n if n_valid is None else n_valid)

    def feats(uv, desc, octv):
        return fe.Features(
            uv=uv.to(dev), response=torch.zeros(n, device=dev),
            angle=torch.zeros(n, device=dev),
            octave=torch.tensor(octv, device=dev),
            size=torch.zeros(n, device=dev),
            desc=torch.tensor(desc.view(np.int32), device=dev),
            valid=torch.tensor(valid, device=dev))
    fl, fr = feats(uv_l, desc_l, oct_l), feats(uv_r, desc_r, oct_r)
    cam_l, cam_r = cam_l.to(dev), cam_r.to(dev)
    return (fl, fr, cameras.unproject_bearing(cam_l, fl.uv),
            cameras.unproject_bearing(cam_r, fr.uv), fl.uv, fr.uv, cam_l,
            cam_r, f32(R).to(dev), f32(t).to(dev),
            (1.2 ** (2.0 * fl.octave.float())))


def _k16_agree(args):
    """K16 against its plain version on the same tensors: the match and
    valid flags equal outside the rows `general_margins` names, depth within
    1e-4 relative, u_right exact. Returns (rows exempted, matches)."""
    got, gi = stereo.match_stereo_general(*args)
    want, wi = stereo.match_stereo_general_plain(*args)
    exempt = testing.general_margins(*args, gi, wi)
    same = (gi == wi) & (got.valid == want.valid)
    assert bool((same | exempt).all()), int((~same & ~exempt).sum())
    both = got.valid & want.valid
    rel = (got.depth - want.depth).abs() / want.depth.abs().clamp(min=1e-6)
    assert float(rel[both].max()) <= 1e-4 if bool(both.any()) else True
    assert torch.equal(got.u_right[both], want.u_right[both])
    assert bool((got.depth[~got.valid] == -1).all())
    return int(exempt.sum()), int((wi >= 0).sum())


@pytest.mark.parametrize("n,kind,n_valid,dup", [
    (1200, 1, None, 0), (1200, 1, 700, 0), (333, 0, None, 0),
    (64, 1, None, 40), (1, 1, None, 0), (1200, 1, 0, 0)])
def test_stereo_general_matches_plain(cuda, n, kind, n_valid, dup):
    args = _rig_features(cuda, n, seed=n, kind=kind, n_valid=n_valid,
                         dup=dup)
    n0 = stereo.GENERAL_LAUNCHES["kernel"]
    exempt, matched = _k16_agree(args)
    assert stereo.GENERAL_LAUNCHES["kernel"] == n0 + 1
    assert exempt <= max(2, 0.01 * n)
    if n == 1200 and n_valid is None:
        assert matched > 500


def test_stereo_general_ties_and_all_big_rows(cuda):
    """With t_rl = 0 (E = 0: every pair passes the epipolar gate) and one
    octave, 41 identical left and 41 identical right descriptors tie in
    both searches: the first column and the first row win, as argmin; an
    invalid left feature's row and an invalid right feature's column are
    all BIG (index 0). The matches equal the plain version's; the result
    repeats bitwise."""
    args = list(_rig_features(cuda, 64, seed=2, dup=40))
    fl, fr = args[0], args[1]
    zero = torch.zeros_like(fl.octave)
    args[0] = fl._replace(octave=zero, valid=fl.valid & (
        torch.arange(64, device=cuda) != 5))
    args[1] = fr._replace(octave=zero, valid=fr.valid & (
        torch.arange(64, device=cuda) != 0))
    args[9] = torch.zeros_like(args[9])
    got, gi = stereo.match_stereo_general(*args)
    _, wi = stereo.match_stereo_general_plain(*args)
    assert torch.equal(gi, wi)
    assert int(gi[5]) == -1 and int((gi[1:41] >= 0).sum()) == 0
    again, ai = stereo.match_stereo_general(*args)
    assert torch.equal(ai, gi) and torch.equal(again.valid, got.valid)
    assert torch.equal(again.depth, got.depth)
    assert torch.equal(again.u_right, got.u_right)


def test_stereo_general_repeats_and_empty_left(cuda):
    args = _rig_features(cuda, 400, seed=3)
    a, ai = stereo.match_stereo_general(*args)
    b, bi = stereo.match_stereo_general(*args)
    assert torch.equal(ai, bi) and torch.equal(a.depth, b.depth)
    fl, fr = args[0], args[1]
    fl0 = fl._replace(**{k: getattr(fl, k)[:0] for k in fl._fields})
    e, ei = stereo.match_stereo_general(fl0, fr, args[2][:0], *args[3:4],
                                        args[4][:0], *args[5:10],
                                        args[10][:0])
    assert e.depth.shape == (0,) and ei.shape == (0,)


def _by_magnitude(got, want, mag):
    return float(((got - want).abs() / mag.clamp(min=1e-30)).max())


# keyframe chains in slots: in order; slot 3 recycled for the newest
# keyframe (its edge from slot 12, slot 4's from slot 2); and a fork, slot
# 3 the predecessor of two edges (4 and 5, whose own edge from 4 is
# dropped), with slot 0's edge live from itself (prev -1 reads as slot 0)
_RECYCLED = [0, 1, 2] + list(range(4, 13)) + [3]


@pytest.mark.parametrize("K,n_kf,opt_scale,layout", [
    (256, 13, True, None), (256, 13, False, None), (4, 4, True, None),
    (40, 2, True, None), (256, 10, True, None), (256, 13, True, "recycled"),
    (256, 13, True, "fork")])
def test_inertial_init_system_matches_plain(cuda, K, n_kf, opt_scale,
                                            layout):
    from morb_slam_tpu_torch.optim import inertial
    ki, R_wb, p_wb, kf_valid = testing.init_store(
        cuda, K, n_kf, slots=_RECYCLED if layout == "recycled" else None)
    if layout == "fork":
        prev = ki.prev.clone()
        prev[5] = 3
        valid = ki.valid.clone()
        valid[0] = True
        ki = ki._replace(prev=prev, valid=valid)
    rng = np.random.default_rng(K)
    p = inertial.init_problem(ki, R_wb, p_wb, kf_valid, opt_scale,
                              1e2, 1e6, torch.eye(3, device=cuda))
    x = torch.tensor(rng.normal(0, 0.05, 9 + 3 * K), dtype=torch.float32,
                     device=cuda)
    x[2] = float(np.log(2.3))
    n0 = inertial.INIT_LAUNCHES["kernel"]
    H, g, c = inertial.inertial_system(p, x)
    H2, g2, c2 = inertial.inertial_system(p, x)
    assert inertial.INIT_LAUNCHES["kernel"] == n0 + 2
    H0, g0, c0 = inertial.inertial_system_plain(p, x)
    Ha, ga, ca = testing.inertial_system_magnitudes(p, x)
    assert torch.equal(H, H2) and torch.equal(g, g2) and torch.equal(c, c2)
    # nothing outside the live edges' blocks
    assert torch.equal(H[Ha == 0], torch.zeros_like(H[Ha == 0]))
    assert _by_magnitude(H, H0, Ha) <= 1e-4
    assert _by_magnitude(g, g0, ga) <= 1e-4
    assert abs(float(c - c0)) <= 1e-4 * float(ca)


def test_inertial_only_optimize_kernel_matches_plain(cuda):
    from morb_slam_tpu_torch.optim import inertial
    ki, R_wb, p_wb, kf_valid = testing.init_store(cuda)
    s, g_vis, v0, _ = inertial.linear_alignment(ki, R_wb, p_wb, kf_valid)
    kw = dict(n_iters=25, prior_gyro=1e2, prior_acc=1e6, s0=float(s),
              v0=v0, R_wg0=inertial.gravity_rotation(g_vis))
    n0 = dict(inertial.INIT_LAUNCHES)
    got = inertial.inertial_only_optimize(ki, R_wb, p_wb, kf_valid, **kw)
    assert inertial.INIT_LAUNCHES["kernel"] == n0["kernel"] + 26
    assert inertial.INIT_LAUNCHES["plain"] == n0["plain"]
    cpu = lambda t: t.cpu() if torch.is_tensor(t) else t   # noqa: E731
    want = inertial.inertial_only_optimize(
        inertial.KfImu(*(t.cpu() for t in ki)), R_wb.cpu(), p_wb.cpu(),
        kf_valid.cpu(), **{k: cpu(v) for k, v in kw.items()})
    _init_outputs_agree(got, want)


def _init_outputs_agree(got, want):
    """R_wg and s within 1e-4; biases and velocities within 1e-3 of each
    one's largest magnitude (25 float32 steps under a 1e6 prior)."""
    for name, a, b in zip(("R_wg", "s", "bg", "ba", "v"), got, want):
        a, b = a.cpu(), b.cpu()
        tol = 1e-4 if name in ("R_wg", "s") else \
            1e-3 * max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) <= tol * (
            float(b.abs()) if name == "s" else 1.0), (name, a, b)


def _verify_problem(dev, F=1200, seed=0, n_in=500, n_out=150):
    """Two keyframes' inputs to K18: n_in candidate landmarks seen by both
    (the Sim(3) (s, R, t) maps candidate camera points to the keyframe's),
    n_out outliers with random descriptors, 0.002 of normalized noise; the
    initial guess perturbed by ~1% in scale, 0.01 rad and 2 cm."""
    from scipy.spatial.transform import Rotation as Rot
    rng = np.random.default_rng(seed)
    s, R = 1.15, Rot.from_rotvec([0.05, -0.3, 0.02]).as_matrix()
    t = np.array([0.4, -0.05, 0.2])
    X2 = rng.uniform([-3, -2, 2], [3, 2, 8], (F, 3))
    X1 = s * X2 @ R.T + t
    xn1 = X1[:, :2] / X1[:, 2:] + rng.normal(0, 0.002, (F, 2))
    xn2 = X2[:, :2] / X2[:, 2:] + rng.normal(0, 0.002, (F, 2))
    perm = rng.permutation(F)
    words = rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint64).astype(
        np.uint32)
    d1 = words.copy()
    d1[n_in:n_in + n_out] = rng.integers(0, 2 ** 32, (n_out, 8),
                                         dtype=np.uint64).astype(np.uint32)
    flips = np.zeros((F, 256), np.uint8)
    for i in range(F):
        flips[i, rng.choice(256, rng.integers(0, 20), replace=False)] = 1
    d1 ^= np.packbits(flips, axis=1, bitorder="little").view(np.uint32)
    inv = np.argsort(perm)
    f = lambda v, dt=torch.float32: torch.tensor(np.asarray(v), dtype=dt,
                                                 device=dev)
    s0 = s * 1.01
    R0 = R @ Rot.from_rotvec([0.01, 0.0, -0.005]).as_matrix()
    t0 = t + [0.02, -0.01, 0.015]
    return dict(X2c=f(X2), ok2=f(np.arange(F) < n_in + n_out, torch.bool),
                oct2=f(rng.integers(0, 4, F), torch.int32),
                desc2=f(words.view(np.int32), torch.int32),
                xn1=f(xn1[perm]), valid1=f(rng.uniform(size=F) < 0.97,
                                           torch.bool),
                desc1=f(d1[perm].view(np.int32), torch.int32),
                X1c=f(X1[perm] + rng.normal(0, 0.01, (F, 3))),
                xn2=f(xn2), inv=inv, s0=f(s0), R0=f(R0), t0=f(t0))


def _refine_inputs(P, idx):
    j = torch.clamp(idx, min=0).long()
    pair_ok = (idx >= 0) & P["ok2"]
    info = torch.full_like(P["xn2"][:, 0], 300.0 ** 2) / \
        1.44 ** P["oct2"].float()
    return (P["X2c"], P["X1c"][j], P["xn1"][j], P["xn2"], info, pair_ok,
            pair_ok & (torch.arange(idx.shape[0], device=idx.device) % 7 > 0),
            P["s0"], P["R0"], P["t0"])


@pytest.mark.parametrize("F,n_in,n_out,seed", [(1200, 500, 150, 0),
                                               (1200, 0, 0, 1),
                                               (257, 200, 40, 2),
                                               (1, 1, 0, 3)])
def test_sim3_verify_matches_plain(cuda, F, n_in, n_out, seed):
    from morb_slam_tpu_torch.pipeline import loop_closing as lc
    P = _verify_problem(cuda, F, seed, n_in, n_out)
    wargs = (P["X2c"], P["ok2"], P["oct2"], P["desc2"], P["xn1"],
             P["valid1"], P["desc1"], P["s0"], P["R0"], P["t0"], 300.0, 1.2)
    n0 = (lc.WINDOW_LAUNCHES["kernel"], lc.REFINE_LAUNCHES["kernel"])
    idx = lc.window_match(*wargs)
    want = lc.window_match_plain(*wargs)
    assert torch.equal(idx, want), int((idx != want).sum())
    if n_in >= 200:
        assert int((idx >= 0).sum()) > 0.8 * n_in
    rargs = _refine_inputs(P, idx)
    got = lc.sim3_refine(*rargs)
    got2 = lc.sim3_refine(*rargs)
    ref = lc.sim3_refine_plain(*rargs)
    assert (lc.WINDOW_LAUNCHES["kernel"], lc.REFINE_LAUNCHES["kernel"]) == \
        (n0[0] + 1, n0[1] + 2)
    # bitwise, NaN included (one pair leaves 3 of the 7 directions to the
    # 1e-4 damping alone: no solution to compare there)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, got2))
    if 0 < n_in < 3:
        return
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a, b), float((a - b).abs().max())
    assert int(got[3]) == int(ref[3])


def _same_bits(a, b):
    """Bitwise equal, NaN where NaN (its payload aside)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na].view(torch.int32),
                                               b[~nb].view(torch.int32))


@pytest.mark.parametrize("case", ["n1", "n300", "inactive", "backward_only",
                                  "F2000"])
def test_sim3_refine_cluster_matches_plain(cuda, case):
    """K18's refinement (a cluster of 8 blocks) against the plain version's
    order, which is the earlier one-block kernel's: (s, R, t) bitwise,
    the same n_good, bitwise repeatable, on one pair, a count that is no
    multiple of the 128 slots, no active pair, backward residuals alone
    and 2,000 features."""
    from morb_slam_tpu_torch.pipeline import loop_closing as lc
    F = dict(n1=1, n300=300, F2000=2000).get(case, 1200)
    P = _verify_problem(cuda, F, 4, max(1, (2 * F) // 5), F // 10)
    idx = lc.window_match_plain(
        P["X2c"], P["ok2"], P["oct2"], P["desc2"], P["xn1"], P["valid1"],
        P["desc1"], P["s0"], P["R0"], P["t0"], 300.0, 1.2)
    if case == "n1":
        idx = torch.zeros(1, dtype=torch.int32, device=cuda)
    r = list(_refine_inputs(P, idx))
    if case == "inactive":
        r[5] = torch.zeros_like(r[5])
        r[6] = torch.zeros_like(r[6])
    elif case == "backward_only":
        r[5] = torch.zeros_like(r[5])
    n0 = lc.REFINE_LAUNCHES["kernel"]
    got, got2 = lc.sim3_refine(*r), lc.sim3_refine(*r)
    want = lc.sim3_refine_plain(*r)
    assert lc.REFINE_LAUNCHES["kernel"] == n0 + 2
    for a, b, c in zip(got[:3], got2[:3], want[:3]):
        assert _same_bits(a, b)
        assert _same_bits(a, c), (case, float((a - c).abs().max()))
    assert int(got[3]) == int(got2[3]) == int(want[3])
    if case in ("inactive", "backward_only"):
        assert int(got[3]) == 0
    if case == "inactive":
        assert torch.equal(got[0], P["s0"]) and torch.equal(got[1], P["R0"])
    if case == "F2000":
        assert int(got[3]) > 0.5 * int(r[5].sum())


def test_k16_k17_k18_refuse_bad_inputs_on_the_card(cuda):
    from morb_slam_tpu_torch.optim import inertial
    from morb_slam_tpu_torch.pipeline import loop_closing as lc
    before = (dict(stereo.GENERAL_LAUNCHES), dict(inertial.INIT_LAUNCHES),
              dict(lc.WINDOW_LAUNCHES), dict(lc.REFINE_LAUNCHES))
    args = list(_rig_features(cuda, 50))
    with pytest.raises(ValueError):
        stereo.match_stereo_general(*args[:2], args[2].double(), *args[3:])
    with pytest.raises(ValueError):
        stereo.match_stereo_general(*args[:10], args[10][:7])
    ki, R_wb, p_wb, kf_valid = testing.init_store(cuda, 8, 4)
    p = inertial.init_problem(ki, R_wb, p_wb, kf_valid)
    with pytest.raises(ValueError):
        inertial.inertial_system(p, torch.zeros(9 + 3 * 7, device=cuda))
    with pytest.raises(ValueError):
        inertial.inertial_system(p._replace(cst=p.cst[:, :100]),
                                 torch.zeros(9 + 3 * 8, device=cuda))
    P = _verify_problem(cuda, 64, 0, 30, 5)
    with pytest.raises(ValueError):
        lc.window_match(P["X2c"].double(), P["ok2"], P["oct2"], P["desc2"],
                        P["xn1"], P["valid1"], P["desc1"], P["s0"], P["R0"],
                        P["t0"], 300.0, 1.2)
    r = list(_refine_inputs(P, torch.zeros(64, dtype=torch.int32,
                                           device=cuda)))
    r[4] = r[4][:10]
    with pytest.raises(ValueError):
        lc.sim3_refine(*r)
    assert (stereo.GENERAL_LAUNCHES, inertial.INIT_LAUNCHES,
            lc.WINDOW_LAUNCHES, lc.REFINE_LAUNCHES) == before


@pytest.mark.parametrize("n,m", [(4096, 1200), (1000, 777), (65, 1)])
def test_hamming_mxu_matches_plain(cuda, n, m):
    """K19 bitwise equal to its plain version and to hamming_matrix, at the
    main path's 4096x1200 and at sizes that are no multiple of its 64 x 64
    tile, with near-duplicate and identical descriptors among them."""
    g = torch.Generator(device=cuda).manual_seed(n + m)
    a, b = (torch.randint(-2 ** 31, 2 ** 31 - 1, (k, 8), generator=g,
                          device=cuda, dtype=torch.int64).to(torch.int32)
            for k in (n, m))
    k = min(n, m) // 2
    a[:k] = b[:k] ^ (1 << torch.randint(0, 31, (k, 8), generator=g,
                                        device=cuda, dtype=torch.int32))
    a[-1] = b[0]
    before = dict(hamming.MXU_LAUNCHES)
    got = hamming.hamming_matrix_mxu(a, b)
    assert hamming.MXU_LAUNCHES["kernel"] == before["kernel"] + 1
    assert got.dtype == torch.int32 and got.shape == (n, m)
    assert torch.equal(got, hamming.hamming_matrix_mxu_plain(a, b))
    assert torch.equal(got, hamming.hamming_matrix(a, b))
    assert int(got[-1, 0]) == 0
    # a view 4 bytes off the 16-byte alignment: the wrapper copies it
    v = a.view(-1)[1:1 + 8 * (n - 1)].view(n - 1, 8)
    assert torch.equal(hamming.hamming_matrix_mxu(v, b),
                       hamming.hamming_matrix_mxu_plain(v, b))
    assert hamming.hamming_matrix_mxu(a[:0], b).shape == (0, m)


def test_hamming_mxu_refuses_bad_inputs_on_the_card(cuda):
    d = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    before = dict(hamming.MXU_LAUNCHES)
    for a, b in ((d.long(), d), (d, d[:, :4]), (d, d.cpu())):
        with pytest.raises(ValueError):
            hamming.hamming_matrix_mxu(a, b)
    assert hamming.MXU_LAUNCHES == before


def test_ba_solve_pcg_sharded_one_nccl_rank(cuda):
    """The observation-sharded PCG on one nccl rank (global_obs_mesh's
    one-rank group) against the single-device PCG over K14's solve: one LM
    step within testing.PCG_TOL of the step's max-abs (K14's solve against
    its plain loop), four steps' costs within 1e-3 relative; K4's
    per-observation mode and K14's passes launched, no plain version."""
    import torch.distributed as dist
    from morb_slam_tpu_torch.parallel import distributed, sharded_ba
    p = _ba_problem(cuda, 8, 600, 300, seed=7, dup=0.0)
    dR = lie.so3_exp(torch.tensor([0.01, -0.01, 0.005], device=cuda))
    p = p._replace(R=dR @ p.R, t=p.t + 0.02)
    want = [ba.ba_solve_pcg(p, n_iters=n, cg_iters=40) for n in (1, 4)]
    mesh = distributed.global_obs_mesh()
    try:
        assert dist.get_backend() == "nccl" and mesh.size() == 1
        n0 = [dict(c) for c in (ba.OBS_LAUNCHES, ba.SCHUR_LAUNCHES,
                                ba.PCG_LAUNCHES)]
        got = [sharded_ba.ba_solve_pcg_sharded(
            sharded_ba.pad_problem_for_mesh(p, 1), mesh, n_iters=n,
            cg_iters=40) for n in (1, 4)]
        n1 = [dict(c) for c in (ba.OBS_LAUNCHES, ba.SCHUR_LAUNCHES,
                                ba.PCG_LAUNCHES)]
    finally:
        dist.destroy_process_group()
    assert n1[0]["kernel"] == n0[0]["kernel"] + 2 + 5
    assert n1[1]["kernel"] > n0[1]["kernel"] and n1[2] == n0[2]
    assert all(n1[i]["plain"] == n0[i]["plain"] for i in range(3))
    assert set(got[1][3]) == {"cost0", "costs", "lambda"}
    for a, b, s0 in zip(got[0][:3], want[0][:3], (p.R, p.t, p.X)):
        assert float((a - b).abs().max()) <= \
            testing.PCG_TOL * float((b - s0).abs().max())
    assert _rel(got[1][3]["costs"], want[1][3]["costs"]) <= 1e-3
    assert float(got[1][3]["costs"][-1]) < float(got[1][3]["cost0"])
