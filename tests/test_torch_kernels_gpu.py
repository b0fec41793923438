"""The CUDA kernels K1-K5 and K7-K15 of the PyTorch port against their
plain PyTorch versions on the card, on shapes and inputs the main path does
not reach: image sizes that are no multiple of the 16-px cell, flat images
where every key ties, empty keypoint and row sets, a single column, fully
masked rows, duplicated descriptors and unaligned views; stereo keypoints
on and beyond the image border, SAD ties and best offsets at both ends of
the sweep; remap coordinates exactly on the last row and column and just
outside; pose problems of 0, 1, 1200 and 16384 observations, all invalid,
partly behind the camera, mono and mixed stereo; vocabulary descents with
tied children, no valid descriptor and other branchings and depths; L1
scores over widths that are no multiple of 4, masked rows and batches of
queries; BA assemblies (K4) of an empty window, one observation, repeated
(landmark, keyframe) pairs and both tangent modes, bitwise repeatable,
and in its per-observation mode; the implicit Schur passes (K14) with
segment lengths that are no multiple of 32, landmarks and a keyframe with
no observation, every observation masked and nothing optimized, bitwise
repeatable, and the PCG LM loop over both kernels;
preintegrations (K11) of an all-padding batch, one sample, fresh and
continued frame batches and a keyframe buffer; inertial pose problems
(K12) with a near-identity edge, no visual rows and mixed stereo; the
inertial assembly of a VI-BA step (K13) over windows of 1, 14 and 32
slots with invalid slots, a chain that skips a slot and no bias prior,
and the LM loop over it; the pose-graph normal equations (K15) of graphs
with zero-weight edges, padding nodes and both parametrizations, and
the Gauss-Newton loop over them; and every new wrapper refusing bad
dtypes and shapes.

Marked `gpu`: each test skips without a CUDA card. On a machine with one
(and without JAX, so without tests/conftest.py):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: K1 and K3 exact; K2 angles within 1e-4 rad and descriptor bits
>= 99.9% identical (the kernel sums the moments in another order); K7 on
integer-valued images: best offset and SAD exact, refined x within 1e-5 px,
on non-integer images within 1e-3 px; K8 exact (same rounding, no FMA); K5
R and t within 1e-4 and the inlier count within 1% (the kernel sums the
normal equations in another order, so a row whose chi2 sits at its gate
may flip), chi2 as residual norms within 1e-6; K9 exact (integer work); K10 within 1e-5 (float sums in another
order), masked rows exactly -1; K4 blocks within 1e-4 of each block
tensor's max-abs and bit-identical across two launches, its LM loop with
the plain loop's accepts, R within 1e-5, t within 1e-4, the final cost
within 1e-3 relative and the landmarks within 1e-2 chi2 units; K11 dR, dV, dP and
the Jacobians within 1e-5, C within 1e-5 of its max-abs; K12 R and t
within 1e-5, v and bias within 1e-4, the same inlier count; K14 within
1e-5 of each output entry's term magnitude (the same sums over absolute
values: the back-substitution's bl - B^T x cancels, so the rounding of
its sums is bounded by the terms, not the result); K13 and K15 H within
1e-5 under Jacobi scaling (|dH_ij| / sqrt(H_ii H_jj)), b within 1e-5 of
its scaled max-abs, the cost within 1e-5 relative, both bitwise repeatable
(the plain K13 Jacobian carries some tangents in float64, the kernel's
dual numbers float32), their loops with states within 1e-4 and costs
within 1e-3 relative.
"""
import math

import numpy as np
import pytest
import torch

from morb_slam_tpu_torch import frontend, imu, lie
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


@pytest.mark.parametrize("rounds,iters", [(2, 8), (3, 10)])
@pytest.mark.parametrize("n,stereo_share", [(0, 0.0), (1200, 0.0),
                                            (1200, 0.6), (16384, 0.3)])
def test_pose_opt_matches_plain(cuda, n, stereo_share, rounds, iters):
    args = _pose_problem(cuda, n, stereo_share=stereo_share, seed=n)
    ur = args[6]
    kw = dict(obs_ur=ur, baseline=0.11 if ur is not None else 0.0,
              n_rounds=rounds, n_iters=iters)
    got = pose_opt.optimize_pose(*args[:6], **kw)
    want = pose_opt.optimize_pose_plain(*args[:6], **kw)
    _pose_check(got, want, int(args[5].sum()))
    if n > 0:   # it converged: most valid rows are inliers
        assert int(got.n_inliers) > 0.7 * int(args[5].sum())


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


@pytest.mark.parametrize("body", [False, True])
@pytest.mark.parametrize("K,L,per_kf", [(18, 6144, 1200), (3, 40, 30),
                                        (1, 1, 1), (4, 50, 0)])
def test_ba_assemble_matches_plain_and_repeats(cuda, K, L, per_kf, body):
    p = _ba_problem(cuda, K, L, per_kf, seed=K)
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


@pytest.mark.parametrize("case", PCG_CASES)
def test_ba_assemble_per_obs_matches_plain_and_repeats(cuda, case):
    p = _pcg_problem(cuda, case)
    order = ba.obs_order(p)
    got = ba.assemble(p, p.R, p.t, p.X, order, per_obs=True)
    want = ba.assemble_obs_plain(p, p.R, p.t, p.X)
    for name, a, b in zip(ba.ObsBlocks._fields, got, want):
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))
    assert not bool(got.Wpl[~p.obs_mask].any())
    again = ba.assemble(p, p.R, p.t, p.X, order, per_obs=True)
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


def test_ba_solve_pcg_kernels_match_plain(cuda, monkeypatch):
    """The PCG LM loop over K4 (per-observation) and K14 against the loop
    over their plain versions: the same accepts, costs within 1e-3
    relative."""
    p = _ba_problem(cuda, 8, 600, 300, seed=7, dup=0.0)
    dR = lie.so3_exp(torch.tensor([0.01, -0.01, 0.005], device=cuda))
    p = p._replace(R=dR @ p.R, t=p.t + 0.02)
    got = ba.ba_solve_pcg(p, n_iters=4, cg_iters=40)
    monkeypatch.setattr(ba, "assemble", lambda p_, R, t, X, order=None,
                        body=False, per_obs=False:
                        ba.assemble_obs_plain(p_, R, t, X))
    monkeypatch.setattr(ba, "schur_lm_pass", lambda p_, W, x, Hi, order=None,
                        c=None: ba.schur_lm_pass_plain(p_, W, x, Hi, c))
    monkeypatch.setattr(ba, "schur_kf_pass", lambda p_, W, y, order=None,
                        Hpp=None, x=None, a=None:
                        ba.schur_kf_pass_plain(p_, W, y, Hpp, x, a))
    want = ba.ba_solve_pcg(p, n_iters=4, cg_iters=40)
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
    (1, 0.0, 0.05)])
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
               noise=None):
    """A W-slot inertial window (no visual rows): random body states, a
    chain of edges (slot 0 and the `invalid` slots without one, slot `skip`
    chained to skip - 2), preintegration constants of plausible size and
    information near the floor_info scale (1e4-1e8); K4-shaped visual pose
    blocks Hpp (W, 6, 6) at the 1e5 scale and bp. With `noise`, the
    preintegrations are those of the states (zero residual at bias0) and
    the states are then perturbed by `noise`."""
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
    prev = torch.where(valid, prev, torch.zeros_like(prev))
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


@pytest.mark.parametrize("W,skip,invalid,prior", [
    (14, None, (), 1.0), (14, 6, (9,), 1e4), (32, 5, (3, 17, 31), 1.0),
    (32, None, (), 0.0), (1, None, (), 1.0)])
def test_vi_edges_match_plain_and_repeat(cuda, W, skip, invalid, prior):
    p, Hpp, bp = _vi_window(cuda, W, seed=W, skip=skip, invalid=invalid,
                            prior=prior)
    st = (p.R_wb, p.p_wb, p.v, p.bias)
    H, b = vi_ba.inertial_system(p, *st, Hpp, bp)
    H2, b2 = vi_ba.inertial_system(p, *st, Hpp, bp)
    H0, b0 = vi_ba.inertial_system_plain(p, *st, Hpp, bp)
    assert torch.equal(H, H2) and torch.equal(b, b2)
    eH, eb = _scaled_errs(H, b, H0, b0)
    assert eH < 1e-5 and eb < 1e-5, (eH, eb)
    c, c2 = vi_ba.inertial_cost(p, *st), vi_ba.inertial_cost(p, *st)
    c0 = vi_ba.inertial_cost_plain(p, *st)
    assert torch.equal(c, c2)
    assert abs(float(c) - float(c0)) <= 1e-5 * abs(float(c0)), (c, c0)


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
    step = vi_ba._lm_step(p, *st, lam, vis)
    got = vi_ba.vi_ba_solve(p, n_iters=6)
    monkeypatch.setattr(vi_ba, "inertial_system", vi_ba.inertial_system_plain)
    monkeypatch.setattr(vi_ba, "inertial_cost", vi_ba.inertial_cost_plain)
    step0 = vi_ba._lm_step(p, *st, lam, vis)
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
        vi_ba.inertial_system(p, p.R_wb.double(), *st[1:], Hpp, bp)
    with pytest.raises(ValueError):
        vi_ba.inertial_system(p, *st, Hpp[:, :5], bp)
    with pytest.raises(ValueError):
        vi_ba.inertial_cost(p._replace(e_valid=p.e_valid.int()), *st)
    with pytest.raises(ValueError):
        vi_ba.inertial_cost(p._replace(e_info=p.e_info[:, :8]), *st)
    g = _graph(cuda, 8, 8)
    with pytest.raises(ValueError):
        pg.normal_equations(g._replace(edge_i=g.edge_i.long()), g.s, g.R,
                            g.t)
    with pytest.raises(ValueError):
        pg.normal_equations(g, g.s, g.R.double(), g.t)
    assert (vi_ba.INERTIAL_LAUNCHES, pg.LAUNCHES) == before
