"""The CUDA kernels K1-K3, K5 and K7-K10 of the PyTorch port against their
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
queries; and every new wrapper refusing bad dtypes and shapes.

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
order), masked rows exactly -1.
"""
import math

import numpy as np
import pytest
import torch

from morb_slam_tpu_torch import frontend, lie
from morb_slam_tpu_torch.ops import (fast, hamming, image, orb_descriptor,
                                     rectify, stereo)
from morb_slam_tpu_torch.optim import pose_opt
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
