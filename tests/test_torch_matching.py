"""Parity of the PyTorch port's Hamming matching (ops/hamming.py, K3's plain
version) and the four matching.py searches with the JAX package, on fixed
descriptors and coordinates made from a seed: every output must be exact.

The descriptors and keypoints are ORB features of test_frontend's
synthetic image and of the same image shifted 8 px, so the searches find
real matches, plus random descriptor sets for the raw Hamming functions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu import lie as j_lie
from morb_slam_tpu import matching as j_match
from morb_slam_tpu.ops import hamming as j_ham
from morb_slam_tpu_torch import frontend as t_fe
from morb_slam_tpu_torch import matching as t_match
from morb_slam_tpu_torch.ops import hamming as t_ham

from test_frontend import synthetic_image

torch.set_num_threads(1)
SHIFT = 8
FX = 300.0


def _u32(a):
    return jnp.asarray(np.asarray(a, np.int32).view(np.uint32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def feats():
    base = synthetic_image(240, 320, seed=8)
    moved = np.roll(base, SHIFT, axis=1)
    cfg = t_fe.OrbConfig(n_features=500, n_levels=4)
    out = []
    for img in (base, moved):
        f = t_fe.extract_orb(torch.from_numpy(img.astype(np.float32)), cfg)
        out.append({k: v.numpy() for k, v in f._asdict().items()})
    return out


def _rand_desc(rng, n):
    return rng.integers(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64).astype(
        np.int32)


def test_hamming_matrix_exact():
    rng = np.random.default_rng(0)
    a, b = _rand_desc(rng, 133), _rand_desc(rng, 97)
    np.testing.assert_array_equal(t_ham.hamming_matrix(_t(a), _t(b)).numpy(),
                                  np.asarray(j_ham.hamming_matrix(_u32(a),
                                                                  _u32(b))))


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
def test_top2_and_hamming_top2_exact(density):
    rng = np.random.default_rng(1)
    a, b = _rand_desc(rng, 200), _rand_desc(rng, 150)
    mask = rng.random((200, 150)) < density
    d = jnp.where(jnp.asarray(mask), j_ham.hamming_matrix(_u32(a), _u32(b)),
                  1 << 20)
    ref = [np.asarray(x) for x in j_ham.top2_min(d)]
    got = t_ham.hamming_top2(_t(a), _t(b), _t(mask))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    got2 = t_ham.top2_min(_t(np.asarray(d)))
    for g, r in zip(got2, ref):
        np.testing.assert_array_equal(g.numpy(), r)


def _dense_top2(a, b, mask):
    """K3's plain function as first written: the whole distance matrix,
    BIG off the mask, then top2_min."""
    return t_ham.top2_min(torch.where(mask, t_ham.hamming_matrix(a, b),
                                      torch.tensor(t_ham.BIG)))


@pytest.mark.parametrize("n,m,density", [(300, 200, 0.0), (300, 200, 0.01),
                                         (300, 200, 0.06), (300, 200, 0.07),
                                         (300, 200, 0.3), (300, 200, 1.0),
                                         (40, 1, 0.5), (1, 40, 1.0)])
def test_hamming_top2_plain_equals_dense_composition(n, m, density):
    """hamming_top2_plain (the masked-in pairs alone at a sparse mask, the
    dense composition above a 16th) bitwise against the whole matrix's
    composition, on seeded masks on both sides of the threshold, with
    repeated descriptors for tied distances and rows with no pair."""
    rng = np.random.default_rng(n + m + int(1000 * density))
    a, b = _rand_desc(rng, n), _rand_desc(rng, m)
    a[n // 2:] = a[:n - n // 2]
    b[m // 2:] = b[:m - m // 2]
    a[::7] = b[0]
    mask = _t(rng.random((n, m)) < density)
    want = _dense_top2(_t(a), _t(b), mask)
    got = t_ham.hamming_top2_plain(_t(a), _t(b), mask)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    i, j = torch.nonzero(mask, as_tuple=True)
    for g, w in zip(t_ham._sparse_top2(_t(a), _t(b), i, j), want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("max_dist,ratio,cross", [(50, 1.0, True),
                                                  (100, 0.8, True),
                                                  (64, 0.9, False)])
def test_match_nn_exact(feats, max_dist, ratio, cross):
    fa, fb = feats
    cand = np.abs(fa["uv"][:, None, :] - fb["uv"][None, :, :]).max(-1) <= 40
    dist = jnp.where(jnp.asarray(cand), j_ham.hamming_matrix(
        _u32(fa["desc"]), _u32(fb["desc"])), 1 << 20)
    j_idx, j_best = j_ham.match_nn(dist, jnp.asarray(fa["valid"]),
                                   jnp.asarray(fb["valid"]), max_dist=max_dist,
                                   ratio=ratio, cross_check=cross)
    t_idx, t_best = t_ham.match_nn(_t(fa["desc"]), _t(fb["desc"]), _t(cand),
                                   _t(fa["valid"]), _t(fb["valid"]),
                                   max_dist=max_dist, ratio=ratio,
                                   cross_check=cross)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_best.numpy(), np.asarray(j_best))
    assert int((t_idx >= 0).sum()) > 50


def test_rotation_consistency_exact(feats):
    fa, fb = feats
    rng = np.random.default_rng(2)
    idx = np.where(rng.random(500) < 0.7, rng.integers(0, 500, 500),
                   -1).astype(np.int32)
    ang_b = (fb["angle"] + np.where(rng.random(500) < 0.2, 1.3, 0.0)
             ).astype(np.float32)
    j = j_ham.rotation_consistency_mask(jnp.asarray(fa["angle"]),
                                        jnp.asarray(ang_b), jnp.asarray(idx))
    t = t_ham.rotation_consistency_mask(_t(fa["angle"]), _t(ang_b), _t(idx))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_search_for_initialization_exact(feats):
    fa, fb = feats
    args = [fa["uv"], fa["desc"], fa["valid"], fa["angle"],
            fb["uv"], fb["desc"], fb["valid"], fb["angle"]]
    j = j_match.search_for_initialization(
        *[_u32(a) if a.dtype == np.int32 and a.ndim == 2 else jnp.asarray(a)
          for a in args])
    t = t_match.search_for_initialization(*[_t(a) for a in args])
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert int((t >= 0).sum()) > 100


def test_search_last_frame_exact(feats):
    fa, fb = feats
    rng = np.random.default_rng(3)
    last_lm = np.where(rng.random(500) < 0.8, np.arange(500), -1).astype(
        np.int32)
    proj = (fa["uv"] + np.array([SHIFT, 0.0]) + rng.normal(0, 0.7, (500, 2))
            ).astype(np.float32)
    proj[rng.random(500) < 0.05] = np.nan
    args = (fa["uv"], fa["desc"], last_lm, fa["valid"], fb["uv"],
            fb["octave"], fb["desc"], fb["valid"], proj, fa["octave"])
    kw = dict(radius_px=8.0, scale=1.2)
    j = j_match.search_last_frame(
        *[_u32(a) if a is fa["desc"] or a is fb["desc"] else jnp.asarray(a)
          for a in args], **kw, last_angle=jnp.asarray(fa["angle"]),
        cur_angle=jnp.asarray(fb["angle"]))
    t = t_match.search_last_frame(*[_t(a) for a in args], **kw,
                                  last_angle=_t(fa["angle"]),
                                  cur_angle=_t(fb["angle"]))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert int((t >= 0).sum()) > 100


@pytest.mark.parametrize("check_view_angle", [True, False])
def test_search_by_projection_exact(feats, check_view_angle):
    """Landmarks back-projected from the shifted frame's features at random
    depths, searched from a slightly perturbed pose."""
    _, fb = feats
    rng = np.random.default_rng(4)
    W, H = 320, 240
    xn = (fb["uv"] - np.array([W / 2, H / 2])) / FX
    depth = rng.uniform(3.0, 8.0, 500)
    X = np.concatenate([xn * depth[:, None], depth[:, None]], 1).astype(
        np.float32)
    normal = (X / np.linalg.norm(X, axis=1, keepdims=True)).astype(np.float32)
    dmax = (depth * 1.2 ** fb["octave"]).astype(np.float32)
    flips = rng.random((500, 8, 32)) < 0.03
    bits = (flips * (1 << np.arange(32))).sum(-1).astype(np.uint32)
    lm_desc = (fb["desc"].view(np.uint32) ^ bits).view(np.int32)
    lm_valid = fb["valid"] & (rng.random(500) < 0.9)
    R, tt = (np.asarray(v) for v in j_lie.se3_exp(
        jnp.asarray([0.01, -0.005, 0.02, 0.002, -0.003, 0.001], jnp.float32)))

    def proj_j(Xc):
        return jnp.stack([FX * Xc[:, 0] / Xc[:, 2] + W / 2,
                          FX * Xc[:, 1] / Xc[:, 2] + H / 2], -1)

    def proj_t(Xc):
        return torch.stack([FX * Xc[:, 0] / Xc[:, 2] + W / 2,
                            FX * Xc[:, 1] / Xc[:, 2] + H / 2], -1)
    kw = dict(radius_px=4.0, scale=1.2, n_levels=4,
              check_view_angle=check_view_angle)
    j = j_match.search_by_projection(
        jnp.asarray(X), jnp.asarray(normal), jnp.asarray(dmax),
        _u32(lm_desc), jnp.asarray(lm_valid), jnp.asarray(R), jnp.asarray(tt),
        proj_j, jnp.asarray(fb["uv"]), jnp.asarray(fb["octave"]),
        _u32(fb["desc"]), jnp.asarray(fb["valid"]), (W, H), **kw)
    t = t_match.search_by_projection(
        _t(X), _t(normal), _t(dmax), _t(lm_desc), _t(lm_valid), _t(R), _t(tt),
        proj_t, _t(fb["uv"]), _t(fb["octave"]), _t(fb["desc"]),
        _t(fb["valid"]), (W, H), **kw)
    np.testing.assert_array_equal(t.feat_lm.numpy(), np.asarray(j.feat_lm))
    assert int(t.n_matches) == int(j.n_matches) > 100


def test_search_for_triangulation_exact(feats):
    fa, fb = feats
    rng = np.random.default_rng(5)
    W, H = 320, 240
    x1 = ((fa["uv"] - np.array([W / 2, H / 2])) / FX).astype(np.float32)
    x2 = ((fb["uv"] - np.array([W / 2, H / 2])) / FX).astype(np.float32)
    t21 = np.array([-SHIFT / FX * 5.0, 0.0, 0.0], np.float32)
    E12 = np.asarray(j_lie.so3_hat(jnp.asarray(t21)))
    free1 = rng.random(500) < 0.8
    free2 = rng.random(500) < 0.8
    args = (x1, fa["desc"], fa["octave"], fa["valid"], free1,
            x2, fb["desc"], fb["octave"], fb["valid"], free2, E12)
    j = j_match.search_for_triangulation(
        *[_u32(a) if a is fa["desc"] or a is fb["desc"] else jnp.asarray(a)
          for a in args], FX, 1.2)
    t = t_match.search_for_triangulation(*[_t(a) for a in args], FX, 1.2)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert int((t >= 0).sum()) > 50


def test_resolve_conflicts_exact():
    rng = np.random.default_rng(6)
    best_feat = rng.integers(0, 40, 300).astype(np.int32)
    best_dist = rng.integers(0, 60, 300).astype(np.int32)
    ok = rng.random(300) < 0.6
    j = j_match._resolve_conflicts(jnp.asarray(best_feat),
                                   jnp.asarray(best_dist), jnp.asarray(ok), 50)
    t = t_match._resolve_conflicts(_t(best_feat), _t(best_dist), _t(ok), 50)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


GATE_MODES = ("window", "window_nan", "row_band")
N_LEVELS = 8


def _gate_case(mode, n=150, m=120, seed=9):
    """Per-row and per-column gate inputs of K3's gated mode, made from a
    seed: columns near the rows so many pairs pass, NaN and +-inf rows
    (one coordinate or both), a row far from every column, flags off, the
    predicted octave at 0 and at N_LEVELS - 1, and duplicated column
    descriptors, so best distances tie."""
    rng = np.random.default_rng(seed + GATE_MODES.index(mode))
    b = _rand_desc(rng, m)
    b[m // 2:] = b[:m - m // 2]                 # every column has a twin
    a = b[rng.integers(0, m, n)].copy()
    flips = rng.random((n, 8, 32)) < 0.04
    a = (a.view(np.uint32) ^ (flips * (1 << np.arange(32))).sum(-1).astype(
        np.uint32)).view(np.int32)
    col_uv = rng.uniform(0, 120, (m, 2)).astype(np.float32)
    row_uv = (col_uv[rng.integers(0, m, n)]
              + rng.normal(0, 3, (n, 2))).astype(np.float32)
    row_uv[:4] = [[np.nan, 5.0], [7.0, np.nan], [np.nan, np.nan],
                  [np.inf, 3.0]]
    row_uv[4:7] = [[-np.inf, 3.0], [3.0, np.inf], [np.inf, -np.inf]]
    row_uv[7] = [1e6, 1e6]                      # no candidate
    row_oct = rng.integers(0, N_LEVELS, n).astype(np.int32)
    row_oct[8:12] = [0, 0, N_LEVELS - 1, N_LEVELS - 1]
    col_oct = rng.integers(0, N_LEVELS, m).astype(np.int32)
    sf = (1.2 ** np.arange(N_LEVELS)).astype(np.float32)
    if mode == "row_band":
        row_uv[12:40, 1] = col_uv[:28, 1]       # on a column's row
        row_uv[12:40, 0] = col_uv[:28, 0] + rng.uniform(0, 30, 28)
        row_r = np.float32(2.0) * sf[row_oct]
    else:
        row_r = np.float32(4.0) * sf[row_oct]
    row_ok = rng.random(n) < 0.9
    col_ok = rng.random(m) < 0.9
    return dict(a=a, b=b, row_uv=row_uv, row_r=row_r.astype(np.float32),
                row_oct=row_oct, row_ok=row_ok, col_uv=col_uv,
                col_oct=col_oct, col_ok=col_ok, max_d=40.0)


def _old_gate(c, mode):
    """The dense gates the three searches built before K3's gated mode
    (matching.py's two windows, stereo.row_search's band), on torch."""
    g = {k: _t(v) for k, v in c.items() if k != "max_d"}
    if mode == "row_band":
        dy = torch.abs(g["row_uv"][:, 1:2] - g["col_uv"][None, :, 1])
        band = g["row_r"][:, None]
        disp = g["row_uv"][:, 0:1] - g["col_uv"][None, :, 0]
        oct_ok = torch.abs(g["row_oct"][:, None] - g["col_oct"][None, :]) <= 1
        return ((dy <= band) & (disp >= 0.0) & (disp <= c["max_d"]) & oct_ok
                & g["row_ok"][:, None] & g["col_ok"][None, :])
    d_uv = g["row_uv"][:, None, :] - g["col_uv"][None, :, :]
    if mode == "window_nan":
        close = torch.amax(torch.abs(torch.nan_to_num(d_uv, nan=1e9)),
                           dim=-1) <= g["row_r"][:, None]
    else:
        close = torch.amax(torch.abs(d_uv), dim=-1) <= g["row_r"][:, None]
    pred = g["row_oct"]
    oct_ok = (g["col_oct"][None, :] >= pred[:, None] - 1) & \
             (g["col_oct"][None, :] <= pred[:, None] + 1)
    return close & oct_ok & g["row_ok"][:, None] & g["col_ok"][None, :]


def _gated(c, mode):
    return t_ham.hamming_top2_gated(
        _t(c["a"]), _t(c["b"]), _t(c["row_uv"]), _t(c["row_r"]),
        _t(c["row_oct"]), _t(c["row_ok"]), _t(c["col_uv"]), _t(c["col_oct"]),
        _t(c["col_ok"]), mode, max_d=c["max_d"])


@pytest.mark.parametrize("mode", GATE_MODES)
def test_gated_plain_equals_old_gate_composition(mode):
    """K3's gated entry on the CPU equals the searches' earlier dense gate
    followed by hamming_top2_plain, bitwise, with rows that have no
    candidate, NaN / inf rows and tied distances among the cases."""
    c = _gate_case(mode)
    mask = _old_gate(c, mode)
    want = _dense_top2(_t(c["a"]), _t(c["b"]), mask)
    got = _gated(c, mode)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    n_cand = mask.sum(1)
    assert int((n_cand == 0).sum()) > 8 and int((n_cand >= 2).sum()) > 20
    assert not bool(mask[:7].any())             # NaN / inf rows never pass
    assert int((got[0] == got[2]).logical_and(n_cand >= 2).sum()) > 0


@pytest.mark.parametrize("mode", GATE_MODES)
def test_gated_matches_jax_gate(mode):
    """The JAX package's gate compositions (matching.py:97-98 and its
    search_last_frame, ops/stereo.py:53-59) with hamming_matrix and
    top2_min give the gated entry's best, index and second, bitwise."""
    c = _gate_case(mode)
    j = {k: jnp.asarray(v) for k, v in c.items() if k != "max_d"}
    if mode == "row_band":
        dy = jnp.abs(j["row_uv"][:, 1:2] - j["col_uv"][None, :, 1])
        disp = j["row_uv"][:, 0:2][:, 0:1] - j["col_uv"][None, :, 0]
        oct_ok = jnp.abs(j["row_oct"][:, None] - j["col_oct"][None, :]) <= 1
        cand = ((dy <= j["row_r"][:, None]) & (disp >= 0.0)
                & (disp <= c["max_d"]) & oct_ok & j["row_ok"][:, None]
                & j["col_ok"][None, :])
    else:
        d_uv = j["row_uv"][:, None, :] - j["col_uv"][None, :, :]
        if mode == "window_nan":
            d_uv = jnp.nan_to_num(d_uv, nan=1e9)
        close = jnp.max(jnp.abs(d_uv), axis=-1) <= j["row_r"][:, None]
        oct_ok = (j["col_oct"][None, :] >= j["row_oct"][:, None] - 1) & \
                 (j["col_oct"][None, :] <= j["row_oct"][:, None] + 1)
        cand = close & oct_ok & j["row_ok"][:, None] & j["col_ok"][None, :]
    d = jnp.where(cand, j_ham.hamming_matrix(_u32(c["a"]), _u32(c["b"])),
                  1 << 20)
    ref = [np.asarray(x) for x in j_ham.top2_min(d)]
    for g, r in zip(_gated(c, mode), ref):
        np.testing.assert_array_equal(g.numpy(), r)
