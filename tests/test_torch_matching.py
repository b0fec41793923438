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
