"""Parity of the PyTorch port's monocular initialization and local mapping
with the JAX package.

* `reconstruct_two_view` fed the JAX draw's RANSAC sample tables: the same
  chosen motion within 1e-4, the same `is_good`, points within 1e-3.
* `create_initial_map` on the same two frames, matches and motion.
* one `mapping_step` on a map captured from the JAX tracker right after
  initialization and carried across with `convert.map_from_numpy`: the
  landmark count identical, and each landmark (identified by the keyframe
  slots observing it, since near-tied triangulation scores may order the
  new landmarks' slots differently) within 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu import cameras as j_cam
from morb_slam_tpu.mapstate import state as j_ms
from morb_slam_tpu.pipeline import local_mapping as j_lm
from morb_slam_tpu.pipeline import tracking as j_tr
from morb_slam_tpu.solvers import ransac as j_ransac
from morb_slam_tpu.solvers import two_view as j_tv
from morb_slam_tpu_torch import cameras as t_cam
from morb_slam_tpu_torch import convert
from morb_slam_tpu_torch.mapstate import state as t_ms
from morb_slam_tpu_torch.pipeline import local_mapping as t_lm
from morb_slam_tpu_torch.pipeline import tracking as t_tr
from morb_slam_tpu_torch.solvers import two_view as t_tv

from synthetic_world import PlaneWorld, camera_path
from test_solvers import cam2_pose, make_scene, normalized_obs

torch.set_num_threads(1)
W, H, FX = 384, 288, 300.0


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed,planar,outliers", [(11, False, 0),
                                                  (12, True, 0),
                                                  (11, False, 30)])
def test_reconstruct_two_view_parity(seed, planar, outliers):
    """The DLT triangulation is solved by inverse iteration on a matrix that
    is singular by design; for a rare point float32 rounding decides
    whether it converges or collapses to the origin, differently in the two
    frameworks (the planar scene of seed 11 has one, so it uses seed 12)."""
    rng = np.random.default_rng(seed)
    n = 300
    X = make_scene(rng, n, planar=planar)
    R21, t21 = cam2_pose()
    noise = 0.5 / 460.0
    x1 = np.array(normalized_obs(rng, X, noise=noise))
    x2 = np.array(normalized_obs(rng, X, R21, t21, noise=noise))
    x2[:outliers] += rng.uniform(-0.05, 0.05, (outliers, 2))
    valid = rng.random(n) < 0.97
    key = jax.random.PRNGKey(3)
    ke, kh = jax.random.split(key)
    idx_E = np.asarray(j_ransac.sample_indices(ke, 200, 8, n,
                                               jnp.asarray(valid)))
    idx_H = np.asarray(j_ransac.sample_indices(kh, 200, 8, n,
                                               jnp.asarray(valid)))
    j = j_tv.reconstruct_two_view(key, jnp.asarray(x1), jnp.asarray(x2),
                                  jnp.asarray(valid), focal=460.0)
    t = t_tv.reconstruct_two_view(_t(x1), _t(x2), _t(valid), focal=460.0,
                                  samples=(_t(idx_E), _t(idx_H)))
    assert bool(t.used_h) == bool(j.used_h) == planar
    np.testing.assert_allclose(t.R21.numpy(), np.asarray(j.R21), atol=1e-4)
    np.testing.assert_allclose(t.t21.numpy(), np.asarray(j.t21), atol=1e-4)
    np.testing.assert_array_equal(t.is_good.numpy(), np.asarray(j.is_good))
    assert int(t.n_good) == int(j.n_good)
    g = np.asarray(j.is_good)
    np.testing.assert_allclose(t.points.numpy()[g], np.asarray(j.points)[g],
                               rtol=1e-3, atol=1e-3)
    assert abs(float(t.parallax_deg) - float(j.parallax_deg)) < 1e-3


@pytest.fixture(scope="module")
def jax_init():
    """The JAX tracker run until it initializes; returns the frames, the
    inputs it gave create_initial_map and the map it made."""
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    world = PlaneWorld(K, W, H, seed=0)
    poses = camera_path(6, step=0.05)
    cfg = j_tr.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                             max_kf=32, max_lm=6000, n_levels=4,
                             min_init_matches=60, min_init_points=40)
    tracker = j_tr.Tracker(j_cam.pinhole(FX, FX, W / 2, H / 2), cfg)
    rec = {}
    orig = j_tr.create_initial_map

    def capture(*args, **kw):
        out = orig(*args, **kw)
        rec["args"], rec["out"] = args, out
        return out
    j_tr.create_initial_map = capture
    try:
        for i, (R, t) in enumerate(poses):
            tracker.track_mono(world.render(R, t), ts=float(i))
            if tracker.state == "OK":
                break
    finally:
        j_tr.create_initial_map = orig
    assert "args" in rec
    return rec


def _t_cfg():
    return t_tr.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                              max_kf=32, max_lm=6000, n_levels=4,
                              min_init_matches=60, min_init_points=40)


def _landmarks(m):
    """{frozenset of (kf, slot) observations: position} of valid landmarks
    observed by valid keyframes."""
    fl, kv, lv, pos = (m["kf_feat_lm"], m["kf_valid"], m["lm_valid"],
                       m["lm_pos"])
    obs = {}
    for k, f in zip(*np.nonzero((fl >= 0) & kv[:, None])):
        obs.setdefault(int(fl[k, f]), set()).add((int(k), int(f)))
    return {frozenset(o): pos[l] for l, o in obs.items() if lv[l]}


def _compare_maps(t_map, j_map, tol=1e-3):
    t_np, j_np = convert.map_to_numpy(t_map), _np(j_map)
    assert int(t_np["lm_valid"].sum()) == int(j_np["lm_valid"].sum())
    np.testing.assert_array_equal(t_np["kf_valid"], j_np["kf_valid"])
    np.testing.assert_allclose(t_np["kf_R"], j_np["kf_R"], atol=tol)
    np.testing.assert_allclose(t_np["kf_t"], j_np["kf_t"], atol=tol)
    tl, jl = _landmarks(t_np), _landmarks(j_np)
    assert tl.keys() == jl.keys()
    for key, p in jl.items():
        np.testing.assert_allclose(tl[key], p, rtol=tol, atol=tol)


def test_create_initial_map_parity(jax_init):
    m, fr0, fr1, match01, R21, t21, pts, good, ts0, ts1 = jax_init["args"][:10]
    m_t, k1 = t_tr.create_initial_map(
        convert.map_from_numpy(_np(m)), convert.frame_from_numpy(_np(fr0)),
        convert.frame_from_numpy(_np(fr1)), _t(match01), _t(R21), _t(t21),
        _t(pts), _t(good), float(ts0), float(ts1), _t_cfg())
    m_j, k1_j = jax_init["out"]
    assert k1 == int(k1_j)
    _compare_maps(m_t, m_j)
    np.testing.assert_array_equal(convert.map_to_numpy(m_t)["kf_feat_lm"],
                                  np.asarray(m_j.kf_feat_lm))


def test_mapping_step_parity(jax_init):
    """mapping_step for the second initial keyframe (triangulation against
    the first, fusion, culling, local BA, keyframe culling)."""
    m_j, k1 = jax_init["out"]
    cam = j_cam.pinhole(FX, FX, W / 2, H / 2)
    lm_cfg = j_lm.LocalMapConfig(focal=FX, scale=1.2, n_levels=4)
    out_j = j_lm.mapping_step(m_j, k1, cam.params, cam.kind, lm_cfg)
    out_t = t_lm.mapping_step(convert.map_from_numpy(_np(m_j)), int(k1),
                              t_cam.pinhole(FX, FX, W / 2, H / 2),
                              _t_cfg().lm_cfg)
    assert int(np.asarray(out_j.lm_valid).sum()) > \
        int(np.asarray(m_j.lm_valid).sum())
    _compare_maps(out_t, out_j)


def test_covisibility_parity(jax_init):
    m_j, k1 = jax_init["out"]
    m_t = convert.map_from_numpy(_np(m_j))
    want = np.asarray(j_ms.covisibility_matrix(m_j))
    assert int(want.max()) > 0
    np.testing.assert_array_equal(t_ms.covisibility_matrix(m_t).numpy(), want)
    np.testing.assert_array_equal(
        t_ms.covisibility_row(m_t, int(k1)).numpy(),
        np.asarray(j_ms.covisibility_row(m_j, k1)))


def test_map_roundtrip(jax_init):
    m_j, _ = jax_init["out"]
    d = _np(m_j)
    back = convert.map_to_numpy(convert.map_from_numpy(d))
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype, k


def test_frame_roundtrip(jax_init):
    d = _np(jax_init["args"][1])
    fr = convert.frame_from_numpy(d)
    assert fr.desc.dtype == torch.int32
    back = convert.frame_to_numpy(fr)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype, k
