"""IMU initialization and inertial mapping of the PyTorch port (plain
versions on the CPU) against the JAX package, on test_inertial.py's
problem: `linear_alignment`, `gravity_rotation`, `inertial_only_optimize`
(biases and velocities within 1e-3 relative), `apply_gauge`,
`compose_preintegration` / `merge_entry_into_next` within 1e-4 relative;
and `mapping_step_inertial` and `cull_keyframes_inertial` on a
stereo-inertial map captured from the port's tracker before its IMU
initialization and carried across (keyframe poses within 1e-4, the same
`kf_valid`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rot

from morb_slam_tpu import cameras as j_cam
from morb_slam_tpu import imu as j_imu
from morb_slam_tpu.optim import inertial as j_in
from morb_slam_tpu.pipeline import local_mapping as j_lm
from morb_slam_tpu_torch import cameras, convert, imu
from morb_slam_tpu_torch.optim import inertial
from morb_slam_tpu_torch.pipeline import local_mapping, tracking

from synthetic_world import PlaneWorld, analytic_pose, imu_between
from test_inertial import CALIB as J_CALIB, build_kf_imu, simulate_rich

torch.set_num_threads(1)
W, H, FX = 384, 288, 300.0


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x), np.float32))


def _close(a, b, rtol=1e-4):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=rtol * max(float(np.abs(b).max()), 1e-6))


@pytest.fixture(scope="module")
def problem():
    bg = np.array([0.004, -0.003, 0.002])
    ba = np.array([0.03, -0.02, 0.04])
    ts, p, v, R, acc, gyr = simulate_rich(T=3.0, bg=bg, ba=ba)
    ki, n_kf = build_kf_imu(ts, acc, gyr)
    idx = np.arange(n_kf) * 50
    R_vg = Rot.from_rotvec([0.25, -0.15, 0.1]).as_matrix()
    R_wb = np.einsum('ij,njk->nik', R_vg, R[idx]).astype(np.float32)
    p_vis = ((p[idx] @ R_vg.T) / 2.5).astype(np.float32)
    return dict(j_ki=ki, ki=convert.imu_from_numpy("KfImu", _np(ki)),
                R_wb=R_wb, p=p_vis, n_kf=n_kf)


def test_linear_alignment_and_gravity_rotation(problem):
    P = problem
    valid = np.ones(P["n_kf"], bool)
    jo = j_in.linear_alignment(P["j_ki"], jnp.asarray(P["R_wb"]),
                               jnp.asarray(P["p"]), jnp.asarray(valid))
    to = inertial.linear_alignment(P["ki"], _t(P["R_wb"]), _t(P["p"]),
                                   torch.from_numpy(valid))
    for a, b in zip(to, jo):
        _close(a.numpy(), b)
    _close(inertial.gravity_rotation(to[1]).numpy(),
           j_in.gravity_rotation(jo[1]))
    # the degenerate branch: gravity already along -z
    g = np.array([0.0, 0.0, -9.81], np.float32)
    _close(inertial.gravity_rotation(_t(g)).numpy(),
           j_in.gravity_rotation(jnp.asarray(g)))


@pytest.mark.parametrize("opt_scale", [True, False])
def test_inertial_only_optimize_matches_reference(problem, opt_scale):
    P = problem
    valid = np.ones(P["n_kf"], bool)
    jl = j_in.linear_alignment(P["j_ki"], jnp.asarray(P["R_wb"]),
                               jnp.asarray(P["p"]), jnp.asarray(valid))
    kw = dict(n_iters=10, opt_scale=opt_scale, prior_gyro=1e2,
              prior_acc=1e5, s0=float(jl[0]))
    jo = j_in.inertial_only_optimize(
        P["j_ki"], jnp.asarray(P["R_wb"]), jnp.asarray(P["p"]),
        jnp.asarray(valid), v0=jl[2], R_wg0=j_in.gravity_rotation(jl[1]),
        **kw)
    to = inertial.inertial_only_optimize(
        P["ki"], _t(P["R_wb"]), _t(P["p"]), torch.from_numpy(valid),
        v0=_t(jl[2]), R_wg0=_t(j_in.gravity_rotation(jl[1])), **kw)
    for name, a, b in zip(("R_wg", "s", "bg", "ba", "v"), to[:5], jo[:5]):
        # biases and velocities to 1e-3 of their size: ten float32
        # Gauss-Newton steps under 1e2-1e5 priors leave ~1e-6 rad/s in bg
        # and ~5e-5 m/s in v of rounding between the frameworks
        _close(a.numpy(), b,
               rtol=1e-3 if name in ("bg", "ba", "v") else 1e-4)
    _close(to[5].numpy(), jo[5], rtol=1e-3)


def test_apply_gauge_matches_reference(problem):
    P = problem
    rng = np.random.default_rng(0)
    R_cw = np.swapaxes(P["R_wb"], -1, -2)
    t_cw = -np.einsum('nij,nj->ni', R_cw, P["p"]).astype(np.float32)
    lm = rng.normal(size=(50, 3)).astype(np.float32)
    v = rng.normal(size=(P["n_kf"], 3)).astype(np.float32)
    R_wg = Rot.from_rotvec([0.1, -0.2, 0.05]).as_matrix().astype(np.float32)
    jo = j_in.apply_gauge(jnp.asarray(R_cw), jnp.asarray(t_cw),
                          jnp.asarray(lm), jnp.asarray(v),
                          jnp.asarray(R_wg), jnp.float32(1.7))
    to = inertial.apply_gauge(_t(R_cw), _t(t_cw), _t(lm), _t(v), _t(R_wg),
                              torch.tensor(1.7))
    for a, b in zip(to, jo):
        _close(a.numpy(), b)


def test_compose_and_merge_match_reference():
    rng = np.random.default_rng(3)
    N = 40
    acc = (rng.normal(0, 1.5, (N, 3)) + [0, 0, 9.81]).astype(np.float32)
    gyr = rng.normal(0, 0.2, (N, 3)).astype(np.float32)
    dts = np.full(N, 0.005, np.float32)
    calib = convert.imu_from_numpy("ImuCalib", _np(J_CALIB))
    jk, tk = j_in.empty_kf_imu(4), inertial.empty_kf_imu(4)
    for k, sl in ((1, slice(0, 20)), (2, slice(20, 40))):
        jp = j_imu.preintegrate(jnp.asarray(acc[sl]), jnp.asarray(gyr[sl]),
                                jnp.asarray(dts[sl]), jnp.ones(20, bool),
                                jnp.zeros(6), J_CALIB)
        tp = imu.preintegrate(_t(acc[sl]), _t(gyr[sl]), _t(dts[sl]),
                              torch.ones(20, dtype=torch.bool),
                              torch.zeros(6), calib)
        jk = j_in.set_kf_imu(jk, k, jp, k - 1)
        tk = inertial.set_kf_imu(tk, k, tp, k - 1)
    for name in j_in.KfImu._fields:
        _close(getattr(tk, name).numpy().astype(np.float32),
               np.asarray(getattr(jk, name)).astype(np.float32), rtol=1e-4)
    jm = j_in.merge_entry_into_next(jk, 1, 2)
    tm = inertial.merge_entry_into_next(tk, torch.tensor(1),
                                        torch.tensor(2))
    assert not bool(tm.valid[1]) and int(tm.prev[2]) == 0
    for name in j_in.KfImu._fields:
        _close(getattr(tm, name).numpy().astype(np.float32),
               np.asarray(getattr(jm, name)).astype(np.float32), rtol=1e-4)
    # splice the two entries into a larger store at offset 3: prev links
    # shift, the rest of the store stays
    js = j_in.splice_kf_imu(j_in.empty_kf_imu(8), jk, 3, 3)
    ts_ = inertial.splice_kf_imu(inertial.empty_kf_imu(8), tk, 3, 3)
    assert ts_.prev.tolist() == [-1, -1, -1, -1, 3, 4, -1, -1]
    for name in j_in.KfImu._fields:
        _close(getattr(ts_, name).numpy().astype(np.float32),
               np.asarray(getattr(js, name)).astype(np.float32), rtol=1e-4)


# ---- inertial mapping on a carried map -------------------------------------

@pytest.fixture(scope="module")
def vi_map():
    """A stereo-inertial map of the port's tracker at 1.5 s (before the IMU
    initialization): keyframes every 0.25 s with their preintegrations,
    velocities and biases."""
    K_ = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    world = PlaneWorld(K_, W, H, seed=0)
    b = 0.12
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                                 max_kf=16, max_lm=6000, n_levels=4,
                                 baseline=b, min_stereo_init_feats=200)
    tr = tracking.Tracker(cameras.pinhole(FX, FX, W / 2, H / 2), cfg,
                          device="cpu",
                          imu_calib=imu.make_calib(np.eye(3), np.zeros(3),
                                                   1.7e-4, 2e-3, 1.9e-5,
                                                   3e-3, 200.0))
    rng = np.random.default_rng(1)
    prev_t = -0.05
    for i in range(31):
        t = i * 0.05
        R, tc = analytic_pose(t)
        R32, t32 = R.astype(np.float32), tc.astype(np.float32)
        ts_i, acc, gyr = imu_between(prev_t, t, rng=rng, noise_g=2.4e-3,
                                     noise_a=2.8e-2)
        tr.track_stereo_inertial(
            world.render(R32, t32),
            world.render(R32, t32 - np.asarray([b, 0, 0], np.float32)), t,
            acc, gyr, ts_i)
        prev_t = t
    assert tr.state == "OK" and not tr.imu_ready
    assert int(tr.kf_imu.valid.sum()) >= 5
    return (convert.map_to_numpy(tr.m),
            convert.tracker_imu_state(tr)["kf_imu"], tr.last_kf_id, cfg)


def _kfimu_j(d):
    return j_in.KfImu(**{k: jnp.asarray(v) for k, v in d.items()})


def _map_j(d):
    from morb_slam_tpu.mapstate import state as j_ms
    return j_ms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def test_mapping_step_inertial_matches_reference(vi_map):
    m_np, ki_np, k, cfg = vi_map
    j_cfg = j_lm.LocalMapConfig(focal=FX, scale=1.2, n_levels=4,
                                baseline=cfg.baseline, inertial=True)
    jcam = j_cam.pinhole(FX, FX, W / 2, H / 2)
    m_j, ki_j = j_lm.mapping_step_inertial(_map_j(m_np), _kfimu_j(ki_np),
                                           jnp.int32(k), jcam.params,
                                           jcam.kind, j_cfg)
    m_t, ki_t = local_mapping.mapping_step_inertial(
        convert.map_from_numpy(m_np), convert.imu_from_numpy("KfImu", ki_np),
        k, cameras.pinhole(FX, FX, W / 2, H / 2),
        tracking.tracking_replace_inertial(cfg).lm_cfg)
    t_np = convert.map_to_numpy(m_t)
    np.testing.assert_array_equal(t_np["kf_valid"], np.asarray(m_j.kf_valid))
    kv = t_np["kf_valid"]
    for f in ("kf_R", "kf_t", "kf_v", "kf_bias"):
        np.testing.assert_allclose(t_np[f][kv], np.asarray(getattr(m_j, f))
                                   [kv], atol=1e-4, err_msg=f)
    assert int(t_np["lm_valid"].sum()) == int(np.asarray(m_j.lm_valid).sum())
    np.testing.assert_array_equal(ki_t.valid.numpy(), np.asarray(ki_j.valid))
    np.testing.assert_array_equal(ki_t.prev.numpy(), np.asarray(ki_j.prev))
    # the window moved: the local inertial BA ran
    assert not np.allclose(t_np["kf_t"][kv], m_np["kf_t"][kv], atol=1e-6)


def test_cull_keyframes_inertial_matches_reference(vi_map):
    m_np, ki_np, k, _ = vi_map
    m_j, ki_j = j_lm.cull_keyframes_inertial(_map_j(m_np), _kfimu_j(ki_np),
                                             jnp.int32(k))
    m_t, ki_t = local_mapping.cull_keyframes_inertial(
        convert.map_from_numpy(m_np), convert.imu_from_numpy("KfImu", ki_np),
        k)
    np.testing.assert_array_equal(m_t.kf_valid.numpy(),
                                  np.asarray(m_j.kf_valid))
    np.testing.assert_array_equal(m_t.kf_prev.numpy(),
                                  np.asarray(m_j.kf_prev))
    for name in j_in.KfImu._fields:
        _close(getattr(ki_t, name).numpy().astype(np.float32),
               np.asarray(getattr(ki_j, name)).astype(np.float32))
