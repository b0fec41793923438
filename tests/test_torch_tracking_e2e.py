"""End-to-end monocular SLAM through the PyTorch port on the CPU (its plain
kernel versions): the test_tracking_e2e.py sequence (384x288, 500
features, 4 levels, 60 frames) with that test's gates, plus a stepwise
parity check: the JAX tracker's post-initialization map and FrameData of 5
frames fed into the port's per-frame tracking, which must give R, t within
1e-4 and >= 99% identical feature-landmark associations."""
import numpy as np
import pytest
import torch

from morb_slam_tpu import cameras as j_cam
from morb_slam_tpu.pipeline import tracking as j_tr
from morb_slam_tpu_torch import alignment, cameras, convert
from morb_slam_tpu_torch.pipeline import tracking

from synthetic_world import PlaneWorld, camera_path

torch.set_num_threads(1)
W, H = 384, 288
FX = 300.0
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
CFG = dict(width=W, height=H, focal=FX, n_feat=500, max_kf=32, max_lm=6000,
           n_levels=4, min_init_matches=60, min_init_points=40)


@pytest.fixture(scope="module")
def world():
    return PlaneWorld(K, W, H, seed=0), camera_path(60, step=0.05)


@pytest.fixture(scope="module")
def run_sequence(world):
    scene, poses = world
    tracker = tracking.Tracker(cameras.pinhole(FX, FX, W / 2, H / 2),
                               tracking.TrackerConfig(**CFG), device="cpu")
    states = []
    for i, (R, t) in enumerate(poses):
        state, _ = tracker.track_mono(scene.render(R, t), ts=float(i))
        states.append(state)
    return tracker, states, poses


def test_initializes(run_sequence):
    _, states, _ = run_sequence
    assert "OK" in states, states[:20]
    assert states.index("OK") < 30


def test_tracks_majority(run_sequence):
    _, states, _ = run_sequence
    assert sum(s == "OK" for s in states) > 0.7 * len(states), states


def test_map_grows(run_sequence):
    tracker, _, _ = run_sequence
    assert int(tracker.m.n_kf) >= 3
    assert int(tracker.m.lm_valid.sum()) > 200


def test_kf_rate_bounded(run_sequence):
    tracker, states, _ = run_sequence
    max_rate = len(states) // tracker.cfg.min_kf_interval
    assert tracker.n_kf_host < 0.5 * max_rate, (tracker.n_kf_host, max_rate)


def test_ate_small(run_sequence):
    tracker, _, gt = run_sequence
    traj = tracker.trajectory_world()
    assert len(traj) > 30
    est, ref = [], []
    for ts, p in traj:
        R, t = gt[int(round(ts))]
        ref.append(-(R.T @ t))
        est.append(p)
    est = torch.tensor(np.asarray(est), dtype=torch.float32)
    ref = torch.tensor(np.asarray(ref), dtype=torch.float32)
    rmse, _, _, _ = alignment.ate_rmse(est, ref, with_scale=True)
    extent = float(torch.linalg.norm(ref[-1] - ref[0]))
    print(f"\nport ATE {float(rmse):.4f} m over {extent:.3f} m")
    assert float(rmse) < 0.023 * extent, (float(rmse), extent)


@pytest.fixture(scope="module")
def jax_steps(world):
    """The JAX tracker's per-frame inputs and outputs for the first 5
    frames tracked after initialization."""
    scene, poses = world
    tracker = j_tr.Tracker(j_cam.pinhole(FX, FX, W / 2, H / 2),
                           j_tr.TrackerConfig(**CFG))
    rec = []
    orig = j_tr.track_step

    def capture(*args, **kw):
        out = orig(*args, **kw)
        rec.append((args, out))
        return out
    j_tr.track_step = capture
    try:
        for i, (R, t) in enumerate(poses):
            tracker.track_mono(scene.render(R, t), ts=float(i))
            if len(rec) >= 5:
                break
    finally:
        j_tr.track_step = orig
    return rec


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("step", range(5))
def test_stepwise_parity(jax_steps, step):
    args, out = jax_steps[step]
    _, m, last, last_lm, R_last, t_last, vel_R, vel_t, has_vel, ref_kf = \
        args[:10]
    fr_j, out_j = out[0], out[1]
    fr_t, out_t, _, _, info_t = tracking.track_step_framedata(
        convert.frame_from_numpy(_np(fr_j)), convert.map_from_numpy(_np(m)),
        convert.frame_from_numpy(_np(last)), _t(last_lm), _t(R_last),
        _t(t_last), _t(vel_R), _t(vel_t), bool(has_vel), int(ref_kf),
        cameras.pinhole(FX, FX, W / 2, H / 2),
        tracking.TrackerConfig(**CFG))
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R),
                               atol=1e-4)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t),
                               atol=1e-4)
    same = (out_t.feat_lm.numpy() == np.asarray(out_j.feat_lm)).mean()
    assert same >= 0.99, same
    assert int(out_t.ref_kf) == int(out_j.ref_kf)
    np.testing.assert_array_equal(info_t.numpy(), np.asarray(out[4]))
