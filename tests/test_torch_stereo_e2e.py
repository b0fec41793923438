"""End-to-end rectified stereo SLAM through the PyTorch port on the CPU (its
plain kernel versions): the test_stereo_e2e.py sequence (384x288, 500
features, 4 levels, 40 frames, 0.12 m baseline) with that test's gates:
initialization on the first frame, > 90% of frames OK, the Sim3 scale
within 5% of 1 and the SE3-aligned ATE under 0.03 x the path extent."""
import numpy as np
import pytest
import torch

from morb_slam_tpu_torch import alignment, cameras
from morb_slam_tpu_torch.ops import stereo
from morb_slam_tpu_torch.pipeline import tracking

from synthetic_world import PlaneWorld, camera_path

torch.set_num_threads(1)
W, H, FX = 384, 288, 300.0
BASELINE = 0.12


@pytest.fixture(scope="module")
def run_stereo():
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    world = PlaneWorld(K, W, H, seed=0)
    poses = camera_path(40, step=0.05)
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                                 max_kf=48, max_lm=8000, n_levels=4,
                                 baseline=BASELINE, min_stereo_init_feats=200)
    tr = tracking.Tracker(cameras.pinhole(FX, FX, W / 2, H / 2), cfg,
                          device="cpu")
    sad_before = stereo.LAUNCHES["plain"]
    states = []
    for i, (R, t) in enumerate(poses):
        img_l = world.render(R, t)
        img_r = world.render(R, t - np.asarray([BASELINE, 0, 0], np.float32))
        state, _ = tr.track_stereo(img_l, img_r, ts=float(i))
        states.append(state)
    return tr, states, poses, stereo.LAUNCHES["plain"] - sad_before


def test_initializes_first_frame(run_stereo):
    _, states, _, _ = run_stereo
    assert states[0] == "OK", states[:3]


def test_tracks_all(run_stereo):
    _, states, _, n_sad = run_stereo
    ok = sum(1 for s in states if s == "OK")
    assert ok > 0.9 * len(states), (ok, states)
    assert n_sad >= len(states)          # K7's plain version on every frame


def test_close_landmarks_and_keyframes(run_stereo):
    tr, _, _, _ = run_stereo
    assert tr.n_kf_host >= 3
    assert int(tr.m.lm_valid.sum()) > 500


def test_metric_scale(run_stereo):
    """Stereo recovers the true metric scale."""
    tr, _, poses, _ = run_stereo
    est, gt = [], []
    for ts, p in tr.trajectory_world():
        R, t = poses[int(round(ts))]
        gt.append(-(R.T @ t))
        est.append(p)
    est = torch.tensor(np.asarray(est), dtype=torch.float32)
    gt = torch.tensor(np.asarray(gt), dtype=torch.float32)
    _, s, _, _ = alignment.ate_rmse(est, gt, with_scale=True)
    assert abs(float(s) - 1.0) < 0.05, float(s)
    rmse_se3, _, _, _ = alignment.ate_rmse(est, gt, with_scale=False)
    extent = float(torch.linalg.norm(gt[-1] - gt[0]))
    print(f"\nport stereo SE3 ATE {float(rmse_se3):.4f} m over {extent:.3f} m,"
          f" scale {float(s):.4f}")
    assert float(rmse_se3) < 0.03 * extent, (float(rmse_se3), extent)
