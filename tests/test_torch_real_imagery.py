"""Real-imagery evidence for the PyTorch port on the CPU (plain kernel
versions), mirroring tests/test_real_imagery.py: 60 monocular frames of the
plane world textured with real photographs (perspective views of a
photo-textured plane are exact homographies of real imagery) through the
port's Tracker, with its settings and assertions: OK at the end, more than
45 trajectory poses and a Sim3 ATE under 0.08 m. Skips when no photo ships
with the installed packages."""
import numpy as np
import pytest
import torch

from morb_slam_tpu_torch import alignment, cameras
from morb_slam_tpu_torch.pipeline import tracking

from synthetic_world import PlaneWorld, camera_path, real_photo_textures

torch.set_num_threads(1)
W, H, FX = 384, 288, 300.0


@pytest.fixture(scope="module")
def photos():
    t = real_photo_textures()
    if not t:
        pytest.skip("no real sample photographs installed")
    return t


def test_mono_tracking_on_real_photo_texture(photos):
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    world = PlaneWorld(K, W, H, seed=0, textures=photos)
    poses = camera_path(60, step=0.05)
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                                 max_kf=64, max_lm=8000, n_levels=4,
                                 min_init_matches=60, min_init_points=40)
    tr = tracking.Tracker(cameras.pinhole(FX, FX, W / 2, H / 2), cfg,
                          device="cpu")
    for i, (R, t) in enumerate(poses):
        img = np.clip(world.render(R, t), 0, 255).astype(np.uint8)
        tr.track_mono(torch.from_numpy(img), ts=float(i))
    tr.flush()
    assert tr.state == "OK"
    traj = tr.trajectory_world()
    assert len(traj) > 45
    est, gt = [], []
    for ts, p in traj:
        R, t = poses[int(round(ts))]
        gt.append(-(R.T @ t))
        est.append(np.asarray(p))
    rmse, _, _, _ = alignment.ate_rmse(
        torch.tensor(np.asarray(est), dtype=torch.float32),
        torch.tensor(np.asarray(gt), dtype=torch.float32), with_scale=True)
    # repetitive real texture is harder than fractal noise; the bound is
    # looser than the synthetic ATE gate but still sub-decimeter
    assert float(rmse) < 0.08, float(rmse)
