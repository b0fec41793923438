"""The PyTorch port's System facade on the CPU (its plain kernel
versions): settings built in code and from YAML (against the JAX
package's loader), the features of later slices refused, localization mode
and reset, and two end-to-end sequences at the JAX tests' gates:

- raw, rotated-rig stereo rectified by the System (test_rectify.py's
  test_unrectified_stereo_e2e: > 80% of 40 frames OK, > 25 trajectory
  poses, path extent within 8% of the truth);
- RGB-D (test_rgbd_e2e.py: the first frame OK, > 85% of 25 frames OK,
  the Sim3 scale within 5% of 1).
"""
import dataclasses

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rot

from morb_slam_tpu.io import config as j_config
from morb_slam_tpu_torch import alignment, convert, system
from morb_slam_tpu_torch.io import config
from morb_slam_tpu_torch.ops import rectify

from synthetic_world import PlaneWorld, camera_path
from test_rgbd_e2e import render_depth

torch.set_num_threads(1)
W, H, FX = 384, 288, 300.0
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])


def _cam():
    return config.CameraSettings(model="PinHole", fx=FX, fy=FX, cx=W / 2,
                                 cy=H / 2, width=W, height=H)


@pytest.fixture(scope="module")
def world():
    return PlaneWorld(K, W, H, seed=0)


YAML = """%YAML:1.0
---
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 458.654
Camera1.fy: 457.296
Camera1.cx: 367.215
Camera1.cy: 248.375
Camera1.k1: -0.28340811
Camera1.k2: 0.07395907
Camera1.p1: 0.00019359
Camera1.p2: 1.76187114e-05
Camera2.fx: 457.587
Camera2.fy: 456.134
Camera2.cx: 379.999
Camera2.cy: 255.238
Camera2.k1: -0.28368365
Camera2.k2: 0.07451284
Camera2.p1: -0.00010473
Camera2.p2: -3.5559e-05
Camera.width: 752
Camera.height: 480
Camera.fps: 20
Stereo.ThDepth: 60.0
Stereo.T_c1_c2:
  rows: 4
  cols: 4
  dt: f
  data: [0.999997256477797, 0.002317135723275, 0.000343393120620, 0.110074137800478,
         -0.002312067192432, 0.999898048507103, -0.014090668452683, -0.000156612054392,
         -0.000376008102320, 0.014089835846691, 0.999900662638081, 0.000889382785432,
         0, 0, 0, 1.0]
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
"""


def test_load_settings_matches_reference(tmp_path):
    p = tmp_path / "euroc.yaml"
    p.write_text(YAML)
    want = dataclasses.asdict(j_config.load_settings(str(p)))
    got = config.load_settings(str(p))
    assert got.cam2.dist == tuple(want["cam2"]["dist"])
    np.testing.assert_array_equal(got.T_c1_c2, want["T_c1_c2"])
    assert got.th_depth == 60.0 and got.fps == 20.0
    rebuilt = convert.settings_from_dict(want)
    assert dataclasses.asdict(rebuilt).keys() == dataclasses.asdict(got).keys()
    for k, v in dataclasses.asdict(got).items():
        if k != "T_c1_c2":
            assert dataclasses.asdict(rebuilt)[k] == v, k


def test_system_from_yaml_builds_rectification(tmp_path):
    p = tmp_path / "euroc.yaml"
    p.write_text(YAML)
    s = system.System(str(p), system.Sensor.STEREO, device="cpu",
                      tracker_overrides=dict(max_kf=8, max_lm=1000))
    cfg = s.tracker.cfg
    assert s.rectify is not None and s.rectify.map1.shape == (480, 752, 2)
    assert cfg.width == 752 and cfg.n_feat == 1200 and cfg.th_depth == 60.0
    assert abs(cfg.baseline - 0.110074) < 1e-4
    assert abs(cfg.focal - 458.654) < 1e-3    # the rectified float32 focal
    assert s.state == "NO_IMAGES"


@pytest.mark.parametrize("kw", [
    dict(sensor=system.Sensor.IMU_STEREO),
    dict(sensor=system.Sensor.MONOCULAR, vocabulary=object()),
    dict(sensor=system.Sensor.MONOCULAR, vocabulary_path="voc.txt")])
def test_later_slices_refused(kw):
    """Atlas loading belongs to the persistence slice, with or without
    loop closing (the inertial sensors run since the visual-inertial slice,
    loop closing since the loop-closing slice)."""
    settings = config.Settings(cam1=_cam(), imu=config.ImuSettings(),
                               load_atlas="atlas.osa")
    with pytest.raises(NotImplementedError, match="persistence"):
        system.System(settings, device="cpu", **kw)


def test_localization_mode_and_reset(world):
    poses = camera_path(7, step=0.05)
    s = system.System(config.Settings(cam1=_cam(), baseline=0.1,
                                      n_features=500, n_levels=4),
                      system.Sensor.RGBD, device="cpu",
                      tracker_overrides=dict(max_kf=8, max_lm=3000,
                                             min_stereo_init_feats=200,
                                             max_kf_interval=1,
                                             min_kf_interval=1))
    states = []
    for i, (R, t) in enumerate(poses):
        if i == 1:
            s.activate_localization_mode()
        if i == 6:
            assert s.tracker.n_kf_host == 1  # no keyframe while localizing
            s.deactivate_localization_mode()
        # frame 3 jumps 5 s ahead: while localizing, the map is kept
        states.append(s.track_rgbd(world.render(R, t),
                                   render_depth(world, K, R, t),
                                   ts=0.1 * i + (5.0 if i >= 3 else 0.0))[0])
    s.tracker.flush()
    assert states == ["OK"] * 7, states
    assert len(s.tracker.trajectory) == 7     # the jump dropped no pose
    assert s.tracker.n_kf_host > 1
    s.reset()
    assert s.state == "NO_IMAGES" and s.tracker.n_kf_host == 0


def _rig(angle=0.02):
    R_12 = Rot.from_rotvec([0.01, angle, -0.005]).as_matrix()
    T = np.eye(4)
    T[:3, :3] = R_12
    T[:3, 3] = [0.11, 0.002, -0.001]
    return T


def test_unrectified_stereo_e2e(world):
    """Raw rotated-rig stereo through the System: rectification gives a
    row-aligned pair that tracks with metric scale."""
    T = _rig()
    R_12, t_12 = T[:3, :3], T[:3, 3]
    R_21 = R_12.T
    t_21 = -R_21 @ t_12
    settings = config.Settings(cam1=_cam(), cam2=_cam(), T_c1_c2=T,
                               baseline=float(np.linalg.norm(t_12)),
                               n_features=500, n_levels=4)
    s = system.System(settings, system.Sensor.STEREO, device="cpu",
                      tracker_overrides=dict(max_kf=64, max_lm=8000,
                                             min_stereo_init_feats=150))
    assert s.rectify is not None
    remaps = rectify.LAUNCHES["plain"]
    poses = camera_path(40, step=0.05)
    gt_centers, states = [], []
    for i, (R1, t1) in enumerate(poses):
        img_l = world.render(R1, t1)
        img_r = world.render((R_21 @ R1).astype(np.float32),
                             (R_21 @ t1 + t_21).astype(np.float32))
        states.append(s.track_stereo(img_l, img_r, ts=i * 0.05)[0])
        gt_centers.append(-(R1.T @ t1))
    assert rectify.LAUNCHES["plain"] - remaps == len(poses)   # one per pair
    ok = sum(1 for st in states if st == "OK")
    assert ok > 0.8 * len(states), states
    traj = s.tracker.trajectory_world()
    assert len(traj) > 25
    est = np.asarray([p for _, p in traj])
    gt = np.asarray(gt_centers[-len(est):])
    ext_est = np.linalg.norm(est[-1] - est[0])
    ext_gt = np.linalg.norm(gt[-1] - gt[0])
    print(f"\nport rectified stereo: extent {ext_est:.4f} m of {ext_gt:.4f}")
    assert abs(ext_est / ext_gt - 1.0) < 0.08, (ext_est, ext_gt)


def test_rgbd_tracks_metric(world):
    poses = camera_path(25, step=0.06)
    s = system.System(config.Settings(cam1=_cam(), baseline=0.1,
                                      n_features=500, n_levels=4),
                      system.Sensor.RGBD, device="cpu",
                      tracker_overrides=dict(max_kf=32, max_lm=6000,
                                             min_stereo_init_feats=200))
    states = []
    for i, (R, t) in enumerate(poses):
        states.append(s.track_rgbd(world.render(R, t),
                                   render_depth(world, K, R, t),
                                   ts=float(i))[0])
    ok = sum(1 for st in states if st == "OK")
    assert states[0] == "OK" and ok > 0.85 * len(states), states
    est, gt = [], []
    for ts, p in s.tracker.trajectory_world():
        R, t = poses[int(round(ts))]
        gt.append(-(R.T @ t))
        est.append(p)
    _, scale, _, _ = alignment.ate_rmse(
        torch.tensor(np.asarray(est), dtype=torch.float32),
        torch.tensor(np.asarray(gt), dtype=torch.float32), with_scale=True)
    print(f"\nport RGB-D Sim3 scale {float(scale):.4f}")
    assert abs(float(scale) - 1.0) < 0.05, float(scale)
