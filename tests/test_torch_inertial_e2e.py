"""Visual-inertial end to end through the PyTorch port on the CPU (its plain
kernel versions), at the gates of test_inertial_e2e.py:

- stereo-inertial, 90 frames (384x288, 500 features, 4 levels, 0.12 m):
  > 85% of frames OK, the IMU initialized, the Sim3 scale within 0.06 of 1
  and the SE3 ATE under 0.04 x the path extent;
- monocular-inertial, 90 frames: > 75% OK, the IMU initialized with
  viba_stage >= 1, a finite trajectory and the Sim3 ATE under 0.04 x the
  extent;
- a few frames through `System(settings, Sensor.IMU_STEREO / IMU_RGBD,
  device="cpu")` with `imu_batch=`, covering the facade.

The sequences run through the port only: the JAX tracker's compilation
would cost minutes here. Run as a script, the file drives the
stereo-inertial sequence through the port or the JAX package for a list of
IMU noise seeds and prints each run's accuracy:

    PYTHONPATH=. python tests/test_torch_inertial_e2e.py --package port --seeds 1,2
    PYTHONPATH=. python tests/test_torch_inertial_e2e.py --package jax --frames 120"""
import json
import sys
import time

import numpy as np
import pytest
import torch

from morb_slam_tpu_torch import alignment, cameras, imu, system
from morb_slam_tpu_torch.io import config
from morb_slam_tpu_torch.optim import pose_opt, vi_ba
from morb_slam_tpu_torch.pipeline import tracking

from synthetic_world import PlaneWorld, analytic_pose, imu_between
from test_rgbd_e2e import render_depth

torch.set_num_threads(1)
W, H, FX = 384, 288, 300.0
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])


def _calib():
    return imu.make_calib(np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5,
                          3e-3, 200.0)


def _ate(tr, gt, with_scale, n_frames=None):
    """(estimated centres, ATE, Sim3 scale, extent) of the trajectory's
    frames (those before frame n_frames when given)."""
    est, gtp = [], []
    for ts, p in tr.trajectory_world():
        i = int(round(ts / 0.05))
        if n_frames is not None and i >= n_frames:
            continue
        R, t = gt[i]
        gtp.append(-(R.T @ t))
        est.append(np.asarray(p))
    est = torch.tensor(np.asarray(est), dtype=torch.float32)
    gtp = torch.tensor(np.asarray(gtp), dtype=torch.float32)
    rmse, s, _, _ = alignment.ate_rmse(est, gtp, with_scale=with_scale)
    return est, float(rmse), float(s), float(torch.linalg.norm(gtp[-1] -
                                                               gtp[0]))


@pytest.fixture(scope="module")
def world():
    return PlaneWorld(K, W, H, seed=0)


def stereo_inertial_run(world, seed=1, n_frames=90, package="port"):
    """test_inertial_e2e.py's stereo-inertial sequence (0.12 m baseline,
    the accelerated analytic path at 20 Hz) with the IMU noise of `seed`,
    through the port's Tracker or the JAX package's. Returns (tracker,
    states, ground-truth poses)."""
    b = 0.12
    if package == "jax":
        import jax.numpy as jnp
        from morb_slam_tpu import cameras as j_cameras, imu as j_imu
        from morb_slam_tpu.pipeline import tracking as j_tracking
        cfg = j_tracking.TrackerConfig(width=W, height=H, focal=FX,
                                       n_feat=500, max_kf=96, max_lm=8000,
                                       n_levels=4, baseline=b,
                                       min_stereo_init_feats=200)
        tr = j_tracking.Tracker(
            j_cameras.pinhole(FX, FX, W / 2, H / 2), cfg,
            imu_calib=j_imu.make_calib(np.eye(3), np.zeros(3), 1.7e-4, 2e-3,
                                       1.9e-5, 3e-3, 200.0))
        image = lambda x: jnp.asarray(x, jnp.float32)
    else:
        cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                                     max_kf=96, max_lm=8000, n_levels=4,
                                     baseline=b, min_stereo_init_feats=200)
        tr = tracking.Tracker(cameras.pinhole(FX, FX, W / 2, H / 2), cfg,
                              device="cpu", imu_calib=_calib())
        image = lambda x: x
    rng = np.random.default_rng(seed)
    prev_t, gt, states = -0.05, [], []
    for i in range(n_frames):
        t = i * 0.05
        R, tc = analytic_pose(t)
        gt.append((R, tc))
        img_l = world.render(R.astype(np.float32), tc.astype(np.float32))
        img_r = world.render(R.astype(np.float32),
                             (tc - np.asarray([b, 0, 0])).astype(np.float32))
        ts_i, acc, gyr = imu_between(prev_t, t, rng=rng, noise_g=2.4e-3,
                                     noise_a=2.8e-2)
        state, _ = tr.track_stereo_inertial(image(img_l), image(img_r), t,
                                            acc, gyr, ts_i)
        states.append(state)
        prev_t = t
    return tr, states, gt


@pytest.fixture(scope="module")
def run_stereo_inertial(world):
    k12 = vi_ba.LAUNCHES["plain"]
    tr, states, gt = stereo_inertial_run(world)
    return tr, states, gt, vi_ba.LAUNCHES["plain"] - k12


def test_stereo_inertial_tracks(run_stereo_inertial):
    tr, states, _, n_k12 = run_stereo_inertial
    ok = sum(1 for s in states if s == "OK")
    assert ok > 0.85 * len(states), states
    assert tr.imu_ready and tr.viba_stage >= 1
    assert n_k12 > 20             # the inertial pose optimizer ran per frame
    assert bool(torch.isfinite(tr.m.kf_v).all())
    assert bool(torch.isfinite(tr.m.kf_bias).all())


def test_stereo_inertial_metric_scale_and_ate(run_stereo_inertial):
    tr, _, gt, _ = run_stereo_inertial
    _, _, s, _ = _ate(tr, gt, with_scale=True)
    assert abs(s - 1.0) < 0.06, s
    _, rmse, _, extent = _ate(tr, gt, with_scale=False)
    print(f"\nport stereo-inertial SE3 ATE {rmse:.4f} m over {extent:.3f} m, "
          f"scale {s:.4f}, viba_stage {tr.viba_stage}")
    assert rmse < 0.04 * extent, (rmse, extent)


@pytest.fixture(scope="module")
def run_mono_inertial(world):
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                                 max_kf=64, max_lm=8000, n_levels=4,
                                 min_init_matches=60, min_init_points=40)
    tr = tracking.Tracker(cameras.pinhole(FX, FX, W / 2, H / 2), cfg,
                          device="cpu", imu_calib=_calib())
    rng = np.random.default_rng(0)
    prev_t, gt, states = -0.05, [], []
    for i in range(90):
        t = i * 0.05
        R, tc = analytic_pose(t)
        gt.append((R, tc))
        img = world.render(R.astype(np.float32), tc.astype(np.float32))
        ts_i, acc, gyr = imu_between(prev_t, t, rng=rng,
                                     noise_g=1.7e-4 * 14.1,
                                     noise_a=2e-3 * 14.1)
        state, _ = tr.track_mono_inertial(img, t, acc, gyr, ts_i)
        states.append(state)
        prev_t = t
    return tr, states, gt


def test_mono_inertial_tracks_and_initializes(run_mono_inertial):
    tr, states, _ = run_mono_inertial
    ok = sum(1 for s in states if s == "OK")
    assert ok > 0.75 * len(states), states
    assert tr.imu_ready, "IMU init never fired"
    assert tr.viba_stage >= 1


def test_mono_inertial_trajectory_after_gauge(run_mono_inertial):
    tr, _, gt = run_mono_inertial
    est, rmse, s, extent = _ate(tr, gt, with_scale=True)
    assert bool(torch.isfinite(est).all()), "NaN in trajectory after gauge"
    print(f"\nport mono-inertial Sim3 ATE {rmse:.4f} m over {extent:.3f} m, "
          f"scale {s:.4f}")
    assert rmse < 0.04 * extent, (rmse, extent)


def _imu_settings():
    return config.ImuSettings(noise_gyro=1.7e-4, noise_acc=2e-3,
                              walk_gyro=1.9e-5, walk_acc=3e-3,
                              frequency=200.0, T_b_c1=np.eye(4))


@pytest.mark.parametrize("sensor", [system.Sensor.IMU_STEREO,
                                    system.Sensor.IMU_RGBD])
def test_system_inertial_sensors(world, sensor):
    """Eight frames through the facade: initialization on the first frame,
    every frame OK, the IMU samples buffered and the since-keyframe chain
    extended by K11's plain version."""
    b = 0.12
    s = system.System(config.Settings(cam1=config.CameraSettings(
        model="PinHole", fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W,
        height=H), baseline=b, n_features=500, n_levels=4,
        imu=_imu_settings()), sensor, device="cpu",
        tracker_overrides=dict(max_kf=16, max_lm=4000,
                               min_stereo_init_feats=200))
    tr = s.tracker
    assert tr.calib is not None and tr.cfg.inertial
    rng = np.random.default_rng(3)
    pre_before = imu.LAUNCHES["plain"]
    prev_t, states = -0.05, []
    for i in range(8):
        t = i * 0.05
        R, tc = analytic_pose(t)
        R32, t32 = R.astype(np.float32), tc.astype(np.float32)
        batch = imu_between(prev_t, t, rng=rng)
        img = world.render(R32, t32)
        if sensor == system.Sensor.IMU_STEREO:
            st, _ = s.track_stereo(img, world.render(
                R32, t32 - np.asarray([b, 0, 0], np.float32)), t,
                imu_batch=batch)
        else:
            st, _ = s.track_rgbd(img, render_depth(world, K, R32, t32), t,
                                 imu_batch=batch)
        states.append(st)
        prev_t = t
    assert states == ["OK"] * 8, states
    assert imu.LAUNCHES["plain"] - pre_before >= 7
    # keyframes after the first carry a preintegration from their
    # predecessor; the since-keyframe chain is live
    assert int(tr.kf_imu.valid.sum()) >= 1 and tr._pre_from_kf is not None
    assert tr.ts_first_kf == 0.0 and not tr.imu_ready
    s.reset()
    assert all(torch.equal(a, b) for a, b in zip(s.tracker.calib, tr.calib))
    assert s.state == "NO_IMAGES"
    assert pose_opt.LAUNCHES["plain"] > 0


def _seed_sweep(argv):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--frames", type=int, default=90)
    args = ap.parse_args(argv)
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
    world = PlaneWorld(K, W, H, seed=0)
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        tr, states, gt = stereo_inertial_run(world, seed, args.frames,
                                             args.package)
        row = dict(package=args.package, seed=seed, frames=args.frames,
                   frames_ok=sum(s == "OK" for s in states),
                   imu_ready=bool(tr.imu_ready),
                   viba_stage=int(tr.viba_stage))
        for n in sorted({90, args.frames}):
            if n > args.frames:
                continue
            _, ate, _, extent = _ate(tr, gt, False, n)
            _, _, scale, _ = _ate(tr, gt, True, n)
            row[f"first_{n}"] = dict(ate_se3_m=ate, sim3_scale=scale,
                                     extent_m=extent,
                                     gate_se3_m=0.04 * extent)
        row["s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    _seed_sweep(sys.argv[1:])
