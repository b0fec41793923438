"""The non-rectified KB8 two-camera rig end to end on the CPU, through the
PyTorch port's `Tracker(cam0, cfg, stereo_rig=(cam1, R_rl, t_rl))` (its
plain kernel versions) and the JAX package's, on the same raw 384x288
pairs of `kb8_rig.Rig` (500 features, 4 levels, 0.10 m baseline): 40
pairs along the tests' camera path through `track_stereo`, at the stereo
e2e test's gates (the first pair initializes, > 90% of the pairs OK, the
Sim3 scale within 0.05 of 1, the SE3 ATE under 0.03 x the extent) in both
packages, and the port's OK count within 2 of JAX's.

The rig's stereo-inertial sequence (120 pairs at 20 Hz through
`track_stereo_inertial`, the IMU noise of the fisheye test, the vi gates)
is a script mode, too long for the CPU tests:

    PYTHONPATH=.:tests python tests/test_torch_stereo_rig_e2e.py --package port --inertial --frames 120
    PYTHONPATH=.:tests python tests/test_torch_stereo_rig_e2e.py --package jax --frames 40
"""
import argparse
import json
import sys
import time

import numpy as np
import pytest
import torch

from kb8_rig import CAM0, H, W, Rig, jax_rig, port_rig
from synthetic_world import analytic_pose, camera_path, imu_between

torch.set_num_threads(1)
N_PAIRS = 40
DT_VI = 0.05


def _cfg_kw(inertial):
    return dict(width=W, height=H, focal=CAM0[0], n_feat=500,
                max_kf=96 if inertial else 48, max_lm=8000, n_levels=4,
                baseline=0.10, min_stereo_init_feats=100)


def vi_pose(t):
    """The tests' accelerated analytic path at half speed: the rig's world
    is the plane world at half scale."""
    return analytic_pose(t, speed=0.5)


def rig_run(package="port", n_frames=N_PAIRS, inertial=False, seed=4,
            rig=None):
    """Drive n_frames rig pairs through one package's Tracker: the camera
    path through `track_stereo`, or with `inertial` the analytic path with
    its IMU samples through `track_stereo_inertial`. Returns (tracker,
    states, ground-truth poses, frame spacing in seconds)."""
    rig = rig or Rig()
    if package == "jax":
        import jax.numpy as jnp
        from morb_slam_tpu import imu as j_imu
        from morb_slam_tpu.pipeline import tracking as j_tracking
        cam, rigp = jax_rig()
        calib = j_imu.make_calib(np.eye(3), np.zeros(3), 1.7e-4, 2e-3,
                                 1.9e-5, 3e-3, 200.0) if inertial else None
        tr = j_tracking.Tracker(cam, j_tracking.TrackerConfig(
            **_cfg_kw(inertial)), imu_calib=calib, stereo_rig=rigp)
        image = jnp.asarray
    else:
        from morb_slam_tpu_torch import imu
        from morb_slam_tpu_torch.pipeline import tracking
        cam, rigp = port_rig()
        calib = imu.make_calib(np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5,
                               3e-3, 200.0) if inertial else None
        tr = tracking.Tracker(cam, tracking.TrackerConfig(
            **_cfg_kw(inertial)), device="cpu", imu_calib=calib,
            stereo_rig=rigp)
        image = torch.from_numpy
    if not inertial:
        gt = camera_path(n_frames, step=0.025)
        states = [tr.track_stereo(*map(image, rig.pair(R, t)), ts=float(i))[0]
                  for i, (R, t) in enumerate(gt)]
        tr.flush()
        return tr, states, gt, 1.0
    rng = np.random.default_rng(seed)
    gt, states = [], []
    for i in range(n_frames):
        t = i * DT_VI
        R, tc = vi_pose(t)
        gt.append((R, tc))
        ts_i, acc, gyr = imu_between(t - DT_VI, t, rng=rng, noise_g=2.4e-3,
                                     noise_a=2.8e-2, pose_fn=vi_pose)
        states.append(tr.track_stereo_inertial(
            *map(image, rig.pair(R, tc)), t, acc, gyr, ts_i)[0])
    tr.flush()
    return tr, states, gt, DT_VI


def accuracy(tr, gt, dt):
    """(Sim3 scale, SE3 ATE, extent) of the tracker's trajectory."""
    from morb_slam_tpu_torch import alignment
    est, gtp = [], []
    for ts, p in tr.trajectory_world():
        R, t = gt[int(round(ts / dt))]
        gtp.append(-(np.asarray(R, np.float64).T @ np.asarray(t)))
        est.append(np.asarray(p))
    est = torch.tensor(np.asarray(est), dtype=torch.float32)
    gtp = torch.tensor(np.asarray(gtp), dtype=torch.float32)
    _, s, _, _ = alignment.ate_rmse(est, gtp, with_scale=True)
    rmse, _, _, _ = alignment.ate_rmse(est, gtp, with_scale=False)
    return float(s), float(rmse), float(torch.linalg.norm(gtp[-1] - gtp[0]))


@pytest.fixture(scope="module")
def runs():
    rig = Rig()
    out = {}
    for package in ("jax", "port"):
        tr, states, gt, dt = rig_run(package, rig=rig)
        out[package] = (states, accuracy(tr, gt, dt))
    return out


@pytest.mark.parametrize("package", ["port", "jax"])
def test_rig_stereo_gates(runs, package):
    states, (scale, ate, extent) = runs[package]
    assert states[0] == "OK", states[:3]
    assert sum(s == "OK" for s in states) > 0.9 * N_PAIRS, states
    assert abs(scale - 1.0) < 0.05, scale
    assert ate < 0.03 * extent, (ate, extent)


def test_rig_port_ok_count_near_jax(runs):
    n = {p: sum(s == "OK" for s in runs[p][0]) for p in runs}
    assert n["port"] >= n["jax"] - 2, n


def _main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--frames", type=int, default=N_PAIRS)
    ap.add_argument("--inertial", action="store_true")
    ap.add_argument("--seed", type=int, default=4)
    args = ap.parse_args(argv)
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    tr, states, gt, dt = rig_run(args.package, args.frames, args.inertial,
                                 args.seed)
    scale, ate, extent = accuracy(tr, gt, dt)
    print(json.dumps(dict(
        package=args.package, inertial=args.inertial, frames=args.frames,
        frames_ok=sum(s == "OK" for s in states),
        states="".join("O" if s == "OK" else s[0] for s in states),
        imu_ready=bool(getattr(tr, "imu_ready", False)),
        viba_stage=int(getattr(tr, "viba_stage", 0)), sim3_scale=scale,
        ate_se3_m=ate, extent_m=extent,
        gate_se3_m=(0.04 if args.inertial else 0.03) * extent,
        s=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    _main(sys.argv[1:])
