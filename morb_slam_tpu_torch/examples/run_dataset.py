"""Dataset runner CLI (counterpart of
`morb_slam_tpu/examples/run_dataset.py`): one entry point for every dataset
(EuRoC, TUM-VI, TUM RGB-D, KITTI) and sensor, through the port's `System`.
It loads the timestamps and IMU, feeds the frames (optionally paced to the
camera rate), writes the trajectories, map dumps and Atlas, and scores the
trajectory against a ground truth when one is given.

Usage:
  python -m morb_slam_tpu_torch.examples.run_dataset \
      --dataset euroc --sensor stereo-inertial \
      --root /data/MH01 --settings EuRoC.yaml --vocab voc.npz \
      --traj traj_tum.txt --traj-format tum --map-ply map.ply \
      [--gt state_groundtruth.csv --max-frames 500 --realtime] \
      [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True,
                   choices=["euroc", "tum-vi", "tum-rgbd", "kitti"])
    p.add_argument("--sensor", required=True,
                   choices=["mono", "stereo", "rgbd", "mono-inertial",
                            "stereo-inertial"])
    p.add_argument("--root", required=True, help="sequence directory")
    p.add_argument("--settings", required=True, help="settings YAML")
    p.add_argument("--vocab", default=None, help="vocabulary .npz")
    p.add_argument("--traj", default=None, help="trajectory output path")
    p.add_argument("--traj-format", default="tum",
                   choices=["tum", "euroc", "kitti"])
    p.add_argument("--kf-traj", default=None,
                   help="keyframe trajectory output (TUM format)")
    p.add_argument("--map-ply", default=None, help="map point-cloud dump")
    p.add_argument("--map-svg", default=None, help="top-down SVG dump")
    p.add_argument("--save-atlas", default=None)
    p.add_argument("--load-atlas", default=None)
    p.add_argument("--gt", default=None, help="ground-truth file for ATE")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--skip", type=int, default=0, help="frames to skip")
    p.add_argument("--depth-factor", type=float, default=5000.0,
                   help="TUM-RGBD depth scaling (DepthMapFactor)")
    p.add_argument("--realtime", action="store_true",
                   help="pace the feed to the camera period (reference "
                        "example mains usleep pacing)")
    p.add_argument("--times", default=None,
                   help="dump per-stage timing stats to this file "
                        "(reference ExecTimeMean.txt)")
    p.add_argument("--max-kf", type=int, default=None,
                   help="keyframe capacity override")
    p.add_argument("--max-lm", type=int, default=None,
                   help="landmark capacity override")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for the "
                        "plain PyTorch path)")
    return p


def load_sequence(args):
    from ..io import datasets
    inertial = "inertial" in args.sensor
    if args.dataset == "euroc":
        return datasets.load_euroc(args.root,
                                   stereo=args.sensor.startswith("stereo"),
                                   imu=inertial)
    if args.dataset == "tum-vi":
        return datasets.load_tum_vi(args.root, imu=inertial)
    if args.dataset == "tum-rgbd":
        return datasets.load_tum_rgbd(args.root)
    if args.dataset == "kitti":
        return datasets.load_kitti(
            args.root, stereo=args.sensor.startswith("stereo"))
    raise ValueError(args.dataset)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .. import system as system_mod, viz
    from ..utils import profiling, verbose

    verbose.set_level(verbose.Level.NORMAL)
    sensor = {
        "mono": system_mod.Sensor.MONOCULAR,
        "stereo": system_mod.Sensor.STEREO,
        "rgbd": system_mod.Sensor.RGBD,
        "mono-inertial": system_mod.Sensor.IMU_MONOCULAR,
        "stereo-inertial": system_mod.Sensor.IMU_STEREO,
    }[args.sensor]

    seq = load_sequence(args)
    frames = seq.frames[args.skip:]
    if args.max_frames:
        frames = frames[:args.max_frames]
    verbose.print_mess(f"{len(frames)} frames loaded from {args.root}")

    overrides = {}
    if args.max_kf:
        overrides["max_kf"] = args.max_kf
    if args.max_lm:
        overrides["max_lm"] = args.max_lm
    slam = system_mod.System(args.settings, sensor,
                             vocabulary_path=args.vocab,
                             tracker_overrides=overrides or None,
                             device=args.device)
    if args.load_atlas:
        slam.load_atlas(args.load_atlas)

    timers = profiling.global_timers()
    t_start = time.perf_counter()
    prev_ts = None
    n_ok = 0
    for i, fr in enumerate(frames):
        imu_batch = None
        if "inertial" in args.sensor and seq.imu_ts is not None \
                and prev_ts is not None:
            imu_batch = seq.imu_between(prev_ts, fr.ts)
        t_frame = time.perf_counter()
        if args.sensor.startswith("stereo"):
            state, pose = slam.track_stereo(fr.load_left(), fr.load_right(),
                                            fr.ts, imu_batch=imu_batch)
        elif args.sensor == "rgbd":
            state, pose = slam.track_rgbd(
                fr.load_left(), fr.load_depth(args.depth_factor), fr.ts)
        else:
            state, pose = slam.track_monocular(fr.load_left(), fr.ts,
                                               imu_batch=imu_batch)
        n_ok += state == "OK"
        if args.realtime and prev_ts is not None:
            budget = fr.ts - prev_ts
            spent = time.perf_counter() - t_frame
            if spent < budget:
                time.sleep(budget - spent)
        prev_ts = fr.ts
        if (i + 1) % 100 == 0:
            fps = (i + 1) / (time.perf_counter() - t_start)
            verbose.print_mess(
                f"frame {i + 1}/{len(frames)} state={state} fps={fps:.1f}")
    elapsed = time.perf_counter() - t_start
    fps = len(frames) / elapsed

    if args.traj:
        {"tum": slam.save_trajectory_tum,
         "euroc": slam.save_trajectory_euroc,
         "kitti": slam.save_trajectory_kitti}[args.traj_format](args.traj)
    if args.kf_traj:
        slam.save_keyframe_trajectory_tum(args.kf_traj)
    if args.save_atlas:
        slam.save_atlas(args.save_atlas)
    if args.map_ply:
        viz.write_ply(args.map_ply, slam.tracker.m)
    if args.map_svg:
        traj = [p for _, p in slam.tracker.trajectory_world()]
        viz.write_svg(args.map_svg, slam.tracker.m, traj)
    if args.times and timers.enabled:
        timers.save(args.times)
        verbose.print_mess(timers.report())

    result = {"frames": len(frames), "ok_frames": int(n_ok),
              "fps": round(fps, 2),
              "keyframes": int(slam.tracker.n_kf_host),
              "loops_closed": int(slam.tracker.n_loops_closed)}
    if args.gt and args.traj and args.traj_format == "tum":
        from ..eval import ate
        res = ate.evaluate(args.gt, args.traj,
                           with_scale=args.sensor == "mono",
                           device=args.device)
        result["ate_rmse"] = round(res["rmse"], 5)
    print(json.dumps(result))
    return 0


def evaluate_sequence(root: str, sensor: str = "mono",
                      max_frames: int = None, vocab=None, device=None):
    """EuRoC evaluation in code: EuRoC's cam0 calibration built in (the
    values are fixed for the dataset), the whole sequence through `System`
    on `device` (default: the card), and the ATE against
    mav0/state_groundtruth_estimate0 when present, aligned on that device. Returns a result dict."""
    import os

    import numpy as np
    import torch

    from .. import alignment
    from .. import system as system_mod
    from ..io import config, datasets

    s = config.Settings()
    s.cam1 = config.CameraSettings(
        model="PinHole", fx=458.654, fy=457.296, cx=367.215, cy=248.375,
        width=752, height=480,
        dist=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05))
    s.n_features = 1200
    s.n_levels = 8
    sensor_enum = {"mono": system_mod.Sensor.MONOCULAR,
                   "stereo": system_mod.Sensor.STEREO}[sensor]
    seq = datasets.load_euroc(root, stereo=sensor.startswith("stereo"),
                              imu=False)
    frames = seq.frames[:max_frames] if max_frames else seq.frames
    slam = system_mod.System(s, sensor_enum, vocabulary=vocab,
                             device=device)
    t0 = time.perf_counter()
    n_ok = 0
    for fr in frames:
        if sensor.startswith("stereo"):
            st, _ = slam.track_stereo(fr.load_left(), fr.load_right(),
                                      fr.ts)
        else:
            st, _ = slam.track_monocular(fr.load_left(), fr.ts)
        n_ok += st == "OK"
    fps = len(frames) / (time.perf_counter() - t0)
    result = {"frames": len(frames), "ok_frames": int(n_ok),
              "fps": round(fps, 2),
              "keyframes": int(slam.tracker.n_kf_host)}
    gt_csv = os.path.join(root, "mav0", "state_groundtruth_estimate0",
                          "data.csv")
    if os.path.isfile(gt_csv):
        gt_raw = np.loadtxt(gt_csv, delimiter=",", usecols=(0, 1, 2, 3),
                            skiprows=1)
        gt_ts = gt_raw[:, 0] * 1e-9
        traj = slam.tracker.trajectory_world()
        est, gtp = [], []
        for ts, p in traj:
            j = int(np.argmin(np.abs(gt_ts - ts)))
            if abs(gt_ts[j] - ts) < 0.02:
                est.append(p)
                gtp.append(gt_raw[j, 1:4])
        if len(est) > 10:
            dev = slam.tracker.device
            rmse, _, _, _ = alignment.ate_rmse(
                torch.tensor(np.asarray(est), dtype=torch.float32,
                             device=dev),
                torch.tensor(np.asarray(gtp), dtype=torch.float32,
                             device=dev),
                with_scale=sensor == "mono")
            result["ate_rmse"] = round(float(rmse), 5)
    return result


if __name__ == "__main__":
    sys.exit(main())
