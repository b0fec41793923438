"""Live-camera / video-stream runner, visual and visual-inertial
(counterpart of `morb_slam_tpu/examples/run_live.py`).

Frames come through OpenCV's VideoCapture (imported inside `main`): a
V4L2 device index ("0"), a GStreamer pipeline, an RTSP URL or a video
file, timestamped from the capture clock (CAP_PROP_POS_MSEC where the
source gives it, the wall clock otherwise), and go to the port's `System`.

IMU (`--imu`): a CSV file of `timestamp_s,gx,gy,gz,ax,ay,az` rows (rad/s,
m/s^2; `#` comments ignored), replayed in step with the frames, or
`udp://BIND_HOST:PORT`, live datagrams of the same lines. Each frame takes
the samples in (t_prev, t_frame].

Usage:
  python -m morb_slam_tpu_torch.examples.run_live \
      --source 0 --settings cam.yaml [--vocab voc.npz] [--imu imu.csv] \
      [--max-frames 1000] [--traj traj_tum.txt] [--map-ply map.ply] \
      [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", required=True,
                   help="VideoCapture source: device index, URL or file")
    p.add_argument("--settings", required=True, help="settings YAML")
    p.add_argument("--vocab", default=None,
                   help="vocabulary (.npz or ORBvoc-format .txt)")
    p.add_argument("--imu", default=None,
                   help="IMU stream: CSV file or udp://host:port "
                        "(ts,gx,gy,gz,ax,ay,az rows)")
    p.add_argument("--traj", default=None, help="TUM trajectory output")
    p.add_argument("--map-ply", default=None, help="map point-cloud dump")
    p.add_argument("--save-atlas", default=None)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--gray", action="store_true", default=True,
                   help="convert to grayscale (default)")
    p.add_argument("--max-kf", type=int, default=None)
    p.add_argument("--max-lm", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; cpu for the "
                        "plain PyTorch path)")
    return p


class ImuSource:
    """Gyro/accel sample feed: CSV file replay or live UDP line stream.
    `take_until(ts)` returns (ts_arr, acc, gyro) for samples in
    (last_taken, ts] — the per-frame batch contract."""

    def __init__(self, spec: str):
        import numpy as np
        self._np = np
        self._buf = []          # (ts, gx, gy, gz, ax, ay, az)
        self._sock = None
        if spec.startswith("udp://"):
            import socket
            import threading
            host, port = spec[6:].rsplit(":", 1)
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.bind((host or "0.0.0.0", int(port)))
            self._lock = threading.Lock()
            th = threading.Thread(target=self._recv_loop, daemon=True)
            th.start()
        else:
            with open(spec) as f:
                for line in f:
                    self._push_line(line)
            self._lock = None

    def _push_line(self, line: str):
        line = line.strip()
        if not line or line.startswith("#"):
            return
        parts = line.replace(",", " ").split()
        if len(parts) < 7:
            return
        try:
            row = tuple(float(x) for x in parts[:7])
        except ValueError:
            return
        self._buf.append(row)

    def _recv_loop(self):
        while True:
            data, _ = self._sock.recvfrom(65536)
            with self._lock:
                for line in data.decode(errors="ignore").splitlines():
                    self._push_line(line)

    def take_until(self, ts: float):
        np = self._np
        if self._lock is not None:
            with self._lock:
                buf, self._buf = self._buf, []
        else:
            take = [r for r in self._buf if r[0] <= ts]
            self._buf = [r for r in self._buf if r[0] > ts]
            buf = take
        if not buf:
            return (np.zeros(0), np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.float32))
        arr = np.asarray(buf, np.float64)
        order = np.argsort(arr[:, 0])
        arr = arr[order]
        return (arr[:, 0],
                arr[:, 4:7].astype(np.float32),    # accel
                arr[:, 1:4].astype(np.float32))    # gyro


def main(argv=None):
    args = build_parser().parse_args(argv)
    import cv2
    import numpy as np

    from .. import system as system_mod, viz
    from ..utils import verbose

    verbose.set_level(verbose.Level.NORMAL)
    src = int(args.source) if args.source.isdigit() else args.source
    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        print(f"cannot open capture source {args.source!r}",
              file=sys.stderr)
        return 1

    overrides = {}
    if args.max_kf:
        overrides["max_kf"] = args.max_kf
    if args.max_lm:
        overrides["max_lm"] = args.max_lm
    imu_src = ImuSource(args.imu) if args.imu else None
    sensor = system_mod.Sensor.IMU_MONOCULAR if imu_src else \
        system_mod.Sensor.MONOCULAR
    slam = system_mod.System(args.settings, sensor,
                             vocabulary_path=args.vocab,
                             tracker_overrides=overrides or None,
                             device=args.device)

    t_wall0 = time.perf_counter()
    n = 0
    n_ok = 0
    state = "NO_IMAGES"
    while args.max_frames is None or n < args.max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        if frame.ndim == 3:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        pos_ms = cap.get(cv2.CAP_PROP_POS_MSEC)
        ts = pos_ms * 1e-3 if pos_ms and pos_ms > 0 else \
            time.perf_counter() - t_wall0
        imu_batch = None
        if imu_src is not None:
            ts_i, acc, gyro = imu_src.take_until(ts)
            imu_batch = (ts_i, acc, gyro)
        state, _ = slam.track_monocular(
            np.ascontiguousarray(frame), ts, imu_batch=imu_batch)
        n_ok += state == "OK"
        n += 1
        if n % 100 == 0:
            fps = n / (time.perf_counter() - t_wall0)
            verbose.print_mess(f"frame {n} state={state} fps={fps:.1f}")
    cap.release()
    if n == 0:
        print("no frames captured", file=sys.stderr)
        return 1

    if args.traj:
        slam.save_trajectory_tum(args.traj)
    if args.map_ply:
        viz.write_ply(args.map_ply, slam.tracker.m)
    if args.save_atlas:
        slam.save_atlas(args.save_atlas)
    print(json.dumps({
        "frames": n, "ok_frames": int(n_ok), "final_state": state,
        "fps": round(n / (time.perf_counter() - t_wall0), 2),
        "keyframes": int(slam.tracker.n_kf_host)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
