"""Dataset loaders: EuRoC, TUM-VI, TUM RGB-D and KITTI odometry
(counterpart of `morb_slam_tpu/io/datasets.py`).

Each loader returns a `Sequence` of timestamped frame records whose images
load on demand (`load_left`, `load_right`, `load_depth`), and the IMU
samples as contiguous arrays with `imu_between(t0, t1)` giving a frame's
batch. Images decode through the port's native loader; cv2 is used only
where that library is unavailable (16-bit depth PNGs, which the native
decoder turns into grey levels, always go through cv2).
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def _imread_gray(path: str) -> np.ndarray:
    """float32 (H, W) grey image: the native decoder first, cv2 where that
    cannot read the file and cv2 imports; with neither, the reason the
    native decoder failed."""
    from . import native_loader
    img = native_loader.decode_gray(path)
    if img is not None:
        return img
    try:
        import cv2
    except ImportError:
        why = native_loader.build_error() or "not a readable PNG / PGM / PPM"
        raise RuntimeError(f"cannot read {path} without cv2: {why}") from None
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


@dataclass
class FrameRecord:
    ts: float
    path_left: str
    path_right: Optional[str] = None
    path_depth: Optional[str] = None

    def load_left(self):
        return _imread_gray(self.path_left)

    def load_right(self):
        return _imread_gray(self.path_right)

    def load_depth(self, factor: float = 1.0):
        import cv2
        d = cv2.imread(self.path_depth, cv2.IMREAD_UNCHANGED)
        return d.astype(np.float32) / factor


@dataclass
class Sequence:
    frames: List[FrameRecord]
    imu_ts: Optional[np.ndarray] = None       # (N,) seconds
    imu_gyro: Optional[np.ndarray] = None     # (N, 3) rad/s
    imu_acc: Optional[np.ndarray] = None      # (N, 3) m/s^2

    def imu_between(self, t0: float, t1: float):
        """IMU samples with t0 < t <= t1 (the reference's per-frame batch,
        Tracking::GrabImuData / PreintegrateIMU semantics)."""
        if self.imu_ts is None:
            return None
        i0 = np.searchsorted(self.imu_ts, t0, side="right")
        i1 = np.searchsorted(self.imu_ts, t1, side="right")
        return (self.imu_ts[i0:i1], self.imu_acc[i0:i1], self.imu_gyro[i0:i1])


def load_euroc(root: str, stereo: bool = True, imu: bool = False) -> Sequence:
    """EuRoC MAV format: <root>/mav0/cam0/data.csv + data/<ts>.png
    (reference Examples/Stereo-Inertial/stereo_inertial_euroc.cc
    LoadImages/LoadIMU)."""
    cam0 = os.path.join(root, "mav0", "cam0")
    cam1 = os.path.join(root, "mav0", "cam1")
    frames = []
    with open(os.path.join(cam0, "data.csv")) as f:
        for row in csv.reader(f):
            if row[0].startswith("#"):
                continue
            ts_ns = int(row[0])
            name = row[1].strip() if len(row) > 1 else f"{ts_ns}.png"
            left = os.path.join(cam0, "data", name)
            right = os.path.join(cam1, "data", name) if stereo else None
            frames.append(FrameRecord(ts=ts_ns * 1e-9, path_left=left,
                                      path_right=right))
    seq = Sequence(frames=frames)
    if imu:
        ts, gyro, acc = [], [], []
        with open(os.path.join(root, "mav0", "imu0", "data.csv")) as f:
            for row in csv.reader(f):
                if row[0].startswith("#"):
                    continue
                ts.append(int(row[0]) * 1e-9)
                gyro.append([float(x) for x in row[1:4]])
                acc.append([float(x) for x in row[4:7]])
        seq.imu_ts = np.asarray(ts)
        seq.imu_gyro = np.asarray(gyro, np.float32)
        seq.imu_acc = np.asarray(acc, np.float32)
    return seq


def load_tum_vi(root: str, imu: bool = False) -> Sequence:
    """TUM-VI uses the same mav0 layout as EuRoC."""
    return load_euroc(root, stereo=True, imu=imu)


def load_tum_rgbd(root: str, association_file: Optional[str] = None
                  ) -> Sequence:
    """TUM RGB-D format: rgb.txt + depth.txt (+ optional associations from
    the reference's evaluation/associate.py protocol)."""
    def read_list(name):
        out = []
        with open(os.path.join(root, name)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, path = line.split()[:2]
                out.append((float(ts), os.path.join(root, path)))
        return out

    if association_file:
        frames = []
        with open(association_file) as f:
            for line in f:
                if not line.strip() or line.startswith("#"):
                    continue
                p = line.split()
                frames.append(FrameRecord(
                    ts=float(p[0]), path_left=os.path.join(root, p[1]),
                    path_depth=os.path.join(root, p[3])))
        return Sequence(frames=frames)
    rgb = read_list("rgb.txt")
    depth = read_list("depth.txt")
    dts = np.asarray([t for t, _ in depth])
    frames = []
    for t, p in rgb:
        j = int(np.argmin(np.abs(dts - t)))
        if abs(dts[j] - t) < 0.02:
            frames.append(FrameRecord(ts=t, path_left=p,
                                      path_depth=depth[j][1]))
    return Sequence(frames=frames)


def load_kitti(root: str, stereo: bool = True) -> Sequence:
    """KITTI odometry format: image_0/ image_1/ + times.txt."""
    times = [float(x) for x in open(os.path.join(root, "times.txt"))]
    frames = []
    for i, t in enumerate(times):
        name = f"{i:06d}.png"
        frames.append(FrameRecord(
            ts=t,
            path_left=os.path.join(root, "image_0", name),
            path_right=os.path.join(root, "image_1", name) if stereo
            else None))
    return Sequence(frames=frames)
