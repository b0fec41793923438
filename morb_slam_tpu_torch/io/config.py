"""Settings: typed configuration, built in code or loaded from the
reference's v1.0 YAML (counterpart of `morb_slam_tpu/io/config.py`).

One dataclass covers the key surface: camera intrinsics and distortion for
both cameras, stereo extrinsics, IMU noise and extrinsics, ORB extractor
parameters and system toggles. `yaml` is imported inside `load_settings`
only, so settings built in code need no YAML parser.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import cameras


@dataclass
class CameraSettings:
    model: str = "PinHole"            # PinHole | Rectified | KannalaBrandt8
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    dist: tuple = ()                  # k1 k2 p1 p2 k3 | k1..k4 fisheye
    width: int = 0
    height: int = 0

    def to_camera(self) -> cameras.Camera:
        if self.model == "KannalaBrandt8":
            k = list(self.dist) + [0.0] * (4 - len(self.dist))
            return cameras.kannala_brandt8(self.fx, self.fy, self.cx,
                                           self.cy, *k[:4])
        dist = self.dist if self.model == "PinHole" else ()
        return cameras.pinhole(self.fx, self.fy, self.cx, self.cy,
                               dist=list(dist) if dist else None)


@dataclass
class ImuSettings:
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3.0e-3
    frequency: float = 200.0
    T_b_c1: Optional[np.ndarray] = None    # (4, 4) camera->body


@dataclass
class Settings:
    sensor: str = "monocular"   # monocular|stereo|rgbd + -inertial suffixes
    cam1: CameraSettings = field(default_factory=CameraSettings)
    cam2: Optional[CameraSettings] = None
    T_c1_c2: Optional[np.ndarray] = None   # (4, 4) stereo extrinsics
    baseline: float = 0.0
    bf: float = 0.0                         # baseline * fx
    th_depth: float = 35.0
    depth_map_factor: float = 1.0
    imu: Optional[ImuSettings] = None
    fps: float = 30.0
    rgb: bool = True
    n_features: int = 1200
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    load_atlas: str = ""
    save_atlas: str = ""
    # landmarks beyond this camera distance (m) are discarded; 0 disables
    th_far_points: float = 0.0
    # 0 disables the loop-closing stage
    loop_closing: bool = True


def _cam_from_yaml(d: dict, prefix: str) -> Optional[CameraSettings]:
    if f"{prefix}.fx" not in d:
        return None
    model = d.get("Camera.type", d.get(f"{prefix}.type", "PinHole"))
    dist_keys_pin = ["k1", "k2", "p1", "p2", "k3"]
    dist_keys_kb = ["k1", "k2", "k3", "k4"]
    keys = dist_keys_kb if model == "KannalaBrandt8" else dist_keys_pin
    dist = tuple(float(d[f"{prefix}.{k}"]) for k in keys
                 if f"{prefix}.{k}" in d)
    return CameraSettings(
        model=model,
        fx=float(d[f"{prefix}.fx"]), fy=float(d[f"{prefix}.fy"]),
        cx=float(d[f"{prefix}.cx"]), cy=float(d[f"{prefix}.cy"]),
        dist=dist,
        width=int(d.get("Camera.width", 0)),
        height=int(d.get("Camera.height", 0)))


def load_settings(path: str) -> Settings:
    """Parse a reference-format YAML (v1.0 `File.version` keys like
    Camera1.fx, or legacy Camera.fx)."""
    import yaml
    with open(path) as f:
        text = f.read()
    if text.startswith("%YAML"):
        text = text.split("\n", 1)[1]
    d = yaml.safe_load(text) or {}
    # flatten one level of nesting if the yaml used mappings
    flat = {}
    for k, v in d.items():
        if isinstance(v, dict) and "data" not in v:
            for k2, v2 in v.items():
                flat[f"{k}.{k2}"] = v2
        else:
            flat[k] = v     # opencv-matrix style {rows, cols, data} kept
    d = flat

    s = Settings()
    cam1 = _cam_from_yaml(d, "Camera1") or _cam_from_yaml(d, "Camera")
    if cam1 is None:
        raise ValueError(f"no camera intrinsics in {path}")
    s.cam1 = cam1
    s.cam2 = _cam_from_yaml(d, "Camera2")
    if "Stereo.T_c1_c2" in d:
        td = d["Stereo.T_c1_c2"]
        data = td["data"] if isinstance(td, dict) else td
        s.T_c1_c2 = np.asarray(data, np.float64).reshape(4, 4)
        s.baseline = float(np.linalg.norm(s.T_c1_c2[:3, 3]))
        s.bf = s.baseline * s.cam1.fx
    if "Camera.bf" in d:
        s.bf = float(d["Camera.bf"])
        s.baseline = s.bf / s.cam1.fx
    s.th_depth = float(d.get("Stereo.ThDepth", d.get("ThDepth", 35.0)))
    s.depth_map_factor = float(d.get("RGBD.DepthMapFactor",
                                     d.get("DepthMapFactor", 1.0)))
    s.fps = float(d.get("Camera.fps", 30.0))
    s.rgb = bool(d.get("Camera.RGB", 1))
    s.n_features = int(d.get("ORBextractor.nFeatures", 1200))
    s.n_levels = int(d.get("ORBextractor.nLevels", 8))
    s.scale_factor = float(d.get("ORBextractor.scaleFactor", 1.2))
    s.ini_th_fast = float(d.get("ORBextractor.iniThFAST", 20))
    s.min_th_fast = float(d.get("ORBextractor.minThFAST", 7))
    s.load_atlas = d.get("System.LoadAtlasFromFile", "")
    s.save_atlas = d.get("System.SaveAtlasToFile", "")
    s.th_far_points = float(d.get("System.thFarPoints",
                                  d.get("thFarPoints", 0.0)))
    s.loop_closing = bool(int(d.get("loopClosing", 1)))
    if "IMU.NoiseGyro" in d:
        T = None
        if "IMU.T_b_c1" in d:
            td = d["IMU.T_b_c1"]
            data = td["data"] if isinstance(td, dict) else td
            T = np.asarray(data, np.float64).reshape(4, 4)
        s.imu = ImuSettings(
            noise_gyro=float(d["IMU.NoiseGyro"]),
            noise_acc=float(d["IMU.NoiseAcc"]),
            walk_gyro=float(d["IMU.GyroWalk"]),
            walk_acc=float(d["IMU.AccWalk"]),
            frequency=float(d.get("IMU.Frequency", 200.0)),
            T_b_c1=T)
    return s
