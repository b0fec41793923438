"""System: the public facade (counterpart of `morb_slam_tpu/system.py`).

One object built from `Settings` (or a YAML path) that owns the tracker and
feeds it frames: `track_monocular`, `track_stereo` (raw pairs are rectified
on the card by K8 with maps built once) and `track_rgbd`, plus the
localization-mode toggles, `reset` and `state`. The inertial sensors
(IMU_MONOCULAR, IMU_STEREO, IMU_RGBD) build the IMU calibration from
`settings.imu` (noise densities, random walks, rate, `T_b_c1`) and take
each frame's samples as `imu_batch=(timestamps, acc, gyro)`. A vocabulary
(`vocabulary=` or `vocabulary_path=`, `.npz` or ORBvoc `.txt`) gives the
tracker BoW relocalization and, with `settings.loop_closing` (the
default), loop closing, the Atlas merge and the detached global BA;
`loopClosing: 0` keeps relocalization only. Atlas save / load (and the
trajectory writers) belong to the persistence slice of the port;
`settings.load_atlas` raises `NotImplementedError` here.
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from . import imu as imu_mod
from .io import config as config_mod
from .io import serialization
from .ops import rectify as rectify_mod
from .pipeline import tracking


class Sensor(enum.Enum):
    MONOCULAR = "monocular"
    STEREO = "stereo"
    RGBD = "rgbd"
    IMU_MONOCULAR = "imu-monocular"
    IMU_STEREO = "imu-stereo"
    IMU_RGBD = "imu-rgbd"

    @property
    def inertial(self):
        return self.name.startswith("IMU")

    @property
    def stereo(self):
        return "STEREO" in self.name

    @property
    def rgbd(self):
        return "RGBD" in self.name


class System:
    """Construct from a Settings object (or YAML path), feed frames, read
    the tracker's state. `device=None` runs on the card and raises without
    one; pass device="cpu" for the plain PyTorch path."""

    def __init__(self, settings, sensor: Sensor, vocabulary=None,
                 vocabulary_path: Optional[str] = None,
                 tracker_overrides: Optional[dict] = None, device=None):
        if isinstance(settings, str):
            settings = config_mod.load_settings(settings)
        if sensor.inertial and settings.imu is None:
            raise ValueError("an inertial sensor needs settings.imu")
        if settings.load_atlas:
            raise NotImplementedError(
                "atlas load / save comes with the persistence slice of the "
                "port")
        self.settings = settings
        self.sensor = sensor
        self.device = tracking.resolve_device(device)
        if vocabulary is None and vocabulary_path:
            vocabulary = serialization.load_vocabulary(vocabulary_path)
        self.voc = None if vocabulary is None else vocabulary.to(self.device)

        cam = settings.cam1.to_camera()
        width = settings.cam1.width or 752
        height = settings.cam1.height or 480
        focal = settings.cam1.fx
        baseline = settings.baseline if (sensor.stereo or sensor.rgbd) \
            else 0.0
        # raw stereo (distorted pinhole or KB8 fisheye) is remapped every
        # frame into an ideal rectified pinhole pair
        self.rectify = None
        if (sensor.stereo and settings.cam2 is not None
                and settings.T_c1_c2 is not None
                and settings.cam1.model != "Rectified"):
            self.rectify = rectify_mod.build_rectify_maps(
                cam, settings.cam2.to_camera(), settings.T_c1_c2, width,
                height, device=self.device)
            self._maps = torch.stack([self.rectify.map1, self.rectify.map2])
            cam = self.rectify.cam_new
            focal = float(cam.params[0])
            baseline = float(self.rectify.baseline)
        calib = None
        if sensor.inertial:
            i = settings.imu
            R_bc, t_bc = np.eye(3), np.zeros(3)
            if i.T_b_c1 is not None:
                T = np.asarray(i.T_b_c1, np.float64)
                R_bc, t_bc = T[:3, :3], T[:3, 3]
            if self.rectify is not None:
                # rectification rotates camera 1's frame by R_rect1
                R_bc = R_bc @ self.rectify.R_rect1.cpu().numpy().T
            calib = imu_mod.make_calib(R_bc, t_bc, i.noise_gyro, i.noise_acc,
                                       i.walk_gyro, i.walk_acc, i.frequency,
                                       device=self.device)
        kw = dict(width=width, height=height, focal=focal,
                  n_feat=settings.n_features, scale=settings.scale_factor,
                  n_levels=settings.n_levels, baseline=baseline,
                  th_depth=settings.th_depth,
                  th_far_points=settings.th_far_points)
        if tracker_overrides:
            kw.update(tracker_overrides)
        self.tracker = tracking.Tracker(cam, tracking.TrackerConfig(**kw),
                                        device=self.device, voc=self.voc,
                                        imu_calib=calib)
        self._drop_loop_closer()
        self.localization_only = False

    def _drop_loop_closer(self):
        """loopClosing: 0 keeps the database for relocalization only."""
        if not self.settings.loop_closing:
            self.tracker.loop_closer = None

    # ---- frame feeds ----------------------------------------------------

    def track_monocular(self, img, ts: float, imu_batch=None):
        """`imu_batch`: (timestamps (n,), acc (n, 3), gyro (n, 3)) of the
        samples since the previous frame, for an inertial sensor."""
        if self.sensor.inertial and imu_batch is not None:
            ts_i, acc, gyro = imu_batch
            return self.tracker.track_mono_inertial(img, ts, acc, gyro, ts_i)
        return self.tracker.track_mono(img, ts)

    def track_stereo(self, img_l, img_r, ts: float, imu_batch=None):
        if self.rectify is not None:
            pair = torch.stack([self.tracker._to_device(img_l),
                                self.tracker._to_device(img_r)])
            img_l, img_r = rectify_mod.remap_bilinear(
                pair.to(torch.float32), self._maps)
        if self.sensor.inertial and imu_batch is not None:
            ts_i, acc, gyro = imu_batch
            return self.tracker.track_stereo_inertial(img_l, img_r, ts, acc,
                                                      gyro, ts_i)
        return self.tracker.track_stereo(img_l, img_r, ts)

    def track_rgbd(self, img, depth, ts: float, imu_batch=None):
        if self.sensor.inertial and imu_batch is not None:
            ts_i, acc, gyro = imu_batch
            return self.tracker.track_rgbd_inertial(img, depth, ts, acc,
                                                    gyro, ts_i)
        return self.tracker.track_rgbd(img, depth, ts)

    # ---- modes / control ------------------------------------------------

    def activate_localization_mode(self):
        """Stop mapping, track only."""
        self.localization_only = True
        self.tracker._mapping_enabled = False

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker._mapping_enabled = True

    def reset(self):
        """Fresh map, same camera, configuration, vocabulary and IMU
        calibration."""
        t = self.tracker
        self.tracker = tracking.Tracker(t.cam, t.cfg, device=self.device,
                                        voc=self.voc, imu_calib=t.calib)
        self._drop_loop_closer()

    @property
    def state(self):
        return self.tracker.state
