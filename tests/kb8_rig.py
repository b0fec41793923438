"""A KB8 fisheye two-camera rig over the tests' plane world, for the rig
tests of both packages: raw, non-rectified 384x288 pairs made by rendering
a wide pinhole view of each camera with `synthetic_world.PlaneWorld` and
remapping it into that camera's Kannala-Brandt-8 model (the port's plain
K8, `rectify.remap_bilinear`), truncated to uint8.

cam0 carries TUM-VI's cam0 distortion (ORB-SLAM3's TUM-VI.yaml) at fx = fy
= 170 for 384x288; cam1 is a slightly different KB8 whose centre lies
0.10 m to the right of cam0's, rotated 1 degree about y:
X_cam1 = R_RL X_cam0 + T_RL.

The world is the plane world shrunk by WORLD_SCALE (its planes at 1.6-4 m
instead of 3.2-8 m: a room, as TUM-VI's rooms are, where the rig's 0.10 m
baseline triangulates): a pose (R, t) of the shrunk world renders the
plane world at (R, t / WORLD_SCALE), and the baseline there is
0.10 / WORLD_SCALE. Camera paths and ground truth are in the shrunk
world's metres.
"""
import numpy as np
import torch

from synthetic_world import PlaneWorld

W, H = 384, 288
CAM0 = (170.0, 170.0, 192.0, 144.0,
        0.00348238, 0.000715034, -0.00205323, 0.000202936)
CAM1 = (170.6, 170.4, 193.5, 143.2,
        0.00340372, 0.000714185, -0.00201631, 0.000193335)
BASELINE = 0.10
_a = np.deg2rad(1.0)
R_RL = np.array([[np.cos(_a), 0.0, np.sin(_a)], [0.0, 1.0, 0.0],
                 [-np.sin(_a), 0.0, np.cos(_a)]])
T_RL = -R_RL @ np.array([BASELINE, 0.0, 0.0])
WORLD_SCALE = 0.5
# the wide pinhole source of each remap: 63 degrees half-width
WP, HP, FP = 800, 600, 200.0


def kb8_map(cam):
    """Raw KB8 pixel -> source pinhole pixel (x, y), float32 (H, W, 2):
    theta_d inverted by 10 Newton steps in float64."""
    fx, fy, cx, cy, k1, k2, k3, k4 = cam
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    dx, dy = (u - cx) / fx, (v - cy) / fy
    r_d = np.sqrt(dx ** 2 + dy ** 2)
    th = r_d.copy()
    for _ in range(10):
        t2 = th * th
        f = th * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - r_d
        fp = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        th = th - f / np.clip(fp, 0.5, None)
    r_p = np.tan(np.clip(th, 0, 1.45))
    scale = np.where(r_d > 1e-9, r_p / np.clip(r_d, 1e-9, None), 1.0)
    return np.stack([(WP / 2 + FP * dx * scale).astype(np.float32),
                     (HP / 2 + FP * dy * scale).astype(np.float32)], -1)


class Rig:
    """The plane world (seed 0) seen through both cameras of the rig."""

    def __init__(self, seed=0):
        Kp = np.array([[FP, 0, WP / 2], [0, FP, HP / 2], [0, 0, 1.0]])
        self.world = PlaneWorld(Kp, WP, HP, seed=seed)
        self.maps = [torch.from_numpy(kb8_map(c)) for c in (CAM0, CAM1)]

    def _raw(self, R, t, k):
        from morb_slam_tpu_torch.ops import rectify
        src = torch.from_numpy(self.world.render(R.astype(np.float32),
                                                 t.astype(np.float32)))
        out = rectify.remap_bilinear(src, self.maps[k])
        return np.clip(out.numpy(), 0, 255).astype(np.uint8)

    def pair(self, R_cw, t_cw):
        """uint8 (left, right) raw images with cam0 at T_c0_w = (R, t) in
        the shrunk world."""
        R = np.asarray(R_cw, np.float64)
        t = np.asarray(t_cw, np.float64)
        return (self._raw(R, t / WORLD_SCALE, 0),
                self._raw(R_RL @ R, (R_RL @ t + T_RL) / WORLD_SCALE, 1))


def port_rig(device="cpu"):
    from morb_slam_tpu_torch import cameras
    return (cameras.kannala_brandt8(*CAM0, device=device),
            (cameras.kannala_brandt8(*CAM1, device=device),
             torch.tensor(R_RL, dtype=torch.float32, device=device),
             torch.tensor(T_RL, dtype=torch.float32, device=device)))


def jax_rig():
    import jax.numpy as jnp
    from morb_slam_tpu import cameras
    return (cameras.kannala_brandt8(*CAM0),
            (cameras.kannala_brandt8(*CAM1),
             jnp.asarray(R_RL, jnp.float32), jnp.asarray(T_RL, jnp.float32)))
