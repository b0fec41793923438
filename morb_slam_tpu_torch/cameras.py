"""Camera projection models: pinhole (+ radial-tangential distortion) and
Kannala-Brandt-8 equidistant fisheye.

Counterpart of `morb_slam_tpu/cameras.py`: project / unproject / projection
Jacobian, with the fisheye unprojection solved by a fixed 10-step Newton
scheme. All ops broadcast over leading batch dims of the point tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

CAM_PINHOLE = 0
CAM_FISHEYE = 1


class Camera(NamedTuple):
    """A camera model. `kind` is a python int.

    params layout:
      pinhole: [fx, fy, cx, cy, k1, k2, p1, p2, k3]
      fisheye (KB8): [fx, fy, cx, cy, k1, k2, k3, k4, 0]
    """
    kind: int
    params: torch.Tensor  # (9,) float32

    @property
    def fx(self):
        return self.params[..., 0]

    @property
    def fy(self):
        return self.params[..., 1]

    @property
    def cx(self):
        return self.params[..., 2]

    @property
    def cy(self):
        return self.params[..., 3]

    def K(self):
        fx, fy, cx, cy = self.params[0], self.params[1], self.params[2], \
            self.params[3]
        z = torch.zeros_like(fx)
        o = torch.ones_like(fx)
        return torch.stack([torch.stack([fx, z, cx]),
                            torch.stack([z, fy, cy]),
                            torch.stack([z, z, o])])

    def to(self, device):
        return Camera(self.kind, self.params.to(device))


def pinhole(fx, fy, cx, cy, dist=None, device="cpu") -> Camera:
    d = [0.0] * 5 if dist is None else [float(v) for v in dist][:5]
    d = d + [0.0] * (5 - len(d))
    return Camera(CAM_PINHOLE, torch.tensor(
        [fx, fy, cx, cy] + d, dtype=torch.float32, device=device))


def kannala_brandt8(fx, fy, cx, cy, k1, k2, k3, k4, device="cpu") -> Camera:
    return Camera(CAM_FISHEYE, torch.tensor(
        [fx, fy, cx, cy, k1, k2, k3, k4, 0.0], dtype=torch.float32,
        device=device))


def _nonzero(z, eps):
    return torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)


def project(cam: Camera, pts):
    """Camera-frame 3D points (..., 3) -> undistorted pixel coords (..., 2)."""
    p = cam.params
    if cam.kind == CAM_PINHOLE:
        zs = _nonzero(pts[..., 2], 1e-9)
        return torch.stack([p[0] * (pts[..., 0] / zs) + p[2],
                            p[1] * (pts[..., 1] / zs) + p[3]], dim=-1)
    return _kb8_project(p, pts)


def _kb8_project(p, pts):
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (p[4] + t2 * (p[5] + t2 * (p[6]
                                                          + t2 * p[7]))))
    tiny = r < 1e-9
    r_safe = torch.where(tiny, torch.ones_like(r), r)
    scale = torch.where(tiny, torch.zeros_like(r), theta_d / r_safe)
    return torch.stack([p[0] * scale * x + p[2], p[1] * scale * y + p[3]],
                       dim=-1)


def project_jac(cam: Camera, pts):
    """d(pixel)/d(camera-frame point): (..., 2, 3)."""
    p = cam.params
    fx, fy = p[0], p[1]
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    if cam.kind == CAM_PINHOLE:
        inv_z = 1.0 / _nonzero(z, 1e-9)
        inv_z2 = inv_z * inv_z
        zero = torch.zeros_like(z)
        row0 = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1)
        row1 = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1)
        return torch.stack([row0, row1], dim=-2)
    k1, k2, k3, k4 = p[4], p[5], p[6], p[7]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=1e-18))
    theta = torch.atan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    d_theta_d = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3
                                                         + t2 * 9 * k4)))
    R2 = r2 + z * z
    dth_dx = x * z / (R2 * r)
    dth_dy = y * z / (R2 * r)
    dth_dz = -r / R2
    inv_r = 1.0 / r
    s = theta_d * inv_r
    ds_dx = d_theta_d * dth_dx * inv_r - theta_d * (x * inv_r) * inv_r * inv_r
    ds_dy = d_theta_d * dth_dy * inv_r - theta_d * (y * inv_r) * inv_r * inv_r
    ds_dz = d_theta_d * dth_dz * inv_r
    row0 = torch.stack([fx * (ds_dx * x + s), fx * ds_dy * x,
                        fx * ds_dz * x], dim=-1)
    row1 = torch.stack([fy * ds_dx * y, fy * (ds_dy * y + s),
                        fy * ds_dz * y], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def unproject(cam: Camera, uv):
    """Pixel coords (..., 2) -> unit-depth bearing (..., 3) with z = 1."""
    p = cam.params
    mx = (uv[..., 0] - p[2]) / p[0]
    my = (uv[..., 1] - p[3]) / p[1]
    if cam.kind == CAM_PINHOLE:
        return torch.stack([mx, my, torch.ones_like(mx)], dim=-1)
    k1, k2, k3, k4 = p[4], p[5], p[6], p[7]
    theta_d = torch.sqrt(mx * mx + my * my)
    theta_d_c = torch.clamp(theta_d, -math.pi / 2, math.pi / 2)
    th = theta_d_c
    for _ in range(10):
        t2 = th * th
        f = th * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) \
            - theta_d_c
        fp = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        th = th - f / _nonzero(fp, 1e-8)
    tiny = theta_d < 1e-9
    scale = torch.where(tiny, torch.ones_like(th),
                        torch.tan(th) / torch.where(tiny,
                                                    torch.ones_like(theta_d),
                                                    theta_d))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def unproject_bearing(cam: Camera, uv):
    v = unproject(cam, uv)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def distort(cam: Camera, uv_norm):
    """Apply radtan distortion to normalized coords (..., 2) (pinhole)."""
    p = cam.params
    k1, k2, p1, p2, k3 = p[4], p[5], p[6], p[7], p[8]
    x, y = uv_norm[..., 0], uv_norm[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: Camera, uv):
    """Raw pixel keypoints -> undistorted pixel coords (8 fixed-point steps).
    Fisheye keypoints stay distorted, as in the reference package."""
    if cam.kind != CAM_PINHOLE:
        return uv
    p = cam.params
    d = torch.stack([(uv[..., 0] - p[2]) / p[0], (uv[..., 1] - p[3]) / p[1]],
                    dim=-1)
    x = d
    for _ in range(8):
        x = d - (distort(cam, x) - x)
    return torch.stack([x[..., 0] * p[0] + p[2], x[..., 1] * p[1] + p[3]],
                       dim=-1)


def project_distorted(cam: Camera, pts):
    """Camera-frame 3D -> raw (distorted) pixel coords."""
    p = cam.params
    if cam.kind == CAM_PINHOLE:
        zs = _nonzero(pts[..., 2], 1e-9)
        dn = distort(cam, torch.stack([pts[..., 0] / zs, pts[..., 1] / zs],
                                      dim=-1))
        return torch.stack([p[0] * dn[..., 0] + p[2],
                            p[1] * dn[..., 1] + p[3]], dim=-1)
    return _kb8_project(p, pts)
