"""Stereo rectification: Bouguet-style rectifying rotations, remap grids
built once, and the per-frame bilinear remap (counterpart of
`morb_slam_tpu/ops/rectify.py`).

The maps are built once, in float32, on the tracker's device, through
`cameras.project_distorted` (any camera model, KB8 fisheye included).
`remap_bilinear` is kernel K8: on CUDA tensors it launches
`csrc/remap_bilinear.cu`, both images of a pair in one launch; on CPU
tensors it runs `remap_bilinear_plain`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import cameras, lie
from . import cuda_build

LAUNCHES = {"kernel": 0, "plain": 0}


class RectifyMaps(NamedTuple):
    """Rectification state of one stereo rig.

    map1, map2: (H, W, 2) source pixel coords (x, y) for each rectified
      output pixel of the left / right camera.
    cam_new: rectified pinhole camera (shared intrinsics, no distortion).
    baseline: () rectified baseline (m), a pure x translation.
    R_rect1: (3, 3) rotation applied to the camera-1 frame
      (X_rect = R_rect1 @ X_c1).
    """
    map1: torch.Tensor
    map2: torch.Tensor
    cam_new: cameras.Camera
    baseline: torch.Tensor
    R_rect1: torch.Tensor


def rectifying_rotations(R_12, t_12):
    """Bouguet split-rotation rectification (cv::stereoRectify's scheme).

    T_12 = (R_12, t_12) maps camera-2 points into camera 1
    (X_c1 = R_12 X_c2 + t_12). Returns (R_rect1, R_rect2, baseline) with
    R_rect1 @ R_12 = R_rect2 and R_rect1 @ t_12 = [b, 0, 0]."""
    r = lie.so3_log(R_12)
    A1 = lie.so3_exp(-0.5 * r)          # half-rotation applied to cam1
    A2 = lie.matmat(A1, R_12)           # = exp(+r/2)
    t_h = lie.matvec(A1, t_12)          # baseline in the half-rotated frame
    b = torch.linalg.norm(t_h)
    e1 = t_h / torch.where(b < 1e-12, torch.ones_like(b), b)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=R_12.dtype, device=R_12.device)
    e2 = torch.linalg.cross(up, e1)
    e2 = e2 / torch.clamp(torch.linalg.norm(e2), min=1e-12)
    e3 = torch.linalg.cross(e1, e2)
    Wrow = torch.stack([e1, e2, e3])    # rows
    return lie.matmat(Wrow, A1), lie.matmat(Wrow, A2), b


def _build_map(cam_src: cameras.Camera, R_rect, cam_new: cameras.Camera,
               width: int, height: int):
    """(H, W, 2) source-pixel lookup for one camera: rectified pixel ->
    bearing in the rectified frame -> original camera frame -> distorted
    projection through the original model."""
    dev = R_rect.device
    u = torch.arange(width, dtype=torch.float32, device=dev)
    v = torch.arange(height, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")     # (H, W)
    p = cam_new.params
    xn = torch.stack([(uu - p[2]) / p[0], (vv - p[3]) / p[1],
                      torch.ones_like(uu)], dim=-1)  # (H, W, 3)
    dirs = lie.matvec(R_rect.T[None, None], xn)      # into original cam
    return cameras.project_distorted(cam_src, dirs)


def build_rectify_maps(cam1: cameras.Camera, cam2: cameras.Camera, T_c1_c2,
                       width: int, height: int, focal: float = None,
                       device="cpu") -> RectifyMaps:
    """Both remap grids from the raw calibration (reference
    Settings::precomputeRectificationMaps), in float32 on `device`."""
    T = torch.as_tensor(T_c1_c2, dtype=torch.float32).to(device)
    R_12, t_12 = T[:3, :3], T[:3, 3]
    R_rect1, R_rect2, b = rectifying_rotations(R_12, t_12)
    cam1, cam2 = cam1.to(device), cam2.to(device)
    f = float(focal) if focal is not None else float(cam1.params[0])
    cam_new = cameras.pinhole(f, f, width / 2.0, height / 2.0, device=device)
    return RectifyMaps(map1=_build_map(cam1, R_rect1, cam_new, width, height),
                       map2=_build_map(cam2, R_rect2, cam_new, width, height),
                       cam_new=cam_new, baseline=b, R_rect1=R_rect1)


def remap_bilinear_plain(img, map_xy):
    """Plain version of K8: sample img (B, Hs, Ws) at map_xy (B, H, W, 2 =
    x, y source coords) bilinearly; 0 outside [0, Ws-1] x [0, Hs-1]
    (cv::remap with BORDER_CONSTANT)."""
    LAUNCHES["plain"] += 1
    B, Hs, Ws = img.shape
    x = map_xy[..., 0]
    y = map_xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.clamp(x0.long(), 0, Ws - 1)
    y0i = torch.clamp(y0.long(), 0, Hs - 1)
    x1i = torch.clamp(x0i + 1, 0, Ws - 1)
    y1i = torch.clamp(y0i + 1, 0, Hs - 1)
    flat = img.reshape(B, Hs * Ws)

    def tap(yi, xi):
        return torch.gather(flat, 1, (yi * Ws + xi).reshape(B, -1)).reshape(
            x.shape)
    out = (tap(y0i, x0i) * (1 - fx) * (1 - fy) + tap(y0i, x1i) * fx * (1 - fy)
           + tap(y1i, x0i) * (1 - fx) * fy + tap(y1i, x1i) * fx * fy)
    inside = (x >= 0) & (x <= Ws - 1) & (y >= 0) & (y <= Hs - 1)
    return torch.where(inside, out, torch.zeros_like(out))


def remap_bilinear(img, map_xy):
    """K8: img (Hs, Ws) at map_xy (H, W, 2), or a batch img (B, Hs, Ws) at
    map_xy (B, H, W, 2) in one launch. CUDA tensors: the kernel (raises if
    it cannot run); CPU tensors: the plain version."""
    single = img.dim() == 2
    if single:
        img, map_xy = img[None], map_xy[None]
    if img.device.type == "cpu":
        out = remap_bilinear_plain(img, map_xy)
        return out[0] if single else out
    if img.device.type != "cuda":
        raise ValueError(f"remap_bilinear: unsupported device {img.device}")
    if img.dtype != torch.float32 or map_xy.dtype != torch.float32 or \
            img.dim() != 3 or map_xy.dim() != 4 or map_xy.shape[-1] != 2 or \
            map_xy.shape[0] != img.shape[0] or \
            map_xy.device != img.device or not 0 < img.shape[0] <= 65535:
        raise ValueError("remap_bilinear: needs float32 images (B, Hs, Ws) "
                         "and maps (B, H, W, 2) on one device")
    B, Hs, Ws = img.shape
    _, H, W, _ = map_xy.shape
    img = img.contiguous()
    map_xy = map_xy.contiguous()
    if map_xy.data_ptr() % 8:
        map_xy = map_xy.clone()
    out = torch.empty((B, H, W), dtype=torch.float32, device=img.device)
    rc = _lib().remap_bilinear(img.data_ptr(), Hs, Ws, map_xy.data_ptr(), H,
                               W, B, out.data_ptr(),
                               cuda_build.stream_ptr(img))
    cuda_build.check(rc, "remap_bilinear")
    LAUNCHES["kernel"] += 1
    return out[0] if single else out


def _lib():
    lib = cuda_build.library("remap_bilinear")
    if lib.remap_bilinear.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.remap_bilinear.argtypes = [P, I, I, P, I, I, I, P, P]
        lib.remap_bilinear.restype = I
    return lib
