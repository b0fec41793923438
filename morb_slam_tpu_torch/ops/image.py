"""Image-level ops: pyramid construction and the separable Gaussian blur
(counterpart of `morb_slam_tpu/ops/image.py`; K6 of the kernel table, plain
PyTorch).

The pyramid applies the same triangle-kernel weight matrices that
`jax.image.resize(..., "linear")` builds (antialiased on downscale), computed
here once per level shape in numpy float32 and applied as two float32
matmuls. `F.interpolate(antialias=True)` differs from that filter in the
last digits, enough to flip FAST selections on the coarse levels. The blur
is the reference's seven shifted adds per axis with edge replication, not a
`conv2d`, which cuDNN would run in TF32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

_weights: dict = {}


def level_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static (h, w) per pyramid level, rounded like the reference."""
    shapes = []
    for l in range(n_levels):
        inv = 1.0 / (scale ** l)
        shapes.append((int(round(h * inv)), int(round(w * inv))))
    return shapes


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 antialiased linear-resize weights, the matrix
    jax.image's scale_and_translate contracts with (triangle kernel widened
    by the downscale factor, columns normalised to sum 1)."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(0.0) - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _weight(n_in: int, n_out: int, device) -> torch.Tensor:
    key = (n_in, n_out, str(device))
    w = _weights.get(key)
    if w is None:
        w = torch.from_numpy(resize_weights(n_in, n_out)).to(device)
        _weights[key] = w
    return w


def resize_bilinear(img, out_hw):
    """Antialiased bilinear resize (H, W) -> out_hw as two float32 matmuls."""
    h, w = img.shape
    oh, ow = out_hw
    out = img
    if oh != h:
        out = _weight(h, oh, img.device).T @ out
    if ow != w:
        out = out @ _weight(w, ow, img.device)
    return out


@record_function("K6 build_pyramid")
def build_pyramid(img, n_levels: int, scale: float):
    """(H, W) float32 -> list of per-level images, each level downscaled
    from the previous one like the reference."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels


def gaussian_kernel1d(ksize: int = 7, sigma: float = 2.0):
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


_KERNEL7 = gaussian_kernel1d()


@record_function("K6 gaussian_blur")
def gaussian_blur(img):
    """7x7 sigma=2 separable blur with edge replication: seven shifted adds
    per axis in the reference's order, so the sums round the same way."""
    h, w = img.shape
    k = [float(v) for v in _KERNEL7]
    r = len(k) // 2
    p = F.pad(img[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    out = torch.zeros_like(img)
    for i in range(len(k)):
        out = out + k[i] * p[i:i + h]
    p = F.pad(out[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    out2 = torch.zeros_like(img)
    for i in range(len(k)):
        out2 = out2 + k[i] * p[:, i:i + w]
    return out2
