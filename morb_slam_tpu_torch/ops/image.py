"""Image-level ops: the pyramid and the separable Gaussian blur, kernel K6
(counterpart of `morb_slam_tpu/ops/image.py`).

`pyramid_blur` (what `frontend.extract_orb` calls) launches
`csrc/pyramid_blur.cu` once for a CUDA image: the level-0 copy, every
level from the one before and every level's blur, the levels and the
blurred levels consecutive contiguous views of one buffer each; for a CPU
image it runs the plain versions, `build_pyramid_plain` and
`gaussian_blur_plain` per level. `build_pyramid` (one launch per level)
and `blur_levels` (one launch for the blur of given levels) are the
per-level path, kept as the one launch's comparison.

The plain pyramid applies the triangle-kernel weight matrices that
`jax.image.resize(..., "linear")` builds (antialiased on downscale),
computed once per level shape in numpy float32, as two float32 matmuls.
`F.interpolate(antialias=True)` differs from that filter in the last
digits, enough to flip FAST selections on the coarse levels. The kernel
sums each output's few non-zero taps of the same weights in ascending input
order, and agrees with the plain pyramid to float32 rounding. The blur is
the reference's seven shifted adds per axis with edge replication, not a
`conv2d` (cuDNN would run that in TF32); the kernel repeats those adds and
is bitwise equal to the plain blur.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from . import cuda_build

LAUNCHES = {"kernel": 0, "plain": 0}
MAX_TAPS = 8      # csrc/pyramid_blur.cu
TILE_X = 32
TILE_SPAN = 64    # input columns one pyramid tile may read
MAX_LEVELS = 16
FUSED_TX = 32     # csrc/pyramid_blur.cu FTX
FUSED_TY = 16     # FTY
FUSED_SPAN = 64   # FCX: input columns one pyramid tile reads
FUSED_RSPAN = 32  # FRX: input rows one pyramid tile reads

_weights: dict = {}
_bands: dict = {}
_plans: dict = {}


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


def build_pyramid_plain(img, n_levels: int, scale: float):
    """Plain K6 pyramid: (H, W) float32 -> list of per-level images, each
    level downscaled from the previous one like the reference."""
    LAUNCHES["plain"] += 1
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


def gaussian_blur_plain(img):
    """Plain K6 blur: 7x7 sigma=2 separable blur with edge replication,
    seven shifted adds per axis in the reference's order, so the sums round
    the same way."""
    LAUNCHES["plain"] += 1
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


def _band(n_in: int, n_out: int):
    """(start, count, weights (n_out, MAX_TAPS)) of each output's run of
    non-zero taps in resize_weights, in ascending input order."""
    if n_in == n_out:
        wt = np.zeros((n_out, MAX_TAPS), np.float32)
        wt[:, 0] = 1.0
        return (np.arange(n_out, dtype=np.int32), np.ones(n_out, np.int32),
                wt)
    W = resize_weights(n_in, n_out)
    start = np.zeros(n_out, np.int32)
    count = np.zeros(n_out, np.int32)
    wt = np.zeros((n_out, MAX_TAPS), np.float32)
    for o in range(n_out):
        nz = np.nonzero(W[:, o])[0]
        if len(nz) == 0:
            start[o] = start[o - 1] if o else 0
            continue
        s, c = int(nz[0]), int(nz[-1]) - int(nz[0]) + 1
        if c > MAX_TAPS:
            raise ValueError(f"K6: {c} taps per output (at most {MAX_TAPS})")
        start[o], count[o] = s, c
        wt[o, :c] = W[s:s + c, o]
    return start, count, wt


def band_tables(h: int, w: int, n_levels: int, scale: float, device):
    """Per level 1..n_levels-1: one int32 device tensor holding the row and
    column bands (start, count, then the weights' bits) that
    `pyramid_level` reads; built once per image shape and device."""
    key = (h, w, n_levels, float(scale), str(device))
    tables = _bands.get(key)
    if tables is not None:
        return tables
    shapes = level_shapes(h, w, n_levels, scale)
    tables = []
    for (hi, wi), (ho, wo) in zip(shapes[:-1], shapes[1:]):
        rs, rc, rw = _band(hi, ho)
        cs, cc, cw = _band(wi, wo)
        ends = cs + cc
        for x0 in range(0, wo, TILE_X):
            if int(ends[x0:x0 + TILE_X].max()) - int(cs[x0]) > TILE_SPAN:
                raise ValueError("K6: a pyramid tile spans more than "
                                 f"{TILE_SPAN} input columns")
        blob = np.concatenate([rs, rc, cs, cc, rw.reshape(-1).view(np.int32),
                               cw.reshape(-1).view(np.int32)])
        tables.append(torch.from_numpy(blob).to(device))
    _bands[key] = tables
    return tables


@record_function("K6 build_pyramid")
def build_pyramid(img, n_levels: int, scale: float):
    """K6 pyramid: (H, W) float32 -> list of n_levels images. CUDA tensors:
    one kernel launch per level 1.., the levels contiguous views of one
    buffer (raises if the kernel cannot run); CPU tensors: the plain
    version."""
    if img.device.type == "cpu":
        return build_pyramid_plain(img, n_levels, scale)
    if img.device.type != "cuda":
        raise ValueError(f"build_pyramid: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or \
            not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError("build_pyramid: needs one float32 (H, W) image and "
                         f"1..{MAX_LEVELS} levels")
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    sizes = [a * b for a, b in shapes]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=img.device)
    levels = list(torch.split(buf, sizes))
    levels = [v.view(s) for v, s in zip(levels, shapes)]
    levels[0].copy_(img)
    lib = _lib()
    stream = cuda_build.stream_ptr(img)
    for l, band in enumerate(band_tables(h, w, n_levels, scale, img.device),
                             start=1):
        (hi, wi), (ho, wo) = shapes[l - 1], shapes[l]
        rc = lib.pyramid_level(levels[l - 1].data_ptr(), hi, wi,
                               levels[l].data_ptr(), ho, wo, band.data_ptr(),
                               stream)
        cuda_build.check(rc, "pyramid_level")
        LAUNCHES["kernel"] += 1
    return levels


@record_function("K6 blur_levels")
def blur_levels(levels):
    """K6 blur of every level. CUDA tensors: one launch over all levels,
    which must be consecutive contiguous views of one buffer, as
    `build_pyramid` returns them; the results are contiguous views of one
    buffer. CPU tensors: the plain blur per level."""
    levels = list(levels)
    dev = levels[0].device
    if dev.type == "cpu":
        return [gaussian_blur_plain(l) for l in levels]
    if dev.type != "cuda":
        raise ValueError(f"blur_levels: unsupported device {dev}")
    if len(levels) > MAX_LEVELS or any(
            l.dtype != torch.float32 or l.dim() != 2 or l.device != dev
            for l in levels):
        raise ValueError("blur_levels: needs float32 (H, W) images on one "
                         f"device, at most {MAX_LEVELS}")
    shapes = [tuple(l.shape) for l in levels]
    sizes = [a * b for a, b in shapes]
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    src = levels[0]
    if not all(l.is_contiguous() and
               l.data_ptr() == src.data_ptr() + 4 * int(o)
               for l, o in zip(levels, offs)):
        raise ValueError("blur_levels: the levels must be consecutive "
                         "contiguous views of one buffer (build_pyramid's)")
    out = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    I = ctypes.c_int * len(levels)
    rc = _lib().blur_levels(
        src.data_ptr(), out.data_ptr(), len(levels), I(*offs.tolist()),
        I(*[s[0] for s in shapes]), I(*[s[1] for s in shapes]),
        (ctypes.c_float * 7)(*_KERNEL7.tolist()), cuda_build.stream_ptr(src))
    cuda_build.check(rc, "blur_levels")
    LAUNCHES["kernel"] += 1
    return [v.view(s) for v, s in zip(torch.split(out, sizes), shapes)]


class _PyrBlurTable(ctypes.Structure):
    """csrc/pyramid_blur.cu PyrBlurTable."""
    _fields_ = [("n", ctypes.c_int)] + [
        (f, ctypes.c_int * MAX_LEVELS) for f in
        ("off", "h", "w", "tiles_x", "tiles", "band", "span", "rspan")] + [
        ("btile0", ctypes.c_int * (MAX_LEVELS + 1)),
        ("bstart", ctypes.c_int * (MAX_LEVELS + 2)),
        ("k", ctypes.c_float * 7)]


def _tile_span(start, count, tile: int) -> int:
    """Input rows (columns) the widest tile of `tile` outputs reads from
    its first output's start; raises where a later output starts
    earlier."""
    span = 0
    for o in range(0, len(start), tile):
        if int(start[o:o + tile].min()) < int(start[o]):
            raise ValueError("K6: bands out of order")
        span = max(span, int((start + count)[o:o + tile].max())
                   - int(start[o]))
    return span


def fused_plan(h: int, w: int, n_levels: int, scale: float, device):
    """The one-launch K6's tables for one image shape and device, built
    once: (the band tables of levels 1.. in one int32 device tensor, the
    kernel's level table, the level shapes, each level's element offset,
    the buffer's length). Raises if a pyramid tile would read more input
    rows or columns than the kernel stages."""
    key = (h, w, n_levels, float(scale), str(device))
    plan = _plans.get(key)
    if plan is not None:
        return plan
    shapes = level_shapes(h, w, n_levels, scale)
    sizes = [a * b for a, b in shapes]
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    t = _PyrBlurTable()
    t.n = n_levels
    blobs, at = [], 0
    for l, (ho, wo) in enumerate(shapes):
        t.off[l], t.h[l], t.w[l] = int(offs[l]), ho, wo
        t.tiles_x[l] = -(-wo // FUSED_TX)
        t.tiles[l] = t.tiles_x[l] * -(-ho // FUSED_TY)
        t.btile0[l + 1] = t.btile0[l] + t.tiles[l]
        if l == 0:
            continue
        hi, wi = shapes[l - 1]
        rs, rc, rw = _band(hi, ho)
        cs, cc, cw = _band(wi, wo)
        span = _tile_span(cs, cc, FUSED_TX)
        rspan = _tile_span(rs, rc, FUSED_TY)
        if span > FUSED_SPAN or rspan > FUSED_RSPAN:
            raise ValueError(f"K6: a tile spans {span} input columns and "
                             f"{rspan} rows (at most {FUSED_SPAN} and "
                             f"{FUSED_RSPAN})")
        t.band[l], t.span[l], t.rspan[l] = at, span, rspan
        blob = np.concatenate([rs, rc, cs, cc, rw.reshape(-1).view(np.int32),
                               cw.reshape(-1).view(np.int32)])
        blobs.append(blob)
        at += blob.size
    t.k[:] = _KERNEL7.tolist()
    blob = np.concatenate(blobs) if blobs else np.zeros(1, np.int32)
    plan = (torch.from_numpy(blob).to(device), t, shapes,
            offs.tolist(), int(sum(sizes)))
    _plans[key] = plan
    return plan


@record_function("K6 pyramid_blur")
def pyramid_blur(img, n_levels: int, scale: float):
    """K6: (H, W) float32 -> (levels, blurred levels), n_levels each. CUDA
    tensors: one kernel launch, the levels and the blurred levels
    consecutive contiguous views of one buffer each (as K1 and K2 take
    them; raises if the kernel cannot run); CPU tensors: the plain pyramid
    and the plain blur per level."""
    if img.device.type == "cpu":
        levels = build_pyramid_plain(img, n_levels, scale)
        return levels, [gaussian_blur_plain(l) for l in levels]
    if img.device.type != "cuda":
        raise ValueError(f"pyramid_blur: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or \
            not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError("pyramid_blur: needs one float32 (H, W) image and "
                         f"1..{MAX_LEVELS} levels")
    h, w = img.shape
    blob, table, shapes, offs, total = fused_plan(h, w, n_levels, scale,
                                                  img.device)
    img = img.contiguous()
    buf = torch.empty(2 * total, dtype=torch.float32, device=img.device)
    rc = _lib().pyramid_blur(img.data_ptr(), buf.data_ptr(),
                             buf.data_ptr() + 4 * total, blob.data_ptr(),
                             ctypes.byref(table), cuda_build.stream_ptr(img))
    cuda_build.check(rc, "pyramid_blur")
    LAUNCHES["kernel"] += 1
    views = [buf.as_strided(s, (s[1], 1), o + k * total)
             for k in (0, 1) for s, o in zip(shapes, offs)]
    return views[:n_levels], views[n_levels:]


def gaussian_blur(img):
    """K6 blur of one image (`blur_levels` of one level)."""
    return blur_levels([img.contiguous()])[0]


def _lib():
    lib = cuda_build.library("pyramid_blur")
    if lib.pyramid_level.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        IP = ctypes.POINTER(ctypes.c_int)
        lib.pyramid_level.argtypes = [P, I, I, P, I, I, P, P]
        lib.pyramid_level.restype = I
        lib.blur_levels.argtypes = [P, P, I, IP, IP, IP,
                                    ctypes.POINTER(ctypes.c_float), P]
        lib.blur_levels.restype = I
        lib.pyramid_blur.argtypes = [P, P, P, P, P, P]
        lib.pyramid_blur.restype = I
    return lib
