"""Intensity-centroid orientation and rotated BRIEF-256 (counterpart of
`morb_slam_tpu/ops/orb_descriptor.py`).

`orb_describe` (one level) and `orb_describe_levels` (every level of one
image, one launch) are kernel K2: on CUDA tensors they launch
`csrc/orb_describe.cu` (orientation and descriptor in one pass); on CPU
tensors they run `compute_orientations` + `compute_descriptors`, the plain
PyTorch version. Descriptors are (N, 8) int32: the bit-identical view of the
reference's uint32 words (bit i of word w = test 32*w + i).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build
from .image import MAX_LEVELS

PATCH_R = 15          # orientation patch radius
PATTERN_R = 13        # max abs pattern coordinate
DESC_PAD = 20         # sampling pad: ceil(13 * sqrt(2)) + 1

LAUNCHES = {"kernel": 0, "plain": 0}


def make_pattern(seed: int = 42) -> np.ndarray:
    """(256, 4) int32 (x1, y1, x2, y2) test pairs ~ N(0, (31/5)^2), rounded
    and clipped: the same numpy draw as the reference package."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0.0, 31.0 / 5.0, size=(256, 4))
    return np.clip(np.round(p), -PATTERN_R, PATTERN_R).astype(np.int32)


PATTERN = make_pattern()

_vu = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
ORI_MASK = ((_vu[0] ** 2 + _vu[1] ** 2) <= PATCH_R ** 2).astype(np.float32)
ORI_U = (_vu[1].astype(np.float32) * ORI_MASK)
ORI_V = (_vu[0].astype(np.float32) * ORI_MASK)

_SHIFTS = torch.arange(32, dtype=torch.int64)


def _pad_reflect(img, pad: int):
    return F.pad(img[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]


def compute_orientations(img, kps_yx):
    """Intensity-centroid angles (N,) for integer (y, x) keypoints on the
    raw level image (reflect-padded 31x31 disc)."""
    side = 2 * PATCH_R + 1
    imgp = _pad_reflect(img, PATCH_R)
    off = torch.arange(side, device=img.device)
    ys = kps_yx[:, 0].long()[:, None, None] + off[None, :, None]
    xs = kps_yx[:, 1].long()[:, None, None] + off[None, None, :]
    patch = imgp[ys, xs]                                   # (N, 31, 31)
    u = torch.from_numpy(ORI_U).to(img.device)
    v = torch.from_numpy(ORI_V).to(img.device)
    m10 = torch.sum((u * patch).reshape(-1, side * side), dim=1)
    m01 = torch.sum((v * patch).reshape(-1, side * side), dim=1)
    return torch.atan2(m01, m10)


def pack_bits(bits):
    """(..., 256) bool -> (..., 8) int32 words (bit i of word w = 32w+i)."""
    words = bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64)
    packed = torch.sum(words << _SHIFTS.to(bits.device), dim=-1)
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(
        torch.int32)


def unpack_bits(desc):
    """(..., 8) int32 words -> (..., 256) bool bits."""
    w = desc.to(torch.int64) & 0xFFFFFFFF
    bits = (w[..., None] >> _SHIFTS.to(desc.device)) & 1
    return bits.reshape(*desc.shape[:-1], 256).bool()


def compute_descriptors(img_blur, kps_yx, angles, pattern=PATTERN):
    """Rotated BRIEF-256 on the blurred level, packed to (N, 8) int32."""
    pad = DESC_PAD
    imgp = _pad_reflect(img_blur, pad)
    pat = torch.as_tensor(pattern, device=img_blur.device).to(torch.float32)
    ca = torch.cos(angles)[:, None]
    sa = torch.sin(angles)[:, None]
    y0 = kps_yx[:, 0].long()[:, None]
    x0 = kps_yx[:, 1].long()[:, None]

    def sample(px, py):
        xr = torch.round(px[None] * ca - py[None] * sa).long() + pad
        yr = torch.round(px[None] * sa + py[None] * ca).long() + pad
        return imgp[y0 + yr, x0 + xr]                     # (N, 256)

    bits = sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3])
    return pack_bits(bits)


def orb_describe(img, img_blur, kps_yx):
    """K2: orientation (N,) float32 and descriptor (N, 8) int32 of integer
    (y, x) keypoints on one level. CUDA tensors: the kernel; CPU tensors:
    the plain version. Keypoints must lie inside the level, and the level
    must be more than DESC_PAD px high and wide (the kernel's reflect
    padding mirrors once)."""
    if img.device.type == "cpu":
        LAUNCHES["plain"] += 1
        ang = compute_orientations(img, kps_yx)
        return ang, compute_descriptors(img_blur, kps_yx, ang)
    if img.device.type != "cuda":
        raise ValueError(f"orb_describe: unsupported device {img.device}")
    for t, dt in ((img, torch.float32), (img_blur, torch.float32),
                  (kps_yx, torch.int32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != img.device:
            raise ValueError("orb_describe: needs contiguous float32 images "
                             "and int32 (N, 2) keypoints on one device")
    if img.shape != img_blur.shape or kps_yx.dim() != 2 or \
            kps_yx.shape[1] != 2 or min(img.shape) <= DESC_PAD:
        raise ValueError("orb_describe: shape mismatch")
    h, w = img.shape
    n = kps_yx.shape[0]
    ang = torch.empty(n, dtype=torch.float32, device=img.device)
    desc = torch.empty((n, 8), dtype=torch.int32, device=img.device)
    lib = _lib()
    rc = lib.orb_describe(img.data_ptr(), img_blur.data_ptr(), h, w,
                          kps_yx.data_ptr(), n, ang.data_ptr(),
                          desc.data_ptr(), cuda_build.stream_ptr(img))
    cuda_build.check(rc, "orb_describe")
    LAUNCHES["kernel"] += 1
    return ang, desc


def orb_describe_levels(levels, blurred, yx_per_level):
    """K2 over every level of one image: `orb_describe` of each (level,
    blurred level, keypoints) triple, the angles (N,) and descriptors (N, 8)
    concatenated in level order (a level may hold no keypoints). CUDA
    tensors: one launch; the levels, and the blurred levels, must be
    consecutive contiguous views of one buffer each, as K6's `build_pyramid`
    and `blur_levels` return them. CPU tensors: the plain version per
    level."""
    levels, blurred, yxs = list(levels), list(blurred), list(yx_per_level)
    dev = levels[0].device
    if dev.type == "cpu":
        LAUNCHES["plain"] += 1
        angs, descs = [], []
        for lvl, blur, yx in zip(levels, blurred, yxs):
            ang = compute_orientations(lvl, yx)
            angs.append(ang)
            descs.append(compute_descriptors(blur, yx, ang))
        return torch.cat(angs), torch.cat(descs)
    if dev.type != "cuda":
        raise ValueError(f"orb_describe_levels: unsupported device {dev}")
    n_lv = len(levels)
    if not 1 <= n_lv <= MAX_LEVELS or len(blurred) != n_lv or \
            len(yxs) != n_lv:
        raise ValueError(f"orb_describe_levels: needs 1..{MAX_LEVELS} levels, "
                         "as many blurred levels and keypoint arrays")
    if {t.device for t in (*levels, *blurred, *yxs)} != {dev} or \
            {t.dtype for t in (*levels, *blurred)} != {torch.float32} or \
            {t.dtype for t in yxs} != {torch.int32}:
        raise ValueError("orb_describe_levels: needs float32 levels and "
                         "blurred levels and int32 keypoints on one device")
    shapes = [tuple(l.shape) for l in levels]
    counts = []
    for shape, blur, yx in zip(shapes, blurred, yxs):
        if len(shape) != 2 or blur.shape != shape or yx.dim() != 2 or \
                yx.shape[1] != 2 or (yx.shape[0] and min(shape) <= DESC_PAD):
            raise ValueError("orb_describe_levels: needs (H, W) levels and "
                             "blurred levels of one shape each and (N, 2) "
                             "keypoints; a level holding keypoints must be "
                             f"more than {DESC_PAD} px high and wide")
        counts.append(yx.shape[0])
    offs = [0]
    for h, w in shapes[:-1]:
        offs.append(offs[-1] + h * w)
    p0, q0 = levels[0].data_ptr(), blurred[0].data_ptr()
    if not all(l.is_contiguous() and b.is_contiguous() and yx.is_contiguous()
               and l.data_ptr() == p0 + 4 * o and b.data_ptr() == q0 + 4 * o
               for l, b, yx, o in zip(levels, blurred, yxs, offs)):
        raise ValueError("orb_describe_levels: the levels and the blurred "
                         "levels must be consecutive contiguous views of one "
                         "buffer each (build_pyramid's, blur_levels'), the "
                         "keypoints contiguous")
    n = sum(counts)
    ang = torch.empty(n, dtype=torch.float32, device=dev)
    desc = torch.empty((n, 8), dtype=torch.int32, device=dev)
    I = ctypes.c_int * n_lv
    rc = _lib().orb_describe_levels(
        levels[0].data_ptr(), blurred[0].data_ptr(), n_lv, I(*offs),
        I(*[s[0] for s in shapes]), I(*[s[1] for s in shapes]), I(*counts),
        (ctypes.c_void_p * n_lv)(*[yx.data_ptr() for yx in yxs]),
        ang.data_ptr(), desc.data_ptr(), cuda_build.stream_ptr(levels[0]))
    cuda_build.check(rc, "orb_describe_levels")
    LAUNCHES["kernel"] += 1
    return ang, desc


_pattern_set = set()


def _lib():
    lib = cuda_build.library("orb_describe")
    if lib.orb_describe.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        IP = ctypes.POINTER(ctypes.c_int)
        lib.orb_describe.argtypes = [P, P, I, I, P, I, P, P, P]
        lib.orb_describe.restype = I
        lib.orb_describe_levels.argtypes = [P, P, I, IP, IP, IP, IP,
                                            ctypes.POINTER(P), P, P, P]
        lib.orb_describe_levels.restype = I
        lib.orb_set_pattern.argtypes = [P]
        lib.orb_set_pattern.restype = I
    dev = torch.cuda.current_device()
    if dev not in _pattern_set:
        pat = np.ascontiguousarray(PATTERN, np.int32)
        cuda_build.check(lib.orb_set_pattern(pat.ctypes.data),
                         "orb_set_pattern")
        _pattern_set.add(dev)
    return lib
