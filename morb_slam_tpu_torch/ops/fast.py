"""FAST-9/16 corner scoring and per-cell keypoint selection (counterpart of
`morb_slam_tpu/ops/fast.py` plus the per-cell stage of
`morb_slam_tpu/frontend.py:_select_level_keypoints`).

`fast_select` is kernel K1: on a CUDA tensor it launches `csrc/fast_select.cu`;
on a CPU tensor it runs `fast_select_plain`, the same function in plain
PyTorch, which the CPU tests hold against the JAX package.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import cuda_build

# Bresenham circle radius 3, circular order (dx, dy) — OpenCV pixel order.
CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)

BORDER = 16          # detection inset per level
CELL = 16            # selection grid cell size in px
CELL_K = 2           # keypoints kept per cell
STRONG_BOOST = 1e4   # key boost for corners above the high threshold

LAUNCHES = {"kernel": 0, "plain": 0}


def _circle_diffs(img):
    """(H, W) -> (16, H, W) of I(p_i) - I(p), wrapping at the edges."""
    shifted = [torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(0, 1))
               for dx, dy in CIRCLE]
    return torch.stack(shifted) - img[None]


def _run9_min(d):
    m = torch.minimum(d, torch.roll(d, -1, dims=0))
    m = torch.minimum(m, torch.roll(m, -2, dims=0))
    m = torch.minimum(m, torch.roll(m, -4, dims=0))
    return torch.minimum(m, torch.roll(d, -8, dims=0))


def fast_score(img):
    """Dense FAST-9 score: the largest threshold at which each pixel is
    still a corner. The 3-px border wraps and is garbage; callers mask it."""
    d = _circle_diffs(img)
    bright = torch.amax(_run9_min(d), dim=0)
    dark = torch.amax(_run9_min(-d), dim=0)
    return torch.maximum(bright, dark)


def nms3(score):
    """True where score >= all 8 neighbours (-inf outside the image)."""
    h, w = score.shape
    p = torch.nn.functional.pad(score[None, None], (1, 1, 1, 1),
                                value=-math.inf)[0, 0]
    neigh = torch.full_like(score, -math.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = torch.maximum(neigh, p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return score >= neigh


def border_mask(h: int, w: int, border: int, device=None):
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= border) & (ys < h - border) & (xs >= border) & \
        (xs < w - border)


def selection_key(score, th_lo: float, th_hi: float, boost: float = STRONG_BOOST,
                  border: int = BORDER):
    """score + boost * (score > th_hi) where a weak NMS corner inside the
    border, else -inf."""
    h, w = score.shape
    weak = (score > th_lo) & nms3(score) & border_mask(h, w, border,
                                                        score.device)
    strong = (score > th_hi).to(score.dtype)
    return torch.where(weak, score + boost * strong,
                       torch.full_like(score, -math.inf))


def fast_select_plain(img, th_lo: float, th_hi: float,
                      boost: float = STRONG_BOOST, border: int = BORDER):
    """Plain version of K1. Returns per 16x16 cell (row-major cells, image
    padded to whole cells) the two best keys, ties to the lower in-cell
    index: (key (ncells, 2) float32, flat pixel index y*W+x (ncells, 2)
    int32, raw FAST score there (ncells, 2) float32; 0 outside the image)."""
    LAUNCHES["plain"] += 1
    h, w = img.shape
    score = fast_score(img)
    key = selection_key(score, th_lo, th_hi, boost, border)
    hp = -(-h // CELL) * CELL
    wp = -(-w // CELL) * CELL
    ncy, ncx = hp // CELL, wp // CELL
    kp = torch.nn.functional.pad(key[None, None], (0, wp - w, 0, hp - h),
                                 value=-math.inf)[0, 0]
    sp = torch.nn.functional.pad(score[None, None], (0, wp - w, 0, hp - h),
                                 value=0.0)[0, 0]

    def cells(x):
        return x.reshape(ncy, CELL, ncx, CELL).permute(0, 2, 1, 3).reshape(
            ncy * ncx, CELL * CELL)

    vals, idx = torch.sort(cells(kp), dim=1, descending=True, stable=True)
    vals, idx = vals[:, :CELL_K], idx[:, :CELL_K]
    c = torch.arange(ncy * ncx, device=img.device)
    ys = (c // ncx)[:, None] * CELL + idx // CELL
    xs = (c % ncx)[:, None] * CELL + idx % CELL
    sc = torch.gather(cells(sp), 1, idx)
    return vals, (ys * w + xs).to(torch.int32), sc


def fast_select(img, th_lo: float, th_hi: float, boost: float = STRONG_BOOST,
                border: int = BORDER):
    """K1: FAST score + NMS + border + key + per-cell top-2 of one level.
    CUDA tensor: the kernel (raises if it cannot run); CPU tensor: the
    plain version."""
    if img.device.type == "cpu":
        return fast_select_plain(img, th_lo, th_hi, boost, border)
    if img.device.type != "cuda":
        raise ValueError(f"fast_select: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError("fast_select: needs a contiguous (H, W) float32 image")
    h, w = img.shape
    ncells = (-(-h // CELL)) * (-(-w // CELL))
    key = torch.empty((ncells, CELL_K), dtype=torch.float32, device=img.device)
    idx = torch.empty((ncells, CELL_K), dtype=torch.int32, device=img.device)
    sc = torch.empty((ncells, CELL_K), dtype=torch.float32, device=img.device)
    lib = _lib()
    rc = lib.fast_select(img.data_ptr(), h, w, th_lo, th_hi, boost, border,
                         key.data_ptr(), idx.data_ptr(), sc.data_ptr(),
                         cuda_build.stream_ptr(img))
    cuda_build.check(rc, "fast_select")
    LAUNCHES["kernel"] += 1
    return key, idx, sc


def _lib():
    lib = cuda_build.library("fast_select")
    if lib.fast_select.argtypes is None:
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fast_select.argtypes = [P, I, I, Fl, Fl, Fl, I, P, P, P, P]
        lib.fast_select.restype = I
    return lib
