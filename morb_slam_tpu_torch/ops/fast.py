"""FAST-9/16 corner scoring and grid-balanced keypoint selection
(counterpart of `morb_slam_tpu/ops/fast.py` plus
`morb_slam_tpu/frontend.py:_select_level_keypoints` and `extract_orb`'s
per-level slots).

Kernel K1 (`csrc/fast_select.cu`) has two entry points. `fast_select_levels`
selects the keypoints of every level of an image (two launches: the cell
stage over all levels' cells, then one block a level for its top n_keep);
`extract_orb` runs it. `fast_select` runs the cell stage alone on one
level. On CUDA tensors they launch the kernel (or raise); on CPU tensors
they run `fast_select_levels_plain` and `fast_select_plain`, the same
functions in plain PyTorch, which the CPU tests hold against the JAX
package.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_build
from .image import MAX_LEVELS

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


class LevelKeypoints(NamedTuple):
    """The kept keypoint slots of an image's levels, in level order: yx
    (M, 2) int32 level pixel (y, x), 0 where not valid; key (M,) selection
    key, -inf where not valid; response (M,) raw FAST score there; valid
    (M,) bool; uv (M, 2) float32 level-0 (x, y); octave (M,) int32; size
    (M,) float32; kept, each level's slot count (min(n_keep, 2 x its
    cells), 0 where n_keep is 0), which sums to M."""
    yx: torch.Tensor
    key: torch.Tensor
    response: torch.Tensor
    valid: torch.Tensor
    uv: torch.Tensor
    octave: torch.Tensor
    size: torch.Tensor
    kept: tuple

    def level_yx(self):
        """yx split into each level's slots (empty for a level without)."""
        return torch.split(self.yx, list(self.kept))


SLOT_FIELDS = LevelKeypoints._fields[:-1]     # the seven per-slot tensors


def _wrap_pad(img):
    """The image padded by the circle's radius on every side, wrapping
    around as torch.roll does (any size)."""
    h, w = img.shape
    r = torch.arange(-3, h + 3, device=img.device) % h
    c = torch.arange(-3, w + 3, device=img.device) % w
    return img[r[:, None], c[None, :]]


def _circle_diffs(img, pad, r0, r1):
    """Rows r0:r1 of the (16, H, W) I(p_i) - I(p), wrapping at the edges,
    extended by its first 8 planes to (24, r1 - r0, W): slices of `pad`
    (`_wrap_pad(img)`), each difference written in place."""
    w = img.shape[1]
    c = img[r0:r1]
    e = torch.empty((24,) + tuple(c.shape), dtype=img.dtype,
                    device=img.device)
    for k, (dx, dy) in enumerate(CIRCLE):
        torch.sub(pad[3 + int(dy) + r0:3 + int(dy) + r1,
                      3 + int(dx):3 + int(dx) + w], c, out=e[k])
    e[16:] = e[:8]
    return e


def _run9(e, f):
    """f (torch.minimum or torch.maximum) over each cyclic run of 9 of the
    16 circle entries, from `_circle_diffs`' extended stack: runs of 2, 4,
    8 and 9 as slices."""
    m = f(e[:-1], e[1:])
    m = f(m[:-2], m[2:])
    m = f(m[:16], m[4:20])
    return f(m, e[8:24])


def fast_score(img):
    """Dense FAST-9 score: the largest threshold at which each pixel is
    still a corner. The 3-px border wraps and is garbage; callers mask it.
    Computed in bands of ~12k pixels, whose 24 planes stay in the CPU's
    cache (each pixel's arithmetic the same). The dark score, the largest
    run-minimum of -d, is taken as minus the smallest run-maximum of d."""
    h, w = img.shape
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    pad = _wrap_pad(img)
    rows = max(8, 12288 // w)
    for r0 in range(0, h, rows):
        e = _circle_diffs(img, pad, r0, min(h, r0 + rows))
        bright = torch.amax(_run9(e, torch.minimum), dim=0)
        dark = torch.amin(_run9(e, torch.maximum), dim=0).neg_()
        out[r0:r0 + rows] = torch.maximum(bright, dark)
    return out


def fast_corners(img, threshold: float):
    """Boolean FAST-9 corner mask at a threshold, without NMS (the 3-px
    border as in `fast_score`)."""
    return fast_score(img) > threshold


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


def _cells_plain(img, th_lo, th_hi, boost, border):
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


def fast_select_plain(img, th_lo: float, th_hi: float,
                      boost: float = STRONG_BOOST, border: int = BORDER):
    """Plain version of K1's cell stage on one level. Returns per 16x16 cell
    (row-major cells, image padded to whole cells) the two best keys, ties
    to the lower in-cell index: (key (ncells, 2) float32, flat pixel index
    y*W+x (ncells, 2) int32, raw FAST score there (ncells, 2) float32; 0
    outside the image)."""
    LAUNCHES["plain"] += 1
    return _cells_plain(img, th_lo, th_hi, boost, border)


def fast_select(img, th_lo: float, th_hi: float, boost: float = STRONG_BOOST,
                border: int = BORDER):
    """K1's cell stage on one level: FAST score + NMS + border + key +
    per-cell top-2. CUDA tensor: the kernel (raises if it cannot run); CPU
    tensor: the plain version."""
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


def select_levels(levels, counts, cfg, cells):
    """The per-level composition: `cells` (a cell stage: `fast_select` or
    `fast_select_plain`) on each level, then the level's best n_keep of its
    cell slots by a stable descending sort (ties keep the lower slot, as
    jax.lax.top_k does) and `extract_orb`'s slots; levels with n_keep 0
    keep no slot. Returns LevelKeypoints."""
    out, kept = [], []
    for l, (lvl, n_keep) in enumerate(zip(levels, counts)):
        kept.append(0)
        if n_keep == 0:
            continue
        w = lvl.shape[1]
        key, idx, score = cells(lvl, cfg.th_fast_lo, cfg.th_fast_hi,
                                STRONG_BOOST, BORDER)
        vals, order = torch.sort(key.reshape(-1), descending=True,
                                 stable=True)
        top_vals, top_i = vals[:n_keep], order[:n_keep]
        m = kept[-1] = top_vals.shape[0]
        pix = idx.reshape(-1)[top_i]
        valid = top_vals > -math.inf
        yx = torch.stack([pix // w, pix % w], dim=-1).to(torch.int32)
        yx = torch.where(valid[:, None], yx, torch.zeros_like(yx))
        s = cfg.scale ** l
        uv = torch.stack([yx[:, 1].to(torch.float32) * s,
                          yx[:, 0].to(torch.float32) * s], dim=-1)
        out.append((
            yx, top_vals, score.reshape(-1)[top_i], valid, uv,
            torch.full((m,), l, dtype=torch.int32, device=lvl.device),
            torch.full((m,), 31.0 * s, dtype=torch.float32,
                       device=lvl.device)))
    if not out:
        dev = levels[0].device
        i32, f32 = torch.int32, torch.float32
        return LevelKeypoints(
            torch.zeros((0, 2), dtype=i32, device=dev),
            torch.zeros(0, dtype=f32, device=dev),
            torch.zeros(0, dtype=f32, device=dev),
            torch.zeros(0, dtype=torch.bool, device=dev),
            torch.zeros((0, 2), dtype=f32, device=dev),
            torch.zeros(0, dtype=i32, device=dev),
            torch.zeros(0, dtype=f32, device=dev), tuple(kept))
    return LevelKeypoints(*(torch.cat(f) for f in zip(*out)), tuple(kept))


def fast_select_levels_plain(levels, counts, cfg):
    """Plain version of K1 over an image's levels: `select_levels` with the
    plain cell stage."""
    LAUNCHES["plain"] += 1
    return select_levels(levels, counts, cfg, cells=_cells_plain)


def fast_select_levels(levels, counts, cfg):
    """K1 over every level of one image: `fast_select_levels_plain`'s
    function (`cfg`: `th_fast_lo`, `th_fast_hi`, `scale`; `counts`: each
    level's n_keep). CUDA tensors: two launches (the cell stage over every
    level's cells, then a block a level for its best n_keep); the levels
    must be consecutive contiguous views of one buffer, as K6's
    `build_pyramid` returns them (raises otherwise). CPU tensors: the plain
    version."""
    levels, counts = list(levels), [int(n) for n in counts]
    dev = levels[0].device
    if dev.type == "cpu":
        return fast_select_levels_plain(levels, counts, cfg)
    if dev.type != "cuda":
        raise ValueError(f"fast_select_levels: unsupported device {dev}")
    n_lv = len(levels)
    if not 1 <= n_lv <= MAX_LEVELS or len(counts) != n_lv or \
            min(counts) < 0:
        raise ValueError(f"fast_select_levels: needs 1..{MAX_LEVELS} levels "
                         "and as many counts >= 0")
    if {t.device for t in levels} != {dev} or \
            {t.dtype for t in levels} != {torch.float32} or \
            {t.dim() for t in levels} != {2}:
        raise ValueError("fast_select_levels: needs float32 (H, W) levels on "
                         "one device")
    shapes = [tuple(l.shape) for l in levels]
    offs = [0]
    for h, w in shapes[:-1]:
        offs.append(offs[-1] + h * w)
    p0 = levels[0].data_ptr()
    if not all(l.is_contiguous() and l.data_ptr() == p0 + 4 * o
               for l, o in zip(levels, offs)):
        raise ValueError("fast_select_levels: the levels must be consecutive "
                         "contiguous views of one buffer (build_pyramid's)")
    slots = [CELL_K * (-(-h // CELL)) * (-(-w // CELL)) if k else 0
             for (h, w), k in zip(shapes, counts)]
    keep = [min(k, s) for k, s in zip(counts, slots)]
    n, m = sum(slots), sum(keep)
    f32, i32 = torch.float32, torch.int32
    cell_key = torch.empty(n, dtype=f32, device=dev)
    cell_idx = torch.empty(n, dtype=i32, device=dev)
    cell_score = torch.empty(n, dtype=f32, device=dev)
    out = LevelKeypoints(
        yx=torch.empty((m, 2), dtype=i32, device=dev),
        key=torch.empty(m, dtype=f32, device=dev),
        response=torch.empty(m, dtype=f32, device=dev),
        valid=torch.empty(m, dtype=torch.bool, device=dev),
        uv=torch.empty((m, 2), dtype=f32, device=dev),
        octave=torch.empty(m, dtype=i32, device=dev),
        size=torch.empty(m, dtype=f32, device=dev), kept=tuple(keep))
    if m == 0:
        return out
    sel_scratch = torch.empty(m, dtype=torch.int64, device=dev)
    I, F = ctypes.c_int * n_lv, ctypes.c_float * n_lv
    scale = [cfg.scale ** l for l in range(n_lv)]
    rc = _lib().fast_select_levels(
        p0, n_lv, I(*offs), I(*[s[0] for s in shapes]),
        I(*[s[1] for s in shapes]), I(*keep), F(*scale),
        F(*[31.0 * s for s in scale]), cfg.th_fast_lo, cfg.th_fast_hi,
        STRONG_BOOST, BORDER, cell_key.data_ptr(), cell_idx.data_ptr(),
        cell_score.data_ptr(), *(t.data_ptr() for t in out[:-1]),
        sel_scratch.data_ptr(), cuda_build.stream_ptr(levels[0]))
    cuda_build.check(rc, "fast_select_levels")
    LAUNCHES["kernel"] += 1
    return out


def _lib():
    lib = cuda_build.library("fast_select")
    if lib.fast_select.argtypes is None:
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        IP, FP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
        lib.fast_select.argtypes = [P, I, I, Fl, Fl, Fl, I, P, P, P, P]
        lib.fast_select.restype = I
        lib.fast_select_levels.argtypes = [P, I, IP, IP, IP, IP, FP, FP, Fl,
                                           Fl, Fl, I] + [P] * 12
        lib.fast_select_levels.restype = I
    return lib
