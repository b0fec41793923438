"""Rectified stereo matching: row-band descriptor search, SAD subpixel
refinement and dispersion-based outlier rejection; RGB-D depth lookup
(counterpart of `morb_slam_tpu/ops/stereo.py`).

A dense (NL, NR) candidate gate (row band, disparity range, octave band)
feeds one K3 launch (`hamming.hamming_top2`): its best index is the
reference's gated argmin, first column on ties. `sad_refine` is kernel K7:
on CUDA tensors it launches `csrc/stereo_sad.cu`; on CPU tensors it runs
`sad_refine_plain`. The median dispersion filter is plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build, hamming

TH_ORB = (hamming.TH_HIGH + hamming.TH_LOW) // 2  # 75
SAD_W = 5          # SAD half-window (11x11)
SAD_L = 5          # disparity slide half-range
PAD = SAD_W + SAD_L + 2
WIN = 2 * SAD_W + 1
STRIP = WIN + 2 * SAD_L
NCAND = 2 * SAD_L + 1

LAUNCHES = {"kernel": 0, "plain": 0}


class StereoMatches(NamedTuple):
    u_right: torch.Tensor   # (NL,) float32 refined right x at level 0, -1
    depth: torch.Tensor     # (NL,) float32 depth, -1 if none
    valid: torch.Tensor     # (NL,) bool


def row_search(feats_l, feats_r, scale_factors, max_d: float):
    """Gated descriptor search along rectified rows. Returns (best right
    index (NL,) int32, matched (NL,) bool: best distance <= TH_ORB)."""
    uv_l, uv_r = feats_l.uv, feats_r.uv
    sf_l = scale_factors[feats_l.octave.long()]
    # the row band scales with the left keypoint's octave
    dy = torch.abs(uv_l[:, 1:2] - uv_r[None, :, 1])
    band = 2.0 * sf_l[:, None]
    disp = uv_l[:, 0:1] - uv_r[None, :, 0]
    oct_ok = torch.abs(feats_l.octave[:, None] - feats_r.octave[None, :]) <= 1
    cand = ((dy <= band) & (disp >= 0.0) & (disp <= max_d) & oct_ok
            & feats_l.valid[:, None] & feats_r.valid[None, :])
    best, best_idx, _ = hamming.hamming_top2(feats_l.desc, feats_r.desc, cand)
    return best_idx, best <= TH_ORB


def filter_matches(u_l, ur_ref, sad_best, matched, bf: float, max_d: float):
    """Disparity range, then the 1.5 * 1.4 * median SAD dispersion rule."""
    nl = u_l.shape[0]
    disparity = u_l - ur_ref
    matched = matched & (disparity > 0.0) & (disparity < max_d)
    sad_sorted = torch.sort(torch.where(matched, sad_best,
                                        torch.full_like(sad_best,
                                                        float("inf"))))[0]
    n_m = torch.sum(matched)
    # a gather, not a 0-d index: indexing with a device scalar would sync
    median = sad_sorted.gather(0, torch.clamp(n_m // 2, 0, nl - 1).reshape(1))
    keep = matched & (sad_best <= 1.5 * 1.4 * median)
    depth = torch.where(keep, bf / torch.where(keep, disparity,
                                               torch.ones_like(disparity)),
                        torch.full_like(disparity, -1.0))
    u_right = torch.where(keep, ur_ref, torch.full_like(ur_ref, -1.0))
    return StereoMatches(u_right=u_right, depth=depth, valid=keep)


def match_stereo(feats_l, feats_r, img_l, img_r, scale_factors,
                 bf: float, min_z: float) -> StereoMatches:
    """Match left features to right features along rectified rows.

    feats_l, feats_r: frontend.Features of the two images; img_l, img_r:
    (H, W) float32 level-0 images; scale_factors (n_levels,) = scale**level;
    bf = baseline * fx; min_z the least admissible depth (the baseline)."""
    max_d = bf / min_z
    best_idx, matched = row_search(feats_l, feats_r, scale_factors, max_d)
    u0_r = feats_r.uv[best_idx.long(), 0]
    ur_ref, sad_best, _ = sad_refine(img_l, img_r, feats_l.uv, u0_r)
    return filter_matches(feats_l.uv[:, 0], ur_ref, sad_best, matched, bf,
                          max_d)


def _windows(img_l, img_r, uv_l, u0_r):
    """The 11x11 left windows (N, 11, 11) and 11x21 right strips
    (N, 11, 21) of the reference's edge-padded images, its dynamic_slice
    start clamping included."""
    h, w = img_l.shape
    hp, wp = h + 2 * PAD, w + 2 * PAD
    yi = torch.round(uv_l[:, 1]).long() + PAD
    xli = torch.round(uv_l[:, 0]).long() + PAD
    xri = torch.round(u0_r).long() + PAD
    y0 = torch.clamp(yi - SAD_W, 0, hp - WIN)
    xl0 = torch.clamp(xli - SAD_W, 0, wp - WIN)
    xr0 = torch.clamp(xri - SAD_W - SAD_L, 0, wp - STRIP)
    dev = img_l.device
    rows = torch.clamp(y0[:, None] + torch.arange(WIN, device=dev) - PAD,
                       0, h - 1)
    cols_l = torch.clamp(xl0[:, None] + torch.arange(WIN, device=dev) - PAD,
                         0, w - 1)
    cols_r = torch.clamp(xr0[:, None] + torch.arange(STRIP, device=dev) - PAD,
                         0, w - 1)
    return (img_l[rows[:, :, None], cols_l[:, None, :]],
            img_r[rows[:, :, None], cols_r[:, None, :]])


def sad_refine_plain(img_l, img_r, uv_l, u0_r):
    """Plain version of K7. Per left keypoint: the 11x11 window minus its
    centre against 11 right windows over +-5 px of u0_r, SAD each, argmin
    (first on ties), parabola fit on (k-1, k, k+1) clipped to +-1 and 0 at
    the ends. Returns (ur_ref (N,) float32, sad_best (N,) float32, k_best
    (N,) int32)."""
    LAUNCHES["plain"] += 1
    wl, strip = _windows(img_l, img_r, uv_l, u0_r)
    wl = wl - wl[:, SAD_W, SAD_W, None, None]
    sads = []
    for k in range(NCAND):
        wr = strip[:, :, k:k + WIN]
        wr = wr - wr[:, SAD_W, SAD_W, None, None]
        sads.append(torch.sum(torch.abs(wl - wr), dim=(1, 2)))
    sads = torch.stack(sads, dim=1)                          # (N, 11)
    k_best = torch.argmin(sads, dim=1)
    km = torch.clamp(k_best - 1, 0, 2 * SAD_L)
    kp = torch.clamp(k_best + 1, 0, 2 * SAD_L)
    s0, s1, s2 = (torch.gather(sads, 1, k[:, None])[:, 0]
                  for k in (km, k_best, kp))
    denom = s0 + s2 - 2 * s1
    big = torch.abs(denom) > 1e-6
    delta = torch.where(big, (s0 - s2) / (2 * torch.where(
        big, denom, torch.ones_like(denom))), torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    interior = (k_best > 0) & (k_best < 2 * SAD_L)
    delta = torch.where(interior, delta, torch.zeros_like(delta))
    ur_ref = u0_r + (k_best.to(torch.float32) - SAD_L) + delta
    return ur_ref, s1, k_best.to(torch.int32)


def sad_refine(img_l, img_r, uv_l, u0_r):
    """K7 over every left keypoint: (ur_ref, sad_best, k_best). CUDA
    tensors: the kernel (raises if it cannot run); CPU tensors: the plain
    version."""
    if img_l.device.type == "cpu":
        return sad_refine_plain(img_l, img_r, uv_l, u0_r)
    if img_l.device.type != "cuda":
        raise ValueError(f"sad_refine: unsupported device {img_l.device}")
    n = uv_l.shape[0]
    if img_l.dtype != torch.float32 or img_r.dtype != torch.float32 or \
            img_l.dim() != 2 or img_r.shape != img_l.shape or \
            uv_l.dtype != torch.float32 or uv_l.shape != (n, 2) or \
            u0_r.dtype != torch.float32 or u0_r.shape != (n,) or \
            any(t.device != img_l.device for t in (img_r, uv_l, u0_r)):
        raise ValueError("sad_refine: needs two float32 (H, W) images, "
                         "float32 uv_l (N, 2) and u0_r (N,) on one device")
    h, w = img_l.shape
    img_l, img_r, u0_r = (t.contiguous() for t in (img_l, img_r, u0_r))
    uv_l = uv_l.contiguous()
    if uv_l.data_ptr() % 8:
        uv_l = uv_l.clone()
    ur_ref = torch.empty(n, dtype=torch.float32, device=img_l.device)
    sad_best = torch.empty(n, dtype=torch.float32, device=img_l.device)
    k_best = torch.empty(n, dtype=torch.int32, device=img_l.device)
    rc = _lib().stereo_sad(img_l.data_ptr(), img_r.data_ptr(), h, w,
                           uv_l.data_ptr(), u0_r.data_ptr(), n,
                           ur_ref.data_ptr(), sad_best.data_ptr(),
                           k_best.data_ptr(), cuda_build.stream_ptr(img_l))
    cuda_build.check(rc, "stereo_sad")
    LAUNCHES["kernel"] += 1
    return ur_ref, sad_best, k_best


def _lib():
    lib = cuda_build.library("stereo_sad")
    if lib.stereo_sad.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.stereo_sad.argtypes = [P, P, I, I, P, P, I, P, P, P, P]
        lib.stereo_sad.restype = I
    return lib


def depth_from_rgbd(feats, depth_map, bf: float) -> StereoMatches:
    """RGB-D: read the depth at each keypoint and synthesize its virtual
    right-image x (reference Frame::ComputeStereoFromRGBD)."""
    h, w = depth_map.shape
    ui = torch.clamp(torch.round(feats.uv[:, 0]).long(), 0, w - 1)
    vi = torch.clamp(torch.round(feats.uv[:, 1]).long(), 0, h - 1)
    d = depth_map[vi, ui]
    valid = feats.valid & (d > 0)
    u_right = torch.where(valid, feats.uv[:, 0] - bf / torch.where(
        d > 0, d, torch.ones_like(d)), torch.full_like(d, -1.0))
    return StereoMatches(u_right=u_right,
                         depth=torch.where(valid, d, torch.full_like(d, -1.0)),
                         valid=valid)
