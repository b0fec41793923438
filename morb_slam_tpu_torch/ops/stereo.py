"""Rectified stereo matching: row-band descriptor search, SAD subpixel
refinement and dispersion-based outlier rejection; the non-rectified
two-camera match with midpoint triangulation; RGB-D depth lookup
(counterpart of `morb_slam_tpu/ops/stereo.py`).

One launch of K3's gated mode (`hamming.hamming_top2_gated`, "row_band":
row band, disparity range, octave band, tested per pair in the kernel)
gives the reference's gated argmin, first column on ties. `refine_and_filter`
is kernel K7, the rest of the match in one launch (the matched right x, the
SAD sweep and parabola, the disparity gate and the median dispersion
filter, the depth): on CUDA tensors it launches `csrc/stereo_sad.cu`; on
CPU tensors it runs `refine_and_filter_plain` (`sad_refine_plain`, then
`filter_matches`). `sad_refine` is the sweep's three outputs alone, from
the same kernel. `match_stereo_general` is kernel K16
(`csrc/stereo_general.cu`) on CUDA tensors and `match_stereo_general_plain`
on CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import cameras, lie
from . import cuda_build, hamming

TH_ORB = (hamming.TH_HIGH + hamming.TH_LOW) // 2  # 75
SAD_W = 5          # SAD half-window (11x11)
SAD_L = 5          # disparity slide half-range
PAD = SAD_W + SAD_L + 2
WIN = 2 * SAD_W + 1
STRIP = WIN + 2 * SAD_L
NCAND = 2 * SAD_L + 1
DISPERSION = 1.5 * 1.4   # the median test's factor, a Python double

LAUNCHES = {"kernel": 0, "plain": 0}
GENERAL_LAUNCHES = {"kernel": 0, "plain": 0}
EP_GATE = 0.01         # |b_r^T E b_l| of a two-camera candidate pair


class StereoMatches(NamedTuple):
    u_right: torch.Tensor   # (NL,) float32 refined right x at level 0, -1
    depth: torch.Tensor     # (NL,) float32 depth, -1 if none
    valid: torch.Tensor     # (NL,) bool


def row_search(feats_l, feats_r, scale_factors, max_d: float):
    """Gated descriptor search along rectified rows. Returns (best right
    index (NL,) int32, matched (NL,) bool: best distance <= TH_ORB)."""
    # the row band scales with the left keypoint's octave
    band = 2.0 * scale_factors[feats_l.octave.long()]
    best, best_idx, _ = hamming.hamming_top2_gated(
        feats_l.desc, feats_r.desc, feats_l.uv, band, feats_l.octave,
        feats_l.valid, feats_r.uv, feats_r.octave, feats_r.valid,
        "row_band", max_d=max_d)
    return best_idx, best <= TH_ORB


def filter_matches(u_l, ur_ref, sad_best, matched, bf: float, max_d: float):
    """Disparity range, then the 1.5 * 1.4 * median SAD dispersion rule.
    No keypoint: empty matches."""
    nl = u_l.shape[0]
    if nl == 0:
        return StereoMatches(u_right=torch.empty_like(ur_ref),
                             depth=torch.empty_like(ur_ref),
                             valid=torch.empty_like(matched))
    disparity = u_l - ur_ref
    matched = matched & (disparity > 0.0) & (disparity < max_d)
    sad_sorted = torch.sort(torch.where(matched, sad_best,
                                        torch.full_like(sad_best,
                                                        float("inf"))))[0]
    n_m = torch.sum(matched)
    # a gather, not a 0-d index: indexing with a device scalar would sync
    median = sad_sorted.gather(0, torch.clamp(n_m // 2, 0, nl - 1).reshape(1))
    keep = matched & (sad_best <= DISPERSION * median)
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
    return refine_and_filter(img_l, img_r, feats_l.uv, feats_r.uv, best_idx,
                             matched, bf, max_d)


def refine_and_filter_plain(img_l, img_r, uv_l, uv_r, best_idx, matched,
                            bf: float, max_d: float) -> StereoMatches:
    """Plain version of K7: the matched right x, `sad_refine_plain`, then
    `filter_matches`."""
    u0_r = uv_r[best_idx.long(), 0]
    ur_ref, sad_best, _ = sad_refine_plain(img_l, img_r, uv_l, u0_r)
    return filter_matches(uv_l[:, 0], ur_ref, sad_best, matched, bf, max_d)


def refine_and_filter(img_l, img_r, uv_l, uv_r, best_idx, matched,
                      bf: float, max_d: float) -> StereoMatches:
    """K7, the rectified match after the row search: the right x of each
    left keypoint's best match (`best_idx` into `uv_r`), the SAD sweep and
    parabola, the disparity gate, the median dispersion filter and the
    depth, `refine_and_filter_plain`'s result bit for bit on integer-valued
    images. CUDA tensors: one launch (raises if it cannot run); CPU
    tensors: the plain version."""
    if img_l.device.type == "cpu":
        return refine_and_filter_plain(img_l, img_r, uv_l, uv_r, best_idx,
                                       matched, bf, max_d)
    if img_l.device.type != "cuda":
        raise ValueError(f"refine_and_filter: unsupported device "
                         f"{img_l.device}")
    n, nr = uv_l.shape[0], uv_r.shape[0]
    if uv_r.dtype != torch.float32 or uv_r.dim() != 2 or \
            uv_r.shape[1] != 2 or (nr == 0 and n > 0) or \
            best_idx.dtype != torch.int32 or best_idx.shape != (n,) or \
            matched.dtype != torch.bool or matched.shape != (n,) or \
            any(t.device != img_l.device for t in (uv_r, best_idx, matched)):
        raise ValueError("refine_and_filter: needs float32 uv_r (NR, 2), "
                         "int32 best_idx (N,) and bool matched (N,) on the "
                         "images' device")
    sm, _ = _k7(img_l, img_r, uv_l, None, uv_r, best_idx, matched, bf, max_d)
    return sm


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
    """K7's sweep over every left keypoint against the right x u0_r:
    (ur_ref, sad_best, k_best). CUDA tensors: the kernel without its
    filter (raises if it cannot run); CPU tensors: the plain version."""
    if img_l.device.type == "cpu":
        return sad_refine_plain(img_l, img_r, uv_l, u0_r)
    if img_l.device.type != "cuda":
        raise ValueError(f"sad_refine: unsupported device {img_l.device}")
    n = uv_l.shape[0]
    if u0_r.dtype != torch.float32 or u0_r.shape != (n,) or \
            u0_r.device != img_l.device:
        raise ValueError("sad_refine: needs float32 u0_r (N,) on the "
                         "images' device")
    _, sweep = _k7(img_l, img_r, uv_l, u0_r.contiguous())
    return sweep


def _k7(img_l, img_r, uv_l, u0_r=None, uv_r=None, best_idx=None,
        matched=None, bf=0.0, max_d=0.0):
    """One K7 launch: (StereoMatches or None without `matched`, (ur_ref,
    sad_best, k_best)); k_best is None with `matched` (the tail does not
    write it). No keypoint: empty outputs, no launch and no count."""
    n = uv_l.shape[0]
    if img_l.dtype != torch.float32 or img_r.dtype != torch.float32 or \
            img_l.dim() != 2 or img_r.shape != img_l.shape or \
            uv_l.dtype != torch.float32 or uv_l.shape != (n, 2) or \
            any(t.device != img_l.device for t in (img_r, uv_l)):
        raise ValueError("K7: needs two float32 (H, W) images and float32 "
                         "uv_l (N, 2) on one device")
    h, w = img_l.shape
    dev = img_l.device
    img_l, img_r = img_l.contiguous(), img_r.contiguous()
    uv_l = _aligned8(uv_l)
    f32 = torch.float32
    ur_ref = torch.empty(n, dtype=f32, device=dev)
    sad_best = torch.empty(n, dtype=f32, device=dev)
    k_best, sm = None, None
    ptr = lambda t: 0 if t is None else t.data_ptr()    # noqa: E731
    if matched is not None:
        uv_r, best_idx = _aligned8(uv_r), best_idx.contiguous()
        matched = matched.contiguous()
        sm = StereoMatches(torch.empty(n, dtype=f32, device=dev),
                           torch.empty(n, dtype=f32, device=dev),
                           torch.empty(n, dtype=torch.bool, device=dev))
    else:
        k_best = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return sm, (ur_ref, sad_best, k_best)
    rc = _lib().stereo_sad(
        img_l.data_ptr(), img_r.data_ptr(), h, w, uv_l.data_ptr(), ptr(u0_r),
        ptr(uv_r), ptr(best_idx), 0 if uv_r is None else uv_r.shape[0],
        ptr(matched), ctypes.c_float(max_d), ctypes.c_float(DISPERSION),
        ctypes.c_float(bf), n, ur_ref.data_ptr(), sad_best.data_ptr(),
        ptr(k_best), *(ptr(t) for t in (sm or (None,) * 3)),
        _ticket(img_l), cuda_build.stream_ptr(img_l))
    cuda_build.check(rc, "stereo_sad")
    LAUNCHES["kernel"] += 1
    return sm, (ur_ref, sad_best, k_best)


def _aligned8(t):
    """t contiguous on an 8-byte boundary (the kernel reads float2)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 8 else t


_TICKETS: dict = {}


def _ticket(t) -> int:
    """The last-block counter of K7 launches on t's current stream: zeroed
    once, and each launch's last block leaves it at zero again."""
    key = (t.device, cuda_build.stream_ptr(t))
    buf = _TICKETS.get(key)
    if buf is None:
        buf = _TICKETS[key] = torch.zeros(1, dtype=torch.int32,
                                          device=t.device)
    return buf.data_ptr()


def _lib():
    lib = cuda_build.library("stereo_sad")
    if lib.stereo_sad.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        Fl = ctypes.c_float
        lib.stereo_sad.argtypes = [P, P, I, I, P, P, P, P, I, P, Fl, Fl, Fl,
                                   I] + [P] * 8
        lib.stereo_sad.restype = I
    return lib


# ---------------------------------------------------------------------------
# non-rectified two-camera rig (K16)
# ---------------------------------------------------------------------------

def _dot3(a, b):
    """Row-wise dot product of (..., 3) tensors, summed left to right (K16
    repeats this order)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _mv3(M, v):
    """(3, 3) matrix times each row of v (N, 3), sums left to right."""
    return torch.stack([M[i, 0] * v[:, 0] + M[i, 1] * v[:, 1]
                        + M[i, 2] * v[:, 2] for i in range(3)], dim=-1)


def _mtv3(M, v):
    """M^T times each row of v (N, 3), sums left to right."""
    return torch.stack([M[0, i] * v[:, 0] + M[1, i] * v[:, 1]
                        + M[2, i] * v[:, 2] for i in range(3)], dim=-1)


def epipolar_residual(bear_l, bear_r, R_rl, t_rl):
    """(NL, NR) |b_r^T E b_l| with E = [t_rl]x R_rl: E b_l per left
    bearing, then the dot with each right bearing, sums left to right."""
    Eb = _mv3(lie.so3_hat(t_rl) @ R_rl, bear_l)              # (NL, 3)
    return torch.abs(Eb[:, None, 0] * bear_r[None, :, 0]
                     + Eb[:, None, 1] * bear_r[None, :, 1]
                     + Eb[:, None, 2] * bear_r[None, :, 2])


def _triangulate_gate(bear_l, bear_r_m, uv_l, uv_r_m, R_rl, t_rl, sigma2,
                      cam_l, cam_r, max_reproj_chi2, max_cos_parallax):
    """Midpoint triangulation of each left bearing with its matched right
    bearing, in the left frame, and the gates: (depth z, gate pass (NL,)
    bool, the two views' chi2 e_l, e_r (NL,))."""
    d1 = bear_l
    d2 = _mtv3(R_rl, bear_r_m)                               # R_lr b_r
    c2 = -_mtv3(R_rl, t_rl[None, :])[0]                      # right centre
    a11 = _dot3(d1, d1)
    a12 = -_dot3(d1, d2)
    a22 = _dot3(d2, d2)
    b1 = _dot3(d1, c2[None, :])
    b2 = -_dot3(d2, c2[None, :])
    det = a11 * a22 - a12 * a12
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                      det)
    alpha = (b1 * a22 - b2 * a12) / det
    beta = (a11 * b2 - a12 * b1) / det
    X = 0.5 * (alpha[:, None] * d1 + c2[None, :] + beta[:, None] * d2)
    cosp = _dot3(d1, d2)
    ul, vl = cameras.project_distorted(cam_l, X).unbind(-1)
    X_r = _mv3(R_rl, X) + t_rl[None, :]
    ur, vr = cameras.project_distorted(cam_r, X_r).unbind(-1)
    dul, dvl = ul - uv_l[:, 0], vl - uv_l[:, 1]
    dur, dvr = ur - uv_r_m[:, 0], vr - uv_r_m[:, 1]
    e_l = (dul * dul + dvl * dvl) / sigma2
    e_r = (dur * dur + dvr * dvr) / sigma2
    good = ((alpha > 0) & (beta > 0) & (X[:, 2] > 0) & (X_r[:, 2] > 0)
            & (cosp < max_cos_parallax) & (e_l < max_reproj_chi2)
            & (e_r < max_reproj_chi2))
    return X[:, 2], good, e_l, e_r


def match_stereo_general_plain(feats_l, feats_r, bear_l, bear_r, uv_l, uv_r,
                               cam_l, cam_r, R_rl, t_rl, sigma2,
                               max_reproj_chi2: float = 5.991,
                               max_cos_parallax: float = 0.9998):
    """Plain version of K16, step by step as the reference package's
    `match_stereo_general`: the epipolar gate in bearing space with octaves
    within 1, the gated Hamming argmin (first column on ties) with a cross
    check (argmin over rows, first row on ties), midpoint triangulation in
    the left frame and the alpha, beta, depth, parallax and two-view chi2
    gates. Returns (StereoMatches (u_right = the matched raw right x, depth
    = z in the left frame), idx (NL,) int32: the cross-checked match under
    TH_ORB before the geometric gates, or -1)."""
    GENERAL_LAUNCHES["plain"] += 1
    nl = bear_l.shape[0]
    dev = bear_l.device
    ep = epipolar_residual(bear_l, bear_r, R_rl, t_rl)
    oct_ok = torch.abs(feats_l.octave[:, None] - feats_r.octave[None, :]) <= 1
    cand = ((ep < EP_GATE) & oct_ok & feats_l.valid[:, None]
            & feats_r.valid[None, :])
    dist = torch.where(cand, hamming.hamming_matrix(feats_l.desc,
                                                    feats_r.desc),
                       torch.full((), hamming.BIG, dtype=torch.int32,
                                  device=dev))
    best_idx = torch.argmin(dist, dim=1)
    best_dist = torch.gather(dist, 1, best_idx[:, None])[:, 0]
    best_rev = torch.argmin(dist, dim=0)
    matched = (best_dist <= TH_ORB) & (
        best_rev[best_idx] == torch.arange(nl, device=dev))
    uv_r_m = uv_r[best_idx]
    z, good, _, _ = _triangulate_gate(
        bear_l, bear_r[best_idx], uv_l, uv_r_m, R_rl, t_rl, sigma2, cam_l,
        cam_r, max_reproj_chi2, max_cos_parallax)
    good = good & matched
    idx = torch.where(matched, best_idx.to(torch.int32),
                      torch.full_like(best_idx, -1, dtype=torch.int32))
    return StereoMatches(
        u_right=torch.where(good, uv_r_m[:, 0],
                            torch.full_like(z, -1.0)),
        depth=torch.where(good, z, torch.full_like(z, -1.0)),
        valid=good), idx


def match_stereo_general(feats_l, feats_r, bear_l, bear_r, uv_l, uv_r,
                         cam_l, cam_r, R_rl, t_rl, sigma2,
                         max_reproj_chi2: float = 5.991,
                         max_cos_parallax: float = 0.9998):
    """K16: the non-rectified two-camera match (reference
    KannalaBrandt8::TriangulateMatches), `match_stereo_general_plain`'s
    result. CUDA tensors: the kernel (raises if it cannot run): one pass
    over the NL x NR pairs that folds each into its row's and its column's
    minimum, then the rows' cross check and triangulation, two kernels
    that never form the distance matrix; CPU tensors: the plain version."""
    if bear_l.device.type == "cpu":
        return match_stereo_general_plain(
            feats_l, feats_r, bear_l, bear_r, uv_l, uv_r, cam_l, cam_r, R_rl,
            t_rl, sigma2, max_reproj_chi2, max_cos_parallax)
    if bear_l.device.type != "cuda":
        raise ValueError(f"match_stereo_general: unsupported device "
                         f"{bear_l.device}")
    nl, nr = bear_l.shape[0], bear_r.shape[0]
    f32, i32 = torch.float32, torch.int32
    want = ((feats_l.desc, i32, (nl, 8)), (feats_r.desc, i32, (nr, 8)),
            (feats_l.octave, i32, (nl,)), (feats_r.octave, i32, (nr,)),
            (feats_l.valid, torch.bool, (nl,)),
            (feats_r.valid, torch.bool, (nr,)), (bear_l, f32, (nl, 3)),
            (bear_r, f32, (nr, 3)), (uv_l, f32, (nl, 2)),
            (uv_r, f32, (nr, 2)), (sigma2, f32, (nl,)),
            (R_rl, f32, (3, 3)), (t_rl, f32, (3,)),
            (cam_l.params, f32, (9,)), (cam_r.params, f32, (9,)))
    if any(t.dtype != d or tuple(t.shape) != s or t.device != bear_l.device
           for t, d, s in want) or nr == 0 or \
            cam_l.kind not in (0, 1) or cam_r.kind not in (0, 1):
        raise ValueError("match_stereo_general: needs int32 (N, 8) "
                         "descriptors and octaves, bool valid flags, "
                         "float32 (N, 3) bearings, (N, 2) pixels, (NL,) "
                         "sigma2, (3, 3) R_rl, (3,) t_rl and two cameras "
                         "on one device")
    if nl == 0:
        e = torch.empty(0, dtype=f32, device=bear_l.device)
        return StereoMatches(e, e, e.bool()), e.to(i32)
    ins = [t.contiguous() for t, _, _ in want]
    ins[4], ins[5] = ins[4].to(torch.uint8), ins[5].to(torch.uint8)
    ins[0], ins[1] = (hamming._aligned(t) for t in ins[:2])
    # E by the plain version's own product, so both gate the same values
    ins.insert(13, (lie.so3_hat(t_rl) @ R_rl).contiguous())
    dev = bear_l.device
    # each 64 x 64 tile's (distance, index) key of its rows and its columns
    row_part = torch.empty(((nr + 63) // 64, nl), dtype=torch.int64,
                           device=dev)
    col_part = torch.empty(((nl + 63) // 64, nr), dtype=torch.int64,
                           device=dev)
    u_right = torch.empty(nl, dtype=f32, device=dev)
    depth = torch.empty(nl, dtype=f32, device=dev)
    valid = torch.empty(nl, dtype=torch.uint8, device=dev)
    idx = torch.empty(nl, dtype=i32, device=dev)
    rc = _general_lib().stereo_general(
        *(t.data_ptr() for t in ins), cam_l.kind, cam_r.kind, nl, nr,
        ctypes.c_float(max_reproj_chi2), ctypes.c_float(max_cos_parallax),
        row_part.data_ptr(), col_part.data_ptr(), u_right.data_ptr(),
        depth.data_ptr(), valid.data_ptr(), idx.data_ptr(),
        cuda_build.stream_ptr(bear_l))
    cuda_build.check(rc, "stereo_general")
    GENERAL_LAUNCHES["kernel"] += 1
    return StereoMatches(u_right=u_right, depth=depth,
                         valid=valid.bool()), idx


def _general_lib():
    lib = cuda_build.library("stereo_general")
    if lib.stereo_general.argtypes is None:
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.stereo_general.argtypes = [P] * 16 + [I, I, I, I, Fl, Fl] + \
            [P] * 7
        lib.stereo_general.restype = I
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
