"""Struct-of-tensors SLAM map state (counterpart of
`morb_slam_tpu/mapstate/state.py`).

One `MapState` NamedTuple of fixed-capacity masked tensors. Updates are
functional: every function returns a new MapState and never writes into a
tensor it was given, so a snapshot held by a pipelined frame decision is
never changed under it. Observations are the per-keyframe feature-slot
table `kf_feat_lm` (slot -> landmark id, -1 none). Descriptors are (.., 8)
int32 words, the bit view of the reference's uint32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..ops.orb_descriptor import pack_bits, unpack_bits
from ..tensor_ops import segment_max, segment_sum, topk


class MapState(NamedTuple):
    kf_R: torch.Tensor          # (K, 3, 3) T_cw rotation
    kf_t: torch.Tensor          # (K, 3)
    kf_valid: torch.Tensor      # (K,) bool
    kf_ts: torch.Tensor         # (K,) float32 timestamps
    kf_feat_uv: torch.Tensor    # (K, F, 2) undistorted pixels
    kf_feat_xn: torch.Tensor    # (K, F, 2) normalized coords
    kf_feat_ur: torch.Tensor    # (K, F) normalized right-u, NaN = mono
    kf_feat_octave: torch.Tensor
    kf_feat_angle: torch.Tensor
    kf_feat_desc: torch.Tensor  # (K, F, 8) int32
    kf_feat_valid: torch.Tensor
    kf_feat_lm: torch.Tensor    # (K, F) int32 landmark per slot, -1 none
    kf_v: torch.Tensor
    kf_bias: torch.Tensor
    kf_prev: torch.Tensor       # (K,) int32 temporal chain
    lm_pos: torch.Tensor        # (L, 3)
    lm_valid: torch.Tensor
    lm_desc: torch.Tensor       # (L, 8) int32
    lm_normal: torch.Tensor
    lm_dist_max: torch.Tensor
    lm_ref_kf: torch.Tensor
    lm_first_ts: torch.Tensor
    lm_visible: torch.Tensor
    lm_found: torch.Tensor
    n_kf: torch.Tensor
    n_lm: torch.Tensor


def empty_map(max_kf: int, n_feat: int, max_lm: int, device="cpu") -> MapState:
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return MapState(
        kf_R=torch.eye(3, dtype=f32, device=device).repeat(max_kf, 1, 1),
        kf_t=full((max_kf, 3), 0.0, f32),
        kf_valid=full((max_kf,), False, torch.bool),
        kf_ts=full((max_kf,), 0.0, f32),
        kf_feat_uv=full((max_kf, n_feat, 2), 0.0, f32),
        kf_feat_xn=full((max_kf, n_feat, 2), 0.0, f32),
        kf_feat_ur=full((max_kf, n_feat), float("nan"), f32),
        kf_feat_octave=full((max_kf, n_feat), 0, i32),
        kf_feat_angle=full((max_kf, n_feat), 0.0, f32),
        kf_feat_desc=full((max_kf, n_feat, 8), 0, i32),
        kf_feat_valid=full((max_kf, n_feat), False, torch.bool),
        kf_feat_lm=full((max_kf, n_feat), -1, i32),
        kf_v=full((max_kf, 3), 0.0, f32),
        kf_bias=full((max_kf, 6), 0.0, f32),
        kf_prev=full((max_kf,), -1, i32),
        lm_pos=full((max_lm, 3), 0.0, f32),
        lm_valid=full((max_lm,), False, torch.bool),
        lm_desc=full((max_lm, 8), 0, i32),
        lm_normal=full((max_lm, 3), 0.0, f32),
        lm_dist_max=full((max_lm,), 1.0, f32),
        lm_ref_kf=full((max_lm,), -1, i32),
        lm_first_ts=full((max_lm,), float("-inf"), f32),
        lm_visible=full((max_lm,), 0, i32),
        lm_found=full((max_lm,), 0, i32),
        n_kf=full((), 0, i32),
        n_lm=full((), 0, i32),
    )


def lie_matvec(M, v):
    return torch.sum(M * v[..., None, :], dim=-1)


def _slot_lm(m: MapState):
    L = m.lm_valid.shape[0]
    return torch.where(m.kf_feat_lm >= 0, m.kf_feat_lm,
                       torch.full_like(m.kf_feat_lm, L)).long()


# ---------------------------------------------------------------------------
# covisibility (derived, not maintained)
# ---------------------------------------------------------------------------

def covisibility_matrix(m: MapState):
    """(K, K) int32 landmarks shared by each keyframe pair."""
    K, F = m.kf_feat_lm.shape
    L = m.lm_valid.shape[0]
    A = torch.zeros((K, L + 1), dtype=torch.float32, device=m.kf_t.device)
    A[torch.arange(K, device=A.device)[:, None], _slot_lm(m)] = 1.0
    A = A[:, :L] * m.lm_valid[None, :].to(torch.float32)
    Wm = (A @ A.T).round().to(torch.int32)
    Wm = Wm * (1 - torch.eye(K, dtype=torch.int32, device=A.device))
    return Wm * (m.kf_valid[:, None] & m.kf_valid[None, :])


def covisibility_row(m: MapState, center_kf):
    """(K,) int32 landmarks shared between `center_kf` and every keyframe
    (0 on the center itself)."""
    L = m.lm_valid.shape[0]
    lm_c = m.kf_feat_lm[center_kf]
    hit = torch.where((lm_c >= 0) & m.kf_feat_valid[center_kf], lm_c,
                      torch.full_like(lm_c, L)).long()
    in_c = torch.zeros(L + 1, dtype=torch.bool, device=lm_c.device)
    in_c[hit] = True
    lookup = torch.cat([in_c[:L] & m.lm_valid, in_c[L:] & False])
    shared = torch.sum(lookup[_slot_lm(m)] & m.kf_feat_valid, dim=1,
                       dtype=torch.int32)
    shared = shared * m.kf_valid
    idx = torch.arange(shared.shape[0], device=shared.device)
    return torch.where(idx == center_kf, torch.zeros_like(shared), shared)


def local_window(m: MapState, center_kf, size: int, min_weight: int = 15):
    """Top covisible keyframes of `center_kf`, itself first. Returns
    (kf_idx (size,) int64, valid (size,) bool)."""
    w = covisibility_row(m, center_kf)
    w = torch.where(torch.arange(w.shape[0], device=w.device) == center_kf,
                    torch.full_like(w, 1 << 30), w)
    vals, idx = topk(w, size)
    valid = (vals >= min_weight) | (idx == center_kf)
    return idx, valid & m.kf_valid[idx]


# ---------------------------------------------------------------------------
# landmark statistics
# ---------------------------------------------------------------------------

@record_function("lm_obs_count")
def lm_obs_count(m: MapState):
    """(L,) int32 observation count per landmark (a profiler range names
    its kernels)."""
    L = m.lm_valid.shape[0]
    slot_ok = m.kf_feat_valid & m.kf_valid[:, None] & (m.kf_feat_lm >= 0)
    lm = torch.where(slot_ok, m.kf_feat_lm,
                     torch.full_like(m.kf_feat_lm, L)).reshape(-1)
    ones = torch.ones_like(lm)
    return segment_sum(ones, lm, L + 1)[:L]


def _stats(lm_of, okf, desc, v, L: int):
    """Per-landmark majority-vote descriptor and mean viewing direction of
    the observations (lm_of (O,), okf (O,) bool, desc (O, 8), v (O, 3) the
    landmark-minus-camera vectors)."""
    f32 = torch.float32
    bits = unpack_bits(desc).to(f32) * okf[:, None].to(f32)
    bit_sum = segment_sum(bits, lm_of, L + 1)[:L]
    n_sum = segment_sum(okf.to(f32), lm_of, L + 1)[:L]
    vn = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                         min=1e-9)
    nrm_sum = segment_sum(vn * okf[:, None].to(f32), lm_of, L + 1)[:L]
    return bit_sum, n_sum, nrm_sum


def _finish(m: MapState, bit_sum, n_sum, nrm_sum):
    new_desc = pack_bits(2.0 * bit_sum > n_sum[:, None])
    normal = nrm_sum / torch.clamp(
        torch.linalg.norm(nrm_sum, dim=-1, keepdim=True), min=1e-9)
    upd = m.lm_valid & (n_sum > 0)
    return new_desc, normal, upd


def update_landmark_stats(m: MapState) -> MapState:
    """Recompute every landmark's majority-vote descriptor, viewing normal
    and scale band (from its reference keyframe) over all observations."""
    K, F = m.kf_feat_lm.shape
    L = m.lm_valid.shape[0]
    f32 = torch.float32
    slot_ok = m.kf_feat_valid & m.kf_valid[:, None] & (m.kf_feat_lm >= 0)
    lm_of_slot = torch.where(slot_ok, m.kf_feat_lm,
                             torch.full_like(m.kf_feat_lm, L)).long()
    cam_centers = -lie_matvec(m.kf_R.transpose(-1, -2), m.kf_t)
    lm_pad = torch.cat([m.lm_pos, torch.zeros_like(m.lm_pos[:1])])
    bit_sum = torch.zeros((L, 256), dtype=f32, device=m.kf_t.device)
    n_sum = torch.zeros(L, dtype=f32, device=m.kf_t.device)
    nrm_sum = torch.zeros((L, 3), dtype=f32, device=m.kf_t.device)
    CHUNK = 32          # bounds the (chunk * F, 256) bit matrix
    for k0 in range(0, K, CHUNK):
        k1 = min(K, k0 + CHUNK)
        lm_k = lm_of_slot[k0:k1].reshape(-1)
        ctr = cam_centers[k0:k1].repeat_interleave(F, dim=0)
        b, n, nr = _stats(lm_k, slot_ok[k0:k1].reshape(-1),
                          m.kf_feat_desc[k0:k1].reshape(-1, 8),
                          lm_pad[lm_k] - ctr, L)
        bit_sum, n_sum, nrm_sum = bit_sum + b, n_sum + n, nrm_sum + nr
    new_desc, normal, upd = _finish(m, bit_sum, n_sum, nrm_sum)

    ref = torch.clamp(m.lm_ref_kf, 0, K - 1).long()
    dist_ref = torch.linalg.norm(m.lm_pos - cam_centers[ref], dim=-1)
    k_ids = torch.arange(K, device=ref.device)[:, None].expand(K, F)
    in_ref = slot_ok & (k_ids == ref[torch.clamp(m.kf_feat_lm, 0,
                                                 L - 1).long()])
    lm_flat = torch.where(in_ref, m.kf_feat_lm,
                          torch.full_like(m.kf_feat_lm, L)).reshape(-1)
    oct_ref = segment_max(m.kf_feat_octave.reshape(-1), lm_flat, L + 1)[:L]
    oct_ref = torch.clamp(oct_ref, 0, 15)
    dmax = dist_ref * (1.2 ** oct_ref.to(f32))
    return m._replace(
        lm_desc=torch.where(upd[:, None], new_desc, m.lm_desc),
        lm_normal=torch.where(upd[:, None], normal, m.lm_normal),
        lm_dist_max=torch.where(upd, torch.clamp(dmax, min=1e-3),
                                m.lm_dist_max))


def update_landmark_stats_window(m: MapState, win_idx, win_ok) -> MapState:
    """Refresh descriptor / normal / scale band of the landmarks observed by
    the keyframe window, from the window's observations only."""
    K, F = m.kf_feat_lm.shape
    L = m.lm_valid.shape[0]
    Wn = win_idx.shape[0]
    f32 = torch.float32
    lm_w = m.kf_feat_lm[win_idx]
    slot_ok = (m.kf_feat_valid[win_idx] & win_ok[:, None] & (lm_w >= 0)
               & m.kf_valid[win_idx][:, None])
    lm_of = torch.where(slot_ok, lm_w, torch.full_like(lm_w, L)).reshape(-1)
    okf = slot_ok.reshape(-1)
    cam_centers = -lie_matvec(m.kf_R[win_idx].transpose(-1, -2),
                              m.kf_t[win_idx])
    ctr = cam_centers.repeat_interleave(F, dim=0)
    lm_pad = torch.cat([m.lm_pos, torch.zeros_like(m.lm_pos[:1])])
    v = lm_pad[lm_of.long()] - ctr
    bit_sum, n_sum, nrm_sum = _stats(lm_of, okf,
                                     m.kf_feat_desc[win_idx].reshape(-1, 8),
                                     v, L)
    new_desc, normal, upd = _finish(m, bit_sum, n_sum, nrm_sum)
    dist = torch.linalg.norm(v, dim=-1)
    octv = m.kf_feat_octave[win_idx].reshape(-1).to(f32)
    dmax_obs = dist * (1.2 ** torch.clamp(octv, 0, 15))
    dmax = segment_max(torch.where(okf, dmax_obs, torch.zeros_like(dmax_obs)),
                       lm_of, L + 1)[:L]
    return m._replace(
        lm_desc=torch.where(upd[:, None], new_desc, m.lm_desc),
        lm_normal=torch.where(upd[:, None], normal, m.lm_normal),
        lm_dist_max=torch.where(upd & (dmax > 0), torch.clamp(dmax, min=1e-3),
                                m.lm_dist_max))


def reparent_landmark_refs(m: MapState) -> MapState:
    """Re-parent landmarks whose reference keyframe is no longer valid onto
    their newest surviving observer."""
    K, F = m.kf_feat_lm.shape
    L = m.lm_valid.shape[0]
    slot_ok = m.kf_feat_valid & m.kf_valid[:, None] & (m.kf_feat_lm >= 0)
    lm_of = torch.where(slot_ok, m.kf_feat_lm,
                        torch.full_like(m.kf_feat_lm, L)).reshape(-1)
    ts_b = torch.where(m.kf_valid, m.kf_ts,
                       torch.full_like(m.kf_ts, float("-inf")))[:, None] \
        .expand(K, F).reshape(-1)
    ok_flat = slot_ok.reshape(-1)
    best_ts = segment_max(torch.where(ok_flat, ts_b,
                                      torch.full_like(ts_b, float("-inf"))),
                          lm_of, L + 1)[:L]
    in_best = ok_flat & (ts_b == best_ts[torch.clamp(lm_of, 0, L - 1).long()]) \
        & (lm_of < L)
    k_b = torch.arange(K, dtype=torch.int32, device=lm_of.device)[:, None] \
        .expand(K, F).reshape(-1)
    new_ref = segment_max(torch.where(in_best, k_b, torch.full_like(k_b, -1)),
                          lm_of, L + 1)[:L]
    ref_bad = m.lm_valid & ((m.lm_ref_kf < 0) | ~m.kf_valid[
        torch.clamp(m.lm_ref_kf, 0, K - 1).long()])
    return m._replace(lm_ref_kf=torch.where(ref_bad & (new_ref >= 0),
                                            new_ref.to(m.lm_ref_kf.dtype),
                                            m.lm_ref_kf))
