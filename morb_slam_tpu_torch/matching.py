"""Data-association searches over fixed-capacity feature / landmark tensors
(counterpart of `morb_slam_tpu/matching.py`): projection search against the
local map and the last frame, initialization and triangulation searches.

Each search builds a dense (rows x features) candidate gate in PyTorch and
hands it with the descriptors to K3 (`ops.hamming.hamming_top2`), which
returns the best, best index and second best per row without writing the
distance matrix. Conflicts resolve by segment-min, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie
from .ops import hamming
from .tensor_ops import segment_min

BIG = hamming.BIG


def predict_scale(dist, max_dist, scale: float, n_levels: int):
    """Scale level predicted from the viewing distance."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-6), min=1.0)
    level = torch.ceil(torch.log(ratio) / torch.log(
        torch.tensor(scale, dtype=torch.float32))).to(torch.int32)
    return torch.clamp(level, 0, n_levels - 1)


class ProjectionMatches(NamedTuple):
    feat_lm: torch.Tensor     # (N,) int32 matched landmark per feature, -1
    n_matches: torch.Tensor


def _resolve_conflicts(best_feat, best_dist, lm_mask, n_feats: int):
    """Per-landmark winners -> per-feature landmark, keeping the closest
    landmark (lowest id on ties) when several claim one feature."""
    key = torch.where(lm_mask, best_dist, torch.full_like(best_dist, BIG))
    feat_min = segment_min(key, best_feat, n_feats)
    won = lm_mask & (key == feat_min[best_feat.long()])
    lm_ids = torch.arange(best_feat.shape[0], dtype=torch.int32,
                          device=best_feat.device)
    id_key = torch.where(won, lm_ids, torch.full_like(lm_ids, 1 << 30))
    first_lm = segment_min(id_key, best_feat, n_feats)
    return torch.where(first_lm < (1 << 30), first_lm,
                       torch.full_like(first_lm, -1))


def _ratio_ok(best, second, max_dist, ratio):
    return (best <= max_dist) & (best.to(torch.float32)
                                 < ratio * second.to(torch.float32))


def search_by_projection(lm_pos, lm_normal, lm_dist_max, lm_desc, lm_valid,
                         R_cw, t_cw, cam_project, feat_uv, feat_octave,
                         feat_desc, feat_valid, image_wh,
                         radius_px: float, scale: float, n_levels: int,
                         max_dist_th: int = hamming.TH_HIGH,
                         ratio: float = 0.8, check_view_angle: bool = True):
    """Project landmarks into the frame and match within a window scaled by
    the predicted octave; returns the landmark index per feature."""
    N = feat_uv.shape[0]
    dev = lm_pos.device
    scale_factors = scale ** torch.arange(n_levels, dtype=torch.float32,
                                          device=dev)
    Xc = lie.se3_apply(R_cw, t_cw, lm_pos)
    z = Xc[..., 2]
    uv = cam_project(Xc)
    in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < image_wh[0]) &
              (uv[:, 1] >= 0) & (uv[:, 1] < image_wh[1]))
    cam_center = -lie.matvec(R_cw.T, t_cw)
    view = lm_pos - cam_center
    dist = torch.linalg.norm(view, dim=-1)
    lm_dist_min = lm_dist_max / (scale ** (n_levels - 1))
    in_band = (dist > 0.8 * lm_dist_min) & (dist < 1.2 * lm_dist_max)
    visible = lm_valid & (z > 0.2) & in_img & in_band
    if check_view_angle:
        cosv = torch.sum(view * lm_normal, dim=-1) / torch.clamp(
            dist * torch.linalg.norm(lm_normal, dim=-1), min=1e-9)
        visible &= cosv > 0.5

    pred = predict_scale(dist, lm_dist_max, scale, n_levels)
    r = radius_px * scale_factors[pred.long()]
    d_uv = uv[:, None, :] - feat_uv[None, :, :]
    close = torch.amax(torch.abs(d_uv), dim=-1) <= r[:, None]
    oct_ok = (feat_octave[None, :] >= pred[:, None] - 1) & \
             (feat_octave[None, :] <= pred[:, None] + 1)
    cand = close & oct_ok & visible[:, None] & feat_valid[None, :]
    best_dist, best_feat, second = hamming.hamming_top2(lm_desc, feat_desc,
                                                        cand)
    ok = _ratio_ok(best_dist, second, max_dist_th, ratio)
    feat_lm = _resolve_conflicts(best_feat, best_dist, ok, N)
    return ProjectionMatches(feat_lm=feat_lm,
                             n_matches=torch.sum(feat_lm >= 0))


def search_for_initialization(uv1, desc1, valid1, ang1, uv2, desc2, valid2,
                              ang2, window_px: float = 100.0,
                              ratio: float = 0.9):
    """Window-gated mutual NN with ratio test and rotation histogram between
    two frames. Returns idx (N1,) into frame 2 or -1."""
    d_uv = uv1[:, None, :] - uv2[None, :, :]
    close = torch.amax(torch.abs(d_uv), dim=-1) <= window_px
    cand = close & valid1[:, None] & valid2[None, :]
    idx, _ = hamming.match_nn(desc1, desc2, cand, valid1, valid2,
                              max_dist=hamming.TH_LOW, ratio=ratio,
                              cross_check=True)
    keep = hamming.rotation_consistency_mask(ang1, ang2, idx)
    return torch.where(keep, idx, torch.full_like(idx, -1))


def search_last_frame(last_uv, last_desc, last_lm, last_valid, cur_uv,
                      cur_octave, cur_desc, cur_valid, proj_uv, proj_pred,
                      radius_px: float, scale: float,
                      last_angle=None, cur_angle=None, ratio: float = 0.9):
    """Match current features against the last frame's landmark-bearing
    features after motion-model projection (proj_uv NaN where it failed).
    Returns the landmark index per current feature."""
    dev = last_uv.device
    has_lm = last_valid & (last_lm >= 0) & torch.isfinite(proj_uv[:, 0])
    scale_factors = scale ** torch.arange(16, dtype=torch.float32, device=dev)
    r = radius_px * scale_factors[torch.clamp(proj_pred, 0, 15).long()]
    d_uv = proj_uv[:, None, :] - cur_uv[None, :, :]
    close = torch.amax(torch.abs(torch.nan_to_num(d_uv, nan=1e9)),
                       dim=-1) <= r[:, None]
    oct_ok = (cur_octave[None, :] >= proj_pred[:, None] - 1) & \
             (cur_octave[None, :] <= proj_pred[:, None] + 1)
    cand = close & oct_ok & has_lm[:, None] & cur_valid[None, :]
    best_dist, best_feat, second = hamming.hamming_top2(last_desc, cur_desc,
                                                        cand)
    ok = _ratio_ok(best_dist, second, hamming.TH_HIGH, ratio)
    if last_angle is not None:
        ok &= hamming.rotation_consistency_mask(
            last_angle, cur_angle,
            torch.where(ok, best_feat, torch.full_like(best_feat, -1)))
    winner = _resolve_conflicts(best_feat, best_dist, ok, cur_uv.shape[0])
    return torch.where(winner >= 0,
                       last_lm[torch.clamp(winner, min=0).long()],
                       torch.full_like(winner, -1))


def search_for_triangulation(xn1, desc1, oct1, valid1, free1,
                             xn2, desc2, oct2, valid2, free2,
                             E12, focal: float, scale: float,
                             ratio: float = 0.75):
    """Epipolar-gated mutual NN between the un-associated features of two
    keyframes. Returns idx (N1,) into KF2's features or -1."""
    x1h = torch.cat([xn1, torch.ones_like(xn1[..., :1])], dim=-1)
    x2h = torch.cat([xn2, torch.ones_like(xn2[..., :1])], dim=-1)
    Ex1 = torch.sum(E12[None, :, :] * x1h[:, None, :], dim=-1)     # (N1, 3)
    num = Ex1 @ x2h.T                                              # (N1, N2)
    den = torch.sqrt(torch.clamp(Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2, min=1e-12))
    dist_epi = torch.abs(num) / den[:, None]
    sf2 = scale ** oct2[None, :].to(torch.float32)
    epi_ok = dist_epi * focal < 3.84 * sf2
    cand = (epi_ok & valid1[:, None] & valid2[None, :] &
            free1[:, None] & free2[None, :])
    idx, _ = hamming.match_nn(desc1, desc2, cand, valid1 & free1,
                              valid2 & free2, max_dist=hamming.TH_LOW,
                              ratio=ratio, cross_check=True)
    return idx
