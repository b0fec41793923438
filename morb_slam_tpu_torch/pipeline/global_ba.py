"""Global bundle adjustment over the whole map, and its detached,
time-sliced form (counterpart of `morb_slam_tpu/pipeline/global_ba.py`).

`global_bundle_adjustment` solves every valid keyframe (keyframe 0 holds the
gauge) and landmark with `ba.ba_solve_pcg` (K4 in per-observation mode and
K14 on the card) and detaches the outlier observations. `GBAJob` is the
detached global BA that follows a loop closure: the solve over a snapshot
of the map advances a few LM iterations per keyframe insert (`advance`, no
host synchronisation) while tracking and mapping go on, and each slice's
result is folded into the live map (`reconcile` -> `gba_reconcile`):
keyframes of the snapshot take their refined poses, newer keyframes follow
their nearest snapshot ancestor on the temporal chain (16 hops at most),
landmarks follow their reference keyframe.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from .. import lie
from ..mapstate import state as ms
from ..optim import ba
from .local_mapping import LocalMapConfig


def _build_global_problem(m: ms.MapState, cfg: LocalMapConfig):
    K, F = m.kf_feat_lm.shape
    dev = m.kf_t.device
    slot_lm = torch.where(m.kf_feat_lm >= 0, m.kf_feat_lm,
                          torch.zeros_like(m.kf_feat_lm))
    obs_ok = (m.kf_feat_lm >= 0) & m.kf_feat_valid & m.kf_valid[:, None] \
        & m.lm_valid[slot_lm.long()]
    inv_sig2 = cfg.sigma2_inv(dev)[torch.clamp(m.kf_feat_octave, 0,
                                               cfg.n_levels - 1).long()]
    info_w = (cfg.focal ** 2) * inv_sig2
    return ba.make_problem(
        R=m.kf_R, t=m.kf_t, X=m.lm_pos,
        obs_kf=torch.arange(K, dtype=torch.int32, device=dev)[:, None]
        .expand(K, F).reshape(-1),
        obs_lm=slot_lm.reshape(-1).contiguous(),
        obs_uv=m.kf_feat_xn.reshape(K * F, 2),
        obs_info=info_w.reshape(-1),
        obs_mask=obs_ok.reshape(-1),
        kf_opt=m.kf_valid & (torch.arange(K, device=dev) != 0),
        lm_opt=m.lm_valid,
        obs_ur=m.kf_feat_ur.reshape(-1),
        baseline=cfg.baseline)


def global_bundle_adjustment(m: ms.MapState, cfg: LocalMapConfig,
                             n_iters: int = 8, cg_iters: int = 40):
    """Full-map BA (all valid keyframes but keyframe 0, all valid
    landmarks) by the implicit-Schur PCG solve; outlier observations (chi2
    over 5.991 / 7.815) are detached afterwards. Returns (new map, info)."""
    K, F = m.kf_feat_lm.shape
    prob = _build_global_problem(m, cfg)
    Rn, tn, Xn, info = ba.ba_solve_pcg(prob, n_iters=n_iters,
                                       cg_iters=cg_iters)
    m = m._replace(
        kf_R=torch.where(prob.kf_opt[:, None, None], Rn, m.kf_R),
        kf_t=torch.where(prob.kf_opt[:, None], tn, m.kf_t),
        lm_pos=torch.where(m.lm_valid[:, None], Xn, m.lm_pos))
    keep = ba.classify_outliers(prob, Rn, tn, Xn)
    drop = (~keep.reshape(K, F)) & prob.obs_mask.reshape(K, F)
    return m._replace(kf_feat_lm=torch.where(
        drop, torch.full_like(m.kf_feat_lm, -1), m.kf_feat_lm)), info


def _gba_slice(prob, carry, n_iters: int, cg_iters: int):
    return ba.ba_solve_pcg(prob, n_iters=n_iters, cg_iters=cg_iters,
                           carry=carry)[3]["carry"]


def gba_reconcile(m_now: ms.MapState, snap_kf_valid, snap_kf_ts,
                  snap_lm_valid, snap_lm_ts, R_g, t_g, X_g) -> ms.MapState:
    """Fold a global BA result over a snapshot into the live map. Slot
    identity across the solve is checked by timestamp (slots recycle)."""
    K = m_now.kf_valid.shape[0]
    idx = torch.arange(K, device=m_now.kf_t.device)
    same_kf = snap_kf_valid & m_now.kf_valid & (m_now.kf_ts == snap_kf_ts)
    # nearest snapshot ancestor along kf_prev (a bounded walk)
    anc = idx
    found = same_kf
    for _ in range(16):
        prv = m_now.kf_prev[anc].long()
        step = (~found) & (prv >= 0)
        anc = torch.where(step, torch.clamp(prv, 0, K - 1), anc)
        found = found | same_kf[anc]
    a = torch.where(found, anc, torch.zeros_like(anc))
    # T_k_new = T_k_now T_a_now^-1 T_a_gba (T_k_gba when a == k)
    Rai, tai = lie.se3_inv(m_now.kf_R[a], m_now.kf_t[a])
    Rm, tm = lie.se3_mul(Rai, tai, R_g[a], t_g[a])
    R_new, t_new = lie.se3_mul(m_now.kf_R, m_now.kf_t, Rm, tm)
    upd = m_now.kf_valid & found
    R_out = torch.where(upd[:, None, None], R_new, m_now.kf_R)
    t_out = torch.where(upd[:, None], t_new, m_now.kf_t)
    # world-frame velocities rotate with each keyframe's correction
    R_cor = lie.matmat(R_out.transpose(-1, -2), m_now.kf_R)
    v_out = torch.where(upd[:, None], lie.matvec(R_cor, m_now.kf_v),
                        m_now.kf_v)
    same_lm = snap_lm_valid & m_now.lm_valid & \
        (m_now.lm_first_ts == snap_lm_ts)
    ref = torch.clamp(m_now.lm_ref_kf, 0, K - 1).long()
    Xc = lie.se3_apply(m_now.kf_R[ref], m_now.kf_t[ref], m_now.lm_pos)
    Rri, tri = lie.se3_inv(R_out[ref], t_out[ref])
    X_via_ref = lie.se3_apply(Rri, tri, Xc)
    ref_ok = upd[ref] & (m_now.lm_ref_kf >= 0)
    X_out = torch.where(same_lm[:, None], X_g,
                        torch.where((m_now.lm_valid & ref_ok)[:, None],
                                    X_via_ref, m_now.lm_pos))
    return m_now._replace(kf_R=R_out, kf_t=t_out, kf_v=v_out, lm_pos=X_out)


class GBAJob:
    """Detached global BA, time-sliced: `advance` runs `slice_iters` LM
    iterations of the solve over the snapshot taken at construction;
    `reconcile` folds the latest result into a live map. Abort by dropping
    the object."""

    def __init__(self, m_snapshot: ms.MapState, cfg: LocalMapConfig,
                 total_iters: int = 8, slice_iters: int = 2,
                 cg_iters: int = 40):
        self.prob = _build_global_problem(m_snapshot, cfg)
        self.snap = (m_snapshot.kf_valid, m_snapshot.kf_ts,
                     m_snapshot.lm_valid, m_snapshot.lm_first_ts)
        self.carry = None
        self.left = total_iters
        self.slice_iters = slice_iters
        self.cg_iters = cg_iters

    def advance(self) -> bool:
        """Run one slice; True when the solve is complete."""
        with record_function("GBA slice"):
            self.carry = _gba_slice(self.prob, self.carry, self.slice_iters,
                                    self.cg_iters)
        self.left -= self.slice_iters
        return self.left <= 0

    def reconcile(self, m_now: ms.MapState) -> ms.MapState:
        R, t, X, _, _ = self.carry
        return gba_reconcile(m_now, *self.snap, R, t, X)
