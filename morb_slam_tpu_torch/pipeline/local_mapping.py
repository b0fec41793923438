"""Per-keyframe mapping: triangulation against covisible neighbours,
fusion, landmark culling, local bundle adjustment and keyframe culling, and
for an IMU-initialized map the visual-inertial variants (local and full
inertial BA over the temporal keyframe chain, keyframe culling that merges
the preintegration chain) (counterpart of
`morb_slam_tpu/pipeline/local_mapping.py`). Every stage is a functional
update of MapState (and of the KfImu store).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import cameras, lie, matching
from ..mapstate import state as ms
from ..optim import ba, vi_ba
from ..optim import inertial as inertial_mod
from ..solvers import triangulation
from ..tensor_ops import mask_first, put, put2, topk

N_TRI_NEIGHBORS = 8       # covisible neighbours for triangulation
BA_WINDOW = 12            # optimized KFs in local BA
BA_FIXED = 6              # frontier KFs held fixed
BA_ITERS = 5              # LM iterations
MAX_LOCAL_LM = 6144
MAX_NEW_PER_PAIR = 384    # new landmarks accepted per neighbour pair


class LocalMapConfig(NamedTuple):
    focal: float
    scale: float = 1.2
    n_levels: int = 8
    baseline: float = 0.0
    inertial: bool = False

    def sigma2_inv(self, device="cpu"):
        """Per-octave information (1 / scale^(2 octave))."""
        return 1.0 / (self.scale ** (2 * torch.arange(
            self.n_levels, dtype=torch.float32, device=device)))


def _relative_pose(R1, t1, R2, t2):
    """T_21 = T_2w T_1w^-1 for world->camera poses."""
    R21 = lie.matmat(R2, R1.transpose(-1, -2))
    return R21, t2 - lie.matvec(R21, t1)


def _set_landmarks(m: ms.MapState, slot, sel_good, pos, desc, ref_kf, ts,
                   dmax):
    """Write new landmarks into `slot` where sel_good (slot == L: none)."""
    g = sel_good
    L = m.lm_valid.shape[0]
    sl = torch.clamp(slot, max=L - 1).long()

    def keep(new, old):
        mask = g.reshape(g.shape + (1,) * (new.dim() - 1))
        return torch.where(mask, new, old)
    return m._replace(
        lm_pos=put(m.lm_pos, slot, keep(pos, m.lm_pos[sl])),
        lm_valid=put(m.lm_valid, slot, g | m.lm_valid[sl]),
        lm_ref_kf=put(m.lm_ref_kf, slot, keep(
            torch.as_tensor(ref_kf, dtype=torch.int32,
                            device=g.device).expand(g.shape),
            m.lm_ref_kf[sl])),
        lm_first_ts=put(m.lm_first_ts, slot, keep(ts.expand(g.shape),
                                                  m.lm_first_ts[sl])),
        lm_desc=put(m.lm_desc, slot, keep(desc, m.lm_desc[sl])),
        lm_dist_max=put(m.lm_dist_max, slot, keep(dmax, m.lm_dist_max[sl])),
        lm_visible=put(m.lm_visible, slot, keep(torch.ones_like(
            m.lm_visible[sl]), m.lm_visible[sl])),
        lm_found=put(m.lm_found, slot, keep(torch.ones_like(
            m.lm_found[sl]), m.lm_found[sl])),
    )


def create_new_landmarks(m: ms.MapState, kf_id: int, cfg: LocalMapConfig,
                         win=None):
    """Triangulate new landmarks between keyframe `kf_id` and its best
    covisible neighbours (plus its temporal predecessor)."""
    K, F = m.kf_feat_lm.shape
    L = m.lm_valid.shape[0]
    dev = m.kf_t.device
    n_neigh = min(N_TRI_NEIGHBORS, K - 1)
    if win is None:
        win = ms.local_window(m, kf_id, n_neigh + 1, min_weight=10)
    neigh_idx = win[0][1:n_neigh + 1]
    neigh_ok = win[1][1:n_neigh + 1]
    prev = m.kf_prev[kf_id].long()
    prev_c = torch.clamp(prev, min=0)
    prev_ok = (prev >= 0) & m.kf_valid[prev_c] & torch.all(neigh_idx != prev)
    last = torch.arange(n_neigh, device=dev) == n_neigh - 1
    neigh_idx = torch.where(last, torch.where(prev_ok, prev_c, neigh_idx),
                            neigh_idx)
    neigh_ok = torch.where(last, neigh_ok | prev_ok, neigh_ok)

    xn1 = m.kf_feat_xn[kf_id]
    desc1 = m.kf_feat_desc[kf_id]
    oct1 = m.kf_feat_octave[kf_id]
    valid1 = m.kf_feat_valid[kf_id]
    R1, t1 = m.kf_R[kf_id], m.kf_t[kf_id]
    n_new_cap = min(MAX_NEW_PER_PAIR, F)
    Rwc1 = R1.T
    c1 = lie.matvec(Rwc1, t1)

    for i in range(n_neigh):
        nkf, ok = neigh_idx[i], neigh_ok[i]
        free1 = m.kf_feat_lm[kf_id] < 0
        R21, t21 = _relative_pose(R1, t1, m.kf_R[nkf], m.kf_t[nkf])
        E12 = lie.matmat(lie.so3_hat(t21), R21)
        baseline = torch.linalg.norm(t21)
        idx = matching.search_for_triangulation(
            xn1, desc1, oct1, valid1, free1,
            m.kf_feat_xn[nkf], m.kf_feat_desc[nkf], m.kf_feat_octave[nkf],
            m.kf_feat_valid[nkf], m.kf_feat_lm[nkf] < 0,
            E12, cfg.focal, cfg.scale)
        matched = (idx >= 0) & ok & (baseline > 0.01)
        j = torch.clamp(idx, min=0).long()
        x2 = m.kf_feat_xn[nkf][j]
        X1 = triangulation.triangulate_two_view(xn1, x2, R21, t21)
        good, cosp = triangulation.depth_and_reproj_checks(
            X1, xn1, x2, R21, t21, th2=5.991 / cfg.focal ** 2)
        good = good & (cosp < 0.9998) & matched
        Xw = lie.se3_apply(Rwc1, -c1, X1)

        score = torch.where(good, 1.0 - cosp, torch.full_like(cosp, -1.0))
        sel = topk(score, n_new_cap)[1]
        sel_good = good[sel]
        free_slots = mask_first(~m.lm_valid, n_new_cap)
        n_free_ok = (~m.lm_valid)[free_slots]
        rank = torch.clamp(torch.cumsum(sel_good.to(torch.int32), 0) - 1,
                           min=0).long()
        sel_good = sel_good & n_free_ok[rank]
        slot = torch.where(sel_good, free_slots[rank],
                           torch.full_like(free_slots[rank], L))
        feat2 = j[sel]
        dist1 = torch.linalg.norm(Xw[sel] + c1[None, :], dim=-1)
        dmax = dist1 * cfg.scale ** oct1[sel].to(torch.float32)
        m = _set_landmarks(m, slot, sel_good, Xw[sel], desc1[sel], kf_id,
                           m.kf_ts[kf_id], dmax)
        sl = slot.to(torch.int32)
        fl = m.kf_feat_lm
        fl = put2(fl, kf_id, sel, torch.where(sel_good, sl, fl[kf_id, sel]))
        fl = put2(fl, nkf, feat2, torch.where(sel_good, sl, fl[nkf, feat2]))
        m = m._replace(kf_feat_lm=fl,
                       n_lm=m.n_lm + torch.sum(sel_good, dtype=torch.int32))
    return m


def fuse_in_neighbors(m: ms.MapState, kf_id: int, cam: cameras.Camera,
                      cfg: LocalMapConfig, win=None):
    """Bind the keyframe's landmarks to free features of its covisible
    neighbours by projection search, and the reverse direction."""
    K, F = m.kf_feat_lm.shape
    L = m.lm_valid.shape[0]
    n_neigh = min(N_TRI_NEIGHBORS, K - 1)
    if win is None:
        win = ms.local_window(m, kf_id, n_neigh + 1, min_weight=10)
    neigh_idx = win[0][1:n_neigh + 1]
    neigh_ok = win[1][1:n_neigh + 1]

    def fuse_into(m, src_kf, dst_kf, ok):
        lm_ids = m.kf_feat_lm[src_kf]
        lm_ok = (lm_ids >= 0) & m.kf_feat_valid[src_kf] & ok
        ids = torch.clamp(lm_ids, min=0).long()
        dst_lm = m.kf_feat_lm[dst_kf]
        seen = torch.zeros(L + 1, dtype=torch.bool, device=ids.device)
        seen[torch.where(dst_lm >= 0, dst_lm, torch.full_like(dst_lm, L))
             .long()] = True
        lm_ok = lm_ok & ~seen[ids]
        res = matching.search_by_projection(
            m.lm_pos[ids], m.lm_normal[ids], m.lm_dist_max[ids],
            m.lm_desc[ids], lm_ok & m.lm_valid[ids],
            m.kf_R[dst_kf], m.kf_t[dst_kf],
            lambda Xc: cameras.project(cam, Xc),
            m.kf_feat_uv[dst_kf], m.kf_feat_octave[dst_kf],
            m.kf_feat_desc[dst_kf], m.kf_feat_valid[dst_kf] & (dst_lm < 0),
            (10000, 10000), radius_px=3.0, scale=cfg.scale,
            n_levels=cfg.n_levels, max_dist_th=50, ratio=1.0)
        new_lm = torch.where(res.feat_lm >= 0,
                             ids[torch.clamp(res.feat_lm, min=0).long()]
                             .to(torch.int32), dst_lm)
        return m._replace(kf_feat_lm=put(m.kf_feat_lm, dst_kf[None],
                                         new_lm[None]))

    for i in range(n_neigh):
        m = fuse_into(m, kf_id, neigh_idx[i], neigh_ok[i])
        m = fuse_into(m, neigh_idx[i], torch.as_tensor(kf_id,
                                                       device=neigh_idx.device),
                      neigh_ok[i])
    return m


def cull_landmarks(m: ms.MapState, kf_id=None):
    """Probation culling of recently created landmarks: too few
    observations two inserts after creation, or a found / visible ratio
    under 0.25."""
    n_obs = ms.lm_obs_count(m)
    K = m.kf_valid.shape[0]
    ts_v = torch.where(m.kf_valid, m.kf_ts,
                       torch.full_like(m.kf_ts, float("-inf")))
    top4 = topk(ts_v, min(4, K))[0]
    thr_recent = top4[-1]
    thr_age2 = top4[min(2, K - 1)]
    recent = torch.isfinite(m.lm_first_ts) & (m.lm_first_ts >= thr_recent)
    aged2 = m.lm_first_ts <= thr_age2
    ratio = m.lm_found.to(torch.float32) / torch.clamp(
        m.lm_visible.to(torch.float32), min=1.0)
    true = torch.ones_like(recent)
    seen_enough = torch.where(recent & aged2, n_obs >= 3, true)
    ratio_ok = torch.where(recent & (m.lm_visible > 4), ratio > 0.25, true)
    keep = m.lm_valid & seen_enough & ratio_ok & (n_obs >= 1)
    L = m.lm_valid.shape[0]
    dropped = torch.cat([~keep, torch.zeros_like(keep[:1])])
    slot_lm = torch.where(m.kf_feat_lm >= 0, m.kf_feat_lm,
                          torch.full_like(m.kf_feat_lm, L)).long()
    detach = dropped[slot_lm]
    return m._replace(lm_valid=keep,
                      kf_feat_lm=torch.where(detach,
                                             torch.full_like(m.kf_feat_lm, -1),
                                             m.kf_feat_lm))


def local_bundle_adjustment(m: ms.MapState, kf_id, cfg: LocalMapConfig,
                            win=None):
    """Local BA over the covisible window (two oldest window keyframes and
    the frontier held fixed), then detach outlier observations."""
    K, F = m.kf_feat_lm.shape
    L = m.lm_valid.shape[0]
    dev = m.kf_t.device
    KW = min(BA_WINDOW + BA_FIXED, K)
    n_opt = min(BA_WINDOW, K)
    if win is None:
        win = ms.local_window(m, kf_id, KW, min_weight=10)
    win_idx, win_ok = win[0][:KW], win[1][:KW]
    oldest = torch.sort(torch.where(win_ok, win_idx,
                                    torch.full_like(win_idx, 1 << 30)))[0][:2]
    opt_mask = (win_ok & (torch.arange(KW, device=dev) < n_opt)
                & (win_idx != 0) & (win_idx != oldest[0])
                & (win_idx != oldest[1]))
    slot_lm = torch.where(m.kf_feat_lm >= 0, m.kf_feat_lm,
                          torch.full_like(m.kf_feat_lm, L)).long()
    win_slots = torch.where(win_ok[:, None], slot_lm[win_idx],
                            torch.full_like(slot_lm[win_idx], L))
    lm_in = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    lm_in[win_slots.reshape(-1)] = True
    lm_in = lm_in[:L] & m.lm_valid
    n_local = min(MAX_LOCAL_LM, L)
    lm_sel = mask_first(lm_in, n_local)
    lm_sel_ok = lm_in[lm_sel]
    g2l = put(torch.full((L + 1,), -1, dtype=torch.int32, device=dev), lm_sel,
              torch.where(lm_sel_ok, torch.arange(n_local, dtype=torch.int32,
                                                  device=dev),
                          torch.full((n_local,), -1, dtype=torch.int32,
                                     device=dev)))
    obs_lm_local = g2l[win_slots]
    obs_ok = (obs_lm_local >= 0) & m.kf_feat_valid[win_idx] & win_ok[:, None]
    inv_sig2 = cfg.sigma2_inv(dev)[torch.clamp(m.kf_feat_octave[win_idx], 0,
                                               cfg.n_levels - 1).long()]
    info = (cfg.focal ** 2) * inv_sig2
    prob = ba.make_problem(
        R=m.kf_R[win_idx], t=m.kf_t[win_idx], X=m.lm_pos[lm_sel],
        obs_kf=torch.arange(KW, dtype=torch.int32, device=dev)[:, None]
        .expand(KW, F).reshape(-1),
        obs_lm=torch.clamp(obs_lm_local, min=0).reshape(-1),
        obs_uv=m.kf_feat_xn[win_idx].reshape(KW * F, 2),
        obs_info=info.reshape(-1), obs_mask=obs_ok.reshape(-1),
        kf_opt=opt_mask, lm_opt=lm_sel_ok,
        obs_ur=m.kf_feat_ur[win_idx].reshape(-1), baseline=cfg.baseline)
    Rn, tn, Xn, _ = ba.ba_solve(prob, n_iters=BA_ITERS)
    m = m._replace(
        kf_R=put(m.kf_R, win_idx, torch.where(opt_mask[:, None, None], Rn,
                                              m.kf_R[win_idx])),
        kf_t=put(m.kf_t, win_idx, torch.where(opt_mask[:, None], tn,
                                              m.kf_t[win_idx])),
        lm_pos=put(m.lm_pos, lm_sel, torch.where(lm_sel_ok[:, None], Xn,
                                                 m.lm_pos[lm_sel])))
    keep = ba.classify_outliers(prob._replace(R=Rn, t=tn, X=Xn), Rn, tn, Xn)
    drop = (~keep.reshape(KW, F)) & obs_ok
    old = m.kf_feat_lm[win_idx]
    new_feat_lm = torch.where(drop, torch.full_like(old, -1), old)
    return m._replace(kf_feat_lm=put(
        m.kf_feat_lm, win_idx, torch.where(win_ok[:, None], new_feat_lm, old)))


def _redundant_rows(m: ms.MapState, rows, n_min_others: int = 3,
                    max_oct: int = 8):
    """(R, F) bool: each slot's landmark seen by >= n_min_others other
    keyframes at the same or finer scale; and the slots holding one."""
    K, F = m.kf_feat_lm.shape
    L = m.lm_valid.shape[0]
    slot_ok = m.kf_feat_valid & m.kf_valid[:, None] & (m.kf_feat_lm >= 0)
    lm = torch.where(slot_ok, m.kf_feat_lm,
                     torch.full_like(m.kf_feat_lm, L)).long()
    oct_ = torch.clamp(m.kf_feat_octave, 0, max_oct - 1).long()
    idx = lm * max_oct + torch.where(slot_ok, oct_, torch.zeros_like(oct_))
    hist = torch.zeros((L + 1) * max_oct, dtype=torch.int32,
                       device=lm.device).index_add(
        0, idx.reshape(-1), slot_ok.reshape(-1).to(torch.int32))
    hist = hist[:L * max_oct].reshape(L, max_oct)
    cum = torch.cat([torch.cumsum(hist, dim=1, dtype=torch.int32),
                     torch.zeros((1, max_oct), dtype=torch.int32,
                                 device=lm.device)])
    lm_r = lm[rows]
    ok_r = slot_ok[rows]
    j = torch.clamp(oct_[rows] + 1, 0, max_oct - 1)
    support = cum[lm_r, j] - 1
    return (support >= n_min_others) & ok_r, ok_r


def cull_keyframes(m: ms.MapState, kf_id, win=None):
    """Drop up to two covisible keyframes whose landmarks are >= 90% seen by
    three other keyframes at the same or finer scale (never KF 0 or the
    newest), splice the temporal chain and re-parent their landmarks."""
    K, F = m.kf_feat_lm.shape
    dev = m.kf_t.device
    nc = min(12, K)
    if win is None:
        win = ms.local_window(m, kf_id, nc, min_weight=10)
    cand, cand_ok = win[0][:nc], win[1][:nc]
    redundant, has = _redundant_rows(m, cand)
    n_lm_cand = torch.sum(has, dim=1, dtype=torch.int32)
    frac_cand = torch.sum(redundant, dim=1, dtype=torch.int32) / torch.clamp(
        n_lm_cand, min=1)
    frac = put(torch.zeros(K, dtype=torch.float32, device=dev), cand,
               torch.where(cand_ok, frac_cand, torch.zeros_like(frac_cand)))
    n_lm_kf = put(torch.zeros(K, dtype=torch.int32, device=dev), cand,
                  torch.where(cand_ok, n_lm_cand, torch.zeros_like(n_lm_cand)))
    is_cand = put(torch.zeros(K, dtype=torch.bool, device=dev),
                  torch.where(cand_ok, cand, torch.zeros_like(cand)), cand_ok)
    ar = torch.arange(K, device=dev)
    cull = (is_cand & m.kf_valid & (frac > 0.9) & (n_lm_kf > 20)
            & (ar != 0) & (ar != kf_id))
    score = torch.where(cull, frac, torch.full_like(frac, -1.0))
    top2 = topk(score, 2)[1]
    keep_cull = put(torch.zeros(K, dtype=torch.bool, device=dev), top2,
                    score[top2] > 0)
    prev = m.kf_prev
    for _ in range(2):
        p = torch.clamp(prev, 0, K - 1).long()
        dangling = (prev >= 0) & keep_cull[p]
        prev = torch.where(dangling, m.kf_prev[p], prev)
    m = m._replace(kf_valid=m.kf_valid & ~keep_cull, kf_prev=prev)
    return ms.reparent_landmark_refs(m)


def mapping_step(m: ms.MapState, kf_id: int, cam: cameras.Camera,
                 cfg: LocalMapConfig):
    """Per-keyframe mapping: triangulate -> stats -> fuse -> cull points ->
    local BA -> cull keyframes -> stats, over one covisibility window (its
    refresh after fusion feeds BA and culling)."""
    K = m.kf_valid.shape[0]
    KW = min(BA_WINDOW + BA_FIXED, K)
    win = ms.local_window(m, kf_id, KW, min_weight=10)
    m = create_new_landmarks(m, kf_id, cfg, win=win)
    m = ms.update_landmark_stats_window(m, win[0], win[1])
    m = fuse_in_neighbors(m, kf_id, cam, cfg, win=win)
    m = cull_landmarks(m, kf_id)
    win = ms.local_window(m, kf_id, KW, min_weight=10)
    m = local_bundle_adjustment(m, kf_id, cfg, win=win)
    if not cfg.inertial:
        m = cull_keyframes(m, kf_id, win=win)
    return ms.update_landmark_stats_window(m, win[0], win[1])


# ---------------------------------------------------------------------------
# visual-inertial mapping
# ---------------------------------------------------------------------------

def _vi_window_problem(m: ms.MapState, ki: inertial_mod.KfImu, win_idx,
                       win_ok, opt_pose, opt_vb, cfg: LocalMapConfig,
                       prior_bias_info, n_local_lm: int):
    """Gather a VIBAProblem over window keyframes `win_idx` (W,) from the
    map and the preintegration store. Returns (problem, lm_sel, lm_sel_ok,
    obs_ok)."""
    K, F = m.kf_feat_lm.shape
    L = m.lm_valid.shape[0]
    W = win_idx.shape[0]
    dev = m.kf_t.device
    i32 = torch.int32
    slot_lm = torch.where(m.kf_feat_lm >= 0, m.kf_feat_lm,
                          torch.full_like(m.kf_feat_lm, L)).long()
    win_slots = torch.where(win_ok[:, None], slot_lm[win_idx],
                            torch.full_like(slot_lm[win_idx], L))
    lm_in = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    lm_in[win_slots.reshape(-1)] = True
    lm_in = lm_in[:L] & m.lm_valid
    n_local = min(n_local_lm, L)
    lm_sel = mask_first(lm_in, n_local)
    lm_sel_ok = lm_in[lm_sel]
    g2l_lm = put(torch.full((L + 1,), -1, dtype=i32, device=dev), lm_sel,
                 torch.where(lm_sel_ok, torch.arange(n_local, dtype=i32,
                                                     device=dev),
                             torch.full((n_local,), -1, dtype=i32,
                                        device=dev)))
    obs_lm_local = g2l_lm[win_slots]
    obs_ok = (obs_lm_local >= 0) & m.kf_feat_valid[win_idx] & win_ok[:, None]
    inv_sig2 = cfg.sigma2_inv(dev)[torch.clamp(m.kf_feat_octave[win_idx], 0,
                                               cfg.n_levels - 1).long()]
    info = (cfg.focal ** 2) * inv_sig2
    R_wb, p_wb = lie.se3_inv(m.kf_R[win_idx], m.kf_t[win_idx])
    # inertial edge at window slot w: g2l[prev[kf_w]] -> w
    ar_w = torch.arange(W, dtype=i32, device=dev)
    g2l_kf = put(torch.full((K + 1,), -1, dtype=i32, device=dev),
                 torch.where(win_ok, win_idx, torch.full_like(win_idx, K)),
                 torch.where(win_ok, ar_w, torch.full_like(ar_w, -1)))
    kf_prev = ki.prev[win_idx].long()
    e_prev_l = g2l_kf[torch.where(kf_prev >= 0, torch.clamp(kf_prev, 0, K - 1),
                                  torch.full_like(kf_prev, K))]
    e_valid = ki.valid[win_idx] & win_ok & (e_prev_l >= 0)
    e_prev_l = torch.where(e_valid, e_prev_l, torch.zeros_like(e_prev_l))
    prob = vi_ba.VIBAProblem(
        R_wb=R_wb, p_wb=p_wb, v=m.kf_v[win_idx], bias=m.kf_bias[win_idx],
        fix_pose=~opt_pose, fix_vb=~opt_vb,
        X=m.lm_pos[lm_sel], lm_opt=lm_sel_ok,
        obs_kf=ar_w[:, None].expand(W, F).reshape(-1),
        obs_lm=torch.clamp(obs_lm_local, min=0).reshape(-1),
        obs_uv=m.kf_feat_xn[win_idx].reshape(W * F, 2),
        obs_ur=m.kf_feat_ur[win_idx].reshape(-1),
        obs_info=info.reshape(-1), obs_mask=obs_ok.reshape(-1),
        baseline=torch.full((), cfg.baseline, dtype=torch.float32,
                            device=dev),
        e_valid=e_valid, e_prev=e_prev_l,
        e_dt=ki.dt[win_idx], e_dR=ki.dR[win_idx], e_dV=ki.dV[win_idx],
        e_dP=ki.dP[win_idx], e_JRg=ki.J_Rg[win_idx],
        e_JVg=ki.J_Vg[win_idx], e_JVa=ki.J_Va[win_idx],
        e_JPg=ki.J_Pg[win_idx], e_JPa=ki.J_Pa[win_idx],
        e_info=vi_ba.floor_info(ki.info[win_idx]),
        e_bias0=ki.bias0[win_idx], e_rw_info=ki.rw_info[win_idx],
        prior_bias_info=prior_bias_info.expand(W, 6))
    return prob, lm_sel, lm_sel_ok, obs_ok


def _vi_write_back(m: ms.MapState, prob, win_idx, win_ok, opt_pose, opt_vb,
                   R_wb, p_wb, v, bias, X, lm_sel, lm_sel_ok, obs_ok):
    W, F = obs_ok.shape
    R_cw, t_cw = lie.se3_inv(R_wb, p_wb)
    wp = (opt_pose & win_ok)
    wv = (opt_vb & win_ok)
    m = m._replace(
        kf_R=put(m.kf_R, win_idx, torch.where(wp[:, None, None], R_cw,
                                              m.kf_R[win_idx])),
        kf_t=put(m.kf_t, win_idx, torch.where(wp[:, None], t_cw,
                                              m.kf_t[win_idx])),
        kf_v=put(m.kf_v, win_idx, torch.where(wv[:, None], v,
                                              m.kf_v[win_idx])),
        kf_bias=put(m.kf_bias, win_idx, torch.where(wv[:, None], bias,
                                                    m.kf_bias[win_idx])),
        lm_pos=put(m.lm_pos, lm_sel, torch.where(lm_sel_ok[:, None], X,
                                                 m.lm_pos[lm_sel])))
    keep = vi_ba.classify_outliers(prob, R_wb, p_wb, X).reshape(W, F)
    drop = (~keep) & obs_ok
    old = m.kf_feat_lm[win_idx]
    new_feat_lm = torch.where(drop, torch.full_like(old, -1), old)
    return m._replace(kf_feat_lm=put(
        m.kf_feat_lm, win_idx, torch.where(win_ok[:, None], new_feat_lm, old)))


def _chain_window(ki: inertial_mod.KfImu, kf_valid, kf_id, W: int):
    """Temporal window: walk the preintegration chain `ki.prev` back from
    `kf_id`. Returns (win_idx oldest -> newest (W,), win_ok)."""
    K = kf_valid.shape[0]
    cur = torch.as_tensor(kf_id, device=kf_valid.device).long()
    newest_first = []
    for _ in range(W):
        newest_first.append(cur)
        c = torch.clamp(cur, 0, K - 1)
        nxt = ki.prev[c].long()
        ok = (cur >= 0) & (nxt >= 0) & kf_valid[torch.clamp(nxt, 0, K - 1)]
        cur = torch.where(ok, nxt, torch.full_like(nxt, -1))
    win_idx = torch.stack(newest_first[::-1])
    win_ok = (win_idx >= 0) & kf_valid[torch.clamp(win_idx, 0, K - 1)]
    return torch.clamp(win_idx, 0, K - 1), win_ok


def local_inertial_ba(m: ms.MapState, ki: inertial_mod.KfImu, kf_id,
                      cfg: LocalMapConfig):
    """Visual-inertial local BA over the temporal window: the newest 10
    keyframes optimize pose, velocity and bias, 4 older ones stay fixed;
    window landmarks refine; outliers detach."""
    K = m.kf_valid.shape[0]
    N_OPT, N_FIX = 10, 4
    W = min(N_OPT + N_FIX, K)
    win_idx, win_ok = _chain_window(ki, m.kf_valid, kf_id, W)
    is_opt = (torch.arange(W, device=win_idx.device) >= W - min(N_OPT, W)) \
        & (win_idx != 0) & win_ok
    prob, lm_sel, lm_sel_ok, obs_ok = _vi_window_problem(
        m, ki, win_idx, win_ok, is_opt, is_opt, cfg,
        torch.zeros(6, dtype=m.kf_t.dtype, device=m.kf_t.device),
        MAX_LOCAL_LM)
    R_wb, p_wb, v, bias, X, _ = vi_ba.vi_ba_solve(prob, n_iters=6)
    return _vi_write_back(m, prob, win_idx, win_ok, is_opt, is_opt,
                          R_wb, p_wb, v, bias, X, lm_sel, lm_sel_ok, obs_ok)


def full_inertial_ba(m: ms.MapState, ki: inertial_mod.KfImu, last_kf,
                     cfg: LocalMapConfig, window: int = 32,
                     prior_gyro=1.0, prior_acc=1e4,
                     fix_landmarks: bool = False):
    """Visual-inertial BA over up to `window` chained keyframes with bias
    priors toward zero (the IMU-init stages); keyframe 0's pose stays
    fixed. Returns (map, per-iteration costs)."""
    K = m.kf_valid.shape[0]
    W = min(window, K)
    win_idx, win_ok = _chain_window(ki, m.kf_valid, last_kf, W)
    is_opt = win_ok & (win_idx != 0)
    dev, f32 = m.kf_t.device, m.kf_t.dtype
    prior = torch.cat([torch.full((3,), float(prior_gyro), dtype=f32,
                                  device=dev),
                       torch.full((3,), float(prior_acc), dtype=f32,
                                  device=dev)])
    prob, lm_sel, lm_sel_ok, obs_ok = _vi_window_problem(
        m, ki, win_idx, win_ok, is_opt, win_ok, cfg, prior, MAX_LOCAL_LM)
    if fix_landmarks:
        prob = prob._replace(lm_opt=torch.zeros_like(prob.lm_opt))
    R_wb, p_wb, v, bias, X, info = vi_ba.vi_ba_solve(prob, n_iters=10)
    m = _vi_write_back(m, prob, win_idx, win_ok, is_opt, win_ok,
                       R_wb, p_wb, v, bias, X, lm_sel, lm_sel_ok, obs_ok)
    return m, info["costs"]


def cull_keyframes_inertial(m: ms.MapState, ki: inertial_mod.KfImu, kf_id,
                            win=None):
    """Redundant-keyframe culling for inertial maps: at most one keyframe
    per step, whose preintegration merges into its temporal successor (the
    merged span under 3 s). Returns (map, kf_imu)."""
    K, F = m.kf_feat_lm.shape
    dev = m.kf_t.device
    nc = min(12, K)
    if win is None:
        win = ms.local_window(m, kf_id, nc, min_weight=10)
    cand, cand_ok = win[0][:nc], win[1][:nc]
    redundant, has = _redundant_rows(m, cand)
    n_lm_cand = torch.sum(has, dim=1, dtype=torch.int32)
    frac_cand = torch.sum(redundant, dim=1, dtype=torch.int32) / torch.clamp(
        n_lm_cand, min=1)
    frac = put(torch.zeros(K, dtype=torch.float32, device=dev), cand,
               torch.where(cand_ok, frac_cand, torch.zeros_like(frac_cand)))
    n_lm_kf = put(torch.zeros(K, dtype=torch.int32, device=dev), cand,
                  torch.where(cand_ok, n_lm_cand, torch.zeros_like(n_lm_cand)))
    is_cand = put(torch.zeros(K, dtype=torch.bool, device=dev),
                  torch.where(cand_ok, cand, torch.zeros_like(cand)), cand_ok)
    ar = torch.arange(K, device=dev)
    cull = (is_cand & m.kf_valid & (frac > 0.9) & (n_lm_kf > 20)
            & (ar != 0) & (ar != kf_id) & ki.valid)
    score = torch.where(cull, frac, torch.full_like(frac, -1.0))
    k = torch.argmax(score)
    nxt_mask = (ki.prev.long() == k) & ki.valid
    nxt = torch.argmax(nxt_mask.to(torch.int32))
    can = (score[k] > 0) & torch.any(nxt_mask) & \
        (ki.dt[k] + ki.dt[nxt] < 3.0)
    ki2 = inertial_mod.merge_entry_into_next(ki, k, nxt)
    m2 = m._replace(kf_valid=m.kf_valid & (ar != k),
                    kf_prev=torch.where(ar == nxt, m.kf_prev[k], m.kf_prev))
    m2 = ms.reparent_landmark_refs(m2)

    def pick(new, old):
        return type(old)(*(torch.where(can, a, b) for a, b in zip(new, old)))
    return pick(m2, m), pick(ki2, ki)


def mapping_step_inertial(m: ms.MapState, ki: inertial_mod.KfImu,
                          kf_id: int, cam: cameras.Camera,
                          cfg: LocalMapConfig):
    """Per-keyframe mapping of an IMU-initialized map: the visual steps,
    then local inertial BA in place of the visual local BA and inertial
    keyframe culling. Returns (map, kf_imu)."""
    K = m.kf_valid.shape[0]
    KW = min(BA_WINDOW + BA_FIXED, K)
    win = ms.local_window(m, kf_id, KW, min_weight=10)
    m = create_new_landmarks(m, kf_id, cfg, win=win)
    m = ms.update_landmark_stats_window(m, win[0], win[1])
    m = fuse_in_neighbors(m, kf_id, cam, cfg, win=win)
    m = cull_landmarks(m, kf_id)
    m = local_inertial_ba(m, ki, kf_id, cfg)
    win = ms.local_window(m, kf_id, KW, min_weight=10)
    m, ki = cull_keyframes_inertial(m, ki, kf_id, win=win)
    return ms.update_landmark_stats_window(m, win[0], win[1]), ki
