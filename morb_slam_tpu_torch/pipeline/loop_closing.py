"""Loop detection, Sim(3) verification, essential-graph correction and the
Atlas merge (counterpart of `morb_slam_tpu/pipeline/loop_closing.py`).

After a keyframe insert, `LoopCloser.maybe_close` queries the keyframe
database (K10) for candidates outside the covisible group, verifies them by
descriptor matching (K3) and a Sim(3) RANSAC on the 3D-3D pairs
(`verify_candidate`), then by guided projection matching and a 7-dof
Gauss-Newton refinement (`guided_sim3_verify`); a loop fires after two
consistent detections. `correct_loop` then redistributes the drift with the
Sim(3) pose graph, `search_and_fuse` welds the two sides' landmarks, and
the detached global BA (`global_ba.GBAJob`, K4 per-observation mode + K14)
starts; its first two slices run at once. `maybe_merge` welds a stashed map
back through the same verification against the stashed database
(`verify_merge`), an essential-graph pass when several contacts verify, and
a weld-window BA. Every Hamming search gives its gate to K3, which never
forms the N x M distance matrix. The RANSAC sample tables are drawn from
the tracker's `torch.Generator`. The decisions (inlier counts, candidate
flags) are read on the host, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import cameras, lie, matching
from ..mapstate import atlas as atlas_mod
from ..mapstate import state as ms
from ..ops import hamming
from ..optim import pose_graph
from ..solvers import sim3 as sim3_solver
from ..tensor_ops import mask_first, put, topk
from ..vocab import database as kfdb
from . import global_ba, local_mapping

MIN_SIM3_INLIERS = 20
MIN_ACCEPT_MATCHES = 35
COVIS_EDGE_MIN = 30        # covisibility weight for pose-graph edges
COVIS_EDGES_PER_KF = 16
MAX_PAST_LOOP_EDGES = 8    # past loop / merge edges kept in the graph
MAX_LOCAL_LM_FUSE = 4096   # loop-side landmark pool of SearchAndFuse
SIM3_HYP = 128


def _kf_landmarks(m: ms.MapState, kf):
    lm = m.kf_feat_lm[kf]
    ok = (lm >= 0) & m.kf_feat_valid[kf] & \
        m.lm_valid[torch.clamp(lm, min=0).long()]
    return lm, ok


def verify_merge(m_new: ms.MapState, kf_id, m_old: ms.MapState, cand, cfg,
                 fix_scale: bool = False, samples=None, generator=None):
    """Geometric verification of a candidate keyframe of m_old (a stashed
    map, or the active one) for keyframe kf_id of m_new: mutual-best
    descriptor matches of their landmark-bound features (K3), then Sim(3)
    RANSAC on the matched points in the two cameras. Returns (s, R, t)
    mapping the candidate's camera points into the keyframe's camera, and
    the inlier count."""
    lm1, ok1 = _kf_landmarks(m_new, kf_id)
    lm2, ok2 = _kf_landmarks(m_old, cand)
    idx, _ = hamming.match_nn(m_new.kf_feat_desc[kf_id],
                              m_old.kf_feat_desc[cand],
                              ok1[:, None] & ok2[None, :], ok1, ok2,
                              max_dist=hamming.TH_LOW, ratio=0.75,
                              cross_check=True)
    j = torch.clamp(idx, min=0).long()
    X1w = m_new.lm_pos[torch.clamp(lm1, min=0).long()]
    X2w = m_old.lm_pos[torch.clamp(lm2[j], min=0).long()]
    X1c = lie.se3_apply(m_new.kf_R[kf_id], m_new.kf_t[kf_id], X1w)
    X2c = lie.se3_apply(m_old.kf_R[cand], m_old.kf_t[cand], X2w)
    res = sim3_solver.solve_sim3(
        X1c, X2c, m_new.kf_feat_xn[kf_id], m_old.kf_feat_xn[cand][j],
        idx >= 0, focal=cfg.focal, fix_scale=fix_scale, n_hyp=SIM3_HYP,
        samples=samples, generator=generator)
    return res.s, res.R, res.t, res.n_inliers


def verify_candidate(m: ms.MapState, kf_id, cand, cfg,
                     fix_scale: bool = False, samples=None, generator=None):
    """Loop verification: `verify_merge` with both keyframes in m."""
    return verify_merge(m, kf_id, m, cand, cfg, fix_scale, samples,
                        generator)


@record_function("guided_sim3_verify")
def guided_sim3_verify(m: ms.MapState, kf_id, cand, s0, R0, t0, cfg):
    """Guided projection matching + Sim(3) Gauss-Newton: project the
    candidate's landmarks through (s0, R0, t0) into the keyframe, match in
    a 7.5 px window scaled by octave (K3), refine (s, R, t) on the pairs
    with two-sided reprojection residuals (2 rounds of 5 steps, outliers
    reclassified at chi2 9.21 between them). Returns (s, R, t,
    n_matches)."""
    f32 = m.kf_t.dtype
    dev = m.kf_t.device
    CHI2_SIM3 = 9.21
    lm2, ok2 = _kf_landmarks(m, cand)
    X2c = lie.se3_apply(m.kf_R[cand], m.kf_t[cand],
                        m.lm_pos[torch.clamp(lm2, min=0).long()])
    ok2 = ok2 & (X2c[:, 2] > 0.05)
    lm1, ok1 = _kf_landmarks(m, kf_id)
    X1c = lie.se3_apply(m.kf_R[kf_id], m.kf_t[kf_id],
                        m.lm_pos[torch.clamp(lm1, min=0).long()])
    ok1 = ok1 & (X1c[:, 2] > 0.05)
    xn1 = m.kf_feat_xn[kf_id]
    xn2 = m.kf_feat_xn[cand]
    valid1 = m.kf_feat_valid[kf_id]

    X1p = lie.sim3_apply(s0, R0, t0, X2c)
    z = X1p[:, 2]
    pred = X1p[:, :2] / torch.where(torch.abs(z) < 1e-6,
                                    torch.full_like(z, 1e-6), z)[:, None]
    rad = 7.5 / cfg.focal * cfg.scale ** m.kf_feat_octave[cand].to(f32)
    d2 = torch.sum((pred[:, None, :] - xn1[None, :, :]) ** 2, dim=-1)
    gate = (d2 < (rad ** 2)[:, None]) & (z > 0.05)[:, None]
    idx, _ = hamming.match_nn(m.kf_feat_desc[cand], m.kf_feat_desc[kf_id],
                              gate, ok2, valid1, max_dist=hamming.TH_HIGH,
                              ratio=1.0, cross_check=True)
    j1 = torch.clamp(idx, min=0).long()
    pair_ok = (idx >= 0) & ok2
    info1 = (cfg.focal ** 2) * cfg.lm_cfg.sigma2_inv(dev)[torch.clamp(
        m.kf_feat_octave[kf_id][j1], 0, cfg.n_levels - 1).long()]
    has_inv = pair_ok & ok1[j1]
    X1c_own = X1c[j1]
    xn1_j = xn1[j1]
    pf = pair_ok.to(f32)[:, None]
    pb = has_inv.to(f32)[:, None]

    def residuals(x):
        s = s0 * torch.exp(x[0])
        R = lie.matmat(R0, lie.so3_exp(x[1:4]))
        t = t0 + x[4:7]
        Xf = lie.sim3_apply(s, R, t, X2c)
        zf = torch.where(torch.abs(Xf[:, 2]) < 1e-6,
                         torch.full_like(Xf[:, 2], 1e-6), Xf[:, 2])
        r_f = (Xf[:, :2] / zf[:, None] - xn1_j) * pf
        si, Ri, ti = lie.sim3_inv(s, R, t)
        Xb = lie.sim3_apply(si, Ri, ti, X1c_own)
        zb = torch.where(torch.abs(Xb[:, 2]) < 1e-6,
                         torch.full_like(Xb[:, 2], 1e-6), Xb[:, 2])
        r_b = (Xb[:, :2] / zb[:, None] - xn2) * pb
        return r_f, r_b

    eye7 = torch.eye(7, dtype=f32, device=dev)

    def gn_step(x, active_f, active_b):
        r_f, r_b = residuals(x)
        Jf, Jb = (J.to(f32) for J in torch.func.jacfwd(residuals)(x))
        wf = info1 * active_f
        wb = info1 * active_b
        H = torch.einsum('nia,n,nib->ab', Jf, wf, Jf) + \
            torch.einsum('nia,n,nib->ab', Jb, wb, Jb)
        g = torch.einsum('nia,n,ni->a', Jf, wf, r_f) + \
            torch.einsum('nia,n,ni->a', Jb, wb, r_b)
        return x - torch.linalg.solve(H + 1e-4 * eye7, g)

    x = torch.zeros(7, dtype=f32, device=dev)
    active_f = pair_ok.to(f32)
    active_b = has_inv.to(f32)
    for _ in range(2):
        for _ in range(5):
            x = gn_step(x, active_f, active_b)
        r_f, r_b = residuals(x)
        active_f = (pair_ok & (torch.sum(r_f * r_f, dim=-1) * info1
                               < CHI2_SIM3)).to(f32)
        active_b = (has_inv & (torch.sum(r_b * r_b, dim=-1) * info1
                               < CHI2_SIM3)).to(f32)
    s = s0 * torch.exp(x[0])
    R = lie.matmat(R0, lie.so3_exp(x[1:4]))
    t = t0 + x[4:7]
    return s, R, t, torch.sum(active_f > 0)


@record_function("search_and_fuse")
def search_and_fuse(m: ms.MapState, kf_id, cand, cam: cameras.Camera, cfg):
    """Landmark weld after the correction: project the candidate side's
    landmarks (its covisible neighbourhood) into the keyframe's covisible
    window and bind them, replacing the current side's duplicates."""
    K = m.kf_valid.shape[0]
    L = m.lm_valid.shape[0]
    dev = m.kf_t.device
    src_idx, src_ok = ms.local_window(m, cand, min(6, K), min_weight=10)
    src_slots = m.kf_feat_lm[src_idx]
    src_valid = (src_slots >= 0) & m.kf_feat_valid[src_idx] & \
        src_ok[:, None] & m.lm_valid[torch.clamp(src_slots, min=0).long()]
    pool = torch.where(src_valid, src_slots,
                       torch.full_like(src_slots, L)).reshape(-1).long()
    in_pool = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    in_pool[pool] = True
    in_pool = in_pool[:L] & m.lm_valid
    ids = mask_first(in_pool, min(MAX_LOCAL_LM_FUSE, L))
    pool_ok = in_pool[ids]
    dst_idx, dst_ok = ms.local_window(m, kf_id, min(8, K), min_weight=10)
    for i in range(dst_idx.shape[0]):
        dst_kf = dst_idx[i]
        dst_lm = m.kf_feat_lm[dst_kf]
        seen = torch.zeros(L + 1, dtype=torch.bool, device=dev)
        seen[torch.where(dst_lm >= 0, dst_lm,
                         torch.full_like(dst_lm, L)).long()] = True
        res = matching.search_by_projection(
            m.lm_pos[ids], m.lm_normal[ids], m.lm_dist_max[ids],
            m.lm_desc[ids], pool_ok & ~seen[ids] & dst_ok[i],
            m.kf_R[dst_kf], m.kf_t[dst_kf],
            lambda Xc: cameras.project(cam, Xc),
            m.kf_feat_uv[dst_kf], m.kf_feat_octave[dst_kf],
            m.kf_feat_desc[dst_kf], m.kf_feat_valid[dst_kf],
            (10000, 10000), radius_px=4.0, scale=cfg.scale,
            n_levels=cfg.n_levels, max_dist_th=50, ratio=1.0)
        new_lm = torch.where(res.feat_lm >= 0,
                             ids[torch.clamp(res.feat_lm, min=0).long()]
                             .to(dst_lm.dtype), dst_lm)
        m = m._replace(kf_feat_lm=put(m.kf_feat_lm, dst_kf[None],
                                      new_lm[None]))
    return ms.update_landmark_stats(m)


def correct_loop(m: ms.MapState, kf_id, cand, s_rel, R_rel, t_rel,
                 four_dof: bool = False, past_i=None, past_j=None,
                 past_ok=None, extra_i=None, extra_j=None, extra_s=None,
                 extra_R=None, extra_t=None, extra_ok=None):
    """Essential-graph correction: edges of the temporal chain, each
    keyframe's top-16 covisible neighbours (weight >= 30), the past loop
    edges and extra measured Sim(3) edges (the merge's further contacts),
    and the loop edge kf_id <- cand measured by (s_rel, R_rel, t_rel);
    12 pose-graph iterations with the candidate and keyframe 0 fixed; every
    landmark follows its reference keyframe's correction; keyframes go
    back to SE(3) and their world velocities rotate with them. Returns
    (map, pose-graph costs)."""
    K = m.kf_valid.shape[0]
    f32, dev = m.kf_t.dtype, m.kf_t.device
    i32 = torch.int32
    ones = torch.ones(K, dtype=f32, device=dev)
    W = ms.covisibility_matrix(m)
    prev = m.kf_prev.long()
    chain_ok = (prev >= 0) & m.kf_valid & m.kf_valid[torch.clamp(prev, min=0)]
    covis_w, covis_j = topk(W, COVIS_EDGES_PER_KF)             # (K, C)
    covis_ok = (covis_w >= COVIS_EDGE_MIN) & m.kf_valid[:, None] & \
        m.kf_valid[covis_j]
    if past_i is None:
        past_i = torch.zeros(MAX_PAST_LOOP_EDGES, dtype=i32, device=dev)
        past_j = torch.zeros_like(past_i)
        past_ok = torch.zeros(MAX_PAST_LOOP_EDGES, dtype=torch.bool,
                              device=dev)
    past_ok = past_ok & m.kf_valid[past_i.long()] & m.kf_valid[past_j.long()]
    if extra_i is None:
        extra_i = torch.zeros(1, dtype=i32, device=dev)
        extra_j = torch.zeros_like(extra_i)
        extra_s = torch.ones(1, dtype=f32, device=dev)
        extra_R = torch.eye(3, dtype=f32, device=dev)[None]
        extra_t = torch.zeros((1, 3), dtype=f32, device=dev)
        extra_ok = torch.zeros(1, dtype=torch.bool, device=dev)
    extra_ok = extra_ok & m.kf_valid[extra_i.long()] & \
        m.kf_valid[extra_j.long()]
    ar = torch.arange(K, dtype=i32, device=dev)
    kf_t_ = torch.as_tensor(kf_id, dtype=i32, device=dev).reshape(1)
    cand_t = torch.as_tensor(cand, dtype=i32, device=dev).reshape(1)
    e_i = torch.cat([ar, ar.repeat_interleave(COVIS_EDGES_PER_KF),
                     past_i.to(i32), extra_i.to(i32), kf_t_])
    e_j = torch.cat([torch.clamp(prev, min=0).to(i32),
                     covis_j.reshape(-1).to(i32), past_j.to(i32),
                     extra_j.to(i32), cand_t])
    e_w = torch.cat([chain_ok.to(f32), covis_ok.reshape(-1).to(f32) * 0.5,
                     past_ok.to(f32) * 10.0, extra_ok.to(f32) * 20.0,
                     torch.full((1,), 20.0, dtype=f32, device=dev)])
    ei, ej = e_i.long(), e_j.long()
    # measured relative transforms from the current poses, except the
    # extra edges and the loop edge (the Sim(3) solver's measurements)
    sij, Rij, tij = pose_graph.relative_sim3(ones[ei], m.kf_R[ei],
                                             m.kf_t[ei], ones[ej],
                                             m.kf_R[ej], m.kf_t[ej])
    nE = extra_i.shape[0]
    a0 = sij.shape[0] - 1 - nE
    sij = torch.cat([sij[:a0], extra_s.to(f32),
                     torch.as_tensor(s_rel, dtype=f32, device=dev)
                     .reshape(1)])
    Rij = torch.cat([Rij[:a0], extra_R.to(f32),
                     torch.as_tensor(R_rel, dtype=f32, device=dev)[None]])
    tij = torch.cat([tij[:a0], extra_t.to(f32),
                     torch.as_tensor(t_rel, dtype=f32, device=dev)[None]])
    idx = torch.arange(K, device=dev)
    g = pose_graph.PoseGraph(
        s=ones, R=m.kf_R, t=m.kf_t, edge_i=e_i, edge_j=e_j, edge_s=sij,
        edge_R=Rij, edge_t=tij, edge_w=e_w,
        fixed=(~m.kf_valid) | (idx == cand_t.long()) | (idx == 0))
    s_new, R_new, t_new, costs = pose_graph.optimize(g, n_iters=12,
                                                     four_dof=four_dof)
    # landmarks: X' = S_new_r^-1 (T_old_r X) through each reference keyframe
    ref = torch.clamp(m.lm_ref_kf, 0, K - 1).long()
    Xc = lie.se3_apply(m.kf_R[ref], m.kf_t[ref], m.lm_pos)
    si, Ri, ti = lie.sim3_inv(s_new[ref], R_new[ref], t_new[ref])
    lm_pos = torch.where(m.lm_valid[:, None],
                         lie.sim3_apply(si, Ri, ti, Xc), m.lm_pos)
    t_se3 = t_new / s_new[:, None]
    R_cor = lie.matmat(R_new.transpose(-1, -2), m.kf_R)
    v_new = lie.matvec(R_cor, m.kf_v) / s_new[:, None]
    kv = m.kf_valid
    return m._replace(
        kf_R=torch.where(kv[:, None, None], R_new, m.kf_R),
        kf_t=torch.where(kv[:, None], t_se3, m.kf_t),
        kf_v=torch.where(kv[:, None], v_new, m.kf_v),
        lm_pos=lm_pos), costs


def _fix_scale(tracker, cfg):
    """Metric maps (stereo / RGB-D, or IMU-initialized) take no scale from
    a loop or merge Sim(3)."""
    return bool(cfg.baseline > 0) or bool(getattr(tracker, "imu_ready",
                                                  False))


class LoopCloser:
    """Host-side loop-closing orchestration: detection, verification,
    temporal consistency, correction and the detached global BA; the Atlas
    merge. `cfg` is the tracker's TrackerConfig."""

    def __init__(self, cfg, min_interval: int = 10, temporal_hits: int = 2):
        self.cfg = cfg
        self.last_loop_kf = -10 ** 9
        self.min_interval = min_interval
        # a loop fires after `temporal_hits` consecutive keyframes verify
        # candidates in one covisible region
        self.temporal_hits = temporal_hits
        self._pending_cand = -1
        self._pending_kf = -1
        self._pending_count = 0
        # the last verified Sim(3) and the keyframe slot it was verified
        # from, carried forward and refined by guided matching
        self._pending_sim3 = None
        self._pending_slot = -1
        # past loop edges: (kf slot, cand slot) kept in later graphs
        self.past_loop_edges = []

    def _reset_pending(self):
        self._pending_count = 0
        self._pending_cand = -1
        self._pending_sim3 = None
        self._pending_slot = -1

    @record_function("maybe_close")
    def maybe_close(self, tracker, kf_id: int, bow) -> bool:
        """After a keyframe insert: True when a loop was closed
        (tracker.m updated)."""
        if tracker.db is None or tracker.n_kf_host < 12:
            return False
        seq = tracker.kf_seq
        if seq - self.last_loop_kf < self.min_interval:
            return False
        cfg = self.cfg
        m = tracker.m
        K = m.kf_valid.shape[0]
        row = ms.covisibility_row(m, kf_id)
        ts_v = torch.where(m.kf_valid, m.kf_ts,
                           torch.full_like(m.kf_ts, float("-inf")))
        thr = topk(ts_v, min(6, K))[0][-1]
        exclude = (row > 0) | (m.kf_ts >= thr) | (~m.kf_valid)
        ids, _, ok = kfdb.top_candidates_grouped(
            tracker.db, bow, 3, ms.covisibility_matrix(m), exclude=exclude,
            min_score=0.15)
        fix_scale = _fix_scale(tracker, cfg)
        hit = None
        refined_from_last = False
        if (self._pending_sim3 is not None
                and seq - self._pending_kf <= 2
                and bool(m.kf_valid[self._pending_slot])
                and bool(m.kf_valid[self._pending_cand])):
            # carry the last verified Sim(3) through the odometry since its
            # keyframe and re-verify by guided matching only
            s_p, R_p, t_p = self._pending_sim3
            R_rel, t_rel = lie.se3_mul(
                m.kf_R[kf_id], m.kf_t[kf_id],
                *lie.se3_inv(m.kf_R[self._pending_slot],
                             m.kf_t[self._pending_slot]))
            s, R, t, n_good = guided_sim3_verify(
                m, kf_id, self._pending_cand, s_p, lie.matmat(R_rel, R_p),
                lie.matvec(R_rel, t_p) + t_rel, cfg)
            n_good = int(n_good)
            if n_good >= MIN_ACCEPT_MATCHES:
                hit = (self._pending_cand, s, R, t, n_good)
                refined_from_last = True
        if hit is None:
            ids_h, ok_h = torch.stack([ids, ok.to(ids.dtype)]).tolist()
            for c, good in zip(ids_h, ok_h):
                if not good:
                    continue
                s, R, t, n_inl = verify_candidate(
                    m, kf_id, c, cfg, fix_scale=fix_scale,
                    generator=tracker.generator)
                if int(n_inl) < MIN_SIM3_INLIERS:
                    continue
                s, R, t, n_good = guided_sim3_verify(m, kf_id, c, s, R, t,
                                                     cfg)
                n_good = int(n_good)
                if n_good < MIN_ACCEPT_MATCHES:
                    continue
                hit = (c, s, R, t, n_good)
                break
        if hit is None:
            # a broken streak of detections resets the counter
            if seq - self._pending_kf > 2:
                self._reset_pending()
            return False
        cand, s, R, t, _ = hit
        consistent = refined_from_last or (
            self._pending_cand >= 0 and seq - self._pending_kf <= 2
            and (cand == self._pending_cand or int(
                ms.covisibility_row(m, cand)[self._pending_cand]) > 0))
        self._pending_cand = cand
        self._pending_kf = seq
        self._pending_sim3 = (s, R, t)
        self._pending_slot = kf_id
        self._pending_count = self._pending_count + 1 if consistent else 1
        if self._pending_count < self.temporal_hits:
            return False
        if bool(getattr(tracker, "imu_ready", False)):
            # gravity-aligned maps: a loop's drift must be mostly yaw
            one = torch.ones((), dtype=m.kf_t.dtype, device=m.kf_t.device)
            _, Rij, _ = pose_graph.relative_sim3(
                one, m.kf_R[kf_id], m.kf_t[kf_id], one, m.kf_R[cand],
                m.kf_t[cand])
            r = lie.so3_log(lie.matmat(R, Rij.transpose(-1, -2))).tolist()
            if abs(r[0]) > 0.05 or abs(r[1]) > 0.05:
                return False
        four_dof = bool(cfg.inertial) and bool(tracker.imu_ready)
        # the correction moves the whole map: drop a running global BA
        tracker._gba_job = None
        past = self.past_loop_edges[-MAX_PAST_LOOP_EDGES:]
        pi = np.zeros(MAX_PAST_LOOP_EDGES, np.int32)
        pj = np.zeros(MAX_PAST_LOOP_EDGES, np.int32)
        pok = np.zeros(MAX_PAST_LOOP_EDGES, bool)
        for n_e, (a, b) in enumerate(past):
            pi[n_e], pj[n_e], pok[n_e] = a, b, True
        dev = tracker.device
        with record_function("correct_loop"):
            tracker.m, _ = correct_loop(
                m, kf_id, cand, s, R, t, four_dof=four_dof,
                past_i=torch.from_numpy(pi).to(dev),
                past_j=torch.from_numpy(pj).to(dev),
                past_ok=torch.from_numpy(pok).to(dev))
        self.past_loop_edges.append((kf_id, cand))
        tracker.m = search_and_fuse(tracker.m, kf_id, cand, tracker.cam,
                                    cfg)
        lm_cfg = cfg.lm_cfg
        if bool(getattr(tracker, "imu_ready", False)) and \
                tracker.kf_imu is not None:
            # an inertial map refines with the synchronous full inertial BA
            tracker.m, _ = local_mapping.full_inertial_ba(
                tracker.m, tracker.kf_imu, kf_id, lm_cfg, window=32,
                prior_gyro=1.0, prior_acc=1.0)
        else:
            # the detached global BA; its first two slices polish the weld
            # before the next local BA, the rest run one per insert
            tracker._gba_job = global_ba.GBAJob(tracker.m, lm_cfg)
            tracker._gba_job.advance()
            tracker._gba_job.advance()
            tracker.m = tracker._gba_job.reconcile(tracker.m)
        tracker.R_last = tracker.m.kf_R[kf_id]
        tracker.t_last = tracker.m.kf_t[kf_id]
        tracker.has_vel = False
        self.last_loop_kf = seq
        self._reset_pending()
        return True

    @record_function("maybe_merge")
    def maybe_merge(self, tracker, kf_id: int, bow) -> bool:
        """Query every unmerged stashed map's database with the new
        keyframe; on a verified Sim(3) weld the stashed map into the active
        one, fuse around the weld and refine with a weld-window BA. True
        when a merge happened."""
        if not tracker.stash or tracker.n_kf_host < 5:
            return False
        m = tracker.m
        cfg = self.cfg
        dev = tracker.device
        n_kf, n_lm = (int(v) for v in torch.stack([m.n_kf, m.n_lm]).tolist())
        for st in tracker.stash:
            if st.merged_into_gen >= 0:
                continue
            if n_kf + st.n_kf > m.kf_valid.shape[0] or \
                    n_lm + int(st.m.n_lm) > m.lm_valid.shape[0]:
                continue
            ids, _, ok = kfdb.top_candidates_grouped(
                st.db, bow, 3, ms.covisibility_matrix(st.m),
                exclude=~st.m.kf_valid, min_score=0.15)
            fix_scale = _fix_scale(tracker, cfg)
            # every verified candidate: the best welds, the others become
            # measured contact edges of an essential-graph pass
            verified = []
            ids_h, ok_h = torch.stack([ids, ok.to(ids.dtype)]).tolist()
            for c, good in zip(ids_h, ok_h):
                if not good:
                    continue
                s_c, R_c, t_c, n_inl = verify_merge(
                    m, kf_id, st.m, c, cfg, fix_scale=fix_scale,
                    generator=tracker.generator)
                n_inl = int(n_inl)
                if n_inl >= MIN_SIM3_INLIERS:
                    verified.append((n_inl, c, s_c, R_c, t_c))
            if not verified:
                continue
            tracker._gba_job = None
            verified.sort(key=lambda v: -v[0])
            _, c_best, s, R, t = verified[0]
            sw, Rw, tw = atlas_mod.sim3_from_cam_pair(
                s, R, t, m.kf_R[kf_id], m.kf_t[kf_id], st.m.kf_R[c_best],
                st.m.kf_t[c_best])
            merged, kf_off, _ = atlas_mod.merge_maps(m, st.m, sw, Rw, tw)
            kf_off = int(kf_off)
            st.merged_into_gen = tracker.map_gen
            st.kf_offset = kf_off
            if tracker.kf_imu is not None and st.kf_imu is not None:
                from ..optim import inertial as inertial_mod
                tracker.kf_imu = inertial_mod.splice_kf_imu(
                    tracker.kf_imu, st.kf_imu, kf_off, st.n_kf)
            # the next keyframe chains to kf_id, not to the welded block
            tracker._kf_prev_override = kf_id
            if tracker.db is not None:
                n_copy = min(st.n_kf, tracker.db.bow.shape[0] - kf_off)
                rows = torch.arange(kf_off, kf_off + n_copy, device=dev)
                tracker.db = kfdb.KeyframeDatabase(
                    bow=put(tracker.db.bow, rows, st.db.bow[:n_copy]),
                    valid=put(tracker.db.valid, rows, st.db.valid[:n_copy]))
            merged = local_mapping.fuse_in_neighbors(merged, kf_id,
                                                     tracker.cam, cfg.lm_cfg)
            merged = ms.update_landmark_stats(merged)
            if len(verified) > 1:
                E = len(verified) - 1
                ei = np.full(E, kf_id, np.int32)
                ej = np.array([v[1] + kf_off for v in verified[1:]],
                              np.int32)
                merged, _ = correct_loop(
                    merged, kf_id, c_best + kf_off, s, R, t,
                    four_dof=bool(getattr(tracker, "imu_ready", False)),
                    extra_i=torch.from_numpy(ei).to(dev),
                    extra_j=torch.from_numpy(ej).to(dev),
                    extra_s=torch.stack([v[2].reshape(()) for v in
                                         verified[1:]]),
                    extra_R=torch.stack([v[3] for v in verified[1:]]),
                    extra_t=torch.stack([v[4] for v in verified[1:]]),
                    extra_ok=torch.ones(E, dtype=torch.bool, device=dev))
            if bool(getattr(tracker, "imu_ready", False)) and \
                    tracker.kf_imu is not None:
                merged = local_mapping.local_inertial_ba(
                    merged, tracker.kf_imu, kf_id, cfg.lm_cfg)
            else:
                merged = local_mapping.local_bundle_adjustment(
                    merged, kf_id, cfg.lm_cfg)
            tracker.m = merged
            tracker.n_kf_host = int(merged.n_kf)
            tracker._free_kf_slots = []
            tracker.R_last = merged.kf_R[kf_id]
            tracker.t_last = merged.kf_t[kf_id]
            tracker.has_vel = False
            self.last_loop_kf = tracker.kf_seq
            return True
        return False
