"""The frame-rate tracking state machine: monocular, rectified stereo and
RGB-D, each with or without IMU, with BoW relocalization when the tracker
has a vocabulary (counterpart of those parts of
`morb_slam_tpu/pipeline/tracking.py`).

Per frame, `extract_frame` runs extraction (K1, K2, the pyramid and blur);
`extract_stereo_frame` extracts both images and matches them along rows
(K3 and K7); `extract_rgbd_frame` reads the depth at the keypoints. Then
`track_step_framedata` runs `track_frame` (motion-model search, pose
optimization, local-map search, pose optimization; K3 inside every
search) on the tracker's device. The host keeps
the state machine and the keyframe decisions, which lag `pipeline_depth`
frames behind the dispatched work: each frame's decision
scalars are copied to the host asynchronously when the frame is dispatched
and read when its decision is due, so the host never waits on frames it
has dispatched since.

With a vocabulary, every keyframe insert adds the keyframe's BoW vector to
the place-recognition database (K9 `transform`), and a frame without
tracking context first scores the database (K10) and tries PnP +
`optimize_pose` (K5) against the best three keyframes
(`relocalize_candidate`) before the reference-keyframe fallback.

With a vocabulary the tracker also closes loops: after every keyframe
insert `LoopCloser.maybe_close` (`loop_closing.py`) detects, verifies and
corrects a loop and starts the detached global BA, whose slices then
advance one per insert (K4 per-observation mode and K14); while a stashed
map exists, `maybe_merge` tries to weld it back. `pipelined = False` makes
every frame's decision at once (deterministic per-frame decisions).

With an IMU calibration the tracker runs the inertial state machine: every
frame's IMU batch extends the since-keyframe preintegration (K11); until
the IMU is initialized the frames track visually and synchronously, with
keyframes every 0.25 s; the staged initialization (at 2, 5, 15, 25 and 45
s) aligns gravity, scale, biases and velocities and runs a full inertial
BA; from then on `track_step_vi_framedata` predicts from the anchor
keyframe through the preintegration, tracks visually and refines the pose,
velocity and bias with `optimize_pose_inertial` (K12), and keyframe inserts
run `mapping_step_inertial`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import cameras, frontend, imu, lie, matching
from ..mapstate import state as ms
from ..mapstate.atlas import StashedMap
from ..ops import hamming
from ..ops import stereo as stereo_ops
from ..optim import inertial as inertial_mod
from ..optim import pose_opt, vi_ba
from ..solvers import pnp, two_view
from ..tensor_ops import add_at, mask_first, put, put2, topk
from ..vocab import database as kfdb
from ..vocab import tree as voctree
from . import local_mapping, loop_closing

MAX_LOCAL_LM = 4096
LOCAL_KFS = 10


@dataclass(frozen=True)
class TrackerConfig:
    width: int
    height: int
    focal: float
    n_feat: int = 1200
    max_kf: int = 512
    max_lm: int = 32768
    scale: float = 1.2
    n_levels: int = 8
    min_init_matches: int = 100
    min_init_points: int = 50
    min_track_points: int = 10
    min_local_points: int = 30
    # KF trigger c2: local-map inliers below this fraction of the inliers
    # at the last keyframe insertion
    kf_ref_ratio: float = 0.95
    max_kf_interval: int = 12
    min_kf_interval: int = 3
    # fraction of the measured inter-frame rotation carried into the
    # constant-velocity prediction (0: translation only)
    vel_rot_damp: float = 0.0
    baseline: float = 0.0      # stereo baseline (m); 0 = monocular
    th_depth: float = 35.0     # close-point gate in baseline units
    # depth-measured features beyond this distance (m) make no landmark;
    # 0 disables the gate
    th_far_points: float = 0.0
    min_stereo_init_feats: int = 400
    ts_jump: float = 1.0       # seconds; a larger gap starts a fresh map
    # seconds without a successful IMU initialization before a forced reset
    bad_imu_timeout: float = 20.0
    # visual dropout survived on IMU dead-reckoning before LOST (seconds)
    time_recently_lost: float = 5.0
    # frames a dispatched frame's host decision may lag behind
    pipeline_depth: int = 2
    inertial: bool = False

    @property
    def orb(self):
        return frontend.OrbConfig(n_features=self.n_feat,
                                  n_levels=self.n_levels, scale=self.scale)

    @property
    def lm_cfg(self):
        return local_mapping.LocalMapConfig(
            focal=self.focal, scale=self.scale, n_levels=self.n_levels,
            baseline=self.baseline, inertial=self.inertial)


def tracking_replace_inertial(cfg: TrackerConfig) -> TrackerConfig:
    import dataclasses
    return dataclasses.replace(cfg, inertial=True)


class FrameData(NamedTuple):
    uv: torch.Tensor        # (F, 2) undistorted pixel coords
    xn: torch.Tensor        # (F, 2) normalized camera coords
    octave: torch.Tensor
    angle: torch.Tensor
    desc: torch.Tensor      # (F, 8) int32
    valid: torch.Tensor
    ur: torch.Tensor        # (F,) normalized right-u (NaN = mono)
    depth: torch.Tensor     # (F,) depth (-1 = none)


class TrackOutput(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    feat_lm: torch.Tensor   # (F,) final landmark association
    n_mm: torch.Tensor      # matches of the motion-model stage
    n_inl: torch.Tensor     # final local-map inliers
    m: ms.MapState          # map with updated visible / found counters
    ref_kf: torch.Tensor    # new reference keyframe id


def _info_of(cfg: TrackerConfig, octave):
    inv_sig2 = cfg.lm_cfg.sigma2_inv(octave.device)
    return (cfg.focal ** 2) * inv_sig2[torch.clamp(octave, 0,
                                                   cfg.n_levels - 1).long()]


# ---------------------------------------------------------------------------
# per-frame stages
# ---------------------------------------------------------------------------

def extract_frame(img, cam: cameras.Camera, cfg: TrackerConfig) -> FrameData:
    img = img.to(torch.float32)
    feats = frontend.extract_orb(img, cfg.orb)
    uv = cameras.undistort_points(cam, feats.uv)
    xn = cameras.unproject(cam, uv)[:, :2]
    F = uv.shape[0]
    return FrameData(uv=uv, xn=xn, octave=feats.octave, angle=feats.angle,
                     desc=feats.desc, valid=feats.valid,
                     ur=torch.full((F,), float("nan"), device=uv.device),
                     depth=torch.full((F,), -1.0, device=uv.device))


def _with_depth(feats, sm: stereo_ops.StereoMatches, cam: cameras.Camera):
    """FrameData of the left / colour image with its stereo or RGB-D depth
    and normalized right-u."""
    uv = cameras.undistort_points(cam, feats.uv)
    xn = cameras.unproject(cam, uv)[:, :2]
    p = cam.params
    ur_n = torch.where(sm.valid, (sm.u_right - p[2]) / p[0],
                       torch.full_like(sm.u_right, float("nan")))
    return FrameData(uv=uv, xn=xn, octave=feats.octave, angle=feats.angle,
                     desc=feats.desc, valid=feats.valid, ur=ur_n,
                     depth=torch.where(sm.valid, sm.depth,
                                       torch.full_like(sm.depth, -1.0)))


def extract_stereo_frame(img_l, img_r, cam: cameras.Camera,
                         cfg: TrackerConfig) -> FrameData:
    """Extract both rectified images and match them along rows."""
    img_l = img_l.to(torch.float32)
    img_r = img_r.to(torch.float32)
    feats_l = frontend.extract_orb(img_l, cfg.orb)
    feats_r = frontend.extract_orb(img_r, cfg.orb)
    sf = torch.tensor([cfg.scale ** i for i in range(cfg.n_levels)],
                      dtype=torch.float32, device=img_l.device)
    sm = stereo_ops.match_stereo(feats_l, feats_r, img_l, img_r, sf,
                                 bf=cfg.baseline * cfg.focal,
                                 min_z=cfg.baseline)
    return _with_depth(feats_l, sm, cam)


def extract_rgbd_frame(img, depth_map, cam: cameras.Camera,
                       cfg: TrackerConfig) -> FrameData:
    """ORB on the grey image, depth read at the keypoints with a synthetic
    right-u (`baseline` sets the virtual stereo baseline)."""
    img = img.to(torch.float32)
    feats = frontend.extract_orb(img, cfg.orb)
    sm = stereo_ops.depth_from_rgbd(feats, depth_map.to(torch.float32),
                                    bf=cfg.baseline * cfg.focal)
    return _with_depth(feats, sm, cam)


def track_frame(m: ms.MapState, fr: FrameData, last: FrameData,
                last_feat_lm, R_last, t_last, vel_R, vel_t, ref_kf,
                cam: cameras.Camera, cfg: TrackerConfig) -> TrackOutput:
    """Motion-model matching + pose optimization + local-map search + pose
    optimization."""
    K, F = m.kf_feat_lm.shape
    L = m.lm_valid.shape[0]
    dev = fr.uv.device
    info = _info_of(cfg, fr.octave)

    # ---- stage 1: motion model + last-frame matching
    R_pred, t_pred = lie.se3_mul(vel_R, vel_t, R_last, t_last)
    last_lm = torch.where(last.valid, last_feat_lm,
                          torch.full_like(last_feat_lm, -1))
    lm_idx = torch.clamp(last_lm, min=0).long()
    lm_ok = (last_lm >= 0) & m.lm_valid[lm_idx]
    Xc = lie.se3_apply(R_pred, t_pred, m.lm_pos[lm_idx])
    proj = cameras.project(cam, Xc)
    proj = torch.where((lm_ok & (Xc[:, 2] > 0.1))[:, None], proj,
                       torch.full_like(proj, float("nan")))
    cur_lm = matching.search_last_frame(
        last.uv, last.desc, last_lm, last.valid,
        fr.uv, fr.octave, fr.desc, fr.valid,
        proj, last.octave, radius_px=8.0, scale=cfg.scale,
        last_angle=last.angle, cur_angle=fr.angle)
    n_mm = torch.sum(cur_lm >= 0)
    lm_i = torch.clamp(cur_lm, min=0).long()
    res1 = pose_opt.optimize_pose(
        R_pred, t_pred, m.lm_pos[lm_i], fr.xn, info,
        (cur_lm >= 0) & m.lm_valid[lm_i], obs_ur=fr.ur,
        baseline=cfg.baseline, n_rounds=2, n_iters=8)
    cur_lm = torch.where(res1.inliers, cur_lm, torch.full_like(cur_lm, -1))

    # ---- stage 2: local map
    match_mask = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    match_mask = put(match_mask, torch.where(cur_lm >= 0, cur_lm,
                                             torch.full_like(cur_lm, L)),
                     True)
    slot_lm = torch.where(m.kf_feat_lm >= 0, m.kf_feat_lm,
                          torch.full_like(m.kf_feat_lm, L)).long()
    votes = torch.sum(torch.cat([match_mask[:L], match_mask[:1] & False])
                      [slot_lm] & m.kf_feat_valid, dim=1,
                      dtype=torch.int32) * m.kf_valid
    match_mask = match_mask[:L]
    new_ref = torch.argmax(votes)
    new_ref = torch.where(votes[new_ref] > 0, new_ref, ref_kf)
    top_kfs = topk(votes, min(LOCAL_KFS, K))[1]
    lm_in = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    lm_in[torch.where(m.kf_feat_valid[top_kfs], slot_lm[top_kfs],
                      torch.full_like(slot_lm[top_kfs], L)).reshape(-1)] = True
    lm_in = lm_in[:L] & m.lm_valid
    lm_sel = mask_first(lm_in, min(MAX_LOCAL_LM, L))
    lm_sel_ok = lm_in[lm_sel] & ~match_mask[lm_sel]
    # every feature is searched against the local map: the multi-view
    # landmarks may overrule a stage-1 association
    proj_m = matching.search_by_projection(
        m.lm_pos[lm_sel], m.lm_normal[lm_sel], m.lm_dist_max[lm_sel],
        m.lm_desc[lm_sel], lm_in[lm_sel],
        res1.R, res1.t, lambda X: cameras.project(cam, X),
        fr.uv, fr.octave, fr.desc, fr.valid,
        (cfg.width, cfg.height), radius_px=4.0, scale=cfg.scale,
        n_levels=cfg.n_levels)
    ext_lm = torch.where(proj_m.feat_lm >= 0,
                         lm_sel[torch.clamp(proj_m.feat_lm, min=0).long()]
                         .to(torch.int32), torch.full_like(proj_m.feat_lm, -1))
    cur_lm2 = torch.where(ext_lm >= 0, ext_lm, cur_lm)
    lm_i2 = torch.clamp(cur_lm2, min=0).long()
    res2 = pose_opt.optimize_pose(
        res1.R, res1.t, m.lm_pos[lm_i2], fr.xn, info,
        (cur_lm2 >= 0) & m.lm_valid[lm_i2], obs_ur=fr.ur,
        baseline=cfg.baseline, n_rounds=2, n_iters=8)
    final_lm = torch.where(res2.inliers, cur_lm2, torch.full_like(cur_lm2, -1))

    # ---- visible / found counters
    vis_ids = torch.where(lm_sel_ok, lm_sel, torch.full_like(lm_sel, L))
    m = m._replace(
        lm_visible=add_at(m.lm_visible, vis_ids, 1),
        lm_found=add_at(m.lm_found, torch.where(final_lm >= 0, final_lm,
                                                torch.full_like(final_lm, L)),
                        1))
    return TrackOutput(R=res2.R, t=res2.t, feat_lm=final_lm, n_mm=n_mm,
                       n_inl=res2.n_inliers, m=m, ref_kf=new_ref)


def track_step_framedata(fr, m, last, last_feat_lm, R_last, t_last, vel_R,
                         vel_t, has_vel: bool, ref_kf, cam,
                         cfg: TrackerConfig):
    """One extracted frame (any sensor): tracking, the new velocity, the
    pose relative to the reference keyframe and the host decision
    scalars."""
    dev = fr.uv.device
    eye = torch.eye(3, device=dev)
    damp = cfg.vel_rot_damp
    if not has_vel:
        vel_R_used, vel_t = eye, torch.zeros(3, device=dev)
    elif damp == 0.0:
        vel_R_used = eye
    elif damp < 1.0:
        vel_R_used = lie.so3_exp(damp * lie.so3_log(vel_R))
    else:
        vel_R_used = vel_R
    out = track_frame(m, fr, last, last_feat_lm, R_last, t_last, vel_R_used,
                      vel_t, ref_kf, cam, cfg)
    Ri, ti = lie.se3_inv(R_last, t_last)
    vel_new = lie.se3_mul(out.R, out.t, Ri, ti)
    Rri, tri = lie.se3_inv(m.kf_R[out.ref_kf], m.kf_t[out.ref_kf])
    rel = lie.se3_mul(out.R, out.t, Rri, tri)
    # host decision scalars in one vector: [n_inl, ref_kf, vel_finite,
    # n_mm, ref_tracked, n_close_tracked, n_close_untracked]; the last three
    # feed the stereo keyframe conditions, and the close counts are 0 mono
    ref_lm2 = m.kf_feat_lm[out.ref_kf]
    lm_c = torch.clamp(ref_lm2, min=0).long()
    ref_ok = (ref_lm2 >= 0) & m.kf_feat_valid[out.ref_kf] & m.lm_valid[lm_c]
    zero = torch.zeros((), device=dev)
    if cfg.baseline > 0:
        # the reference KF's landmarks seen >= 3 times (2 while the map
        # holds <= 2 KFs); map-wide counts every frame, as the reference
        # package does
        obs = ms.lm_obs_count(m)
        min_obs = torch.where(m.n_kf <= 2, 2, 3)
        ref_tracked = torch.sum(ref_ok & (obs[lm_c] >= min_obs))
        close = fr.valid & (fr.depth > 0) & \
            (fr.depth < cfg.th_depth * cfg.baseline)
        tracked = out.feat_lm >= 0
        n_close = (torch.sum(close & tracked).to(torch.float32),
                   torch.sum(close & ~tracked).to(torch.float32))
    else:
        ref_tracked = torch.sum(ref_ok)
        n_close = (zero, zero)
    info = torch.stack([
        out.n_inl.to(torch.float32), out.ref_kf.to(torch.float32),
        torch.isfinite(vel_new[1]).all().to(torch.float32),
        out.n_mm.to(torch.float32), ref_tracked.to(torch.float32), *n_close])
    return fr, out, vel_new, rel, info


def track_reference_kf(m: ms.MapState, fr: FrameData, ref_kf, R0, t0,
                       cfg: TrackerConfig):
    """Prediction-free fallback: mutual-NN descriptor match against the
    reference keyframe's landmark-bearing features, then pose optimization
    from (R0, t0)."""
    F = fr.uv.shape[0]
    ref_lm = m.kf_feat_lm[ref_kf]
    ref_ok = m.kf_feat_valid[ref_kf] & (ref_lm >= 0) & \
        m.lm_valid[torch.clamp(ref_lm, min=0).long()]
    idx, _ = hamming.match_nn(m.kf_feat_desc[ref_kf], fr.desc,
                              ref_ok[:, None] & fr.valid[None, :], ref_ok,
                              fr.valid, max_dist=hamming.TH_LOW, ratio=0.7,
                              cross_check=True)
    keep = hamming.rotation_consistency_mask(m.kf_feat_angle[ref_kf],
                                             fr.angle, idx)
    idx = torch.where(keep, idx, torch.full_like(idx, -1))
    cur_lm = put(torch.full((F,), -1, dtype=torch.int32, device=idx.device),
                 torch.where(idx >= 0, idx, torch.full_like(idx, F)), ref_lm)
    lm_i = torch.clamp(cur_lm, min=0).long()
    res = pose_opt.optimize_pose(
        R0, t0, m.lm_pos[lm_i], fr.xn, _info_of(cfg, fr.octave),
        (cur_lm >= 0) & m.lm_valid[lm_i], n_rounds=3, n_iters=10)
    return res.R, res.t, torch.where(res.inliers, cur_lm,
                                     torch.full_like(cur_lm, -1)), \
        res.n_inliers


def relocalize_candidate(m: ms.MapState, fr: FrameData, kf_id: int,
                         cfg: TrackerConfig, cam: cameras.Camera,
                         samples=None, generator=None):
    """One relocalization attempt against candidate keyframe kf_id:
    brute-force descriptor match (ratio 0.75, cross check) to its
    landmarks, PnP RANSAC (192 hypotheses; samples (192, 8), drawn from
    `generator` when absent) and pose optimization (3 x 10); then a guided
    second pass projects the candidate's covisible window (min_weight 10)
    with that pose, searches a 10-px window and optimizes again, and the
    pass with more inliers wins. Returns (R, t, feat_lm, n_inliers)."""
    K, F = m.kf_feat_lm.shape
    L = m.lm_valid.shape[0]
    ref_lm = m.kf_feat_lm[kf_id]
    ref_ok = m.kf_feat_valid[kf_id] & (ref_lm >= 0) & \
        m.lm_valid[torch.clamp(ref_lm, min=0).long()]
    idx, _ = hamming.match_nn(m.kf_feat_desc[kf_id], fr.desc,
                              ref_ok[:, None] & fr.valid[None, :], ref_ok,
                              fr.valid, max_dist=hamming.TH_LOW, ratio=0.75,
                              cross_check=True)
    cur_lm = put(torch.full((F,), -1, dtype=torch.int32, device=idx.device),
                 torch.where(idx >= 0, idx, torch.full_like(idx, F)), ref_lm)
    lm_i = torch.clamp(cur_lm, min=0).long()
    has = (cur_lm >= 0) & m.lm_valid[lm_i]
    pnp_res = pnp.solve_pnp(m.lm_pos[lm_i], fr.xn, has, focal=cfg.focal,
                            samples=samples, generator=generator, n_hyp=192)
    info = _info_of(cfg, fr.octave)
    res = pose_opt.optimize_pose(pnp_res.R, pnp_res.t, m.lm_pos[lm_i], fr.xn,
                                 info, has, n_rounds=3, n_iters=10)
    cur_lm = torch.where(res.inliers, cur_lm, torch.full_like(cur_lm, -1))
    # guided second pass over the candidate's covisible window
    win_idx, win_ok = ms.local_window(m, kf_id, min(LOCAL_KFS, K),
                                      min_weight=10)
    slot_lm = torch.where(m.kf_feat_lm >= 0, m.kf_feat_lm,
                          torch.full_like(m.kf_feat_lm, L)).long()
    lm_in = torch.zeros(L + 1, dtype=torch.bool, device=fr.uv.device)
    lm_in[torch.where(m.kf_feat_valid[win_idx] & win_ok[:, None],
                      slot_lm[win_idx],
                      torch.full_like(slot_lm[win_idx], L)).reshape(-1)] = True
    lm_in = lm_in[:L] & m.lm_valid
    lm_sel = mask_first(lm_in, min(MAX_LOCAL_LM, L))
    proj_m = matching.search_by_projection(
        m.lm_pos[lm_sel], m.lm_normal[lm_sel], m.lm_dist_max[lm_sel],
        m.lm_desc[lm_sel], lm_in[lm_sel],
        res.R, res.t, lambda X: cameras.project(cam, X),
        fr.uv, fr.octave, fr.desc, fr.valid,
        (cfg.width, cfg.height), radius_px=10.0, scale=cfg.scale,
        n_levels=cfg.n_levels)
    ext_lm = torch.where(proj_m.feat_lm >= 0,
                         lm_sel[torch.clamp(proj_m.feat_lm, min=0).long()]
                         .to(torch.int32), torch.full_like(proj_m.feat_lm, -1))
    cur_lm2 = torch.where(ext_lm >= 0, ext_lm, cur_lm)
    lm_i2 = torch.clamp(cur_lm2, min=0).long()
    res2 = pose_opt.optimize_pose(
        res.R, res.t, m.lm_pos[lm_i2], fr.xn, info,
        (cur_lm2 >= 0) & m.lm_valid[lm_i2], n_rounds=3, n_iters=10)
    better = res2.n_inliers >= res.n_inliers
    R_f = torch.where(better, res2.R, res.R)
    t_f = torch.where(better, res2.t, res.t)
    lm_f = torch.where(better, torch.where(res2.inliers, cur_lm2,
                                           torch.full_like(cur_lm2, -1)),
                       cur_lm)
    return R_f, t_f, lm_f, torch.maximum(res2.n_inliers, res.n_inliers)


def insert_keyframe(m: ms.MapState, fr: FrameData, feat_lm, R, t, ts,
                    slot: int, prev_id: Optional[int] = None):
    """Write the frame into keyframe slot `slot`; `prev_id` is its temporal
    predecessor (default slot - 1)."""
    k = int(slot)
    prev = k - 1 if prev_id is None else int(prev_id)
    lm_i = torch.clamp(feat_lm, min=0).long()
    assoc = (feat_lm >= 0) & m.lm_valid[lm_i]
    ki = torch.tensor([k], device=fr.uv.device)

    def row(x, v):
        return put(x, ki, torch.as_tensor(v, dtype=x.dtype,
                                          device=x.device)[None])
    m = m._replace(
        kf_R=row(m.kf_R, R), kf_t=row(m.kf_t, t),
        kf_valid=row(m.kf_valid, True), kf_ts=row(m.kf_ts, float(ts)),
        kf_feat_uv=row(m.kf_feat_uv, fr.uv),
        kf_feat_xn=row(m.kf_feat_xn, fr.xn),
        kf_feat_octave=row(m.kf_feat_octave, fr.octave),
        kf_feat_angle=row(m.kf_feat_angle, fr.angle),
        kf_feat_desc=row(m.kf_feat_desc, fr.desc),
        kf_feat_valid=row(m.kf_feat_valid, fr.valid),
        kf_feat_ur=row(m.kf_feat_ur, fr.ur),
        kf_feat_lm=row(m.kf_feat_lm, torch.where(assoc, feat_lm,
                                                 torch.full_like(feat_lm, -1))),
        kf_prev=row(m.kf_prev, prev),
        n_kf=torch.maximum(m.n_kf, torch.as_tensor(k + 1, dtype=m.n_kf.dtype,
                                                   device=m.n_kf.device)))
    return m, k


def _nanmedian(x):
    """Median of the finite entries, the mean of the two middle ones for an
    even count (jnp.nanmedian)."""
    n = torch.sum(torch.isfinite(x))
    v = torch.sort(torch.where(torch.isfinite(x), x,
                               torch.full_like(x, math.inf)))[0]
    pos = 0.5 * (n.to(torch.float32) - 1.0)
    lo = torch.clamp(torch.floor(pos).long(), min=0)
    hi = torch.clamp(torch.ceil(pos).long(), min=0)
    med = (v[lo] + v[hi]) * 0.5
    return torch.where(n > 0, med, torch.full_like(med, math.nan))


def create_initial_map(m: ms.MapState, fr0: FrameData, fr1: FrameData,
                       match01, R21, t21, points, good, ts0, ts1,
                       cfg: TrackerConfig):
    """Monocular initial map: two keyframes, the triangulated landmarks
    scaled to unit median depth, then a local BA."""
    L = m.lm_valid.shape[0]
    F = fr0.uv.shape[0]
    dev = fr0.uv.device
    med = _nanmedian(torch.where(good, points[:, 2],
                                 torch.full_like(points[:, 2], math.nan)))
    inv_med = 1.0 / torch.clamp(med, min=1e-3)
    pts = points * inv_med
    t21n = t21 * inv_med
    k0 = int(m.n_kf)
    none = torch.full((F,), -1, dtype=torch.int32, device=dev)
    m, k0 = insert_keyframe(m, fr0, none, torch.eye(3, device=dev),
                            torch.zeros(3, device=dev), ts0, slot=k0)
    m, k1 = insert_keyframe(m, fr1, none, R21, t21n, ts1, slot=k0 + 1)
    n_new = torch.cumsum(good.to(torch.int32), 0) - 1
    slot = torch.where(good, n_new, torch.full_like(n_new, L - 1)).long()
    j = torch.clamp(match01, min=0).long()
    dmax = torch.linalg.norm(pts, dim=-1) * cfg.scale ** fr0.octave.to(
        torch.float32)
    g1 = good[:, None]
    m = m._replace(
        lm_pos=put(m.lm_pos, slot, torch.where(g1, pts, m.lm_pos[slot])),
        lm_valid=put(m.lm_valid, slot, good | m.lm_valid[slot]),
        lm_desc=put(m.lm_desc, slot, torch.where(g1, fr0.desc,
                                                 m.lm_desc[slot])),
        lm_ref_kf=put(m.lm_ref_kf, slot, torch.where(
            good, torch.full_like(m.lm_ref_kf[slot], k0), m.lm_ref_kf[slot])),
        lm_first_ts=put(m.lm_first_ts, slot, torch.where(
            good, m.kf_ts[k0].expand(F), m.lm_first_ts[slot])),
        lm_dist_max=put(m.lm_dist_max, slot, torch.where(
            good, dmax, m.lm_dist_max[slot])),
        lm_visible=put(m.lm_visible, slot, 1),
        lm_found=put(m.lm_found, slot, 1),
        kf_feat_lm=put2(put2(m.kf_feat_lm, k0, torch.arange(F, device=dev),
                             torch.where(good, slot.to(torch.int32), none)),
                        k1, j, torch.where(good, slot.to(torch.int32),
                                           m.kf_feat_lm[k1, j])),
        n_lm=torch.sum(good, dtype=torch.int32))
    m = ms.update_landmark_stats(m)
    m = local_mapping.local_bundle_adjustment(m, k1, cfg.lm_cfg)
    return ms.update_landmark_stats(m), k1


def stereo_initialize(m: ms.MapState, fr: FrameData, ts,
                      cfg: TrackerConfig, slot: int = 0):
    """First-frame stereo / RGB-D map: every feature with a valid depth
    becomes a landmark of keyframe `slot`."""
    L = m.lm_valid.shape[0]
    F = fr.uv.shape[0]
    dev = fr.uv.device
    good = fr.valid & (fr.depth > 0)
    if cfg.th_far_points > 0:
        good = good & (fr.depth < cfg.th_far_points)
    Xw = torch.cat([fr.xn * fr.depth[:, None], fr.depth[:, None]], dim=-1)
    n_new = torch.cumsum(good.to(torch.int32), 0) - 1
    lm = torch.where(good, n_new, torch.full_like(n_new, L - 1)).long()
    # landmarks must exist before the keyframe's associations are written
    # (insert_keyframe drops associations to invalid landmarks)
    none = torch.full((F,), -1, dtype=torch.int32, device=dev)
    m, k0 = insert_keyframe(m, fr, none, torch.eye(3, device=dev),
                            torch.zeros(3, device=dev), ts, slot=slot)
    dmax = fr.depth * cfg.scale ** fr.octave.to(torch.float32)
    g1 = good[:, None]
    down = torch.tensor([0.0, 0.0, -1.0], device=dev).expand(F, 3)
    m = m._replace(
        kf_feat_lm=put(m.kf_feat_lm, torch.tensor([k0], device=dev),
                       torch.where(good, lm.to(torch.int32), none)[None]),
        lm_pos=put(m.lm_pos, lm, torch.where(g1, Xw, m.lm_pos[lm])),
        lm_valid=put(m.lm_valid, lm, good | m.lm_valid[lm]),
        lm_desc=put(m.lm_desc, lm, torch.where(g1, fr.desc, m.lm_desc[lm])),
        lm_ref_kf=put(m.lm_ref_kf, lm, torch.where(
            good, torch.full_like(m.lm_ref_kf[lm], k0), m.lm_ref_kf[lm])),
        lm_first_ts=put(m.lm_first_ts, lm, torch.where(
            good, m.kf_ts[k0].expand(F), m.lm_first_ts[lm])),
        lm_dist_max=put(m.lm_dist_max, lm, torch.where(
            good, dmax, m.lm_dist_max[lm])),
        lm_normal=put(m.lm_normal, lm, torch.where(g1, down,
                                                   m.lm_normal[lm])),
        lm_visible=put(m.lm_visible, lm, 1),
        lm_found=put(m.lm_found, lm, 1),
        n_lm=torch.sum(good, dtype=torch.int32))
    return ms.update_landmark_stats(m), k0


def create_close_landmarks(m: ms.MapState, kf_id: int, fr: FrameData,
                           cfg: TrackerConfig):
    """New landmarks straight from the measured depth for the keyframe's
    unmatched close features (nearer than th_depth * baseline), the 128
    closest first, into free landmark slots."""
    L = m.lm_valid.shape[0]
    th = cfg.th_depth * cfg.baseline
    if cfg.th_far_points > 0:
        th = min(th, cfg.th_far_points)
    free_f = (m.kf_feat_lm[kf_id] < 0) & fr.valid & (fr.depth > 0) & \
        (fr.depth < th)
    n_c = min(128, fr.uv.shape[0])
    sel = topk(torch.where(free_f, -fr.depth,
                           torch.full_like(fr.depth, -math.inf)), n_c)[1]
    sel_good = free_f[sel]
    n_free_ok, free_slots = topk((~m.lm_valid).to(torch.int32), n_c)
    rank = torch.clamp(torch.cumsum(sel_good.to(torch.int32), 0) - 1, min=0)
    sel_good = sel_good & (n_free_ok == 1)[rank]
    slot = torch.where(sel_good, free_slots[rank],
                       torch.full_like(free_slots[rank], L))
    old = torch.clamp(slot, max=L - 1)    # a slot of L is dropped by put
    z = fr.depth[sel]
    Xc = torch.cat([fr.xn[sel] * z[:, None], z[:, None]], dim=-1)
    Rwc = m.kf_R[kf_id].T
    Xw = lie.se3_apply(Rwc, -lie.matvec(Rwc, m.kf_t[kf_id]), Xc)
    dmax = z * cfg.scale ** fr.octave[sel].to(torch.float32)
    g1 = sel_good[:, None]
    return m._replace(
        lm_pos=put(m.lm_pos, slot, torch.where(g1, Xw, m.lm_pos[old])),
        lm_valid=put(m.lm_valid, slot, sel_good | m.lm_valid[old]),
        lm_desc=put(m.lm_desc, slot, torch.where(g1, fr.desc[sel],
                                                 m.lm_desc[old])),
        lm_ref_kf=put(m.lm_ref_kf, slot, torch.where(
            sel_good, torch.full_like(m.lm_ref_kf[old], kf_id),
            m.lm_ref_kf[old])),
        lm_first_ts=put(m.lm_first_ts, slot, torch.where(
            sel_good, m.kf_ts[kf_id].expand(n_c), m.lm_first_ts[old])),
        lm_dist_max=put(m.lm_dist_max, slot, torch.where(
            sel_good, dmax, m.lm_dist_max[old])),
        lm_visible=put(m.lm_visible, slot, torch.where(
            sel_good, torch.ones_like(m.lm_visible[old]), m.lm_visible[old])),
        lm_found=put(m.lm_found, slot, torch.where(
            sel_good, torch.ones_like(m.lm_found[old]), m.lm_found[old])),
        kf_feat_lm=put2(m.kf_feat_lm, kf_id, sel, torch.where(
            sel_good, slot.to(torch.int32), m.kf_feat_lm[kf_id, sel])),
        n_lm=m.n_lm + torch.sum(sel_good, dtype=torch.int32))


# ---------------------------------------------------------------------------
# visual-inertial per-frame functions
# ---------------------------------------------------------------------------

def imu_predict(R_cw, t_cw, v, bias, acc, gyro, dts, mask,
                calib: imu.ImuCalib):
    """Dead-reckon the last frame's state through this frame's IMU batch.
    Returns the predicted (R_cw, t_cw, v)."""
    pre = imu.preintegrate(acc, gyro, dts, mask, bias, calib)
    R2, p2, v2 = imu.predict_state(*lie.se3_inv(R_cw, t_cw), v, bias, pre)
    return (*lie.se3_inv(R2, p2), v2)


def continue_preintegration(pre: imu.Preintegrated, acc, gyro, dts, mask,
                            calib: imu.ImuCalib):
    """Extend the since-keyframe preintegration by one frame's batch."""
    return imu.preintegrate(acc, gyro, dts, mask, pre.bias, calib, init=pre)


def imu_predict_from_kf(m: ms.MapState, anchor_kf, bias,
                        pre: imu.Preintegrated):
    """The current camera pose and velocity dead-reckoned from the anchor
    keyframe's (possibly BA-updated) state through `pre`."""
    R_wb, p = lie.se3_inv(m.kf_R[anchor_kf], m.kf_t[anchor_kf])
    R2, p2, v2 = imu.predict_state(R_wb, p, m.kf_v[anchor_kf], bias, pre)
    return (*lie.se3_inv(R2, p2), v2)


def pose_inertial_step(m: ms.MapState, fr: FrameData, feat_lm, R, t, v0,
                       bias0, anchor_kf, pre: imu.Preintegrated, ref_kf,
                       cfg: TrackerConfig):
    """Visual-inertial refinement of the frame (K12) against the anchor
    keyframe's state, with the since-keyframe preintegration as the edge.
    Returns (PoseInertialResult, pose relative to ref_kf)."""
    lm_i = torch.clamp(feat_lm, min=0).long()
    valid = (feat_lm >= 0) & m.lm_valid[lm_i]
    R_a_wb, p_a = lie.se3_inv(m.kf_R[anchor_kf], m.kf_t[anchor_kf])
    eye9 = torch.eye(9, dtype=pre.C.dtype, device=pre.C.device)
    info9 = torch.linalg.inv_ex(pre.C[:9, :9] + 1e-9 * eye9).inverse
    info9 = vi_ba.floor_info(0.5 * (info9 + info9.T))
    rw = 1.0 / torch.clamp(torch.diagonal(pre.C[9:, 9:]), min=1e-12)
    res = vi_ba.optimize_pose_inertial(
        R, t, v0, bias0, m.lm_pos[lm_i], fr.xn, _info_of(cfg, fr.octave),
        valid, fr.ur, torch.full((), cfg.baseline, device=t.device),
        R_a_wb, p_a, m.kf_v[anchor_kf], m.kf_bias[anchor_kf],
        pre.dt, pre.dR, pre.dV, pre.dP, pre.J_Rg, pre.J_Vg, pre.J_Va,
        pre.J_Pg, pre.J_Pa, info9, pre.bias, rw, n_iters=6)
    Rri, tri = lie.se3_inv(m.kf_R[ref_kf], m.kf_t[ref_kf])
    return res, lie.se3_mul(res.R_cw, res.t_cw, Rri, tri)


def track_step_vi_framedata(fr, m, last, last_feat_lm, R_last, t_last,
                            ref_kf, cam, cfg: TrackerConfig,
                            pre: imu.Preintegrated, anchor_kf, bias, acc,
                            gyro, dts, calib: imu.ImuCalib):
    """One extracted frame of an IMU-initialized map: extend the
    since-keyframe preintegration by the frame's batch (K11), predict from
    the anchor keyframe, track visually with that prediction, refine with
    `pose_inertial_step` (K12; kept only where finite). Returns
    `track_step_framedata`'s five outputs, then the refined velocity, bias
    and the extended preintegration."""
    pre = imu.preintegrate(acc, gyro, dts, dts > 0, pre.bias, calib,
                           init=pre)
    R_pred, t_pred, v_pred = imu_predict_from_kf(m, anchor_kf, bias, pre)
    Ri, ti = lie.se3_inv(R_last, t_last)
    vel = lie.se3_mul(R_pred, t_pred, Ri, ti)
    fr, out, _, _, info = track_step_framedata(
        fr, m, last, last_feat_lm, R_last, t_last, vel[0], vel[1], True,
        ref_kf, cam, cfg)
    res, _ = pose_inertial_step(out.m, fr, out.feat_lm, out.R, out.t, v_pred,
                                bias, anchor_kf, pre, out.ref_kf, cfg)
    ok = (torch.isfinite(res.R_cw).all() & torch.isfinite(res.t_cw).all()
          & torch.isfinite(res.v).all() & torch.isfinite(res.bias).all())
    R_f = torch.where(ok, res.R_cw, out.R)
    t_f = torch.where(ok, res.t_cw, out.t)
    v_f = torch.where(ok, res.v, v_pred)
    b_f = torch.where(ok, res.bias, bias)
    out = out._replace(R=R_f, t=t_f)
    vel_new = lie.se3_mul(R_f, t_f, Ri, ti)
    Rri, tri = lie.se3_inv(out.m.kf_R[out.ref_kf], out.m.kf_t[out.ref_kf])
    rel = lie.se3_mul(R_f, t_f, Rri, tri)
    info = torch.cat([info[:2], torch.isfinite(vel_new[1]).all()
                      .to(info.dtype)[None], info[3:]])
    return fr, out, vel_new, rel, info, v_f, b_f, pre


def apply_imu_gauge(m: ms.MapState, R_wg, scale, v_kf, bias):
    """Rotate and rescale the whole map after an IMU-initialization stage:
    valid keyframes take the new pose, velocity and the common bias."""
    kf_R2, kf_t2, lm2, v2 = inertial_mod.apply_gauge(
        m.kf_R, m.kf_t, m.lm_pos, v_kf, R_wg, scale)
    kv, lv = m.kf_valid, m.lm_valid
    return m._replace(
        kf_R=torch.where(kv[:, None, None], kf_R2, m.kf_R),
        kf_t=torch.where(kv[:, None], kf_t2, m.kf_t),
        lm_pos=torch.where(lv[:, None], lm2, m.lm_pos),
        kf_v=torch.where(kv[:, None], v2, m.kf_v),
        kf_bias=torch.where(kv[:, None], bias[None, :].expand_as(m.kf_bias),
                            m.kf_bias),
        lm_dist_max=torch.where(lv, m.lm_dist_max * scale, m.lm_dist_max))


# ---------------------------------------------------------------------------
# host state machine
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """None means the card; without CUDA that is an error, never a silent
    fallback to the CPU (pass device="cpu" to run there)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "Tracker: CUDA is not available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        device = "cuda"
    return torch.device(device)


def _info_to_host(info):
    """Start the copy of a frame's decision vector to the host as soon as
    the frame is dispatched; returns (host tensor, event) to wait on."""
    if info.device.type != "cuda":
        return info, None
    host = torch.empty(info.shape, dtype=info.dtype, pin_memory=True)
    host.copy_(info, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _host_info(fetch):
    host, ev = fetch
    if ev is not None:
        ev.synchronize()
    return host.numpy()


class Tracker:
    """Host-side orchestration of monocular, rectified stereo and RGB-D
    tracking (`cfg.baseline` > 0 for the two depth sensors), each with IMU
    when given `imu_calib` (the `track_*_inertial` feeds).

    States: NO_IMAGES -> NOT_INITIALIZED -> OK <-> RECENTLY_LOST -> LOST.
    `device=None` runs on the card and raises without one. With a
    vocabulary `voc` the tracker keeps a keyframe database, relocalizes by
    BoW and closes loops and merges maps (`loop_closer`; set it to None to
    keep relocalization only).
    """

    IMU_BUF = 768   # max IMU samples between keyframes
    FRAME_IMU = 64  # max IMU samples of one frame

    def __init__(self, cam: cameras.Camera, cfg: TrackerConfig, device=None,
                 seed: int = 0, voc: Optional[voctree.Vocabulary] = None,
                 imu_calib: Optional[imu.ImuCalib] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cam = cam.to(self.device)
        if imu_calib is not None and not cfg.inertial:
            cfg = tracking_replace_inertial(cfg)
        self.cfg = cfg
        # inertial state: the since-keyframe preintegration and its anchor
        # keyframe, the current velocity and bias, the samples since the
        # last keyframe; the rest is reset with each map
        self.calib = None if imu_calib is None else \
            imu_calib.to(self.device)
        # the host copy of R_bc that rotates each frame's samples
        self._R_bc_host = None if imu_calib is None else \
            imu_calib.R_bc.cpu().numpy()
        self.imu_predict_ok = True
        self.bias = torch.zeros(6, device=self.device)
        self.imu_buf = []
        self.imu_ready = False
        self.viba_stage = 0
        self.ts_first_kf = None
        self.kf_imu = None
        self._frame_imu = None
        self.v_cur = torch.zeros(3, device=self.device)
        self._pre_from_kf = None      # preintegration since the last KF
        self._anchor_kf = None        # the keyframe it starts from
        self._vi_suspended = False
        self._ts_lost_start = None
        self._prev_pose_for_v = None
        self._v_pred = None
        self.kf_seq = 0               # keyframe inserts, for the scale gate
        self.voc = None if voc is None else voc.to(self.device)
        self.loop_closer = None if voc is None else \
            loop_closing.LoopCloser(cfg)
        self.n_loops_closed = 0
        # decisions lag the dispatched frames in state OK (False: every
        # frame decided at once)
        self.pipelined = True
        self._kf_prev_override = None   # set by a merge (chain splice)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stash = []
        self.map_gen = 0
        # trajectory: (ts, map_gen, ref_kf, R_cr, t_cr) — pose relative to
        # a reference keyframe of one map generation
        self.trajectory = []
        # localization-only mode switches keyframe insertion and map resets
        # off
        self._mapping_enabled = True
        self._fresh_map_state()
        self.state = "NO_IMAGES"

    # -- public API -------------------------------------------------------

    def _check_timestamp(self, ts: float):
        """A backwards jump or a gap over ts_jump: a young map resets, a
        mature one is stashed and a fresh one starts."""
        last = getattr(self, "_last_seen_ts", None)
        self._last_seen_ts = ts
        if last is None or self.state not in ("OK", "RECENTLY_LOST"):
            return
        dt = ts - last
        if dt < 0 or dt > self.cfg.ts_jump:
            self.flush()
            self._drop_lost_map()

    def _to_device(self, img):
        return torch.as_tensor(np.asarray(img) if not torch.is_tensor(img)
                               else img).to(self.device, non_blocking=True)

    def track_mono(self, img, ts: float):
        """One grayscale frame (numpy or tensor, uint8 or float) ->
        (state, (R_cw, t_cw) or None)."""
        self._check_timestamp(ts)
        fr = extract_frame(self._to_device(img), self.cam, self.cfg)
        if self.state in ("NO_IMAGES", "NOT_INITIALIZED"):
            self._try_initialize(fr, ts)
            pose = (self.R_last, self.t_last) if self.state == "OK" else None
            return self.state, pose
        return self._track(fr, ts)

    def track_stereo(self, img_l, img_r, ts: float):
        """One rectified stereo pair -> (state, (R_cw, t_cw) or None)."""
        self._check_timestamp(ts)
        fr = extract_stereo_frame(self._to_device(img_l),
                                  self._to_device(img_r), self.cam, self.cfg)
        if self.state in ("NO_IMAGES", "NOT_INITIALIZED"):
            return self._try_init_from_depth(fr, ts)
        return self._track(fr, ts)

    def track_rgbd(self, img, depth_map, ts: float):
        """One grey image and its depth map (metres, 0 = none) -> (state,
        (R_cw, t_cw) or None)."""
        self._check_timestamp(ts)
        fr = extract_rgbd_frame(self._to_device(img),
                                self._to_device(depth_map), self.cam,
                                self.cfg)
        if self.state in ("NO_IMAGES", "NOT_INITIALIZED"):
            return self._try_init_from_depth(fr, ts)
        return self._track(fr, ts)

    # -- inertial feeds -----------------------------------------------------

    def track_mono_inertial(self, img, ts: float, imu_acc, imu_gyro, imu_ts):
        """A monocular frame with the IMU samples of (last frame, ts]
        (body-frame acc, gyro (n, 3), timestamps (n,))."""
        return self._inertial_frame(ts, imu_acc, imu_gyro, imu_ts,
                                    lambda: self.track_mono(img, ts))

    def track_stereo_inertial(self, img_l, img_r, ts: float, imu_acc,
                              imu_gyro, imu_ts):
        return self._inertial_frame(
            ts, imu_acc, imu_gyro, imu_ts,
            lambda: self.track_stereo(img_l, img_r, ts))

    def track_rgbd_inertial(self, img, depth_map, ts: float, imu_acc,
                            imu_gyro, imu_ts):
        return self._inertial_frame(
            ts, imu_acc, imu_gyro, imu_ts,
            lambda: self.track_rgbd(img, depth_map, ts))

    def _inertial_frame(self, ts, acc, gyro, imu_ts, track):
        self._pre_inertial_frame(ts)
        self._accumulate_imu(acc, gyro, imu_ts, ts)
        if not (self._use_vi_fused() and self.last is not None):
            # a fused frame extends the since-KF chain itself
            self._update_pre_from_kf()
        if self.imu_ready and self.imu_predict_ok and \
                self.state == "OK" and self.last is not None and \
                not self._use_vi_fused():
            self._set_imu_prediction()
        out = self._inertial_lost_fallback(ts, track())
        self._after_inertial_frame(ts)
        return out

    def _pre_inertial_frame(self, ts: float):
        if self.state == "OK":
            self._ts_lost_start = None
        elif self._ts_lost_start is None and self.state == "RECENTLY_LOST":
            self._ts_lost_start = ts

    def _inertial_lost_fallback(self, ts: float, out):
        """IMU dead-reckoning through RECENTLY_LOST on an initialized map,
        for up to time_recently_lost seconds; then LOST."""
        state, _ = out
        if state != "RECENTLY_LOST" or not self.imu_ready or \
                self.calib is None or self._pre_from_kf is None or \
                self._anchor_kf is None or self._vi_suspended:
            return out
        if self._ts_lost_start is None:
            self._ts_lost_start = ts
        if ts - self._ts_lost_start > self.cfg.time_recently_lost:
            self.flush()
            self.state = "LOST"
            self._drop_lost_map()
            return self.state, None
        R_p, t_p, v_p = imu_predict_from_kf(self.m, self._anchor_kf,
                                            self.bias, self._pre_from_kf)
        if not bool(torch.isfinite(t_p).all()):
            return out
        self.R_last, self.t_last = R_p, t_p
        self.v_cur = v_p
        self.frames_lost = 0          # the time budget governs
        Rri, tri = lie.se3_inv(self.m.kf_R[self.ref_kf],
                               self.m.kf_t[self.ref_kf])
        rel = lie.se3_mul(R_p, t_p, Rri, tri)
        self.trajectory.append((ts, self.map_gen, self.ref_kf, rel[0],
                                rel[1]))
        return self.state, (R_p, t_p)

    def _accumulate_imu(self, acc, gyro, ts_arr, frame_ts):
        """Buffer the frame's samples, rotated from body into camera axes
        (R_bc^T a; body == camera downstream, lever arm neglected), with
        per-sample intervals; the last one reaches the frame time."""
        if self.calib is None or len(ts_arr) == 0:
            self._frame_imu = None
            return
        acc = np.asarray(acc, np.float32)
        gyro = np.asarray(gyro, np.float32)
        R_bc = self._R_bc_host
        if not np.allclose(R_bc, np.eye(3)):
            acc = acc @ R_bc
            gyro = gyro @ R_bc
        ts_arr = np.asarray(ts_arr)
        prev = getattr(self, "_last_frame_ts", ts_arr[0] - 0.005)
        dts = np.diff(np.concatenate([[prev], ts_arr])).astype(np.float32)
        if frame_ts > ts_arr[-1]:
            dts[-1] += frame_ts - ts_arr[-1]
        self._frame_imu = (acc, gyro, dts)
        self.imu_buf.append((frame_ts, acc, gyro, dts))
        self._last_frame_ts = frame_ts

    def _padded(self, acc, gyro, dts, cap: int):
        """The newest `cap` samples, zero-padded to `cap`, on the device;
        dts == 0 marks the padding."""
        n = len(dts)
        if n > cap:
            acc, gyro, dts = acc[-cap:], gyro[-cap:], dts[-cap:]
            n = cap
        z = np.zeros((cap - n, 3), np.float32)
        buf = np.concatenate([np.concatenate([acc, z]),
                              np.concatenate([gyro, z]),
                              np.concatenate([dts, np.zeros(cap - n,
                                                            np.float32)]
                                             )[:, None]], axis=1)
        t = torch.from_numpy(buf).to(self.device, non_blocking=True)
        return t[:, 0:3], t[:, 3:6], t[:, 6], n

    def _padded_frame_imu(self, cap: int = FRAME_IMU):
        if self._frame_imu is None:
            return None, None, None
        return self._padded(*self._frame_imu, cap)[:3]

    def _fused_frame_imu(self, cap: int = FRAME_IMU):
        """The fused program's padded batch (all padding without
        samples)."""
        acc, gyro, dts = self._padded_frame_imu(cap)
        if acc is None:
            z = torch.zeros((cap, 3), device=self.device)
            return z, z, torch.zeros(cap, device=self.device)
        return acc, gyro, dts

    def _update_pre_from_kf(self):
        """Extend the since-keyframe preintegration by this frame's batch."""
        if self._pre_from_kf is None:
            return
        acc, gyro, dts = self._padded_frame_imu()
        if acc is None:
            return
        self._pre_from_kf = continue_preintegration(
            self._pre_from_kf, acc, gyro, dts, dts > 0, self.calib)

    def _reset_pre_from_kf(self, k: int):
        """Restart the since-keyframe preintegration at keyframe k and the
        current bias."""
        if self.calib is None:
            return
        z = torch.zeros((1, 3), device=self.device)
        self._pre_from_kf = imu.preintegrate(
            z, z, torch.zeros(1, device=self.device),
            torch.zeros(1, dtype=torch.bool, device=self.device), self.bias,
            self.calib)
        self._anchor_kf = k

    def _set_imu_prediction(self):
        """Motion model from the anchor keyframe through the since-keyframe
        preintegration (translation only is trusted for the search)."""
        if self._pre_from_kf is None or self._anchor_kf is None or \
                self._vi_suspended:
            return
        R_pred, t_pred, v_pred = imu_predict_from_kf(
            self.m, self._anchor_kf, self.bias, self._pre_from_kf)
        Ri, ti = lie.se3_inv(self.R_last, self.t_last)
        self.vel = lie.se3_mul(R_pred, t_pred, Ri, ti)
        self.has_vel = True
        self._v_pred = v_pred

    def _after_inertial_frame(self, ts: float):
        if self.calib is None or self.state != "OK":
            return
        # finite-difference velocity before the IMU initialization; after
        # it the pose-inertial refinement maintains the velocity
        if not self.imu_ready and self._prev_pose_for_v is not None:
            R0, t0, t_prev = self._prev_pose_for_v
            dt = max(ts - t_prev, 1e-3)
            c1 = -lie.matvec(self.R_last.T, self.t_last)
            c0 = -lie.matvec(R0.T, t0)
            v = torch.nan_to_num((c1 - c0) / dt, nan=0.0, posinf=0.0,
                                 neginf=0.0)
            self.v_cur = torch.clamp(v, -20.0, 20.0)
        self._prev_pose_for_v = (self.R_last, self.t_last, ts)
        self._maybe_init_imu(ts)

    # (t_min s, kf_min, prior gyro, prior acc) of InitializeIMU, VIBA1, VIBA2
    # and the later refinements
    IMU_STAGES = ((2.0, 10, 1e2, 1e10), (5.0, 10, 1.0, 1e5),
                  (15.0, 10, 0.0, 0.0), (25.0, 10, 0.0, 0.0),
                  (45.0, 10, 0.0, 0.0))

    def _maybe_init_imu(self, ts: float):
        """Staged IMU initialization: closed-form alignment over the 14
        newest keyframes (scale for monocular maps, behind a two-attempt
        agreement gate), inertial-only Gauss-Newton at fixed scale, the
        gauge change, then a full inertial BA with the stage's priors."""
        if self.calib is None or self.ts_first_kf is None:
            return
        elapsed = ts - self.ts_first_kf
        if not self.imu_ready and elapsed > self.cfg.bad_imu_timeout:
            self.bad_imu = True
            self.flush()
            self.reset_active_map()
            return
        if self.viba_stage >= len(self.IMU_STAGES):
            return
        t_min, kf_min, pg, pa = self.IMU_STAGES[self.viba_stage]
        if elapsed < t_min or self.n_kf_host < kf_min:
            return
        # the gauge change invalidates in-flight frames: decide them first
        self.flush()
        m = self.m
        R_wb, p_wb = lie.se3_inv(m.kf_R, m.kf_t)
        mono = self.cfg.baseline == 0.0
        K = m.kf_valid.shape[0]
        ts_v = torch.where(m.kf_valid, m.kf_ts,
                           torch.full_like(m.kf_ts, float("-inf")))
        thr = topk(ts_v, min(14, K))[0][-1]
        recent = m.kf_valid & (m.kf_ts >= thr)
        s_lin, g_lin, v_lin, rms = inertial_mod.linear_alignment(
            self.kf_imu, R_wb, p_wb, recent)
        g_norm, rms, s_cand = torch.stack(
            [torch.linalg.norm(g_lin), rms, s_lin]).tolist()
        s_f = 1.0
        if mono and not self.imu_ready:
            # monocular scale: a tight residual and two consecutive
            # estimates on different keyframe sets that agree
            s_prev, seq_prev = getattr(self, "_s_cand_prev", (None, -1))
            self._s_cand_prev = (s_cand, self.kf_seq)
            stable = (s_prev is not None and seq_prev != self.kf_seq
                      and abs(s_cand - s_prev) < 0.15 * max(s_cand, 1e-6))
            if not (0.05 < s_cand < 50.0 and rms < 0.008 and stable):
                return
            s_f = s_cand
        if not (9.0 < g_norm < 10.6) or rms > 0.03:
            return
        R_wg0 = inertial_mod.gravity_rotation(g_lin)
        R_wg, _, bg, ba_, v_e, _ = inertial_mod.inertial_only_optimize(
            self.kf_imu, R_wb, p_wb * s_f, recent, n_iters=25,
            opt_scale=False, prior_gyro=max(pg, 1e-2),
            prior_acc=max(pa, 1e-2), v0=v_lin, R_wg0=R_wg0)
        if not bool(torch.isfinite(v_e).all() & torch.isfinite(R_wg).all()
                    & torch.isfinite(bg).all() & torch.isfinite(ba_).all()):
            return
        self.bias = torch.cat([bg, ba_])
        if self.imu_ready:
            s_f = 1.0   # later stages refine gravity and bias at fixed scale
        # re-apply the gravity rotation (and the first scale) on every stage
        self.m = apply_imu_gauge(m, R_wg, s_f, v_e, self.bias)
        self.R_last = lie.matmat(self.R_last, R_wg)
        self.t_last = self.t_last * s_f
        self.v_cur = lie.matvec(R_wg.T, self.v_cur) * s_f
        if s_f != 1.0:
            self.trajectory = [
                (t_, g_, r_, R_cr, t_cr * s_f) if g_ == self.map_gen
                else (t_, g_, r_, R_cr, t_cr)
                for (t_, g_, r_, R_cr, t_cr) in self.trajectory]
        self.has_vel = False
        self.imu_ready = True
        if self.n_kf_host >= 4:
            last = self.last_kf_id
            self.m, _ = local_mapping.full_inertial_ba(
                self.m, self.kf_imu, last, self.cfg.lm_cfg, window=32,
                prior_gyro=max(pg, 1e-2), prior_acc=max(pa, 1e-2))
            self.bias = self.m.kf_bias[last]
            self.has_vel = False
        self.viba_stage += 1

    def _use_pipeline(self):
        """Decisions lag the dispatched frames in state OK when `pipelined`,
        except on an inertial map before its IMU initialization (its visual
        odometry stays synchronous; the staged init flushes before a gauge
        change)."""
        if self.calib is not None and not self.imu_ready:
            return False
        return self.pipelined and self.state == "OK"

    def _use_vi_fused(self):
        """The fused visual-inertial frame step runs once the IMU is
        initialized and a since-keyframe chain is live (suspended after a
        relocalization until the next keyframe)."""
        return (self.calib is not None and self.imu_ready
                and self._pre_from_kf is not None
                and self._anchor_kf is not None and not self._vi_suspended)

    # -- init -------------------------------------------------------------

    def _try_initialize(self, fr: FrameData, ts: float):
        cfg = self.cfg
        if self.fr_init is None or int(fr.valid.sum()) < cfg.min_init_matches:
            self.fr_init, self.ts_init = fr, ts
            self.state = "NOT_INITIALIZED"
            return
        idx = matching.search_for_initialization(
            self.fr_init.uv, self.fr_init.desc, self.fr_init.valid,
            self.fr_init.angle, fr.uv, fr.desc, fr.valid, fr.angle)
        if int((idx >= 0).sum()) < cfg.min_init_matches:
            self.fr_init, self.ts_init = fr, ts
            return
        j = torch.clamp(idx, min=0).long()
        res = two_view.reconstruct_two_view(
            self.fr_init.xn, fr.xn[j], idx >= 0, focal=cfg.focal,
            generator=self.generator)
        if int(res.n_good) < cfg.min_init_points or \
                float(res.parallax_deg) < 1.0:
            return
        self.m, k1 = create_initial_map(
            self.m, self.fr_init, fr, idx, res.R21, res.t21, res.points,
            res.is_good, self.ts_init, ts, cfg)
        self._db_add(k1 - 1, self.fr_init)
        self._db_add(k1, fr)
        if self.calib is not None:
            # keyframe 0's time bounds keyframe 1's preintegration window
            self._last_kf_ts = self.ts_init
            self.ts_first_kf = self.ts_init
            self._record_kf_imu(k1, ts)
        self.kf_seq += 2
        self.last = fr
        self.last_feat_lm = self.m.kf_feat_lm[k1]
        self.R_last = self.m.kf_R[k1]
        self.t_last = self.m.kf_t[k1]
        self.ref_kf = k1
        self.n_kf_host = k1 + 1
        self.last_kf_id = k1
        self._ref_matches = int((self.last_feat_lm >= 0).sum())
        self.frames_since_kf = 0
        self.has_vel = False
        self.state = "OK"
        eye, zero = torch.eye(3, device=self.device), \
            torch.zeros(3, device=self.device)
        self.trajectory.append((self.ts_init, self.map_gen, k1 - 1, eye, zero))
        self.trajectory.append((ts, self.map_gen, k1, eye, zero))

    def _try_init_from_depth(self, fr: FrameData, ts: float):
        """Stereo / RGB-D: a map from the first frame with enough features
        of valid depth."""
        n_depth = int((fr.valid & (fr.depth > 0)).sum())
        if n_depth < self.cfg.min_stereo_init_feats:
            self.state = "NOT_INITIALIZED"
            return self.state, None
        self.m, k0 = stereo_initialize(self.m, fr, ts, self.cfg,
                                       slot=self.n_kf_host)
        if self.calib is not None:
            self._record_kf_imu(k0, ts)   # anchors ts_first_kf and the chain
        self.kf_seq += 1
        self._db_add(k0, fr)
        self.last = fr
        self.last_feat_lm = self.m.kf_feat_lm[k0]
        self.R_last = torch.eye(3, device=self.device)
        self.t_last = torch.zeros(3, device=self.device)
        self.ref_kf = k0
        self.n_kf_host = k0 + 1
        self.last_kf_id = k0
        self._ref_matches = int((self.last_feat_lm >= 0).sum())
        self.frames_since_kf = 0
        self.has_vel = False
        self.state = "OK"
        self.trajectory.append((ts, self.map_gen, k0, self.R_last,
                                self.t_last))
        return self.state, (self.R_last, self.t_last)

    # -- tracking ---------------------------------------------------------

    def _track(self, fr: FrameData, ts: float):
        if self.last is None:
            if self._recover_lost(fr):
                return self.state, (self.R_last, self.t_last)
            return self.state, None
        if self._use_vi_fused():
            out_tuple = track_step_vi_framedata(
                fr, self.m, self.last, self.last_feat_lm, self.R_last,
                self.t_last, self.ref_kf, self.cam, self.cfg,
                self._pre_from_kf, self._anchor_kf, self.bias,
                *self._fused_frame_imu(), self.calib)
        else:
            vel_R, vel_t = self.vel
            out_tuple = track_step_framedata(
                fr, self.m, self.last, self.last_feat_lm, self.R_last,
                self.t_last, vel_R, vel_t, self.has_vel, self.ref_kf,
                self.cam, self.cfg)
        if self._use_pipeline():
            return self._track_pipelined(out_tuple, ts)
        return self._post_track(out_tuple, ts)

    def _track_pipelined(self, out_tuple, ts: float):
        fr, out, vel_new, rel, info = out_tuple[:5]
        self._pending.append([out_tuple, ts, None, _info_to_host(info)])
        # optimistic device-side state for the next dispatch; the decision
        # is made pipeline_depth frames later
        self.m = out.m
        self.last = fr
        self.last_feat_lm = out.feat_lm
        self.R_last, self.t_last = out.R, out.t
        self.vel = vel_new
        self.has_vel = True
        if len(out_tuple) > 5:
            # the fused VI step's velocity, bias and extended preintegration
            self.v_cur, self.bias, self._pre_from_kf = out_tuple[5:8]
        self.frames_since_kf += 1
        while len(self._pending) > self.cfg.pipeline_depth:
            self._decide_pending(*self._pending.pop(0))
        return self.state, (out.R, out.t)

    def flush(self):
        """Resolve the in-flight frames' deferred decisions and finish a
        running detached global BA (call at the end of a sequence or before
        reading the trajectory or map)."""
        while self._pending:
            self._decide_pending(*self._pending.pop(0))
        if self._gba_job is not None:
            with record_function("GBATotal"):
                while not self._gba_job.advance():
                    pass
                self.m = self._gba_job.reconcile(self.m)
            self._gba_job = None

    def _decide_pending(self, out_tuple, ts: float, corr=None, fetch=None):
        """Deferred host decisions for a dispatched frame: state machine,
        trajectory entry, keyframe insertion."""
        cfg = self.cfg
        fr, out, vel_new, rel, info = out_tuple[:5]
        v_bias = out_tuple[5:7] if len(out_tuple) > 5 else None
        info_h = _host_info(fetch) if fetch is not None else \
            info.cpu().numpy()
        n_inl = int(info_h[0])
        ref_kf_new = int(info_h[1])
        if not bool(info_h[2] > 0.5):
            self.has_vel = False
        if n_inl < cfg.min_track_points:
            # this frame was bad and its in-flight successors built on it:
            # drop them and recover from the reference keyframe
            self.state = "RECENTLY_LOST"
            self.has_vel = False
            self.frames_lost += 1
            self._pending = []
            self.last = None
            if not self._use_vi_fused():
                # visual: re-seed the recovery at the reference keyframe;
                # inertial keeps the pose the IMU fallback replaces
                self.R_last = self.m.kf_R[self.ref_kf]
                self.t_last = self.m.kf_t[self.ref_kf]
            if self.frames_lost > 60:
                self.state = "LOST"
                self._drop_lost_map()
            return
        self.frames_lost = 0
        self.state = "OK"
        self.ref_kf = ref_kf_new
        if corr is not None:
            # keyframe BA moved the map since this frame was dispatched:
            # carry the pose into the current gauge and recompute its
            # trajectory entry against the reference keyframe's pose now
            out = out._replace(R=lie.matmat(out.R, corr[0]),
                               t=lie.matvec(out.R, corr[1]) + out.t)
            Rri, tri = lie.se3_inv(self.m.kf_R[ref_kf_new],
                                   self.m.kf_t[ref_kf_new])
            rel = lie.se3_mul(out.R, out.t, Rri, tri)
        self.trajectory.append((ts, self.map_gen, ref_kf_new, rel[0], rel[1]))
        need = self._need_new_kf(n_inl, info_h, ts, lag=len(self._pending))
        if need and self._mapping_enabled:
            loops_before = self.n_loops_closed
            k = self._insert_keyframe(fr, out, ts, refresh_anchors=False,
                                      ref_inliers=n_inl, v_bias=v_bias)
            if k is None:
                pass
            elif self.n_loops_closed != loops_before:
                # a loop correction or a merge moved the whole map: the
                # in-flight frames' results are stale, so drop them and
                # re-anchor at the corrected keyframe
                self._pending = []
                self.last = None
            else:
                # the keyframe's association table was enriched by
                # triangulation and fusion: it becomes the stage-1 anchor
                self.last = fr
                self.last_feat_lm = self.m.kf_feat_lm[k]

    def _need_new_kf(self, n_inl: int, info_h, ts: float, lag: int = 0):
        """NeedNewKeyFrame: c1a too long since the last KF; c1b the min gap;
        c1c (stereo / RGB-D) tracking starved of close points or under a
        quarter of the reference KF's landmarks; c2 inliers decayed below
        kf_ref_ratio of those at the last insertion, or close points
        starved. Insert on c1a, or on (c1b or c1c) and c2."""
        cfg = self.cfg
        ref_tracked = max(int(info_h[4]), 1)
        close_trk, close_untrk = int(info_h[5]), int(info_h[6])
        stereoish = cfg.baseline > 0
        need_close = stereoish and close_trk < 100 and close_untrk > 70
        fs = self.frames_since_kf - lag
        c1a = fs >= cfg.max_kf_interval
        c1b = fs >= cfg.min_kf_interval
        c1c = stereoish and c1b and \
            (n_inl < 0.25 * ref_tracked or need_close)
        c2 = (n_inl < cfg.kf_ref_ratio * max(self._ref_matches, 1)
              or need_close) and n_inl > 15
        need = c1a or ((c1b or c1c) and c2)
        if cfg.inertial and self.calib is not None and n_inl > 15:
            # c3: inertial timer, every 0.25 s before the IMU initialization
            # (it needs ~10 keyframes in 2 s), every 0.5 s after; c4: weak
            # monocular-inertial tracking
            last_ts = getattr(self, "_last_kf_ts", None)
            if last_ts is not None and \
                    ts - last_ts >= (0.5 if self.imu_ready else 0.25):
                need = True
            if self.imu_ready and not stereoish and c1b and 15 < n_inl < 75:
                need = True
        return need and n_inl > 15

    def _recompute_vel_rel(self, out):
        Ri, ti = lie.se3_inv(self.R_last, self.t_last)
        vel_new = lie.se3_mul(out.R, out.t, Ri, ti)
        Rri, tri = lie.se3_inv(self.m.kf_R[out.ref_kf],
                               self.m.kf_t[out.ref_kf])
        return vel_new, lie.se3_mul(out.R, out.t, Rri, tri)

    def _post_track(self, out_tuple, ts: float):
        """Synchronous decision path (while not in state OK)."""
        cfg = self.cfg
        fr, out, vel_new, rel, info = out_tuple[:5]
        # the fused VI step already refined the pose, velocity and bias
        v_bias = out_tuple[5:7] if len(out_tuple) > 5 else None
        info_h = info.cpu().numpy()
        n_inl = int(info_h[0])
        ref_kf_new = int(info_h[1])
        vel_finite = bool(info_h[2] > 0.5)
        if v_bias is None and self.has_vel and n_inl < cfg.min_local_points:
            # the motion-model prediction may have poisoned the window
            # search: retry prediction-free
            _, out2, vel2, rel2, info2 = track_step_framedata(
                fr, self.m, self.last, self.last_feat_lm, self.R_last,
                self.t_last, None, None, False, self.ref_kf, self.cam, cfg)
            info2_h = info2.cpu().numpy()
            if int(info2_h[0]) > n_inl:
                out, n_inl = out2, int(info2_h[0])
                ref_kf_new = int(info2_h[1])
                vel_finite = bool(info2_h[2] > 0.5)
                vel_new, rel = vel2, rel2
        if v_bias is None and n_inl < cfg.min_local_points:
            Rr, tr_, lm_r, n_r = track_reference_kf(
                self.m, fr, self.ref_kf, self.R_last, self.t_last, cfg)
            if int(n_r) > n_inl:
                out = out._replace(R=Rr, t=tr_, feat_lm=lm_r, n_inl=n_r,
                                   ref_kf=torch.as_tensor(
                                       self.ref_kf, device=self.device))
                n_inl = int(n_r)
                ref_kf_new = self.ref_kf
                self.has_vel = False
                vel_new, rel = self._recompute_vel_rel(out)
                vel_finite = bool(torch.isfinite(vel_new[1]).all())
        self.m = out.m
        if len(out_tuple) > 7:
            self._pre_from_kf = out_tuple[7]
        if n_inl < cfg.min_track_points:
            self.state = "RECENTLY_LOST"
            self.has_vel = False
            self.frames_lost += 1
            if v_bias is not None:
                # an initialized map dead-reckons through the dropout
                return self.state, None
            if self.frames_lost > 60:
                self.state = "LOST"
                self._drop_lost_map()
            return self.state, None
        self.frames_lost = 0
        self.state = "OK"
        if vel_finite:
            self.vel = vel_new
            self.has_vel = True
        else:
            self.has_vel = False
        self.R_last, self.t_last = out.R, out.t
        if v_bias is not None:
            self.v_cur, self.bias = v_bias
        elif (self.calib is not None and self.imu_ready
                and self._pre_from_kf is not None
                and self._anchor_kf is not None and not self._vi_suspended):
            v0 = self.v_cur if self._v_pred is None else self._v_pred
            res, rel = pose_inertial_step(
                self.m, fr, out.feat_lm, out.R, out.t, v0, self.bias,
                self._anchor_kf, self._pre_from_kf, ref_kf_new, cfg)
            self.R_last, self.t_last = res.R_cw, res.t_cw
            self.v_cur, self.bias = res.v, res.bias
            out = out._replace(R=res.R_cw, t=res.t_cw)
        self.last = fr
        self.last_feat_lm = out.feat_lm
        self.ref_kf = ref_kf_new
        self.frames_since_kf += 1
        self.trajectory.append((ts, self.map_gen, self.ref_kf, rel[0], rel[1]))
        if self._need_new_kf(n_inl, info_h, ts) and self._mapping_enabled:
            self._insert_keyframe(fr, out, ts, ref_inliers=n_inl,
                                  v_bias=v_bias)
        return self.state, (out.R, out.t)

    def _alloc_kf_slot(self):
        """Append below the high-water mark; at capacity, recycle culled
        keyframes' slots. None when every slot is live."""
        cfg = self.cfg
        if self.n_kf_host < cfg.max_kf - 1:
            k = self.n_kf_host
            self.n_kf_host += 1
            return k
        if not self._free_kf_slots:
            valid = self.m.kf_valid[:self.n_kf_host].cpu().numpy()
            protect = {0, self.ref_kf, self.last_kf_id}
            if self._anchor_kf is not None:
                protect.add(self._anchor_kf)
            self._free_kf_slots = [i for i in range(1, self.n_kf_host)
                                   if not valid[i] and i not in protect]
        if not self._free_kf_slots:
            return None
        k = self._free_kf_slots.pop(0)
        self._rebase_trajectory(k)
        lc = self.loop_closer
        if lc is not None:
            # a recycled slot must not revive a past loop edge or a carried
            # candidate Sim(3) anchored on the culled keyframe
            lc.past_loop_edges = [e for e in lc.past_loop_edges
                                  if k not in e]
            if k in (lc._pending_slot, lc._pending_cand):
                lc._reset_pending()
        return k

    def _rebase_trajectory(self, slot: int):
        """Re-anchor trajectory entries of a recycled keyframe slot onto the
        newest keyframe through the culled keyframe's final pose."""
        hits = [i for i, e in enumerate(self.trajectory)
                if e[1] == self.map_gen and e[2] == slot]
        if not hits:
            return
        anchor = self.last_kf_id
        Rai, tai = lie.se3_inv(self.m.kf_R[anchor], self.m.kf_t[anchor])
        dR, dt = lie.se3_mul(self.m.kf_R[slot], self.m.kf_t[slot], Rai, tai)
        for i in hits:
            t0, g0, _, R_cr, t_cr = self.trajectory[i]
            R2, t2 = lie.se3_mul(R_cr, t_cr, dR, dt)
            self.trajectory[i] = (t0, g0, anchor, R2, t2)

    def _insert_keyframe(self, fr: FrameData, out: TrackOutput, ts: float,
                         refresh_anchors: bool = True, ref_inliers=None,
                         v_bias=None):
        k = self._alloc_kf_slot()
        if k is None:
            return None
        # the temporal predecessor: the newest keyframe, or after a merge
        # the active map's keyframe the weld was made from
        prev = self.last_kf_id if self._kf_prev_override is None else \
            self._kf_prev_override
        self._kf_prev_override = None
        self.m, _ = insert_keyframe(self.m, fr, out.feat_lm, out.R, out.t,
                                    ts, slot=k, prev_id=prev)
        self.last_kf_id = k
        self.kf_seq += 1
        if ref_inliers is not None:
            self._ref_matches = int(ref_inliers)
        self._record_kf_imu(k, ts, prev=prev, v_bias=v_bias)
        if self.cfg.baseline > 0:
            self.m = create_close_landmarks(self.m, k, fr, self.cfg)
        bow = self._db_add(k, fr)
        if self.cfg.inertial and self.imu_ready and self.kf_imu is not None:
            self.m, self.kf_imu = local_mapping.mapping_step_inertial(
                self.m, self.kf_imu, k, self.cam, self.cfg.lm_cfg)
        else:
            self.m = local_mapping.mapping_step(self.m, k, self.cam,
                                                self.cfg.lm_cfg)
        if self.loop_closer is not None and bow is not None:
            with record_function("LoopTotal"):
                if self.loop_closer.maybe_close(self, k, bow) or (
                        self.stash and
                        self.loop_closer.maybe_merge(self, k, bow)):
                    self.n_loops_closed += 1
        if self._gba_job is not None:
            # one slice of the detached global BA per insert, folded into
            # the live map at once
            with record_function("GBATotal"):
                done = self._gba_job.advance()
                self.m = self._gba_job.reconcile(self.m)
                if done:
                    self._gba_job = None
        self.ref_kf = k
        self.frames_since_kf = 0
        if refresh_anchors:
            self.last_feat_lm = self.m.kf_feat_lm[k]
            self.R_last = self.m.kf_R[k]
            self.t_last = self.m.kf_t[k]
        else:
            # pipelined: the optimistic anchor is a newer frame; carry the
            # keyframe's BA correction over to it and to every in-flight
            # frame (T_last' = T_last T_kf_old^-1 T_kf_new)
            Ri, ti = lie.se3_inv(out.R, out.t)
            dR, dt = lie.se3_mul(Ri, ti, self.m.kf_R[k], self.m.kf_t[k])
            self.R_last, self.t_last = lie.se3_mul(self.R_last, self.t_last,
                                                   dR, dt)
            for entry in self._pending:
                entry[2] = (dR, dt) if entry[2] is None else \
                    lie.se3_mul(entry[2][0], entry[2][1], dR, dt)
        return k

    def _record_kf_imu(self, k: int, ts: float, prev: Optional[int] = None,
                       v_bias=None):
        """Keyframe k's preintegration from the previous keyframe (the
        buffered samples of (previous KF time, ts], K11 on a 768-sample
        buffer), its velocity and bias; then restart the since-keyframe
        chain at k and re-apply the batches newer than ts (the pipelined
        decision lags the dispatched frames)."""
        if self.calib is None:
            return
        if self.ts_first_kf is None:
            self.ts_first_kf = ts
        v_rec, b_rec = (self.v_cur, self.bias) if v_bias is None else v_bias
        prev_ts = getattr(self, "_last_kf_ts", -np.inf)
        buf = [e for e in self.imu_buf if prev_ts + 1e-9 < e[0] <= ts + 1e-9]
        leftover = [e for e in self.imu_buf if e[0] > ts + 1e-9]
        self._last_kf_ts = ts
        ki = torch.tensor([k], device=self.device)
        if buf and k > 0:
            acc, gyro, dts, n = self._padded(
                *(np.concatenate([e[i] for e in buf]) for i in (1, 2, 3)),
                self.IMU_BUF)
            mask = torch.arange(self.IMU_BUF, device=self.device) < n
            pre = imu.preintegrate(acc, gyro, dts, mask, b_rec, self.calib)
            self.kf_imu = inertial_mod.set_kf_imu(
                self.kf_imu, k, pre, k - 1 if prev is None else prev)
        elif self.kf_imu is not None:
            # no samples: a recycled slot must not keep its old entry
            self.kf_imu = self.kf_imu._replace(
                valid=put(self.kf_imu.valid, ki, False))
        self.m = self.m._replace(kf_v=put(self.m.kf_v, ki, v_rec[None]),
                                 kf_bias=put(self.m.kf_bias, ki,
                                             b_rec[None]))
        self.imu_buf = leftover
        self._reset_pre_from_kf(k)
        for (_, a, g, d) in leftover:
            acc, gyro, dts, _ = self._padded(a, g, d, self.FRAME_IMU)
            self._pre_from_kf = continue_preintegration(
                self._pre_from_kf, acc, gyro, dts, dts > 0, self.calib)
        self._vi_suspended = False

    def _db_add(self, kf_id: int, fr: FrameData):
        """Put the keyframe's BoW vector into the database (with a
        vocabulary) and return it (None without one)."""
        if self.db is None:
            return None
        bow = voctree.bow_vector(
            self.voc, voctree.transform(self.voc, fr.desc, fr.valid))
        self.db = kfdb.add_keyframe(self.db, kf_id, bow)
        return bow

    def _try_relocalize(self, fr: FrameData):
        """BoW candidates (the top 3 by L1 score) + PnP RANSAC + pose
        optimization; the candidate with the most inliers wins if it has at
        least 30."""
        if self.db is None:
            return False
        bow = voctree.bow_vector(
            self.voc, voctree.transform(self.voc, fr.desc, fr.valid))
        ids, _, ok = kfdb.top_candidates(self.db, bow, 3)
        ids_h, ok_h = torch.stack([ids, ok.to(ids.dtype)]).tolist()
        best = None
        for kf, good in zip(ids_h, ok_h):
            if not good:
                continue
            R, t, feat_lm, n_inl = relocalize_candidate(
                self.m, fr, kf, self.cfg, self.cam, generator=self.generator)
            n_inl = int(n_inl)
            if best is None or n_inl > best[3]:
                best = (R, t, feat_lm, n_inl, kf)
        if best is None or best[3] < 30:
            return False
        self.R_last, self.t_last, self.last_feat_lm, n_inl, self.ref_kf = best
        self.last = fr
        self.has_vel = False
        self.state = "OK"
        self.frames_lost = 0
        # re-arm the keyframe trigger: insertion may happen at once
        self._ref_matches = n_inl
        self.frames_since_kf = self.cfg.min_kf_interval
        if self.calib is not None:
            # the preintegration across the gap no longer bounds the pose:
            # the VI step stays off until the next keyframe re-roots it
            self._vi_suspended = True
        return True

    def _recover_lost(self, fr: FrameData):
        """No tracking context: BoW relocalization when the tracker has a
        vocabulary, then a match against the reference keyframe and the
        newest keyframes. Failing both, count the frame lost."""
        if self._try_relocalize(fr):
            return True
        if self.n_kf_host > 0:
            valid = self.m.kf_valid[:self.n_kf_host].cpu().numpy()
            kts = self.m.kf_ts[:self.n_kf_host].cpu().numpy()
            order = sorted((k for k in range(self.n_kf_host)
                            if valid[k] and k != self.ref_kf),
                           key=lambda k: -kts[k])
            # live IMU dead-reckoning seeds the pose optimization better than
            # the candidate keyframe's pose
            imu_seed = (self.calib is not None and self.imu_ready
                        and not self._vi_suspended
                        and self._pre_from_kf is not None)
            for k in ([self.ref_kf] + order[:3])[:4]:
                R0, t0 = (self.R_last, self.t_last) if imu_seed else \
                    (self.m.kf_R[k], self.m.kf_t[k])
                R, t, lm, n = track_reference_kf(self.m, fr, k, R0, t0,
                                                 self.cfg)
                if int(n) >= max(15, self.cfg.min_track_points):
                    self.R_last, self.t_last = R, t
                    self.last = fr
                    self.last_feat_lm = lm
                    self.ref_kf = k
                    self.has_vel = False
                    self.state = "OK"
                    self.frames_lost = 0
                    self._ref_matches = int(n)
                    self.frames_since_kf = self.cfg.min_kf_interval
                    if self.calib is not None:
                        self._vi_suspended = True
                    return True
        self.state = "RECENTLY_LOST"
        self.frames_lost += 1
        if self.frames_lost > 60:
            self.state = "LOST"
            self._drop_lost_map()
        return False

    # -- maps ---------------------------------------------------------------

    def _fresh_map_state(self):
        cfg = self.cfg
        dev = self.device
        self._gba_job = None          # a running global BA is meaningless
        self.m = ms.empty_map(cfg.max_kf, cfg.n_feat, cfg.max_lm, device=dev)
        self.db = None if self.voc is None else \
            kfdb.empty(cfg.max_kf, self.voc.n_words, device=dev)
        if self.calib is not None:
            # a fresh map restarts the IMU initialization; the bias and the
            # sample buffer carry over
            self.kf_imu = inertial_mod.empty_kf_imu(cfg.max_kf, device=dev)
            self.imu_ready = False
            self.viba_stage = 0
            self.ts_first_kf = None
            self.v_cur = torch.zeros(3, device=dev)
            self._pre_from_kf = None
            self._anchor_kf = None
            self._vi_suspended = False
            self._ts_lost_start = None
        self.state = "NOT_INITIALIZED"
        self.fr_init: Optional[FrameData] = None
        self.ts_init = 0.0
        self.last: Optional[FrameData] = None
        self.last_feat_lm = None
        self.R_last = torch.eye(3, device=dev)
        self.t_last = torch.zeros(3, device=dev)
        self.vel = (torch.eye(3, device=dev), torch.zeros(3, device=dev))
        self.has_vel = False
        self.ref_kf = 0
        self.n_kf_host = 0
        self.last_kf_id = -1
        self._free_kf_slots = []
        self._ref_matches = 0
        self.frames_since_kf = 0
        self.frames_lost = 0
        self._pending = []

    def _drop_lost_map(self):
        """After LOST or a timestamp jump: a young map is thrown away, a
        mature one stashed; localization mode keeps the map."""
        if not self._mapping_enabled:
            return
        if self.n_kf_host < 10:
            self.reset_active_map()
        else:
            self.create_map_in_atlas()

    def reset_active_map(self):
        """Throw the active map away and re-initialize."""
        self.trajectory = [e for e in self.trajectory if e[1] != self.map_gen]
        self._fresh_map_state()

    def create_map_in_atlas(self):
        """Stash the active map and start a fresh one."""
        self.stash.append(StashedMap(gen=self.map_gen, m=self.m,
                                     n_kf=self.n_kf_host, db=self.db,
                                     kf_imu=self.kf_imu))
        self.map_gen += 1
        self._fresh_map_state()

    def resolve_ref_pose(self, gen, ref):
        """World->camera pose of keyframe `ref` of map generation `gen`,
        following merge offsets into the map it was welded into; an
        unmerged stashed map resolves in its own gauge. None if gone."""
        while gen != self.map_gen:
            st = next((s for s in self.stash if s.gen == gen), None)
            if st is None:
                return None
            if st.merged_into_gen < 0:
                if ref >= st.m.kf_valid.shape[0]:
                    return None
                return st.m.kf_R[ref], st.m.kf_t[ref]
            ref += st.kf_offset
            gen = st.merged_into_gen
        if ref >= self.m.kf_valid.shape[0]:
            return None
        return self.m.kf_R[ref], self.m.kf_t[ref]

    def trajectory_world(self):
        """[(ts, camera centre (3,) numpy)], chaining each relative pose
        through its (possibly BA-updated) reference keyframe."""
        self.flush()
        out = []
        for ts, gen, ref, R_cr, t_cr in self.trajectory:
            resolved = self.resolve_ref_pose(gen, ref)
            if resolved is None:
                continue
            R_cw, t_cw = lie.se3_mul(R_cr, t_cr, *resolved)
            _, twc = lie.se3_inv(R_cw, t_cw)
            out.append((ts, twc.cpu().numpy()))
        return out
