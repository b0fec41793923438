"""Multi-map Atlas: stashed maps and the Sim(3) weld of a stashed map into
the active one (counterpart of `morb_slam_tpu/mapstate/atlas.py`).

When tracking is lost in a mature map the tracker stashes it (StashedMap,
with its place-recognition database and preintegration store) and starts a
fresh map. When place recognition later finds the stashed map again,
`merge_maps` transforms it through the welding Sim(3) and appends its
keyframes and landmarks to the active map's free capacity, the old ids
shifted by the active map's counts, so the active map's own ids (and the
tracker's references into it) stay as they were.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import lie
from . import state as ms


@dataclass
class StashedMap:
    """An inactive map: its generation, map, keyframe count, database
    (None without a vocabulary) and KfImu store (None without an IMU); once
    welded into a later map, that map's generation and the keyframe id
    offset the weld applied."""
    gen: int
    m: ms.MapState
    n_kf: int
    db: Optional[object] = None
    kf_imu: Optional[object] = None
    merged_into_gen: int = -1
    kf_offset: int = 0


def sim3_from_cam_pair(s_c, R_c, t_c, R_kf_new, t_kf_new, R_kf_old,
                       t_kf_old):
    """The world-level welding Sim(3) S_wn_wo = T_cw_new^-1 S_c T_cw_old
    from a camera-level match (s_c, R_c, t_c) that maps the old candidate
    keyframe's camera points into the new keyframe's camera."""
    one = torch.ones_like(s_c)
    a = lie.sim3_mul(s_c, R_c, t_c, one, R_kf_old, t_kf_old)
    Ri, ti = lie.se3_inv(R_kf_new, t_kf_new)
    return lie.sim3_mul(one, Ri, ti, *a)


def transform_map(m: ms.MapState, s, R, t) -> ms.MapState:
    """Apply a world-frame Sim(3) to every keyframe pose (T_cw S^-1, back to
    SE(3)), landmark (S X) and velocity (s R v)."""
    si, Ri, ti = lie.sim3_inv(s, R, t)
    Rn = lie.matmat(m.kf_R, Ri.expand(m.kf_R.shape))
    tn = (lie.matvec(m.kf_R, ti.expand(m.kf_t.shape)) + m.kf_t) / si
    X = lie.sim3_apply(s, R, t, m.lm_pos)
    v = s * lie.matvec(R.expand(m.kf_v.shape[0], 3, 3), m.kf_v)
    return m._replace(kf_R=Rn, kf_t=tn, lm_pos=X, kf_v=v)


def merge_maps(m_act: ms.MapState, m_old: ms.MapState, s, R, t):
    """Weld m_old, moved by the world Sim(3) (s, R, t) (old world -> active
    world), into m_act's free capacity: old keyframe k lands at slot
    n_kf_act + k, old landmark l at n_lm_act + l. Returns (merged map,
    kf_offset, lm_offset) (offsets as 0-dim tensors). The caller checks the
    capacity."""
    K = m_act.kf_valid.shape[0]
    L = m_act.lm_valid.shape[0]
    dev = m_act.kf_t.device
    mo = transform_map(m_old, s, R, t)
    kf_off, lm_off = m_act.n_kf, m_act.n_lm
    kf_ids = torch.arange(K, device=dev)
    lm_ids = torch.arange(L, device=dev)
    take_kf = (kf_ids >= kf_off) & (kf_ids < kf_off + mo.n_kf)
    take_lm = (lm_ids >= lm_off) & (lm_ids < lm_off + mo.n_lm)
    src_kf = torch.clamp(kf_ids - kf_off, 0, K - 1)
    src_lm = torch.clamp(lm_ids - lm_off, 0, L - 1)

    def kf_field(dst, src):
        return torch.where(take_kf.reshape((K,) + (1,) * (dst.dim() - 1)),
                           src[src_kf], dst)

    def lm_field(dst, src):
        return torch.where(take_lm.reshape((L,) + (1,) * (dst.dim() - 1)),
                           src[src_lm], dst)

    def shifted(ids, off):
        return torch.where(ids >= 0, ids + off.to(ids.dtype),
                           torch.full_like(ids, -1))

    new_kf = dict(kf_feat_lm=shifted(mo.kf_feat_lm, lm_off),
                  kf_prev=shifted(mo.kf_prev, kf_off))
    kf_names = [f for f in ms.MapState._fields if f.startswith("kf_")]
    lm_names = [f for f in ms.MapState._fields if f.startswith("lm_")]
    merged = m_act._replace(
        **{f: kf_field(getattr(m_act, f), new_kf.get(f, getattr(mo, f)))
           for f in kf_names},
        **{f: lm_field(getattr(m_act, f), getattr(mo, f))
           for f in lm_names if f != "lm_ref_kf"},
        lm_ref_kf=lm_field(m_act.lm_ref_kf, shifted(mo.lm_ref_kf, kf_off)),
        n_kf=m_act.n_kf + mo.n_kf, n_lm=m_act.n_lm + mo.n_lm)
    return merged, kf_off, lm_off
