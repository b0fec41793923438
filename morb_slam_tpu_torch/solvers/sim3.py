"""Batched RANSAC Sim(3) between two matched 3D point sets (counterpart of
`morb_slam_tpu/solvers/sim3.py`).

Horn's closed form (Umeyama) on 3-point samples, scored by the two-sided
reprojection error in both cameras, every hypothesis at once. `fix_scale`
holds s = 1 (stereo / RGB-D and IMU-initialized maps). The sample table is
an argument, drawn by `ransac.sample_indices` from a `torch.Generator` when
absent.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import alignment, lie
from . import ransac


class Sim3Result(NamedTuple):
    s: torch.Tensor
    R: torch.Tensor         # maps points of KF2's frame into KF1's
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _reproj_err(Xc, obs):
    z = Xc[..., 2]
    z = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    e = Xc[..., :2] / z[..., None] - obs
    return torch.sum(e * e, dim=-1)


def solve_sim3(X1, X2, x1, x2, valid, focal: float, fix_scale: bool,
               th2_px: float = 9.21, n_hyp: int = 128, samples=None,
               generator=None) -> Sim3Result:
    """Estimate (s, R, t) with X1 ~ s R X2 + t from X1, X2 (N, 3) matched
    points in the two keyframes' camera frames, x1, x2 (N, 2) their
    normalized observations, valid (N,) bool. th2_px is the chi2 gate in
    pixels^2 at `focal`. samples: an (n_hyp, 3) index table, drawn from
    `generator` when absent."""
    th2 = th2_px / focal ** 2
    if samples is None:
        samples = ransac.sample_indices(generator, n_hyp, 3, valid)
    idx = samples.to(X1.device).long()

    def fit(i):
        s, R, t = alignment.umeyama(X2[i], X1[i], with_scale=not fix_scale)
        return torch.cat([s[:, None], R.reshape(-1, 9), t], dim=-1)

    def unpack(m):
        return m[..., 0], m[..., 1:10].reshape(m.shape[:-1] + (3, 3)), \
            m[..., 10:13]

    def score(models):
        s, R, t = unpack(models)
        X2in1 = lie.sim3_apply(s[:, None], R[:, None], t[:, None], X2[None])
        si, Ri, ti = lie.sim3_inv(s, R, t)
        X1in2 = lie.sim3_apply(si[:, None], Ri[:, None], ti[:, None],
                               X1[None])
        inl = (_reproj_err(X2in1, x1[None]) < th2) & \
            (_reproj_err(X1in2, x2[None]) < th2) & valid[None]
        return torch.sum(inl, dim=-1), inl

    model, n_inl, inl, _ = ransac.run(idx, fit, score)
    s, R, t = unpack(model)
    if fix_scale:
        s = torch.ones_like(s)
    return Sim3Result(s=s, R=R, t=t, inliers=inl, n_inliers=n_inl)
