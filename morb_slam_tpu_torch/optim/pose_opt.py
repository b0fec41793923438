"""Motion-only pose optimization: Gauss-Newton on one SE(3) pose with
Huber-weighted reprojection residuals and the reference's optimize-then-
reclassify outlier rounds (counterpart of `morb_slam_tpu/optim/pose_opt.py`;
K5 of the kernel table, plain PyTorch in this slice).

Pose convention: T_cw, residuals in normalized image coordinates,
information = focal^2 / sigma^2, left-composed updates T <- exp(dx) T.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from .. import lie
from . import linalg
from .robust import huber_weight

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor     # (N,) bool final chi2 classification
    n_inliers: torch.Tensor
    chi2: torch.Tensor


def _jacobian_se3(Xc):
    """d Xc / d dx = [I | -hat(Xc)], (N, 3, 6)."""
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(
        Xc.shape[:-1] + (3, 3))
    return torch.cat([eye, -lie.so3_hat(Xc)], dim=-1)


@record_function("K5 optimize_pose")
def optimize_pose(R0, t0, Xw, obs, info, valid, obs_ur=None, baseline=0.0,
                  n_rounds: int = 4, n_iters: int = 10):
    """Motion-only BA over world points Xw (N, 3) observed at normalized
    coords obs (N, 2) with information info (N,). Stereo rows (finite
    obs_ur) add the right-image residual."""
    if obs_ur is None:
        obs_ur = torch.full((obs.shape[0],), float("nan"), dtype=obs.dtype,
                            device=obs.device)
    is_stereo = torch.isfinite(obs_ur)
    st_f = is_stereo.to(obs.dtype)
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(obs.dtype)
    ur0 = torch.nan_to_num(obs_ur)
    eye6 = 1e-6 * torch.eye(6, dtype=obs.dtype, device=obs.device)

    def gn_step(R, t, active):
        Xc = lie.se3_apply(R, t, Xw)
        x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        iz = 1.0 / zs
        iz2 = iz * iz
        r2 = Xc[..., :2] / zs[..., None] - obs
        r_ur = torch.where(is_stereo, (x - baseline) / zs - ur0,
                           torch.zeros_like(z))
        zero = torch.zeros_like(z)
        J_pt = torch.stack([torch.stack([iz, zero, -x * iz2], dim=-1),
                            torch.stack([zero, iz, -y * iz2], dim=-1)],
                           dim=-2)                               # (N, 2, 3)
        J_se3 = _jacobian_se3(Xc)
        J2 = torch.einsum('nij,njk->nik', J_pt, J_se3)           # (N, 2, 6)
        Jr_pt = torch.stack([iz, zero, -(x - baseline) * iz2], dim=-1)
        Jr = torch.einsum('nj,njk->nk', Jr_pt, J_se3)            # (N, 6)
        chi2 = (torch.sum(r2 * r2, dim=-1) + r_ur * r_ur) * info
        w = info * huber_weight(chi2, chi2_th) * active
        w = torch.where(z > 0, w, torch.zeros_like(w))
        ws = w * st_f
        H = (torch.einsum('nia,n,nib->ab', J2, w, J2)
             + torch.einsum('na,n,nb->ab', Jr, ws, Jr)) + eye6
        g = (torch.einsum('nia,n,ni->a', J2, w, r2)
             + torch.einsum('na,n,n->a', Jr, ws, r_ur))
        dx = -linalg.solve_6x6(H, g)
        dR, dt = lie.se3_exp(dx)
        return lie.se3_mul(dR, dt, R, t), chi2

    R, t = R0, t0
    active = valid.to(obs.dtype)
    for _ in range(n_rounds):
        for _ in range(n_iters):
            (R, t), _ = gn_step(R, t, active)
        _, chi2 = gn_step(R, t, active)
        active = (valid & (chi2 < chi2_th)).to(obs.dtype)
    _, chi2 = gn_step(R, t, active)
    inl = valid & (chi2 < chi2_th)
    return PoseOptResult(R=R, t=t, inliers=inl, n_inliers=torch.sum(inl),
                         chi2=chi2)
