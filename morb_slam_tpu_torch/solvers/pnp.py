"""Batched RANSAC PnP: camera pose from 3D-2D correspondences (counterpart
of `morb_slam_tpu/solvers/pnp.py`).

Each hypothesis fits an 8-point DLT projection matrix whose rotation block
is re-orthonormalized (Procrustes) and is scored by its reprojection
inliers; the best one is refit twice on all its inliers. The sample table
is an argument, drawn by `ransac.sample_indices` from a `torch.Generator`
when absent.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import lie
from . import ransac


class PnPResult(NamedTuple):
    R: torch.Tensor         # (3, 3) world -> camera
    t: torch.Tensor         # (3,)
    inliers: torch.Tensor   # (N,) bool
    n_inliers: torch.Tensor


def _normalize_3d(X, w):
    """Weighted centring and isotropic scaling of world points X (..., k, 3)
    with weights w (..., k): (X_norm, S (..., 4, 4)), X_norm_h = S X_h."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    mu = torch.sum(X * w[..., None], dim=-2) / wsum[..., None]
    d = X - mu[..., None, :]
    mean_norm = torch.sum(torch.linalg.norm(d, dim=-1) * w, dim=-1) / wsum
    s = math.sqrt(3.0) / torch.clamp(mean_norm, min=1e-9)
    S = torch.eye(4, dtype=X.dtype, device=X.device) * s[..., None, None]
    S[..., 3, 3] = 1.0
    S[..., :3, 3] = -s[..., None] * mu
    return d * s[..., None, None], S


def _det3(M):
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _fit_dlt(X, x, w=None):
    """(R, t) from X (..., k, 3) world points and x (..., k, 2) normalized
    observations, k >= 6, batched over the leading dims; optional weights
    w (..., k) for the masked all-inlier refit."""
    k = X.shape[-2]
    if w is None:
        w = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    Xn, S = _normalize_3d(X, w)
    zeros = torch.zeros(X.shape[:-1] + (4,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([Xn, torch.ones_like(Xn[..., :1])], dim=-1)
    r1 = torch.cat([Xh, zeros, -x[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -x[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                       # (..., 2k, 12)
    A = A * torch.cat([w, w], dim=-1)[..., None]
    # only the right singular vector of the least singular value is read:
    # the reduced factorization has it (2k >= 12)
    Vt = torch.linalg.svd(A, full_matrices=False)[2]
    P = lie.matmat(Vt[..., -1, :].reshape(Vt.shape[:-2] + (3, 4)), S)
    M = P[..., :3]
    # sign: the points must lie in front of the camera
    depths = lie.matvec(M[..., None, :, :], X) + P[..., None, :, 3]
    sgn = torch.sign(torch.sum(torch.sign(depths[..., 2]), dim=-1))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    P = P * sgn[..., None, None]
    M = P[..., :3]
    # Procrustes: the rotation nearest to M, its scale recovered for t
    U, Sv, Vt = torch.linalg.svd(M)
    det = _det3(lie.matmat(U, Vt))
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = lie.matmat(U, d[..., :, None] * Vt)
    scale = torch.sum(Sv * d, dim=-1) / 3.0
    t = P[..., 3] / torch.where(torch.abs(scale) < 1e-12,
                                torch.full_like(scale, 1e-12), scale)[..., None]
    return R, t


def _score(R, t, X, x, valid, th2):
    """Inlier counts (...,) and masks (..., N) of poses R (..., 3, 3), t
    (..., 3) on the correspondences X (N, 3), x (N, 2)."""
    Xc = lie.matvec(R[..., None, :, :], X) + t[..., None, :]
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    e = Xc[..., :2] / zs[..., None] - x
    err2 = torch.sum(e * e, dim=-1)
    inl = (err2 < th2) & (z > 0) & valid
    return torch.sum(inl, dim=-1), inl


def solve_pnp(X, x, valid, focal: float, samples=None, generator=None,
              sigma_px: float = 1.0, n_hyp: int = 256,
              chi2_th: float = 5.991) -> PnPResult:
    """RANSAC PnP over fixed-capacity correspondences: X (N, 3) world
    points, x (N, 2) normalized image coordinates, valid (N,) bool, focal
    the focal length in pixels for the threshold. samples: an (n_hyp, 8)
    index table, drawn from `generator` when absent."""
    th2 = chi2_th * sigma_px ** 2 / focal ** 2
    if samples is None:
        samples = ransac.sample_indices(generator, n_hyp, 8, valid)
    idx = samples.to(X.device).long()

    def fit(i):
        R, t = _fit_dlt(X[i], x[i])
        return torch.cat([R, t[..., None]], dim=-1)       # (n_hyp, 3, 4)

    def score(Rt):
        return _score(Rt[..., :3], Rt[..., 3], X, x, valid, th2)

    # 8-point samples: a minimal 6-point DLT amplifies pixel noise too much
    model, _, inl, _ = ransac.run(idx, fit, score)
    R, t = model[:, :3], model[:, 3]
    # all-inlier refit, two rounds (recovers the inliers that a noisy
    # minimal-sample model misses)
    for _ in range(2):
        R, t = _fit_dlt(X, x, w=inl.to(X.dtype))
        n_inl, inl = _score(R, t, X, x, valid, th2)
    return PnPResult(R=R, t=t, inliers=inl, n_inliers=n_inl)
