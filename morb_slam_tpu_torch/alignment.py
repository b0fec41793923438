"""Closed-form point-set alignment: Umeyama similarity and the ATE metric
(counterpart of `morb_slam_tpu/alignment.py`)."""
from __future__ import annotations

import torch

from .lie import matmat, matvec


def umeyama(src, dst, weights=None, with_scale=True):
    """Least-squares similarity aligning src -> dst ((..., N, 3) each).

    Returns (s, R, t) with dst ~= s * R @ src + t."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True),
                              min=1e-12)
    mu_s = torch.sum(src * w[..., None], dim=-2)
    mu_d = torch.sum(dst * w[..., None], dim=-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = torch.einsum('...ni,...n,...nj->...ij', dc, w, sc)
    U, S, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(matmat(U, Vt))
    d = torch.ones_like(S)
    d[..., 2] = torch.sign(det)
    R = matmat(U, d[..., :, None] * Vt)
    var_s = torch.sum(w * torch.sum(sc * sc, dim=-1), dim=-1)
    if with_scale:
        s = torch.sum(S * d, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones_like(var_s)
    t = mu_d - s[..., None] * matvec(R, mu_s)
    return s, R, t


def ate_rmse(est, gt, with_scale=False, weights=None):
    """RMS absolute trajectory error after Umeyama alignment.

    Returns (rmse, s, R, t)."""
    s, R, t = umeyama(est, gt, weights=weights, with_scale=with_scale)
    aligned = s * matvec(R, est) + t
    err2 = torch.sum((aligned - gt) ** 2, dim=-1)
    if weights is not None:
        w = weights / torch.clamp(torch.sum(weights), min=1e-12)
        rmse = torch.sqrt(torch.sum(err2 * w))
    else:
        rmse = torch.sqrt(torch.mean(err2))
    return rmse, s, R, t
