"""Monocular two-view initialization: parallel-hypothesis E / H RANSAC with
model selection and motion reconstruction (counterpart of
`morb_slam_tpu/solvers/two_view.py`).

Both models are fitted from the same kind of 8-point samples, scored with
the symmetric transfer error, refit on their inliers, and the winner
(H when its score share exceeds 0.4) is decomposed and cheirality-checked,
all candidates at once. The RANSAC sample tables are an argument: drawn
from a `torch.Generator` by default, or given (a parity test passes the
reference package's draw).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import lie
from . import ransac, triangulation

CHI2_EPI = 3.841
CHI2_H = 5.991
SCORE_TH = 5.991


class TwoViewResult(NamedTuple):
    R21: torch.Tensor
    t21: torch.Tensor
    points: torch.Tensor      # (N, 3) in camera 1
    is_good: torch.Tensor     # (N,) bool
    n_good: torch.Tensor
    parallax_deg: torch.Tensor
    used_h: torch.Tensor


def _hartley(x, w):
    """Weighted Hartley normalization over the point axis of x (..., n, 2):
    (x_norm, T (..., 3, 3))."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    mu = torch.sum(x * w[..., None], dim=-2) / wsum[..., None]
    d = x - mu[..., None, :]
    mean_norm = torch.sum(torch.linalg.norm(d, dim=-1) * w, dim=-1) / wsum
    s = math.sqrt(2.0) / torch.clamp(mean_norm, min=1e-9)
    z = torch.zeros_like(s)
    T = torch.stack([torch.stack([s, z, -s * mu[..., 0]], -1),
                     torch.stack([z, s, -s * mu[..., 1]], -1),
                     torch.stack([z, z, torch.ones_like(s)], -1)], -2)
    return d * s[..., None, None], T


def _null_vector(A):
    """Right singular vector of the smallest singular value, (..., 9)."""
    _, _, Vt = torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1])
    return Vt[..., -1, :]


def _fit_essential(x1, x2, w=None):
    """(..., k, 2) normalized correspondences -> (..., 3, 3) essential."""
    if w is None:
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    n1, T1 = _hartley(x1, w)
    n2, T2 = _hartley(x2, w)
    u1, v1 = n1[..., 0], n1[..., 1]
    u2, v2 = n2[..., 0], n2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1) * w[..., None]
    En = _null_vector(A).reshape(A.shape[:-2] + (3, 3))
    E0 = lie.matmat(T2.transpose(-1, -2), lie.matmat(En, T1))
    U, _, Vt = torch.linalg.svd(E0)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=E0.dtype, device=E0.device)
    return lie.matmat(U, d[:, None] * Vt)


def _fit_homography(x1, x2, w=None):
    """(..., k, 2) correspondences -> (..., 3, 3) homography x2 ~ H x1."""
    if w is None:
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    n1, T1 = _hartley(x1, w)
    n2, T2 = _hartley(x2, w)
    u1, v1 = n1[..., 0], n1[..., 1]
    u2, v2 = n2[..., 0], n2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    A = torch.cat([r1, r2], dim=-2) * torch.cat([w, w], dim=-1)[..., None]
    Hn = _null_vector(A).reshape(A.shape[:-2] + (3, 3))
    return lie.matmat(torch.linalg.inv_ex(T2).inverse, lie.matmat(Hn, T1))


def _apply(M, xh):
    """(..., 3, 3) x (N, 3) -> (..., N, 3)."""
    return torch.sum(M[..., None, :, :] * xh[:, None, :], dim=-1)


def _score_essential(E, x1h, x2h, valid, inv_sigma2):
    Ex1 = _apply(E, x1h)
    Etx2 = _apply(E.transpose(-1, -2), x2h)
    x2Ex1 = torch.sum(x2h * Ex1, dim=-1)
    d2_2 = x2Ex1 ** 2 / torch.clamp(Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2,
                                    min=1e-12)
    d2_1 = x2Ex1 ** 2 / torch.clamp(Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2,
                                    min=1e-12)
    chi1 = d2_1 * inv_sigma2
    chi2 = d2_2 * inv_sigma2
    inl = (chi1 < CHI2_EPI) & (chi2 < CHI2_EPI) & valid
    zero = torch.zeros_like(chi1)
    sc = (torch.where(chi1 < CHI2_EPI, SCORE_TH - chi1, zero)
          + torch.where(chi2 < CHI2_EPI, SCORE_TH - chi2, zero))
    return torch.sum(sc * valid, dim=-1), inl


def _score_homography(H, x1h, x2h, valid, inv_sigma2):
    Hinv = torch.linalg.inv_ex(H).inverse

    def transfer(M, a, b):
        p = _apply(M, a)
        w = torch.where(torch.abs(p[..., 2:3]) < 1e-12,
                        torch.full_like(p[..., 2:3], 1e-12), p[..., 2:3])
        e = p[..., :2] / w - b[:, :2]
        return torch.sum(e * e, dim=-1)

    chi_12 = transfer(H, x1h, x2h) * inv_sigma2
    chi_21 = transfer(Hinv, x2h, x1h) * inv_sigma2
    inl = (chi_12 < CHI2_H) & (chi_21 < CHI2_H) & valid
    zero = torch.zeros_like(chi_12)
    sc = (torch.where(chi_12 < CHI2_H, SCORE_TH - chi_12, zero)
          + torch.where(chi_21 < CHI2_H, SCORE_TH - chi_21, zero))
    return torch.sum(sc * valid, dim=-1), inl


def _decompose_essential(E):
    """E -> 4 candidate (R, t)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    Wm = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                      dtype=E.dtype, device=E.device)
    R1 = lie.matmat(lie.matmat(U, Wm), Vt)
    R2 = lie.matmat(lie.matmat(U, Wm.T), Vt)
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_homography(H):
    """Faugeras SVD decomposition -> 8 candidate (R, t)."""
    U, d, Vt = torch.linalg.svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    d2s = torch.where(torch.abs(d2) < 1e-12, torch.full_like(d2, 1e-12), d2)
    eps = torch.tensor([(1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)],
                       dtype=H.dtype, device=H.device)
    e1, e3 = eps[:, 0], eps[:, 1]
    zero, one = torch.zeros_like(e1), torch.ones_like(e1)
    st = (d1 - d3) * x1 * x3 * e1 * e3 / d2s
    ct = (d1 * x3 * x3 + d3 * x1 * x1) / d2s * one
    Rp_pos = torch.stack([torch.stack([ct, zero, -st], -1),
                          torch.stack([zero, one, zero], -1),
                          torch.stack([st, zero, ct], -1)], -2)
    tp_pos = torch.stack([e1 * x1, zero, -e3 * x3], -1) * (d1 - d3)
    sp = (d1 + d3) * x1 * x3 * e1 * e3 / d2s
    cp = (d3 * x1 * x1 - d1 * x3 * x3) / d2s * one
    Rp_neg = torch.stack([torch.stack([cp, zero, sp], -1),
                          torch.stack([zero, -one, zero], -1),
                          torch.stack([sp, zero, -cp], -1)], -2)
    tp_neg = torch.stack([e1 * x1, zero, e3 * x3], -1) * (d1 + d3)
    Rp = torch.cat([Rp_pos, Rp_neg])
    tp = torch.cat([tp_pos, tp_neg])
    R = s * lie.matmat(lie.matmat(U.expand(8, 3, 3), Rp), Vt.expand(8, 3, 3))
    t = lie.matvec(U.expand(8, 3, 3), tp)
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    return R, t


def _check_motion(Rs, ts, x1, x2, inliers, th2):
    """Triangulate under each candidate (C, 3, 3) / (C, 3) and count good
    points; parallax is the median cosine over good points."""
    C, N = Rs.shape[0], x1.shape[0]
    x1b = x1.expand(C, N, 2)
    x2b = x2.expand(C, N, 2)
    Rb = Rs[:, None].expand(C, N, 3, 3)
    tb = ts[:, None].expand(C, N, 3)
    X = triangulation.triangulate_two_view(x1b, x2b, Rb, tb)
    good, cosp = triangulation.depth_and_reproj_checks(X, x1b, x2b, Rb, tb,
                                                       th2)
    good = good & inliers
    n_good = torch.sum(good, dim=-1)
    cos_sorted = torch.sort(torch.where(good, cosp,
                                        torch.full_like(cosp, math.inf)),
                            dim=-1)[0]
    mid = torch.clamp(n_good // 2, 0, N - 1)
    cos_med = torch.gather(cos_sorted, 1, mid[:, None])[:, 0]
    cos_med = torch.where(n_good > 0, cos_med, torch.ones_like(cos_med))
    par = torch.rad2deg(torch.arccos(torch.clamp(cos_med, -1.0, 1.0)))
    return X, good, n_good, par


def reconstruct_two_view(x1, x2, valid, focal: float, samples=None,
                         generator=None, sigma_px: float = 1.0,
                         n_hyp: int = 200):
    """Monocular initialization from matched normalized coords x1, x2
    (N, 2). samples: optional (idx_E, idx_H), each (n_hyp, 8) indices into
    the matches; drawn from `generator` when absent."""
    if samples is None:
        samples = (ransac.sample_indices(generator, n_hyp, 8, valid),
                   ransac.sample_indices(generator, n_hyp, 8, valid))
    idx_E, idx_H = (s.to(x1.device).long() for s in samples)
    inv_sigma2 = (focal / sigma_px) ** 2
    x1h = torch.cat([x1, torch.ones_like(x1[:, :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[:, :1])], dim=-1)

    E, sE, inlE, _ = ransac.run(
        idx_E, lambda i: _fit_essential(x1[i], x2[i]),
        lambda E: _score_essential(E, x1h, x2h, valid, inv_sigma2))
    H, sH, inlH, _ = ransac.run(
        idx_H, lambda i: _fit_homography(x1[i], x2[i]),
        lambda H: _score_homography(H, x1h, x2h, valid, inv_sigma2))
    for _ in range(2):
        E = _fit_essential(x1, x2, w=inlE.to(x1.dtype))
        H = _fit_homography(x1, x2, w=inlH.to(x1.dtype))
        _, inlE = _score_essential(E, x1h, x2h, valid, inv_sigma2)
        _, inlH = _score_homography(H, x1h, x2h, valid, inv_sigma2)

    use_h = sH / torch.clamp(sH + sE, min=1e-9) > 0.40
    th2 = 4.0 * sigma_px ** 2 / focal ** 2
    RsE, tsE = _decompose_essential(E)
    RsH, tsH = _decompose_homography(H)
    Rs = torch.cat([RsE, RsH])
    ts = torch.cat([tsE, tsH])
    inl = torch.where(use_h, inlH, inlE)
    is_h = torch.tensor([False] * 4 + [True] * 8, device=x1.device)
    cand_mask = is_h == use_h
    X_all, good_all, n_all, par_all = _check_motion(Rs, ts, x1, x2, inl, th2)
    n_all = torch.where(cand_mask, n_all, torch.full_like(n_all, -1))
    best = torch.argmax(n_all)
    return TwoViewResult(R21=Rs[best], t21=ts[best], points=X_all[best],
                         is_good=good_all[best], n_good=n_all[best],
                         parallax_deg=par_all[best], used_h=use_h)
