"""Batched two-view DLT triangulation (counterpart of
`morb_slam_tpu/solvers/triangulation.py`): the homogeneous 4x4 solution by
three steps of inverse iteration with a Schur-complement solve, plus the
cheirality / reprojection / parallax gates."""
from __future__ import annotations

import torch

from .. import lie
from ..optim import linalg


def projection_matrix(R, t):
    return torch.cat([R, t[..., None]], dim=-1)


def triangulate(x1, x2, P1, P2):
    """Normalized points x1, x2 (..., 2) and projections P1, P2 (..., 3, 4)
    -> world points (..., 3)."""
    rows = [
        x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(rows, dim=-2)
    AtA = torch.einsum('...ij,...ik->...jk', A, A)
    B = AtA[..., :3, :3]
    c = AtA[..., :3, 3]
    d = AtA[..., 3, 3]
    eps = 1e-9 * (1.0 + torch.einsum('...ii->...', AtA))
    Binv = linalg.inv3x3(B + eps[..., None, None]
                         * torch.eye(3, dtype=A.dtype, device=A.device))
    k = torch.einsum('...ab,...b->...a', Binv, c)
    s = d + eps - torch.einsum('...a,...a->...', c, k)
    s = torch.where(torch.abs(s) < 1e-20, torch.full_like(s, 1e-20), s)

    def solve4(x_a, x_w):
        Bx = torch.einsum('...ab,...b->...a', Binv, x_a)
        y_w = (x_w - torch.einsum('...a,...a->...', c, Bx)) / s
        return Bx - k * y_w[..., None], y_w

    x_a, x_w = -k, torch.ones_like(d)
    for _ in range(3):
        n = torch.sqrt(torch.sum(x_a * x_a, dim=-1) + x_w * x_w)
        n = torch.where(n < 1e-20, torch.full_like(n, 1e-20), n)
        x_a, x_w = solve4(x_a / n[..., None], x_w / n)
    w_safe = torch.where(torch.abs(x_w) < 1e-12,
                         torch.where(x_w < 0, torch.full_like(x_w, -1e-12),
                                     torch.full_like(x_w, 1e-12)), x_w)
    return x_a / w_safe[..., None]


def triangulate_two_view(x1, x2, R21, t21):
    """Camera 1 at identity, camera 2 at (R21, t21); points in camera 1."""
    batch = x1.shape[:-1]
    eye = torch.eye(3, dtype=x1.dtype, device=x1.device).expand(batch + (3, 3))
    zero = torch.zeros(batch + (3,), dtype=x1.dtype, device=x1.device)
    P1 = projection_matrix(eye, zero)
    P2 = projection_matrix(R21.expand(batch + (3, 3)), t21.expand(batch + (3,)))
    return triangulate(x1, x2, P1, P2)


def depth_and_reproj_checks(X, x1, x2, R21, t21, th2: float):
    """(good (...,) bool, parallax cosine (...,)) of points X in camera 1."""
    def nz(z):
        return torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    z1 = X[..., 2]
    X2 = lie.matvec(R21, X) + t21
    z2 = X2[..., 2]
    e1 = X[..., :2] / nz(z1[..., None]) - x1
    e2 = X2[..., :2] / nz(z2[..., None]) - x2
    r1 = torch.sum(e1 * e1, dim=-1)
    r2 = torch.sum(e2 * e2, dim=-1)
    c2 = -lie.matvec(R21.transpose(-1, -2), t21)
    ray2 = X - c2
    cosp = torch.sum(X * ray2, dim=-1) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(ray2, dim=-1),
        min=1e-12)
    good = (z1 > 0) & (z2 > 0) & (r1 < th2) & (r2 < th2)
    return good, cosp
