"""Dense small-system linear algebra: Cholesky SPD solve and closed-form
3x3 / 6x6 inverses (counterpart of `morb_slam_tpu/optim/linalg.py`)."""
from __future__ import annotations

import torch


def solve_spd(A, b, jitter: float = 0.0):
    """Solve A x = b for symmetric positive-definite A ((..., N, N) and
    (..., N) or (..., N, K))."""
    if jitter:
        A = A + jitter * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    # cholesky_ex: no host synchronisation on the card (the checked form
    # reads the factorization status back)
    L = torch.linalg.cholesky_ex(A).L
    vec = b.dim() == A.dim() - 1
    x = torch.cholesky_solve(b[..., None] if vec else b, L)
    return x[..., 0] if vec else x


def inv3x3(M):
    """Closed-form batched 3x3 inverse via the adjugate."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack([torch.stack([A, B, C], -1),
                       torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return adj / det[..., None, None]


def _mm(a, b):
    return torch.einsum('...ij,...jk->...ik', a, b)


def inv6x6(M):
    """Batched 6x6 inverse via blockwise 3x3 Schur complements."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    C = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ai = inv3x3(A)
    Si = inv3x3(D - _mm(C, _mm(Ai, B)))
    AiB = _mm(Ai, B)
    CAi = _mm(C, Ai)
    top = torch.cat([Ai + _mm(AiB, _mm(Si, CAi)), -_mm(AiB, Si)], dim=-1)
    bot = torch.cat([-_mm(Si, CAi), Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def solve_6x6(H, g):
    """x = H^-1 g for 6x6 SPD blocks via the closed-form inverse."""
    return torch.einsum('...ab,...b->...a', inv6x6(H), g)
