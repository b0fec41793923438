"""Lie groups SO(3) / SE(3) / Sim(3) as plain PyTorch functions.

Counterpart of `morb_slam_tpu/lie.py`: exp/log maps, composition, group
actions and the SO(3) Jacobians.

Conventions
-----------
* Rotations are (..., 3, 3) tensors; translations (..., 3); every function
  broadcasts over leading batch dims.
* SE(3) elements are (R, t) pairs; Sim(3) elements are (s, R, t).
* Tangent ordering: se3 = [rho(3), phi(3)]; sim3 = [rho(3), phi(3), sigma].
* Small 3x3 products are broadcast-multiply + sum, the same arithmetic as the
  reference package, so the two agree to float32 rounding.
"""
from __future__ import annotations

import math

import torch


def _eye(like, shape):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def _safe_norm(w):
    return torch.sqrt(torch.sum(w * w, dim=-1) + 1e-24)


def matvec(M, v):
    """(..., m, n) x (..., n) -> (..., m)."""
    return torch.sum(M * v[..., None, :], dim=-1)


def matmat(A, B):
    """(..., m, k) x (..., k, n) -> (..., m, n)."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def _hat_sq(w):
    outer = w[..., :, None] * w[..., None, :]
    n2 = torch.sum(w * w, dim=-1)[..., None, None]
    return outer - n2 * _eye(w, outer.shape)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def so3_vee(W):
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc(x):
    small = torch.abs(x) < 1e-4
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(xs) / xs)


def _cosc(x):
    small = torch.abs(x) < 1e-4
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 0.5 - x * x / 24.0,
                       (1.0 - torch.cos(xs)) / (xs * xs))


def _sinc3(x):
    small = torch.abs(x) < 1e-4
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 / 6.0 - x * x / 120.0,
                       (xs - torch.sin(xs)) / (xs ** 3))


def so3_exp(w):
    """(..., 3) -> (..., 3, 3) via Rodrigues."""
    theta = _safe_norm(w)
    W = so3_hat(w)
    W2 = _hat_sq(w)
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    return _eye(w, W.shape) + a * W + b * W2


def so3_log(R):
    """(..., 3, 3) -> (..., 3). Robust near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    w_generic = so3_vee(R - R.transpose(-1, -2)) * 0.5
    small = theta < 1e-4
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        theta / torch.sin(torch.where(small,
                                                      torch.ones_like(theta),
                                                      theta)))
    w_small = w_generic * scale[..., None]
    B = (R + R.transpose(-1, -2)) * 0.5
    one_minus = torch.clamp(1.0 - cos_theta, min=1e-8)[..., None]
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    a2 = torch.clamp((diag - cos_theta[..., None]) / one_minus, min=1e-12)
    a = torch.sqrt(a2)
    idx = torch.argmax(a2, dim=-1)
    off = torch.stack([
        torch.stack([diag[..., 0], B[..., 0, 1], B[..., 0, 2]], dim=-1),
        torch.stack([B[..., 0, 1], diag[..., 1], B[..., 1, 2]], dim=-1),
        torch.stack([B[..., 0, 2], B[..., 1, 2], diag[..., 2]], dim=-1),
    ], dim=-2)
    row = torch.gather(off, -2, idx[..., None, None].expand(
        *idx.shape, 1, 3))[..., 0, :]
    onehot = torch.arange(3, device=R.device) == idx[..., None]
    sign = torch.where(onehot, 1.0, torch.where(row < 0, -1.0, 1.0))
    a_signed = a * sign
    dot = torch.sum(a_signed * w_generic, dim=-1, keepdim=True)
    a_signed = torch.where(dot < 0, -a_signed, a_signed)
    w_pi = a_signed * theta[..., None]
    near_pi = (math.pi - theta) < 1e-3
    return torch.where(near_pi[..., None], w_pi, w_small)


def so3_left_jacobian(w):
    theta = _safe_norm(w)
    W = so3_hat(w)
    W2 = _hat_sq(w)
    b = _cosc(theta)[..., None, None]
    c = _sinc3(theta)[..., None, None]
    return _eye(w, W.shape) + b * W + c * W2


def so3_right_jacobian(w):
    return so3_left_jacobian(-w)


def so3_right_jacobian_inv(w):
    theta = _safe_norm(w)
    W = so3_hat(w)
    W2 = _hat_sq(w)
    small = theta < 1e-4
    ts = torch.where(small, torch.ones_like(theta), theta)
    coef = torch.where(
        small, 1.0 / 12.0 + theta * theta / 720.0,
        (1.0 / (ts * ts)) - (1.0 + torch.cos(ts)) / (2.0 * ts * torch.sin(ts)),
    )[..., None, None]
    return _eye(w, W.shape) + 0.5 * W + coef * W2


def so3_left_jacobian_inv(w):
    return so3_right_jacobian_inv(-w)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_exp(xi):
    """(..., 6) [rho, phi] -> (R (..., 3, 3), t (..., 3))."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return so3_exp(phi), matvec(so3_left_jacobian(phi), rho)


def se3_log(R, t):
    phi = so3_log(R)
    rho = matvec(so3_left_jacobian_inv(phi), t)
    return torch.cat([rho, phi], dim=-1)


def se3_inv(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -matvec(Rt, t)


def se3_mul(Ra, ta, Rb, tb):
    return matmat(Ra, Rb), matvec(Ra, tb) + ta


def se3_apply(R, t, p):
    return matvec(R, p) + t


def se3_matrix(R, t):
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)),
                     t.expand(batch + (3,))[..., None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def _sim3_W(theta, sigma, phi):
    Phi = so3_hat(phi)
    Phi2 = _hat_sq(phi)
    s = torch.exp(sigma)
    small_sig = torch.abs(sigma) < 1e-5
    small_th = theta < 1e-5
    sig_safe = torch.where(small_sig, torch.ones_like(sigma), sigma)
    th_safe = torch.where(small_th, torch.ones_like(theta), theta)
    C = torch.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / sig_safe)
    a = s * torch.sin(th_safe)
    b = s * torch.cos(th_safe)
    th2 = th_safe * th_safe
    sig2 = sig_safe * sig_safe
    denom = torch.where(small_sig | small_th, torch.ones_like(sigma),
                        sig2 + th2)
    A_gen = (a * sig_safe + (1.0 - b) * th_safe) / (th_safe * denom)
    B_gen = (C - ((b - 1.0) * sig_safe + a * th_safe) / denom) / th2
    A_sig0 = _cosc(theta)
    B_sig0 = _sinc3(theta)
    A_th0 = torch.where(small_sig, 0.5 + sigma / 6.0,
                        ((sig_safe - 1.0) * s + 1.0) / sig2)
    B_th0 = torch.where(small_sig, 1.0 / 6.0 + sigma / 24.0,
                        (s * 0.5 * sig2 + s - 1.0 - sig_safe * s)
                        / (sig2 * sig_safe))
    A = torch.where(small_th, A_th0, torch.where(small_sig, A_sig0, A_gen))
    B = torch.where(small_th, B_th0, torch.where(small_sig, B_sig0, B_gen))
    return (C[..., None, None] * _eye(phi, Phi.shape)
            + A[..., None, None] * Phi + B[..., None, None] * Phi2)


def sim3_exp(xi):
    """(..., 7) [rho, phi, sigma] -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = _sim3_W(_safe_norm(phi), sigma, phi)
    return torch.exp(sigma), so3_exp(phi), matvec(W, rho)


def sim3_log(s, R, t):
    sigma = torch.log(s)
    phi = so3_log(R)
    W = _sim3_W(_safe_norm(phi), sigma, phi)
    rho = torch.linalg.solve(W, t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_inv(s, R, t):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * matvec(Rt, t)


def sim3_mul(sa, Ra, ta, sb, Rb, tb):
    return sa * sb, matmat(Ra, Rb), sa[..., None] * matvec(Ra, tb) + ta


def sim3_apply(s, R, t, p):
    return s[..., None] * matvec(R, p) + t


# ---------------------------------------------------------------------------
# Quaternions (IO / trajectory formats; Hamilton convention, [x, y, z, w])
# ---------------------------------------------------------------------------

def quat_to_rotmat(q):
    """(..., 4) [x, y, z, w] quaternion -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def rotmat_to_quat(R):
    """(..., 3, 3) -> (..., 4) [x, y, z, w] with w >= 0, from the largest
    of the four Shepperd pivots."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)
    pivots = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                          1 - m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        *idx.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    q = torch.stack([q[..., 1], q[..., 2], q[..., 3], q[..., 0]], dim=-1)
    return torch.where(q[..., 3:4] < 0, -q, q)
