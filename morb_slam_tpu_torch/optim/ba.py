"""Bundle adjustment: Huber-robust Levenberg-Marquardt with a dense Schur
complement over the window's poses (counterpart of
`morb_slam_tpu/optim/ba.py:ba_solve` and `classify_outliers`; K4 of the
kernel table, plain PyTorch in this slice).

The reference lays observations out landmark-major and O-minor for the
TPU's tiling; the port keeps the same arithmetic in PyTorch's natural
(O, ...) layout: per-observation Jacobians, one index_add per block type
over the joint (landmark, keyframe) index, closed-form 3x3 inverses, a
dense (6K, 6K) Schur system solved by Cholesky, and the same accept /
reject schedule. Pose convention: T_cw, T <- exp(dx) T; X <- X + dx.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from .. import lie
from . import linalg
from .robust import huber_weight

HUBER2_MONO = 5.991
HUBER2_STEREO = 7.815


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem: poses R (K, 3, 3), t (K, 3); points X
    (L, 3); observations obs_kf, obs_lm (O,), obs_uv (O, 2) normalized,
    obs_ur (O,) right-u or NaN, obs_info (O,), obs_mask (O,); kf_opt (K,),
    lm_opt (L,) bool; baseline ()."""
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    obs_kf: torch.Tensor
    obs_lm: torch.Tensor
    obs_uv: torch.Tensor
    obs_ur: torch.Tensor
    obs_info: torch.Tensor
    obs_mask: torch.Tensor
    kf_opt: torch.Tensor
    lm_opt: torch.Tensor
    baseline: torch.Tensor


def make_problem(R, t, X, obs_kf, obs_lm, obs_uv, obs_info, obs_mask,
                 kf_opt, lm_opt, obs_ur=None, baseline=0.0) -> BAProblem:
    O = obs_uv.shape[0]
    if obs_ur is None:
        obs_ur = torch.full((O,), float("nan"), dtype=obs_uv.dtype,
                            device=obs_uv.device)
    return BAProblem(R=R, t=t, X=X, obs_kf=obs_kf, obs_lm=obs_lm,
                     obs_uv=obs_uv, obs_ur=obs_ur, obs_info=obs_info,
                     obs_mask=obs_mask, kf_opt=kf_opt, lm_opt=lm_opt,
                     baseline=torch.as_tensor(baseline, dtype=obs_uv.dtype,
                                              device=obs_uv.device))


def _obs_terms(p: BAProblem, R, t, X, robust: bool = True):
    """Residuals r (O, 3), Jacobians Jp (O, 3, 6), Jl (O, 3, 3), weights w
    (O,) and chi2 (O,). Row 3 is the stereo right-u (zero for mono)."""
    Rk = R[p.obs_kf.long()]
    tk = t[p.obs_kf.long()]
    Xc = lie.se3_apply(Rk, tk, X[p.obs_lm.long()])
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    iz = 1.0 / zs
    iz2 = iz * iz
    is_stereo = torch.isfinite(p.obs_ur)
    zero = torch.zeros_like(z)
    r2 = Xc[..., :2] * iz[..., None] - p.obs_uv
    r_ur = torch.where(is_stereo,
                       (x - p.baseline) * iz - torch.nan_to_num(p.obs_ur),
                       zero)
    r = torch.cat([r2, r_ur[..., None]], dim=-1)
    J_pt = torch.stack([
        torch.stack([iz, zero, -x * iz2], dim=-1),
        torch.stack([zero, iz, -y * iz2], dim=-1),
        torch.stack([torch.where(is_stereo, iz, zero), zero,
                     torch.where(is_stereo, -(x - p.baseline) * iz2, zero)],
                    dim=-1)], dim=-2)                          # (O, 3, 3)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(
        Xc.shape[:-1] + (3, 3))
    J_se3 = torch.cat([eye, -lie.so3_hat(Xc)], dim=-1)
    Jp = torch.einsum('oij,ojk->oik', J_pt, J_se3)
    Jl = torch.einsum('oij,ojk->oik', J_pt, Rk)
    chi2 = torch.sum(r * r, dim=-1) * p.obs_info
    delta2 = torch.where(is_stereo, HUBER2_STEREO, HUBER2_MONO).to(z.dtype)
    w_rob = huber_weight(chi2, delta2) if robust else torch.ones_like(chi2)
    w = p.obs_info * w_rob * p.obs_mask.to(z.dtype) * (z > 0).to(z.dtype)
    return r, Jp, Jl, w, chi2


@record_function("K4 ba_solve")
def ba_solve(p: BAProblem, n_iters: int = 10, lambda0: float = 1e-4):
    """Levenberg-Marquardt with dense-window Schur reduction. Returns
    (R, t, X, info) with info["costs"] the per-iteration cost and
    info["accepted"] the accept / reject sequence."""
    K = p.R.shape[0]
    L = p.X.shape[0]
    dev, f32 = p.obs_uv.device, p.obs_uv.dtype
    kf_opt_f = p.kf_opt.to(f32)
    lm_opt_f = p.lm_opt.to(f32)
    mask_f = p.obs_mask.to(f32)
    # joint (landmark, keyframe) index; masked rows go to a dump segment
    j = torch.where(p.obs_mask, p.obs_lm.long() * K + p.obs_kf.long(),
                    torch.full_like(p.obs_lm, L * K, dtype=torch.long))
    lm_opt_obs = lm_opt_f[p.obs_lm.long()] * mask_f
    eyeK = torch.eye(6, dtype=f32, device=dev)
    eyeL = torch.eye(3, dtype=f32, device=dev)
    kf_idx = p.obs_kf.long()

    def cost_of(terms):
        r, _, _, w, _ = terms
        return torch.sum(w * torch.sum(r * r, dim=-1))

    def lm_step(terms, R, t, X, lam):
        r, Jp, Jl, w, _ = terms
        Hpp = torch.zeros((K, 6, 6), dtype=f32, device=dev).index_add(
            0, kf_idx, torch.einsum('oia,o,oib->oab', Jp, w, Jp))
        bp = -torch.zeros((K, 6), dtype=f32, device=dev).index_add(
            0, kf_idx, torch.einsum('oia,o,oi->oa', Jp, w, r))
        Wpl = torch.einsum('oia,o,oib->oab', Jp, w * lm_opt_obs, Jl)
        hll = torch.einsum('oia,o,oib->oab', Jl, w, Jl)
        gl = torch.einsum('oia,o,oi->oa', Jl, w, r)
        payload = torch.cat([Wpl.reshape(-1, 18), hll.reshape(-1, 9), gl],
                            dim=1)                               # (O, 30)
        seg = torch.zeros((L * K + 1, 30), dtype=f32, device=dev).index_add(
            0, j, payload)[:L * K].reshape(L, K, 30)
        Bt = seg[:, :, :18].reshape(L, K, 6, 3)
        Hll = seg[:, :, 18:27].sum(dim=1).reshape(L, 3, 3)
        bl = -seg[:, :, 27:30].sum(dim=1)

        Hpp = Hpp + lam * eyeK * torch.clamp(
            torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-6)[..., None] * eyeK
        Hll_d = Hll + lam * eyeL * torch.clamp(
            torch.diagonal(Hll, dim1=-2, dim2=-1), min=1e-6)[..., None] * eyeL
        Hll_d = torch.where(p.lm_opt[:, None, None], Hll_d,
                            eyeL.expand(Hll_d.shape))
        bl = bl * lm_opt_f[:, None]
        Hll_inv = linalg.inv3x3(Hll_d)

        B = Bt.permute(1, 2, 0, 3).reshape(K * 6, L, 3)
        BC = torch.einsum('mlb,lbc->mlc', B, Hll_inv)             # (6K, L, 3)
        S_off = BC.reshape(K * 6, L * 3) @ B.reshape(K * 6, L * 3).T
        S = torch.block_diag(*Hpp) - S_off
        b_schur = bp.reshape(K * 6) - BC.reshape(K * 6, L * 3) @ \
            bl.reshape(L * 3)
        free = kf_opt_f.repeat_interleave(6)
        S = S * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        b_schur = b_schur * free

        dxp = linalg.solve_spd(S, b_schur)
        Btdxp = torch.einsum('mlc,m->lc', B, dxp)
        dxl = torch.einsum('lab,lb->la', Hll_inv, bl - Btdxp) * \
            lm_opt_f[:, None]
        dxp = dxp.reshape(K, 6) * kf_opt_f[:, None]
        dR, dt = lie.se3_exp(dxp)
        R_new, t_new = lie.se3_mul(dR, dt, R, t)
        return R_new, t_new, X + dxl

    R, t, X = p.R, p.t, p.X
    terms = _obs_terms(p, R, t, X)
    cost0 = cost = cost_of(terms)
    lam = torch.tensor(lambda0, dtype=f32, device=dev)
    costs, accepted = [], []
    for _ in range(n_iters):
        R_c, t_c, X_c = lm_step(terms, R, t, X, lam)
        terms_c = _obs_terms(p, R_c, t_c, X_c)
        new_cost = cost_of(terms_c)
        accept = new_cost < cost
        R = torch.where(accept, R_c, R)
        t = torch.where(accept, t_c, t)
        X = torch.where(accept, X_c, X)
        terms = tuple(torch.where(accept, a, b)
                      for a, b in zip(terms_c, terms))
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-9, 1e4)
        costs.append(cost)
        accepted.append(accept)
    return R, t, X, {"cost0": cost0, "costs": torch.stack(costs),
                     "accepted": torch.stack(accepted), "lambda": lam}


def classify_outliers(p: BAProblem, R, t, X):
    """Observations kept after BA: chi2 under 5.991 (mono) / 7.815
    (stereo)."""
    _, _, _, _, chi2 = _obs_terms(p, R, t, X, robust=False)
    th = torch.where(torch.isfinite(p.obs_ur), HUBER2_STEREO,
                     HUBER2_MONO).to(chi2.dtype)
    return p.obs_mask & (chi2 < th)
