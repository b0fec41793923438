"""Bundle adjustment: Huber-robust Levenberg-Marquardt with a dense Schur
complement over the window's poses (counterpart of
`morb_slam_tpu/optim/ba.py:ba_solve` and `classify_outliers`).

`assemble` is kernel K4: the per-observation residuals, Jacobians and Huber
weights and their block sums (Hpp, bp, the dense landmark-keyframe coupling
B, Hll, bl) with the cost, at one state. On CUDA tensors it launches
`csrc/ba_assemble.cu` once per state, reducing in a fixed, once-sorted
observation order (bitwise repeatable); on CPU tensors it runs
`assemble_plain` (index_add over the keyframes and the joint (landmark,
keyframe) index). The Schur product, the Cholesky solve and the
back-substitution stay PyTorch. The visual-inertial BA takes its visual
blocks from the same kernel in body-tangent mode. Pose convention: T_cw,
T <- exp(dx) T; X <- X + dx.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.profiler import record_function

from .. import lie
from ..ops import cuda_build
from . import linalg
from .robust import huber_weight

HUBER2_MONO = 5.991
HUBER2_STEREO = 7.815

LAUNCHES = {"kernel": 0, "plain": 0}


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


def _obs_terms(p: BAProblem, R, t, X, robust: bool = True,
               body: bool = False):
    """Residuals r (O, 3), Jacobians Jp (O, 3, 6), Jl (O, 3, 3), weights w
    (O,) and chi2 (O,). Row 3 is the stereo right-u (zero for mono). Jp is
    taken in the camera tangent [I | -hat(Xc)], or with `body` in the body
    tangent [-I | hat(Xc)] (the visual-inertial BA's)."""
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
    if body:
        J_se3 = -J_se3
    Jp = torch.einsum('oij,ojk->oik', J_pt, J_se3)
    Jl = torch.einsum('oij,ojk->oik', J_pt, Rk)
    chi2 = torch.sum(r * r, dim=-1) * p.obs_info
    delta2 = torch.where(is_stereo, HUBER2_STEREO, HUBER2_MONO).to(z.dtype)
    w_rob = huber_weight(chi2, delta2) if robust else torch.ones_like(chi2)
    w = p.obs_info * w_rob * p.obs_mask.to(z.dtype) * (z > 0).to(z.dtype)
    return r, Jp, Jl, w, chi2


class BlockSums(NamedTuple):
    """K4's outputs at one state: Hpp (K, 6, 6), bp (K, 6) = -sum Jp^T w r,
    Bt (L, K, 6, 3) = sum Jp^T w Jl over each (landmark, keyframe) pair's
    observations of optimized landmarks, Hll (L, 3, 3), bl (L, 3) =
    -sum Jl^T w r, and the robust cost sum w |r|^2 ()."""
    Hpp: torch.Tensor
    bp: torch.Tensor
    Bt: torch.Tensor
    Hll: torch.Tensor
    bl: torch.Tensor
    cost: torch.Tensor


class ObsOrder(NamedTuple):
    """The once-per-solve observation order K4 reduces in: observation ids
    sorted by keyframe (kf_perm, segment starts kf_start (K + 1,)) and by
    (landmark, keyframe) (lm_perm, lm_start (L + 1,)); masked observations
    sort past the last segment."""
    kf_perm: torch.Tensor
    kf_start: torch.Tensor
    lm_perm: torch.Tensor
    lm_start: torch.Tensor


def obs_order(p: BAProblem) -> ObsOrder:
    """Sort the observations once (no host synchronisation)."""
    K, L = p.R.shape[0], p.X.shape[0]
    dev = p.obs_uv.device
    kf = p.obs_kf.long()
    lm = p.obs_lm.long()
    key_kf = torch.where(p.obs_mask, kf, torch.full_like(kf, K))
    key_lm = torch.where(p.obs_mask, lm * K + kf,
                         torch.full_like(lm, L * K))
    kf_perm = torch.sort(key_kf, stable=True)
    lm_perm = torch.sort(key_lm, stable=True)
    kf_start = torch.searchsorted(kf_perm.values, torch.arange(
        K + 1, device=dev))
    lm_start = torch.searchsorted(lm_perm.values, torch.arange(
        L + 1, device=dev) * K)
    i32 = torch.int32
    return ObsOrder(kf_perm=kf_perm.indices.to(i32),
                    kf_start=kf_start.to(i32),
                    lm_perm=lm_perm.indices.to(i32),
                    lm_start=lm_start.to(i32))


def assemble_plain(p: BAProblem, R, t, X, body: bool = False) -> BlockSums:
    """The block sums and cost from `_obs_terms` by index_add over the
    keyframes and the joint (landmark, keyframe) index."""
    LAUNCHES["plain"] += 1
    K, L = p.R.shape[0], p.X.shape[0]
    dev, f32 = p.obs_uv.device, p.obs_uv.dtype
    r, Jp, Jl, w, _ = _obs_terms(p, R, t, X, body=body)
    kf_idx = p.obs_kf.long()
    j = torch.where(p.obs_mask, p.obs_lm.long() * K + kf_idx,
                    torch.full_like(kf_idx, L * K))
    lm_opt_obs = p.lm_opt.to(f32)[p.obs_lm.long()] * p.obs_mask.to(f32)
    Hpp = torch.zeros((K, 6, 6), dtype=f32, device=dev).index_add(
        0, kf_idx, torch.einsum('oia,o,oib->oab', Jp, w, Jp))
    bp = -torch.zeros((K, 6), dtype=f32, device=dev).index_add(
        0, kf_idx, torch.einsum('oia,o,oi->oa', Jp, w, r))
    Wpl = torch.einsum('oia,o,oib->oab', Jp, w * lm_opt_obs, Jl)
    hll = torch.einsum('oia,o,oib->oab', Jl, w, Jl)
    gl = torch.einsum('oia,o,oi->oa', Jl, w, r)
    payload = torch.cat([Wpl.reshape(-1, 18), hll.reshape(-1, 9), gl], dim=1)
    seg = torch.zeros((L * K + 1, 30), dtype=f32, device=dev).index_add(
        0, j, payload)[:L * K].reshape(L, K, 30)
    return BlockSums(Hpp=Hpp, bp=bp, Bt=seg[:, :, :18].reshape(L, K, 6, 3),
                     Hll=seg[:, :, 18:27].sum(dim=1).reshape(L, 3, 3),
                     bl=-seg[:, :, 27:30].sum(dim=1),
                     cost=torch.sum(w * torch.sum(r * r, dim=-1)))


@record_function("K4 ba_assemble")
def assemble(p: BAProblem, R, t, X, order: ObsOrder = None,
             body: bool = False) -> BlockSums:
    """K4: `assemble_plain`'s function at state (R, t, X). CUDA tensors: one
    launch over `order` (from `obs_order(p)`), results on the card; CPU
    tensors: the plain version. `body` switches the pose Jacobian to the
    body tangent [-I | hat(Xc)] (R, t still world-to-camera)."""
    dev = p.obs_uv.device
    if dev.type == "cpu":
        return assemble_plain(p, R, t, X, body)
    if dev.type != "cuda":
        raise ValueError(f"ba_assemble: unsupported device {dev}")
    K, L, O = R.shape[0], X.shape[0], p.obs_uv.shape[0]
    f32, i32 = torch.float32, torch.int32
    if order is None:
        order = obs_order(p)
    floats = (R, t, X, p.obs_uv, p.obs_ur, p.obs_info)
    ints = (p.obs_kf, p.obs_lm) + tuple(order)
    if any(x.dtype != f32 or x.device != dev for x in floats) or \
            any(x.dtype != i32 or x.device != dev for x in ints) or \
            any(x.dtype != torch.bool or x.device != dev
                for x in (p.obs_mask, p.lm_opt)) or \
            R.shape != (K, 3, 3) or t.shape != (K, 3) or X.shape != (L, 3) \
            or p.obs_uv.shape != (O, 2) or \
            any(x.shape != (O,) for x in (p.obs_kf, p.obs_lm, p.obs_ur,
                                          p.obs_info, p.obs_mask)) or \
            p.lm_opt.shape != (L,) or order.kf_start.shape != (K + 1,) or \
            order.lm_start.shape != (L + 1,) or p.baseline.numel() != 1:
        raise ValueError("ba_assemble: needs float32 R (K, 3, 3), t (K, 3), "
                         "X (L, 3), obs_uv (O, 2), obs_ur / obs_info (O,), "
                         "int32 obs_kf / obs_lm (O,) and order, bool "
                         "obs_mask (O,) / lm_opt (L,) on one card")
    c = [x.contiguous() for x in (R, t, X, p.obs_kf, p.obs_lm, p.obs_uv,
                                  p.obs_ur, p.obs_info, p.obs_mask,
                                  p.lm_opt) + tuple(order)]
    base = p.baseline.to(device=dev, dtype=f32).reshape(1)
    out = BlockSums(
        Hpp=torch.empty((K, 6, 6), dtype=f32, device=dev),
        bp=torch.empty((K, 6), dtype=f32, device=dev),
        Bt=torch.empty((L, K, 6, 3), dtype=f32, device=dev),
        Hll=torch.empty((L, 3, 3), dtype=f32, device=dev),
        bl=torch.empty((L, 3), dtype=f32, device=dev),
        cost=torch.zeros((), dtype=f32, device=dev))
    scratch = torch.zeros(max(K, 1) + 1, dtype=f32, device=dev)
    rc = _lib().ba_assemble(
        *(x.data_ptr() for x in c), base.data_ptr(), int(body), K, L, O,
        *(x.data_ptr() for x in out), scratch.data_ptr(),
        cuda_build.stream_ptr(R))
    cuda_build.check(rc, "ba_assemble")
    LAUNCHES["kernel"] += 1
    return out


def _lib():
    lib = cuda_build.library("ba_assemble")
    if lib.ba_assemble.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ba_assemble.argtypes = [P] * 15 + [I] * 4 + [P] * 8
        lib.ba_assemble.restype = I
    return lib


def _where(ok, new, old):
    return type(old)(*(torch.where(ok, a, b) for a, b in zip(new, old)))


@record_function("K4 ba_solve")
def ba_solve(p: BAProblem, n_iters: int = 10, lambda0: float = 1e-4):
    """Levenberg-Marquardt with dense-window Schur reduction. Returns
    (R, t, X, info) with info["costs"] the per-iteration cost and
    info["accepted"] the accept / reject sequence. K4 assembles the blocks
    once at the initial state and once per iteration at the candidate
    state; a rejected candidate's blocks are dropped."""
    K = p.R.shape[0]
    L = p.X.shape[0]
    dev, f32 = p.obs_uv.device, p.obs_uv.dtype
    kf_opt_f = p.kf_opt.to(f32)
    lm_opt_f = p.lm_opt.to(f32)
    eyeK = torch.eye(6, dtype=f32, device=dev)
    eyeL = torch.eye(3, dtype=f32, device=dev)
    order = obs_order(p) if dev.type == "cuda" else None

    def lm_step(bs: BlockSums, R, t, X, lam):
        Hpp = bs.Hpp + lam * eyeK * torch.clamp(
            torch.diagonal(bs.Hpp, dim1=-2, dim2=-1), min=1e-6)[..., None] \
            * eyeK
        Hll_d = bs.Hll + lam * eyeL * torch.clamp(
            torch.diagonal(bs.Hll, dim1=-2, dim2=-1), min=1e-6)[..., None] \
            * eyeL
        Hll_d = torch.where(p.lm_opt[:, None, None], Hll_d,
                            eyeL.expand(Hll_d.shape))
        bl = bs.bl * lm_opt_f[:, None]
        Hll_inv = linalg.inv3x3(Hll_d)

        B = bs.Bt.permute(1, 2, 0, 3).reshape(K * 6, L, 3)
        BC = torch.einsum('mlb,lbc->mlc', B, Hll_inv)             # (6K, L, 3)
        S_off = BC.reshape(K * 6, L * 3) @ B.reshape(K * 6, L * 3).T
        S = torch.block_diag(*Hpp) - S_off
        b_schur = bs.bp.reshape(K * 6) - BC.reshape(K * 6, L * 3) @ \
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
    bs = assemble(p, R, t, X, order)
    cost0 = cost = bs.cost
    lam = torch.tensor(lambda0, dtype=f32, device=dev)
    costs, accepted = [], []
    for _ in range(n_iters):
        R_c, t_c, X_c = lm_step(bs, R, t, X, lam)
        bs_c = assemble(p, R_c, t_c, X_c, order)
        accept = bs_c.cost < cost
        R = torch.where(accept, R_c, R)
        t = torch.where(accept, t_c, t)
        X = torch.where(accept, X_c, X)
        bs = _where(accept, bs_c, bs)
        cost = torch.where(accept, bs_c.cost, cost)
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
