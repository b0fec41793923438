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

`ba_solve_pcg` is the global BA's scalable solve: LM with the Schur system
solved by preconditioned CG through an implicit product, never forming the
dense coupling. K4 runs there in its per-observation mode (`assemble(...,
per_obs=True)`: the coupling as Wpl (O, 6, 3), one 6 x 3 block per
observation in observation order), and the implicit product S x, the
right-hand side and the back-substitution are kernel K14
(`csrc/schur_pcg.cu`): `pcg_solve` runs the whole CG solve of an LM step
(right-hand side, iterations, back-substitution) in one cooperative launch;
`schur_lm_pass` + `schur_kf_pass` launch its two passes alone, for S x as a
product of its own. Their plain versions are the reference's gathers and
segment sums and its CG loop.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.profiler import record_function

from .. import lie
from ..ops import cuda_build
from ..tensor_ops import einsum
from . import linalg
from .robust import huber_weight

HUBER2_MONO = 5.991
HUBER2_STEREO = 7.815

LAUNCHES = {"kernel": 0, "plain": 0}
# K4's per-observation mode (counted in LAUNCHES too); K14's passes and
# its whole solve
OBS_LAUNCHES = {"kernel": 0, "plain": 0}
SCHUR_LAUNCHES = {"kernel": 0, "plain": 0}
PCG_LAUNCHES = {"kernel": 0, "plain": 0}


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


class ObsBlocks(NamedTuple):
    """K4's outputs in per-observation mode: Hpp, bp, Hll, bl and the cost
    as in BlockSums, and in place of the dense coupling Wpl (O, 6, 3) =
    Jp^T w Jl of each observation in observation order (zero for masked
    observations; not weighted by lm_opt)."""
    Hpp: torch.Tensor
    bp: torch.Tensor
    Wpl: torch.Tensor
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
        0, kf_idx, einsum('oia,o,oib->oab', Jp, w, Jp))
    bp = -torch.zeros((K, 6), dtype=f32, device=dev).index_add(
        0, kf_idx, einsum('oia,o,oi->oa', Jp, w, r))
    Wpl = einsum('oia,o,oib->oab', Jp, w * lm_opt_obs, Jl)
    hll = einsum('oia,o,oib->oab', Jl, w, Jl)
    gl = einsum('oia,o,oi->oa', Jl, w, r)
    payload = torch.cat([Wpl.reshape(-1, 18), hll.reshape(-1, 9), gl], dim=1)
    seg = torch.zeros((L * K + 1, 30), dtype=f32, device=dev).index_add(
        0, j, payload)[:L * K].reshape(L, K, 30)
    return BlockSums(Hpp=Hpp, bp=bp, Bt=seg[:, :, :18].reshape(L, K, 6, 3),
                     Hll=seg[:, :, 18:27].sum(dim=1).reshape(L, 3, 3),
                     bl=-seg[:, :, 27:30].sum(dim=1),
                     cost=torch.sum(w * torch.sum(r * r, dim=-1)))


def assemble_obs_plain(p: BAProblem, R, t, X,
                       body: bool = False) -> ObsBlocks:
    """K4's per-observation mode in plain PyTorch (the reference's
    `_assemble_blocks` before damping): index_add over the keyframes and
    the landmarks, the coupling kept per observation."""
    LAUNCHES["plain"] += 1
    OBS_LAUNCHES["plain"] += 1
    K, L = p.R.shape[0], p.X.shape[0]
    dev, f32 = p.obs_uv.device, p.obs_uv.dtype
    r, Jp, Jl, w, _ = _obs_terms(p, R, t, X, body=body)
    kf_idx, lm_idx = p.obs_kf.long(), p.obs_lm.long()
    Hpp = torch.zeros((K, 6, 6), dtype=f32, device=dev).index_add(
        0, kf_idx, einsum('oia,o,oib->oab', Jp, w, Jp))
    bp = -torch.zeros((K, 6), dtype=f32, device=dev).index_add(
        0, kf_idx, einsum('oia,o,oi->oa', Jp, w, r))
    Hll = torch.zeros((L, 3, 3), dtype=f32, device=dev).index_add(
        0, lm_idx, einsum('oia,o,oib->oab', Jl, w, Jl))
    bl = -torch.zeros((L, 3), dtype=f32, device=dev).index_add(
        0, lm_idx, einsum('oia,o,oi->oa', Jl, w, r))
    Wpl = einsum('oia,o,oib->oab', Jp, w, Jl) * \
        p.obs_mask.to(f32)[:, None, None]
    return ObsBlocks(Hpp=Hpp, bp=bp, Wpl=Wpl, Hll=Hll, bl=bl,
                     cost=torch.sum(w * torch.sum(r * r, dim=-1)))


@record_function("K4 ba_assemble")
def assemble(p: BAProblem, R, t, X, order: ObsOrder = None,
             body: bool = False, per_obs: bool = False):
    """K4: `assemble_plain`'s function at state (R, t, X), or with
    `per_obs` `assemble_obs_plain`'s (ObsBlocks: the coupling per
    observation, no dense (L, K, 6, 3) tensor allocated). CUDA tensors: one
    launch over `order` (from `obs_order(p)`), results on the card; CPU
    tensors: the plain version. `body` switches the pose Jacobian to the
    body tangent [-I | hat(Xc)] (R, t still world-to-camera)."""
    dev = p.obs_uv.device
    if dev.type == "cpu":
        return assemble_obs_plain(p, R, t, X, body) if per_obs else \
            assemble_plain(p, R, t, X, body)
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
    # every entry of the coupling is written by the kernel: the dense rows
    # whole, or each observation slot's block (masked slots as zeros)
    coupling = torch.empty((O, 6, 3) if per_obs else (L, K, 6, 3),
                           dtype=f32, device=dev)
    # one zero fill: the cost (stays 0 without keyframes), the keyframes'
    # partial costs and the ticket
    zeroed = torch.zeros(max(K, 1) + 2, dtype=f32, device=dev)
    out = (BlockSums if not per_obs else ObsBlocks)(
        torch.empty((K, 6, 6), dtype=f32, device=dev),
        torch.empty((K, 6), dtype=f32, device=dev), coupling,
        torch.empty((L, 3, 3), dtype=f32, device=dev),
        torch.empty((L, 3), dtype=f32, device=dev), zeroed[0])
    rc = _lib().ba_assemble(
        *(x.data_ptr() for x in c), base.data_ptr(), int(body),
        int(per_obs), K, L, O,
        *(x.data_ptr() for x in out), zeroed[1:].data_ptr(),
        cuda_build.stream_ptr(R))
    cuda_build.check(rc, "ba_assemble")
    LAUNCHES["kernel"] += 1
    OBS_LAUNCHES["kernel"] += int(per_obs)
    return out


def _lib():
    lib = cuda_build.library("ba_assemble")
    if lib.ba_assemble.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ba_assemble.argtypes = [P] * 15 + [I] * 5 + [P] * 8
        lib.ba_assemble.restype = I
    return lib


def _where(ok, new, old):
    return type(old)(*(torch.where(ok, a, b) for a, b in zip(new, old)))


def _lm_loop(blocks, step, R, t, X, bs, lam, cost, n_iters: int):
    """The LM loop every solver shares: `step(bs, R, t, X, lam)` proposes a
    candidate from the accepted state's blocks, `blocks(R, t, X)` gives the
    candidate's (with its cost); a rejected candidate's blocks are dropped.
    Returns (R, t, X, bs, lam, cost, costs, accepted)."""
    costs, accepted = [], []
    for _ in range(n_iters):
        R_c, t_c, X_c = step(bs, R, t, X, lam)
        bs_c = blocks(R_c, t_c, X_c)
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
    return R, t, X, bs, lam, cost, costs, accepted


def dense_step(p: BAProblem, bs: BlockSums, R, t, X, lam):
    """One LM step of `ba_solve` from the block sums bs: the damped Schur
    system over the window's poses solved densely, then the landmarks'
    back-substitution. Returns the candidate (R, t, X)."""
    K = p.R.shape[0]
    L = p.X.shape[0]
    dev, f32 = p.obs_uv.device, p.obs_uv.dtype
    kf_opt_f = p.kf_opt.to(f32)
    lm_opt_f = p.lm_opt.to(f32)
    eyeL = torch.eye(3, dtype=f32, device=dev)
    Hpp = _damp(bs.Hpp, lam)
    Hll_d = torch.where(p.lm_opt[:, None, None], _damp(bs.Hll, lam),
                        eyeL.expand(bs.Hll.shape))
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
    return apply_step(dxp, dxl, R, t, X)


def apply_step(dxp, dxl, R, t, X):
    """The pose and landmark update: T <- exp(dxp) T, X <- X + dxl."""
    dR, dt = lie.se3_exp(dxp)
    R_new, t_new = lie.se3_mul(dR, dt, R, t)
    return R_new, t_new, X + dxl


@record_function("K4 ba_solve")
def ba_solve(p: BAProblem, n_iters: int = 10, lambda0: float = 1e-4):
    """Levenberg-Marquardt with dense-window Schur reduction. Returns
    (R, t, X, info) with info["costs"] the per-iteration cost and
    info["accepted"] the accept / reject sequence. K4 assembles the blocks
    once at the initial state and once per iteration at the candidate
    state; a rejected candidate's blocks are dropped."""
    dev, f32 = p.obs_uv.device, p.obs_uv.dtype
    order = obs_order(p) if dev.type == "cuda" else None

    def blocks(R, t, X):
        return assemble(p, R, t, X, order)

    def step(bs, R, t, X, lam):
        return dense_step(p, bs, R, t, X, lam)

    bs = blocks(p.R, p.t, p.X)
    lam = torch.tensor(lambda0, dtype=f32, device=dev)
    R, t, X, _, lam, _, costs, accepted = _lm_loop(
        blocks, step, p.R, p.t, p.X, bs, lam, bs.cost, n_iters)
    return R, t, X, {"cost0": bs.cost, "costs": torch.stack(costs),
                     "accepted": torch.stack(accepted), "lambda": lam}


def _damp(H, lam):
    """LM damping: the diagonal scaled by (1 + lam), at least lam * 1e-6."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + lam * eye * torch.clamp(
        torch.diagonal(H, dim1=-2, dim2=-1), min=1e-6)[..., None] * eye


# ---------------------------------------------------------------------------
# K14: the implicit Schur product of the PCG solve
# ---------------------------------------------------------------------------

def schur_lm_pass_plain(p: BAProblem, Wpl, x, Hll_inv, c=None):
    """y_l = lm_opt_l Hll_inv_l (c_l - sum_o Wpl_o^T x'[kf_o]) over
    landmark l's observations, x' = kf_opt x; without c, + the sum."""
    SCHUR_LAUNCHES["plain"] += 1
    f32 = x.dtype
    xp = x * p.kf_opt.to(f32)[:, None]
    Btx = torch.zeros((p.X.shape[0], 3), dtype=f32, device=x.device) \
        .index_add(0, p.obs_lm.long(), torch.einsum(
            'oab,oa->ob', Wpl, xp[p.obs_kf.long()]))
    v = Btx if c is None else c - Btx
    return torch.einsum('lab,lb->la', Hll_inv, v) * \
        p.lm_opt.to(f32)[:, None]


def schur_kf_pass_plain(p: BAProblem, Wpl, y, Hpp=None, x=None, a=None):
    """out_k = kf_opt_k (a_k - sum_o Wpl_o y[lm_o]) over keyframe k's
    observations, with a = Hpp (kf_opt x) when Hpp is given."""
    SCHUR_LAUNCHES["plain"] += 1
    f32 = y.dtype
    kf_opt_f = p.kf_opt.to(f32)[:, None]
    By = torch.zeros((p.R.shape[0], 6), dtype=f32, device=y.device) \
        .index_add(0, p.obs_kf.long(), torch.einsum(
            'oab,ob->oa', Wpl, y[p.obs_lm.long()]))
    if Hpp is not None:
        a = torch.einsum('kab,kb->ka', Hpp, x * kf_opt_f)
    return (a - By) * kf_opt_f


def _schur_check(p: BAProblem, Wpl, order, vecs):
    dev = Wpl.device
    if dev.type != "cuda":
        raise ValueError(f"schur_pcg: unsupported device {dev}")
    K, L, O = p.R.shape[0], p.X.shape[0], p.obs_uv.shape[0]
    shapes = {"Wpl": (O, 6, 3), **{k: s for k, (_, s) in vecs.items()}}
    tensors = {"Wpl": Wpl, **{k: v for k, (v, _) in vecs.items()}}
    for name, x in tensors.items():
        if x is None:
            continue
        if x.dtype != torch.float32 or x.device != dev or \
                tuple(x.shape) != shapes[name]:
            raise ValueError(f"schur_pcg: {name} must be float32 "
                             f"{shapes[name]} on {dev}")
    if order is None or order.kf_start.shape != (K + 1,) or \
            order.lm_start.shape != (L + 1,) or \
            any(t.dtype != torch.int32 or t.device != dev for t in order) \
            or any(t.dtype != torch.int32 or t.device != dev
                   for t in (p.obs_kf, p.obs_lm)) or \
            any(t.dtype != torch.bool or t.device != dev
                for t in (p.kf_opt, p.lm_opt)) or \
            not all(t.is_contiguous() for t in (p.obs_kf, p.obs_lm, p.kf_opt,
                                                p.lm_opt) + tuple(order)):
        raise ValueError("schur_pcg: needs the problem's int32 obs_kf / "
                         "obs_lm and ObsOrder and bool kf_opt / lm_opt, "
                         "contiguous, on the card")


def _ptr(x):
    return None if x is None else x.contiguous().data_ptr()


def _aligned8(W):
    """W contiguous from an 8-byte aligned address (the kernels read each
    observation's 72-byte block as 9 float pairs)."""
    W = W.contiguous()
    return W if W.data_ptr() % 8 == 0 else W.clone()


@record_function("K14 schur_lm_pass")
def schur_lm_pass(p: BAProblem, Wpl, x, Hll_inv, order: ObsOrder = None,
                  c=None):
    """K14's landmark pass: `schur_lm_pass_plain`'s function. CUDA
    tensors: one launch, one warp per landmark over its segment of
    order.lm_perm; CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return schur_lm_pass_plain(p, Wpl, x, Hll_inv, c)
    K, L = p.R.shape[0], p.X.shape[0]
    _schur_check(p, Wpl, order, {"x": (x, (K, 6)),
                                 "Hll_inv": (Hll_inv, (L, 3, 3)),
                                 "c": (c, (L, 3))})
    y = torch.empty((L, 3), dtype=torch.float32, device=x.device)
    keep = [_aligned8(Wpl)] + [t.contiguous() for t in (x, Hll_inv) + (
        () if c is None else (c,))]
    rc = _schur_lib().schur_lm_pass(
        _ptr(keep[0]), _ptr(keep[1]), p.kf_opt.data_ptr(),
        p.lm_opt.data_ptr(), _ptr(keep[2]),
        None if c is None else _ptr(keep[3]), p.obs_kf.data_ptr(),
        order.lm_perm.data_ptr(), order.lm_start.data_ptr(), L,
        y.data_ptr(), cuda_build.stream_ptr(x))
    cuda_build.check(rc, "schur_lm_pass")
    SCHUR_LAUNCHES["kernel"] += 1
    return y


@record_function("K14 schur_kf_pass")
def schur_kf_pass(p: BAProblem, Wpl, y, order: ObsOrder = None, Hpp=None,
                  x=None, a=None):
    """K14's keyframe pass: `schur_kf_pass_plain`'s function. CUDA
    tensors: one launch, one block per keyframe over its segment of
    order.kf_perm; CPU tensors: the plain version."""
    if y.device.type == "cpu":
        return schur_kf_pass_plain(p, Wpl, y, Hpp, x, a)
    K, L = p.R.shape[0], p.X.shape[0]
    if (Hpp is None) == (a is None) or (Hpp is not None and x is None):
        raise ValueError("schur_kf_pass: give Hpp and x, or a")
    _schur_check(p, Wpl, order, {"y": (y, (L, 3)), "Hpp": (Hpp, (K, 6, 6)),
                                 "x": (x, (K, 6)), "a": (a, (K, 6))})
    out = torch.empty((K, 6), dtype=torch.float32, device=y.device)
    keep = [_aligned8(Wpl)] + [None if t is None else t.contiguous()
                               for t in (y, Hpp, x, a)]
    rc = _schur_lib().schur_kf_pass(
        *(_ptr(t) for t in keep[:2]), p.kf_opt.data_ptr(),
        *(_ptr(t) for t in keep[2:]), p.obs_lm.data_ptr(),
        order.kf_perm.data_ptr(), order.kf_start.data_ptr(), K,
        out.data_ptr(), cuda_build.stream_ptr(y))
    cuda_build.check(rc, "schur_kf_pass")
    SCHUR_LAUNCHES["kernel"] += 1
    return out


def schur_matvec(p: BAProblem, Wpl, Hpp, Hll_inv, x, order=None):
    """S x = kf_opt (Hpp x' - B Hll^-1 B^T x'), x' = kf_opt x, B the
    coupling held per observation in Wpl: two K14 launches."""
    y = schur_lm_pass(p, Wpl, x, Hll_inv, order)
    return schur_kf_pass(p, Wpl, y, order, Hpp=Hpp, x=x)


def _schur_lib():
    lib = cuda_build.library("schur_pcg")
    if lib.schur_lm_pass.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.schur_lm_pass.argtypes = [P] * 9 + [I, P, P]
        lib.schur_lm_pass.restype = I
        lib.schur_kf_pass.argtypes = [P] * 9 + [I, P, P]
        lib.schur_kf_pass.restype = I
        lib.schur_pcg.argtypes = [P] * 14 + [I] * 5 + [P] * 6
        lib.schur_pcg.restype = I
    return lib


def pcg_args(p: BAProblem, ob: ObsBlocks, lam, order: ObsOrder = None):
    """One LM step's solve inputs at damping lam, as `pcg_solve` takes them:
    (p, Wpl, Hpp, Minv, Hll_inv, bp, bl, order), with Hpp and Hll damped,
    the non-optimized landmarks' Hll the identity and bl zero there."""
    dev, f32 = ob.Hpp.device, ob.Hpp.dtype
    Hpp = _damp(ob.Hpp, lam)
    Hll_d = torch.where(p.lm_opt[:, None, None], _damp(ob.Hll, lam),
                        torch.eye(3, dtype=f32, device=dev)
                        .expand(ob.Hll.shape))
    return (p, ob.Wpl, Hpp, linalg.inv6x6(Hpp), linalg.inv3x3(Hll_d), ob.bp,
            ob.bl * p.lm_opt.to(f32)[:, None], order)


def pcg_solve_plain(p: BAProblem, Wpl, Hpp, Minv, Hll_inv, bp, bl,
                    order: ObsOrder = None, cg_iters: int = 40):
    """The Schur system of one LM step solved by `cg_iters` iterations of
    CG preconditioned by Minv (block-diagonal, kf_opt-masked), x0 = 0, no
    early exit (the reference's lax.scan), over the plain passes; then the
    back-substitution. Returns (dxp (K, 6) = kf_opt x, dxl (L, 3)).
    `order` is unused (the kernel's)."""
    PCG_LAUNCHES["plain"] += 1
    f32, dev = bp.dtype, bp.device
    kf_opt_f = p.kf_opt.to(f32)[:, None]
    tiny = torch.tensor(1e-20, dtype=f32, device=dev)

    def guard(v):
        return torch.where(torch.abs(v) < 1e-20, tiny, v)

    def precond(v):
        return torch.einsum('kab,kb->ka', Minv, v) * kf_opt_f
    # rhs: bp - B Hll^-1 bl
    y0 = torch.einsum('lab,lb->la', Hll_inv, bl)
    rhs = schur_kf_pass_plain(p, Wpl, y0, a=bp)
    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(rhs)
    pdir = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        Ap = schur_kf_pass_plain(
            p, Wpl, schur_lm_pass_plain(p, Wpl, pdir, Hll_inv), Hpp=Hpp,
            x=pdir)
        alpha = rz / guard(torch.sum(pdir * Ap))
        x = x + alpha * pdir
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        pdir = z + rz_new / guard(rz) * pdir
        rz = rz_new
    dxp = x * kf_opt_f
    # back-substitution: dxl = Hll^-1 (bl - B^T dxp)
    return dxp, schur_lm_pass_plain(p, Wpl, dxp, Hll_inv, c=bl)


@record_function("K14 schur_pcg")
def pcg_solve(p: BAProblem, Wpl, Hpp, Minv, Hll_inv, bp, bl,
              order: ObsOrder = None, cg_iters: int = 40):
    """K14's whole solve: `pcg_solve_plain`'s function. CUDA tensors: one
    cooperative launch (the right-hand side, `cg_iters` iterations of three
    grid-wide phases, the back-substitution; raises if the card refuses
    it); CPU tensors: the plain version."""
    if Wpl.device.type == "cpu":
        return pcg_solve_plain(p, Wpl, Hpp, Minv, Hll_inv, bp, bl, order,
                               cg_iters)
    return _pcg_launch(p, Wpl, Hpp, Minv, Hll_inv, bp, bl, order, cg_iters)


def _pcg_launch(p: BAProblem, Wpl, Hpp, Minv, Hll_inv, bp, bl, order,
                cg_iters, grid: int = 0):
    """pcg_solve's launch on `grid` blocks (0: as many as are co-resident;
    the result has the same bits at any grid)."""
    K, L = p.R.shape[0], p.X.shape[0]
    ins = {"Hpp": (Hpp, (K, 6, 6)), "Minv": (Minv, (K, 6, 6)),
           "Hll_inv": (Hll_inv, (L, 3, 3)), "bp": (bp, (K, 6)),
           "bl": (bl, (L, 3))}
    cg_iters, grid = int(cg_iters), int(grid)
    if any(t is None for t, _ in ins.values()) or cg_iters < 0 or grid < 0:
        raise ValueError("pcg_solve: needs Hpp, Minv, Hll_inv, bp, bl and "
                         "cg_iters >= 0")
    _schur_check(p, Wpl, order, ins)
    dev, O = Wpl.device, Wpl.shape[0]
    f32 = torch.float32
    keep = [_aligned8(Wpl)] + [t.contiguous()
                               for t in (Hpp, Minv, Hll_inv, bp, bl)]
    # the CG vectors and y; the observations' blocks and ids in the two
    # slot orders, copied once by the launch
    scratch = torch.empty(26 * K + 3 * L, dtype=f32, device=dev)
    wscratch = torch.empty(36 * O, dtype=f32, device=dev)
    iscratch = torch.empty(2 * O, dtype=torch.int32, device=dev)
    dxp = torch.empty((K, 6), dtype=f32, device=dev)
    dxl = torch.empty((L, 3), dtype=f32, device=dev)
    rc = _schur_lib().schur_pcg(
        *(t.data_ptr() for t in keep), p.kf_opt.data_ptr(),
        p.lm_opt.data_ptr(), p.obs_kf.data_ptr(), p.obs_lm.data_ptr(),
        *(t.data_ptr() for t in order), K, L, O, cg_iters, grid,
        scratch.data_ptr(), wscratch.data_ptr(), iscratch.data_ptr(),
        dxp.data_ptr(), dxl.data_ptr(), cuda_build.stream_ptr(Wpl))
    cuda_build.check(rc, "schur_pcg")
    PCG_LAUNCHES["kernel"] += 1
    return dxp, dxl


@record_function("ba_solve_pcg")
def ba_solve_pcg(p: BAProblem, n_iters: int = 8, cg_iters: int = 40,
                 lambda0: float = 1e-4, carry=None):
    """LM with the Schur system solved by preconditioned CG through the
    implicit product (the dense coupling is never formed); the block-
    diagonal pose Hessian is the preconditioner. Returns (R, t, X, info):
    info["costs"] and info["accepted"] per iteration, info["carry"] =
    (R, t, X, lam, cost) resumes the solve (`carry=`), which is how the
    detached global BA advances in slices. K4 (per-observation mode)
    assembles the blocks at the start state and at every candidate; an
    accepted candidate's blocks serve the next step. No host
    synchronisation: the CG and LM scalars stay on the device."""
    dev, f32 = p.obs_uv.device, p.obs_uv.dtype
    order = obs_order(p) if dev.type == "cuda" else None

    def blocks(R, t, X):
        return assemble(p, R, t, X, order, per_obs=True)

    def step(ob: ObsBlocks, R, t, X, lam):
        dxp, dxl = pcg_solve(*pcg_args(p, ob, lam, order), cg_iters)
        return apply_step(dxp, dxl, R, t, X)

    if carry is None:
        R, t, X = p.R, p.t, p.X
        ob = blocks(R, t, X)
        lam = torch.tensor(lambda0, dtype=f32, device=dev)
        cost = ob.cost
    else:
        R, t, X, lam, cost = carry
        ob = blocks(R, t, X)
    R, t, X, _, lam, cost_n, costs, accepted = _lm_loop(
        blocks, step, R, t, X, ob, lam, cost, n_iters)
    return R, t, X, {"cost0": cost, "costs": torch.stack(costs),
                     "accepted": torch.stack(accepted), "lambda": lam,
                     "carry": (R, t, X, lam, cost_n)}


def classify_outliers(p: BAProblem, R, t, X):
    """Observations kept after BA: chi2 under 5.991 (mono) / 7.815
    (stereo)."""
    _, _, _, _, chi2 = _obs_terms(p, R, t, X, robust=False)
    th = torch.where(torch.isfinite(p.obs_ur), HUBER2_STEREO,
                     HUBER2_MONO).to(chi2.dtype)
    return p.obs_mask & (chi2 < th)
