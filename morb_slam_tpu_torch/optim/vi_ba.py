"""Visual-inertial bundle adjustment and the per-frame inertial pose
optimization (counterpart of `morb_slam_tpu/optim/vi_ba.py`).

Each keyframe carries a 15-dof body-frame state [dp, phi, dv, dbg, dba]
(body == camera at this layer); R' = R exp(phi), p' = p + R dp, v' = v + dv,
b' = b + db. The window BA (`vi_ba_solve`) is Levenberg-Marquardt over a
dense (15W)^2 system with the landmarks Schur-reduced: its visual blocks and
visual cost come from K4 (`optim.ba.assemble`) in body-tangent mode; the
inertial edges (9-dof residual, (9, 30) Jacobian at zero tangent), the bias
random walk and the bias priors assembled into that system, and the
inertial cost of the accept test, are kernel K13 (`inertial_system`,
`inertial_cost`: `csrc/vi_edges.cu` on CUDA tensors; on CPU tensors
`inertial_system_plain` / `inertial_cost_plain`, whose Jacobian is
`torch.func.vmap(jacfwd)`).

`optimize_pose_inertial` is kernel K12: on CUDA tensors one launch of
`csrc/pose_inertial.cu` runs every Gauss-Newton step and reclassification
round of one call; on CPU tensors it runs `optimize_pose_inertial_plain`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap
from torch.profiler import record_function

from .. import lie
from ..imu import gravity
from ..ops import cuda_build
from . import ba, linalg

HUBER2_MONO = 5.991
HUBER2_STEREO = 7.815

LAUNCHES = {"kernel": 0, "plain": 0}
# K13 (inertial_system and inertial_cost)
INERTIAL_LAUNCHES = {"kernel": 0, "plain": 0}


class VIBAProblem(NamedTuple):
    """Fixed-capacity visual-inertial window problem.

    Window states (W slots, body frame): R_wb (W, 3, 3), p_wb, v (W, 3),
    bias (W, 6); fix_pose / fix_vb (W,) bool. Landmarks X (L, 3), lm_opt
    (L,). Visual observations (O,): obs_kf, obs_lm, obs_uv (O, 2), obs_ur,
    obs_info, obs_mask; baseline (). Inertial edges, one slot per window
    keyframe (slot e connects e_prev[e] -> e): e_valid, e_prev, e_dt (W,),
    e_dR (W, 3, 3), e_dV, e_dP (W, 3), e_JRg..e_JPa (W, 3, 3), e_info
    (W, 9, 9), e_bias0 (W, 6), e_rw_info (W, 6). prior_bias_info (W, 6)
    diagonal information pulling the bias toward zero."""
    R_wb: torch.Tensor
    p_wb: torch.Tensor
    v: torch.Tensor
    bias: torch.Tensor
    fix_pose: torch.Tensor
    fix_vb: torch.Tensor
    X: torch.Tensor
    lm_opt: torch.Tensor
    obs_kf: torch.Tensor
    obs_lm: torch.Tensor
    obs_uv: torch.Tensor
    obs_ur: torch.Tensor
    obs_info: torch.Tensor
    obs_mask: torch.Tensor
    baseline: torch.Tensor
    e_valid: torch.Tensor
    e_prev: torch.Tensor
    e_dt: torch.Tensor
    e_dR: torch.Tensor
    e_dV: torch.Tensor
    e_dP: torch.Tensor
    e_JRg: torch.Tensor
    e_JVg: torch.Tensor
    e_JVa: torch.Tensor
    e_JPg: torch.Tensor
    e_JPa: torch.Tensor
    e_info: torch.Tensor
    e_bias0: torch.Tensor
    e_rw_info: torch.Tensor
    prior_bias_info: torch.Tensor


def floor_info(info9, sig_r: float = 0.003, sig_v: float = 0.01,
               sig_p: float = 0.005):
    """Information with a systematic-error covariance floor added to its
    covariance (`inv_ex`: no host synchronisation)."""
    eye9 = torch.eye(9, dtype=info9.dtype, device=info9.device)
    fl = torch.diag(torch.cat([torch.full((3,), sig_r ** 2),
                               torch.full((3,), sig_v ** 2),
                               torch.full((3,), sig_p ** 2)])
                    ).to(info9.dtype).to(info9.device)
    cov = torch.linalg.inv_ex(info9 + 1e-9 * eye9).inverse + fl
    out = torch.linalg.inv_ex(cov).inverse
    return 0.5 * (out + out.transpose(-1, -2))


def _ba_problem(p: VIBAProblem) -> ba.BAProblem:
    """The window's visual part as a BAProblem (K4's input)."""
    R_cw, t_cw = lie.se3_inv(p.R_wb, p.p_wb)
    return ba.BAProblem(R=R_cw, t=t_cw, X=p.X, obs_kf=p.obs_kf,
                        obs_lm=p.obs_lm, obs_uv=p.obs_uv, obs_ur=p.obs_ur,
                        obs_info=p.obs_info, obs_mask=p.obs_mask,
                        kf_opt=~p.fix_pose, lm_opt=p.lm_opt,
                        baseline=p.baseline)


def _visual_terms(p: VIBAProblem, R_wb, p_wb, X, robust: bool):
    """Reprojection r (O, 3), Jp (O, 3, 6) in the body tangent [dp, phi],
    Jl (O, 3, 3), w (O,), chi2 (O,)."""
    R_cw, t_cw = lie.se3_inv(R_wb, p_wb)
    return ba._obs_terms(_ba_problem(p), R_cw, t_cw, X, robust=robust,
                         body=True)


def _edge_residual(x30, Ri, pi, vi, bi, Rj, pj, vj, dt, dR, dV, dP,
                   JRg, JVg, JVa, JPg, JPa, bias0, g):
    """9-dof preintegration residual [r_R, r_v, r_p] of one edge as a
    function of the 30-dim (state_i, state_j) perturbation; batches over
    leading dims."""
    xi, xj = x30[..., :15], x30[..., 15:]
    Ri_ = lie.matmat(Ri, lie.so3_exp(xi[..., 3:6]))
    pi_ = pi + lie.matvec(Ri, xi[..., 0:3])
    vi_ = vi + xi[..., 6:9]
    bg = bi[..., :3] + xi[..., 9:12]
    ba_ = bi[..., 3:] + xi[..., 12:15]
    Rj_ = lie.matmat(Rj, lie.so3_exp(xj[..., 3:6]))
    pj_ = pj + lie.matvec(Rj, xj[..., 0:3])
    vj_ = vj + xj[..., 6:9]
    dbg = bg - bias0[..., :3]
    dba = ba_ - bias0[..., 3:]
    dR_c = lie.matmat(dR, lie.so3_exp(lie.matvec(JRg, dbg)))
    dV_c = dV + lie.matvec(JVg, dbg) + lie.matvec(JVa, dba)
    dP_c = dP + lie.matvec(JPg, dbg) + lie.matvec(JPa, dba)
    RiT = Ri_.transpose(-1, -2)
    dt = dt[..., None]
    r_R = lie.so3_log(lie.matmat(dR_c.transpose(-1, -2),
                                 lie.matmat(RiT, Rj_)))
    r_v = lie.matvec(RiT, vj_ - vi_ - g * dt) - dV_c
    r_p = lie.matvec(RiT, pj_ - pi_ - vi_ * dt - 0.5 * g * dt * dt) - dP_c
    return torch.cat([r_R, r_v, r_p], dim=-1)


def _edge_args(p: VIBAProblem, R_wb, p_wb, v, bias):
    prev = torch.clamp(p.e_prev, min=0).long()
    return (R_wb[prev], p_wb[prev], v[prev], bias[prev], R_wb, p_wb, v,
            p.e_dt, p.e_dR, p.e_dV, p.e_dP, p.e_JRg, p.e_JVg, p.e_JVa,
            p.e_JPg, p.e_JPa, p.e_bias0)


def _edge_terms(p: VIBAProblem, R_wb, p_wb, v, bias):
    """Residual (W, 9) and (W, 9, 30) Jacobian of every inertial edge, zero
    for invalid edges."""
    g = gravity(p_wb)
    z = torch.zeros(30, dtype=p_wb.dtype, device=p_wb.device)

    def one(*a):
        def f(x):
            return _edge_residual(x, *a, g)
        return f(z), jacfwd(f)(z)
    r, J = vmap(one)(*_edge_args(p, R_wb, p_wb, v, bias))
    # (torch's forward mode carries some tangents in float64)
    J = J.to(p_wb.dtype)
    w = p.e_valid.to(p_wb.dtype)
    return r * w[:, None], J * w[:, None, None]


def _edge_residuals(p: VIBAProblem, R_wb, p_wb, v, bias):
    z = torch.zeros((R_wb.shape[0], 30), dtype=p_wb.dtype,
                    device=p_wb.device)
    r = _edge_residual(z, *_edge_args(p, R_wb, p_wb, v, bias),
                       gravity(p_wb))
    return r * p.e_valid.to(p_wb.dtype)[:, None]


def inertial_cost_plain(p: VIBAProblem, R_wb, p_wb, v, bias):
    """Inertial + bias random walk + bias prior costs (K13's cost mode)."""
    INERTIAL_LAUNCHES["plain"] += 1
    r = _edge_residuals(p, R_wb, p_wb, v, bias)
    c_in = torch.sum(torch.einsum('ei,eij,ej->e', r, p.e_info, r))
    prev = torch.clamp(p.e_prev, min=0).long()
    r_rw = (bias - bias[prev]) * p.e_valid.to(bias.dtype)[:, None]
    c_rw = torch.sum(r_rw * r_rw * p.e_rw_info)
    c_pr = torch.sum(bias * bias * p.prior_bias_info)
    return c_in + c_rw + c_pr


def _total_cost(p: VIBAProblem, vis: ba.BlockSums, R_wb, p_wb, v, bias):
    """The robust visual cost (K4's, from the blocks `vis` assembled at this
    state) plus the inertial, random-walk and bias-prior costs."""
    return vis.cost + inertial_cost(p, R_wb, p_wb, v, bias)


def _free_mask(p: VIBAProblem):
    W = p.R_wb.shape[0]
    return torch.cat([(~p.fix_pose)[:, None].expand(W, 6),
                      (~p.fix_vb)[:, None].expand(W, 9)],
                     dim=1).reshape(15 * W).to(p.p_wb.dtype)


def _add_blocks(H, rb, cb, r0, c0, vals):
    """H (D, D) += vals (W, n, m) at block rows rb (W,) offset r0, block
    columns cb (W,) offset c0 (15-wide blocks), duplicates summed."""
    n, m = vals.shape[1:]
    dev = H.device
    rows = (rb * 15 + r0)[:, None] + torch.arange(n, device=dev)[None]
    cols = (cb * 15 + c0)[:, None] + torch.arange(m, device=dev)[None]
    H.index_put_((rows[:, :, None], cols[:, None, :]), vals, accumulate=True)


def inertial_system_plain(p: VIBAProblem, R_wb, p_wb, v, bias, Hpp, bp):
    """The dense window system of `_lm_step` before the landmark Schur step:
    H (15W, 15W) and b (15W,) holding the visual pose blocks Hpp (W, 6, 6)
    and bp (W, 6), the inertial edges' J^T Omega J and -J^T Omega r, the
    bias random walk and the bias priors (K13's function)."""
    INERTIAL_LAUNCHES["plain"] += 1
    W = p.R_wb.shape[0]
    D = 15 * W
    f32, dev = p.p_wb.dtype, p.p_wb.device
    prev = torch.clamp(p.e_prev, min=0).long()
    ks = torch.arange(W, device=dev)
    H = torch.zeros((D, D), dtype=f32, device=dev)
    b = torch.zeros((W, 15), dtype=f32, device=dev)
    _add_blocks(H, ks, ks, 0, 0, Hpp)
    b[:, 0:6] += bp

    with record_function("K13 vi_ba edges"):
        re, Je = _edge_terms(p, R_wb, p_wb, v, bias)         # (W,9),(W,9,30)
        JtW = torch.einsum('eai,eab->ebi', Je, p.e_info)
        He = torch.einsum('ebi,ebj->eij', JtW, Je)
        ge = -torch.einsum('ebi,eb->ei', JtW, re)
        ij = He[:, :15, 15:]
        _add_blocks(H, prev, prev, 0, 0, He[:, :15, :15])
        _add_blocks(H, prev, ks, 0, 0, ij)
        _add_blocks(H, ks, prev, 0, 0, ij.transpose(-1, -2))
        _add_blocks(H, ks, ks, 0, 0, He[:, 15:, 15:])
        b.index_add_(0, prev, ge[:, :15])
        b.index_add_(0, ks, ge[:, 15:])
        # bias random walk r = b_j - b_i (diagonal information)
        valid_f = p.e_valid.to(f32)[:, None]
        r_rw = (bias - bias[prev]) * valid_f
        rw = p.e_rw_info * valid_f
        dia = torch.diag_embed(rw)
        _add_blocks(H, prev, prev, 9, 9, dia)
        _add_blocks(H, ks, ks, 9, 9, dia)
        _add_blocks(H, prev, ks, 9, 9, -dia)
        _add_blocks(H, ks, prev, 9, 9, -dia)
        pad9 = torch.nn.functional.pad
        b.index_add_(0, prev, pad9(rw * r_rw, (9, 0)))
        b.index_add_(0, ks, pad9(-rw * r_rw, (9, 0)))
        # bias priors toward zero
        _add_blocks(H, ks, ks, 9, 9, torch.diag_embed(p.prior_bias_info))
        b[:, 9:15] += -p.prior_bias_info * bias
    return H, b.reshape(D)


def _edge_consts(p: VIBAProblem):
    """Each edge's constants in K13's layout (W, 160): dt, dR, dV, dP, the
    five bias Jacobians, Omega, bias0, the random-walk and the prior
    information."""
    W = p.R_wb.shape[0]
    return torch.cat([p.e_dt[:, None], p.e_dR.reshape(W, 9), p.e_dV, p.e_dP,
                      *(J.reshape(W, 9) for J in (p.e_JRg, p.e_JVg, p.e_JVa,
                                                   p.e_JPg, p.e_JPa)),
                      p.e_info.reshape(W, 81), p.e_bias0, p.e_rw_info,
                      p.prior_bias_info], dim=1).contiguous()


def _k13_inputs(p: VIBAProblem, R_wb, p_wb, v, bias):
    """Check and pack K13's inputs: the body states (W, 21), the edge
    constants, int32 e_prev and bool e_valid, contiguous on one card."""
    W = p.R_wb.shape[0]
    dev = p_wb.device
    if dev.type != "cuda":
        raise ValueError(f"vi_edges: unsupported device {dev}")
    f32 = torch.float32
    shapes = {"R_wb": (R_wb, (W, 3, 3)), "p_wb": (p_wb, (W, 3)),
              "v": (v, (W, 3)), "bias": (bias, (W, 6)),
              "e_dt": (p.e_dt, (W,)), "e_dR": (p.e_dR, (W, 3, 3)),
              "e_dV": (p.e_dV, (W, 3)), "e_dP": (p.e_dP, (W, 3)),
              "e_JRg": (p.e_JRg, (W, 3, 3)), "e_JVg": (p.e_JVg, (W, 3, 3)),
              "e_JVa": (p.e_JVa, (W, 3, 3)), "e_JPg": (p.e_JPg, (W, 3, 3)),
              "e_JPa": (p.e_JPa, (W, 3, 3)), "e_info": (p.e_info, (W, 9, 9)),
              "e_bias0": (p.e_bias0, (W, 6)),
              "e_rw_info": (p.e_rw_info, (W, 6)),
              "prior_bias_info": (p.prior_bias_info, (W, 6))}
    bad = [k for k, (x, s) in shapes.items()
           if x.dtype != f32 or x.device != dev or tuple(x.shape) != s]
    if bad or p.e_valid.dtype != torch.bool or p.e_valid.shape != (W,) or \
            p.e_prev.shape != (W,) or p.e_prev.dtype.is_floating_point or \
            p.e_valid.device != dev or p.e_prev.device != dev:
        raise ValueError(f"vi_edges: needs float32 states and edge tensors "
                         f"of the window's shapes, int e_prev and bool "
                         f"e_valid (W,) on one card (bad: {bad})")
    state = torch.cat([R_wb.reshape(W, 9), p_wb, v, bias], dim=1).contiguous()
    return (state, _edge_consts(p), p.e_prev.to(torch.int32).contiguous(),
            p.e_valid.contiguous())


@record_function("K13 inertial_system")
def inertial_system(p: VIBAProblem, R_wb, p_wb, v, bias, Hpp, bp):
    """K13: `inertial_system_plain`'s function. CUDA tensors: two launches
    of `csrc/vi_edges.cu` (a warp per edge, then a thread per entry of H and
    b); CPU tensors: the plain version."""
    if p_wb.device.type == "cpu":
        return inertial_system_plain(p, R_wb, p_wb, v, bias, Hpp, bp)
    W = p.R_wb.shape[0]
    state, cst, prev, valid = _k13_inputs(p, R_wb, p_wb, v, bias)
    if Hpp.shape != (W, 6, 6) or bp.shape != (W, 6) or \
            Hpp.dtype != torch.float32 or bp.dtype != torch.float32 or \
            Hpp.device != p_wb.device or bp.device != p_wb.device:
        raise ValueError("vi_edges: needs float32 Hpp (W, 6, 6) and bp "
                         "(W, 6) on the window's card")
    Hpp, bp = Hpp.contiguous(), bp.contiguous()
    D = 15 * W
    dev = p_wb.device
    He = torch.empty((W, 30, 30), dtype=torch.float32, device=dev)
    ge = torch.empty((W, 30), dtype=torch.float32, device=dev)
    H = torch.empty((D, D), dtype=torch.float32, device=dev)
    b = torch.empty(D, dtype=torch.float32, device=dev)
    rc = _k13_lib().vi_edges_system(
        state.data_ptr(), cst.data_ptr(), prev.data_ptr(), valid.data_ptr(),
        Hpp.data_ptr(), bp.data_ptr(), W, He.data_ptr(), ge.data_ptr(),
        H.data_ptr(), b.data_ptr(), cuda_build.stream_ptr(p_wb))
    cuda_build.check(rc, "vi_edges_system")
    INERTIAL_LAUNCHES["kernel"] += 1
    return H, b


@record_function("K13 inertial_cost")
def inertial_cost(p: VIBAProblem, R_wb, p_wb, v, bias):
    """K13's cost mode: `inertial_cost_plain`'s function. CUDA tensors: one
    launch (a warp, fixed-order reduction); CPU tensors: the plain
    version."""
    if p_wb.device.type == "cpu":
        return inertial_cost_plain(p, R_wb, p_wb, v, bias)
    state, cst, prev, valid = _k13_inputs(p, R_wb, p_wb, v, bias)
    out = torch.empty((), dtype=torch.float32, device=p_wb.device)
    rc = _k13_lib().vi_edges_cost(
        state.data_ptr(), cst.data_ptr(), prev.data_ptr(), valid.data_ptr(),
        p.R_wb.shape[0], out.data_ptr(), cuda_build.stream_ptr(p_wb))
    cuda_build.check(rc, "vi_edges_cost")
    INERTIAL_LAUNCHES["kernel"] += 1
    return out


def _k13_lib():
    lib = cuda_build.library("vi_edges")
    if lib.vi_edges_system.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.vi_edges_system.argtypes = [P, P, P, P, P, P, I, P, P, P, P, P]
        lib.vi_edges_system.restype = I
        lib.vi_edges_cost.argtypes = [P, P, P, P, I, P, P]
        lib.vi_edges_cost.restype = I
    return lib


def _lm_step(p: VIBAProblem, R_wb, p_wb, v, bias, X, lam,
             vis: ba.BlockSums):
    """One damped LM step of the window system; `vis` holds K4's visual
    blocks at (R_wb, p_wb, X)."""
    W = p.R_wb.shape[0]
    L = p.X.shape[0]
    D = 15 * W
    f32, dev = p.p_wb.dtype, p.p_wb.device
    lm_opt_f = p.lm_opt.to(f32)
    eyeL = torch.eye(3, dtype=f32, device=dev)
    free = _free_mask(p)
    ks = torch.arange(W, device=dev)
    H, b = inertial_system(p, R_wb, p_wb, v, bias, vis.Hpp, vis.bp)

    # landmark Schur complement
    Hll_d = vis.Hll + lam * eyeL * torch.clamp(
        torch.diagonal(vis.Hll, dim1=-2, dim2=-1), min=1e-6)[..., None] * eyeL
    Hll_d = torch.where(p.lm_opt[:, None, None], Hll_d,
                        eyeL.expand(Hll_d.shape))
    bl_m = vis.bl * lm_opt_f[:, None]
    Hll_inv = linalg.inv3x3(Hll_d)
    B = vis.Bt.permute(1, 2, 0, 3).reshape(W * 6, L, 3)
    BC = torch.einsum('mlb,lbc->mlc', B, Hll_inv)
    S_off = BC.reshape(W * 6, L * 3) @ B.reshape(W * 6, L * 3).T
    rhs_off = BC.reshape(W * 6, L * 3) @ bl_m.reshape(L * 3)
    pose_idx = (ks[:, None] * 15 + torch.arange(6, device=dev)[None]
                ).reshape(-1)
    H[pose_idx[:, None], pose_idx[None, :]] -= S_off
    b[pose_idx] -= rhs_off

    # Jacobi scaling + damping + fixing + solve
    H = 0.5 * (H + H.T)
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-8))
    d = torch.where(free > 0, d, torch.ones_like(d))
    Hs = H / d[:, None] / d[None, :] + lam * torch.eye(D, dtype=f32,
                                                         device=dev)
    Hs = Hs * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    bs = (b / d) * free
    dx = (linalg.solve_spd(Hs, bs) / d).reshape(W, 15) * free.reshape(W, 15)

    # back-substitute the landmarks
    Btdxp = torch.einsum('mlc,m->lc', B, dx[:, 0:6].reshape(-1))
    dxl = torch.einsum('lab,lb->la', Hll_inv, bl_m - Btdxp) * \
        lm_opt_f[:, None]
    return (lie.matmat(R_wb, lie.so3_exp(dx[:, 3:6])),
            p_wb + lie.matvec(R_wb, dx[:, 0:3]), v + dx[:, 6:9],
            bias + dx[:, 9:15], X + dxl)


def vi_ba_solve(p: VIBAProblem, n_iters: int = 8, lambda0: float = 1e-3):
    """Visual-inertial LM over the window. Returns (R_wb, p_wb, v, bias, X,
    info) with info["cost0"], info["costs"] (per iteration)."""
    f32, dev = p.p_wb.dtype, p.p_wb.device
    bap = _ba_problem(p)
    order = ba.obs_order(bap) if dev.type == "cuda" else None

    def visual(R_wb, p_wb, X):
        R_cw, t_cw = lie.se3_inv(R_wb, p_wb)
        return ba.assemble(bap, R_cw, t_cw, X, order, body=True)

    state = (p.R_wb, p.p_wb, p.v, p.bias, p.X)
    vis = visual(p.R_wb, p.p_wb, p.X)
    cost0 = cost = _total_cost(p, vis, *state[:4])
    lam = torch.tensor(lambda0, dtype=f32, device=dev)
    costs = []
    for _ in range(n_iters):
        out = _lm_step(p, *state, lam, vis)
        vis_c = visual(out[0], out[1], out[4])
        new_cost = _total_cost(p, vis_c, *out[:4])
        ok = torch.isfinite(new_cost) & (new_cost < cost)
        state = tuple(torch.where(ok, n, o) for n, o in zip(out, state))
        vis = ba._where(ok, vis_c, vis)
        cost = torch.where(ok, new_cost, cost)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 8.0), 1e-9, 1e7)
        costs.append(cost)
    return (*state, {"cost0": cost0, "costs": torch.stack(costs)})


def classify_outliers(p: VIBAProblem, R_wb, p_wb, X):
    """Visual observations kept: chi2 under 5.991 (mono) / 7.815
    (stereo)."""
    _, _, _, _, chi2 = _visual_terms(p, R_wb, p_wb, X, robust=False)
    th = torch.where(torch.isfinite(p.obs_ur), HUBER2_STEREO,
                     HUBER2_MONO).to(chi2.dtype)
    return p.obs_mask & (chi2 < th)


# ---------------------------------------------------------------------------
# per-frame pose-inertial optimization (K12)
# ---------------------------------------------------------------------------

class PoseInertialResult(NamedTuple):
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    v: torch.Tensor
    bias: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    H_marg: torch.Tensor      # (15, 15) marginal information of the state


def _marginal(H_full):
    """Marginalize the anchor out of the 30-dim Hessian."""
    eye = torch.eye(15, dtype=H_full.dtype, device=H_full.device)
    Hac = H_full[:15, 15:]
    sol = torch.linalg.solve_ex(H_full[:15, :15] + 1e-5 * eye, Hac).result
    H_marg = H_full[15:, 15:] - Hac.T @ sol
    return 0.5 * (H_marg + H_marg.T)


def optimize_pose_inertial_plain(R0_cw, t0_cw, v0, bias0, Xw, obs, info,
                                 valid, obs_ur, baseline, R_a_wb, p_a, v_a,
                                 bias_a, e_dt, e_dR, e_dV, e_dP, e_JRg,
                                 e_JVg, e_JVa, e_JPg, e_JPa, e_info, e_bias0,
                                 e_rw_info, n_iters: int = 10):
    """30-dim robust Gauss-Newton over (anchor keyframe state, current
    state) with the anchor fixed: the current frame's visual terms, the
    inertial edge anchor -> current and the bias random walk; 2 rounds of
    `n_iters` steps, each followed by a chi2 reclassification, then the
    final Hessian. Returns the current frame's camera pose, velocity, bias,
    inliers and the (15, 15) marginal information."""
    LAUNCHES["plain"] += 1
    f32, dev = t0_cw.dtype, t0_cw.device
    n = Xw.shape[0]
    chi2_th = torch.where(torch.isfinite(obs_ur), HUBER2_STEREO,
                          HUBER2_MONO).to(f32)
    eye30 = torch.eye(30, dtype=f32, device=dev)
    g = gravity(t0_cw)
    z30 = torch.zeros(30, dtype=f32, device=dev)
    tail = (e_dt, e_dR, e_dV, e_dP, e_JRg, e_JVg, e_JVa, e_JPg, e_JPa,
            e_bias0)
    mask = torch.cat([torch.zeros(15, dtype=f32, device=dev),
                      torch.ones(15, dtype=f32, device=dev)])
    # the frame's observations as a one-keyframe BA problem (K4's terms)
    frame = ba.BAProblem(
        R=R0_cw[None], t=t0_cw[None], X=Xw,
        obs_kf=torch.zeros(n, dtype=torch.int32, device=dev),
        obs_lm=torch.arange(n, dtype=torch.int32, device=dev), obs_uv=obs,
        obs_ur=obs_ur, obs_info=info, obs_mask=valid,
        kf_opt=torch.ones(1, dtype=torch.bool, device=dev),
        lm_opt=torch.zeros(n, dtype=torch.bool, device=dev),
        baseline=baseline)

    def gn_step(Ra, pa, va, ba_, R_wb, p_wb, v, bias, active):
        R_cw, t_cw = lie.se3_inv(R_wb, p_wb)
        r, Jp, _, w, chi2 = ba._obs_terms(frame._replace(obs_mask=active),
                                          R_cw[None], t_cw[None], Xw,
                                          body=True)
        Hv = torch.einsum('nia,n,nib->ab', Jp, w, Jp)
        gv = -torch.einsum('nia,n,ni->a', Jp, w, r)

        def f(x):
            return _edge_residual(x, Ra, pa, va, ba_, R_wb, p_wb, v, *tail,
                                  g)
        re = f(z30)
        Je = jacfwd(f)(z30).to(f32)                          # (9, 30)
        JtW = torch.einsum('ai,ab->bi', Je, e_info)
        H = torch.einsum('bi,bj->ij', JtW, Je)
        gg = -torch.einsum('bi,b->i', JtW, re)
        H[15:21, 15:21] += Hv
        gg[15:21] += gv
        r_rw = bias - ba_
        drw = torch.diag(e_rw_info)
        H[9:15, 9:15] += drw
        H[24:30, 24:30] += drw
        H[9:15, 24:30] -= drw
        H[24:30, 9:15] -= drw
        gg[9:15] += e_rw_info * r_rw
        gg[24:30] += -e_rw_info * r_rw
        H = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        gg = gg * mask
        H = 0.5 * (H + H.T)
        d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-8))
        Hs = H / d[:, None] / d[None, :] + 1e-6 * eye30
        dx = linalg.solve_spd(Hs, gg / d) / d
        xi, xj = dx[:15], dx[15:]
        new = (lie.matmat(Ra, lie.so3_exp(xi[3:6])),
               pa + lie.matvec(Ra, xi[0:3]), va + xi[6:9], ba_ + xi[9:15],
               lie.matmat(R_wb, lie.so3_exp(xj[3:6])),
               p_wb + lie.matvec(R_wb, xj[0:3]), v + xj[6:9],
               bias + xj[9:15])
        return new, chi2, H

    st = (R_a_wb, p_a, v_a, bias_a, *lie.se3_inv(R0_cw, t0_cw), v0, bias0)
    active = valid
    for _ in range(2):
        for _ in range(n_iters):
            st, _, _ = gn_step(*st, active)
        _, chi2, _ = gn_step(*st, active)
        active = valid & (chi2 < chi2_th)
    _, chi2, H_full = gn_step(*st, active)
    inl = valid & (chi2 < chi2_th)
    R_cw, t_cw = lie.se3_inv(*st[4:6])
    return PoseInertialResult(R_cw=R_cw, t_cw=t_cw, v=st[6], bias=st[7],
                              inliers=inl, n_inliers=torch.sum(inl),
                              H_marg=_marginal(H_full))


@record_function("K12 optimize_pose_inertial")
def optimize_pose_inertial(R0_cw, t0_cw, v0, bias0, Xw, obs, info, valid,
                           obs_ur, baseline, R_a_wb, p_a, v_a, bias_a,
                           e_dt, e_dR, e_dV, e_dP, e_JRg, e_JVg, e_JVa,
                           e_JPg, e_JPa, e_info, e_bias0, e_rw_info,
                           n_iters: int = 10):
    """K12: `optimize_pose_inertial_plain`'s function. CUDA tensors: one
    launch for every step and round, then the marginal by torch; CPU
    tensors: the plain version."""
    args = (R0_cw, t0_cw, v0, bias0, Xw, obs, info, valid, obs_ur, baseline,
            R_a_wb, p_a, v_a, bias_a, e_dt, e_dR, e_dV, e_dP, e_JRg, e_JVg,
            e_JVa, e_JPg, e_JPa, e_info, e_bias0, e_rw_info)
    dev = Xw.device
    if dev.type == "cpu":
        return optimize_pose_inertial_plain(*args, n_iters=n_iters)
    if dev.type != "cuda":
        raise ValueError(f"pose_inertial: unsupported device {dev}")
    n = Xw.shape[0]
    f32 = torch.float32
    small = (R0_cw, t0_cw, v0, bias0, R_a_wb, p_a, v_a, bias_a, e_dt, e_dR,
             e_dV, e_dP, e_JRg, e_JVg, e_JVa, e_JPg, e_JPa, e_info, e_bias0,
             e_rw_info, baseline)
    shapes = ((3, 3), (3,), (3,), (6,), (3, 3), (3,), (3,), (6,), (),
              (3, 3), (3,), (3,), (3, 3), (3, 3), (3, 3), (3, 3), (3, 3),
              (9, 9), (6,), (6,), ())
    if any(not torch.is_tensor(x) or x.dtype != f32 or x.device != dev or
           tuple(x.shape) != s for x, s in zip(small, shapes)) or \
            any(x.dtype != f32 or x.device != dev
                for x in (Xw, obs, info, obs_ur)) or \
            valid.dtype != torch.bool or valid.device != dev or \
            Xw.shape != (n, 3) or obs.shape != (n, 2) or \
            info.shape != (n,) or obs_ur.shape != (n,) or \
            valid.shape != (n,) or n_iters < 0:
        raise ValueError("pose_inertial: needs float32 state and edge "
                         "tensors of their shapes, Xw (N, 3), obs "
                         "(N, 2), info / obs_ur (N,) and a bool valid (N,) "
                         "on one card")
    const = torch.cat([x.reshape(-1) for x in small])          # (197,)
    Xw, obs, info, valid, obs_ur = (x.contiguous()
                                    for x in (Xw, obs, info, valid, obs_ur))
    out = torch.empty(21 + 900, dtype=f32, device=dev)
    inl = torch.empty(n, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int64, device=dev)
    rc = _lib().pose_inertial(
        const.data_ptr(), Xw.data_ptr(), obs.data_ptr(), info.data_ptr(),
        valid.data_ptr(), obs_ur.data_ptr(), n, int(n_iters),
        out.data_ptr(), inl.data_ptr(), n_inl.data_ptr(),
        cuda_build.stream_ptr(Xw))
    cuda_build.check(rc, "pose_inertial")
    LAUNCHES["kernel"] += 1
    return PoseInertialResult(R_cw=out[0:9].view(3, 3), t_cw=out[9:12],
                              v=out[12:15], bias=out[15:21], inliers=inl,
                              n_inliers=n_inl,
                              H_marg=_marginal(out[21:].view(30, 30)))


def _lib():
    lib = cuda_build.library("pose_inertial")
    if lib.pose_inertial.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pose_inertial.argtypes = [P, P, P, P, P, P, I, I, P, P, P, P]
        lib.pose_inertial.restype = I
    return lib
