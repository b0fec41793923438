"""Inertial optimization: the per-keyframe preintegration store, IMU
initialization (scale, gravity, biases, velocities) and the map gauge
change (counterpart of `morb_slam_tpu/optim/inertial.py`).

`inertial_only_optimize` is Gauss-Newton over {gravity direction (2), log
scale, bg, ba, v_0..v_K} with poses fixed. Its system at each point is
kernel K17 (`inertial_system`): on CUDA tensors `csrc/inertial_init.cu`,
on CPU tensors `inertial_system_plain`, whose per-edge Jacobian over the
15 parameters an edge touches is forward-mode autodiff. The damping, the
dense solve and the accept test are plain PyTorch on the device.
`linear_alignment` is the closed-form initial estimate, plain PyTorch.
Body frame == camera frame at this layer.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.profiler import record_function

from .. import dual
from .. import imu as imu_mod
from .. import lie
from ..ops import cuda_build
from ..tensor_ops import einsum

G = 9.81


class KfImu(NamedTuple):
    """Per-keyframe preintegration from the previous keyframe (index-aligned
    with the map's keyframes; entry k covers prev(k) -> k).

    valid (K,) bool; prev (K,) int32; dt (K,); dR (K, 3, 3); dV, dP (K, 3);
    J_Rg, J_Vg, J_Va, J_Pg, J_Pa (K, 3, 3); info (K, 9, 9) information of
    [r_R, r_v, r_p]; bias0 (K, 6) integration bias; rw_info (K, 6) diagonal
    information of the bias random walk over the edge."""
    valid: torch.Tensor
    prev: torch.Tensor
    dt: torch.Tensor
    dR: torch.Tensor
    dV: torch.Tensor
    dP: torch.Tensor
    J_Rg: torch.Tensor
    J_Vg: torch.Tensor
    J_Va: torch.Tensor
    J_Pg: torch.Tensor
    J_Pa: torch.Tensor
    info: torch.Tensor
    bias0: torch.Tensor
    rw_info: torch.Tensor


def empty_kf_imu(max_kf: int, device="cpu") -> KfImu:
    f32 = torch.float32

    def z(*shape):
        return torch.zeros(shape, dtype=f32, device=device)
    eye3 = torch.eye(3, dtype=f32, device=device).expand(max_kf, 3, 3)
    return KfImu(valid=torch.zeros(max_kf, dtype=torch.bool, device=device),
                 prev=torch.full((max_kf,), -1, dtype=torch.int32,
                                 device=device),
                 dt=z(max_kf), dR=eye3.clone(), dV=z(max_kf, 3),
                 dP=z(max_kf, 3), J_Rg=z(max_kf, 3, 3), J_Vg=z(max_kf, 3, 3),
                 J_Va=z(max_kf, 3, 3), J_Pg=z(max_kf, 3, 3),
                 J_Pa=z(max_kf, 3, 3),
                 info=torch.eye(9, dtype=f32, device=device).expand(
                     max_kf, 9, 9).clone(),
                 bias0=z(max_kf, 6),
                 rw_info=torch.ones((max_kf, 6), dtype=f32, device=device))


def _set_row(x, k: int, v):
    x = x.clone()
    x[k] = v
    return x


def edge_info(pre: imu_mod.Preintegrated):
    """(info (9, 9), rw (6,)) of one preintegration: the inverse of its
    [dR, dV, dP] covariance (+1e-9 I, symmetrized) and the inverse random
    walk variances. `inv_ex`: the checked inverse syncs the host."""
    eye9 = torch.eye(9, dtype=pre.C.dtype, device=pre.C.device)
    info = torch.linalg.inv_ex(pre.C[:9, :9] + 1e-9 * eye9).inverse
    info = 0.5 * (info + info.T)
    rw = 1.0 / torch.clamp(torch.diagonal(pre.C[9:, 9:]), min=1e-12)
    return info, rw


def set_kf_imu(ki: KfImu, k: int, pre: imu_mod.Preintegrated,
               prev: int) -> KfImu:
    info, rw = edge_info(pre)
    return ki._replace(
        valid=_set_row(ki.valid, k, pre.dt > 1e-6),
        prev=_set_row(ki.prev, k, int(prev)),
        dt=_set_row(ki.dt, k, pre.dt), dR=_set_row(ki.dR, k, pre.dR),
        dV=_set_row(ki.dV, k, pre.dV), dP=_set_row(ki.dP, k, pre.dP),
        J_Rg=_set_row(ki.J_Rg, k, pre.J_Rg),
        J_Vg=_set_row(ki.J_Vg, k, pre.J_Vg),
        J_Va=_set_row(ki.J_Va, k, pre.J_Va),
        J_Pg=_set_row(ki.J_Pg, k, pre.J_Pg),
        J_Pa=_set_row(ki.J_Pa, k, pre.J_Pa),
        info=_set_row(ki.info, k, info),
        bias0=_set_row(ki.bias0, k, pre.bias),
        rw_info=_set_row(ki.rw_info, k, rw))


def splice_kf_imu(dst: KfImu, src: KfImu, off: int, n: int) -> KfImu:
    """Copy src's first `n` entries into dst at offset `off`, prev links
    shifted by +off."""
    K = dst.valid.shape[0]
    idx = torch.arange(K, device=dst.valid.device)
    take = (idx >= off) & (idx < off + n)
    s = torch.clamp(idx - off, 0, src.valid.shape[0] - 1)
    out = {}
    for name in KfImu._fields:
        d = getattr(dst, name)
        a = getattr(src, name)[s]
        if name == "prev":
            a = torch.where(a >= 0, a + off, torch.full_like(a, -1))
        out[name] = torch.where(take.reshape((K,) + (1,) * (d.dim() - 1)),
                                a, d)
    return KfImu(**out)


def _block3(rows):
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def compose_preintegration(dt1, dR1, dV1, dP1, J1, info1, rw1,
                           dt2, dR2, dV2, dP2, J2, info2, rw2):
    """Compose consecutive preintegration blocks 1 (i->j) and 2 (j->k) into
    one (i->k) in closed form; J1 / J2 are dicts with Rg / Vg / Va / Pg /
    Pa (small-rotation approximation in the bias cross terms)."""
    dt = dt1 + dt2
    dR = lie.matmat(dR1, dR2)
    dV = dV1 + lie.matvec(dR1, dV2)
    dP = dP1 + dV1 * dt2 + lie.matvec(dR1, dP2)
    dR2T = dR2.transpose(-1, -2)
    hV2 = lie.so3_hat(dV2)
    hP2 = lie.so3_hat(dP2)
    J = {
        "Rg": lie.matmat(dR2T, J1["Rg"]) + J2["Rg"],
        "Va": J1["Va"] + lie.matmat(dR1, J2["Va"]),
        "Vg": (J1["Vg"] + lie.matmat(dR1, J2["Vg"])
               - lie.matmat(dR1, lie.matmat(hV2, J1["Rg"]))),
        "Pa": J1["Pa"] + J1["Va"] * dt2 + lie.matmat(dR1, J2["Pa"]),
        "Pg": (J1["Pg"] + J1["Vg"] * dt2 + lie.matmat(dR1, J2["Pg"])
               - lie.matmat(dR1, lie.matmat(hP2, J1["Rg"]))),
    }
    f32, dev = dR1.dtype, dR1.device
    eye3 = torch.eye(3, dtype=f32, device=dev)
    z3 = torch.zeros((3, 3), dtype=f32, device=dev)
    A = _block3([[dR2T, z3, z3],
                 [-lie.matmat(dR1, hV2), eye3, z3],
                 [-lie.matmat(dR1, hP2), dt2 * eye3, eye3]])
    T = _block3([[eye3, z3, z3], [z3, dR1, z3], [z3, z3, dR1]])
    eps = 1e-9 * torch.eye(9, dtype=f32, device=dev)
    C1 = torch.linalg.inv_ex(info1 + eps).inverse
    C2 = torch.linalg.inv_ex(info2 + eps).inverse
    C = (einsum('ab,bc,dc->ad', A, C1, A)
         + einsum('ab,bc,dc->ad', T, C2, T))
    info = torch.linalg.inv_ex(C + eps).inverse
    info = 0.5 * (info + info.T)
    rw = 1.0 / (1.0 / torch.clamp(rw1, min=1e-12)
                + 1.0 / torch.clamp(rw2, min=1e-12))
    return dt, dR, dV, dP, J, info, rw


def _jac(ki: KfImu, k):
    return {"Rg": ki.J_Rg[k], "Vg": ki.J_Vg[k], "Va": ki.J_Va[k],
            "Pg": ki.J_Pg[k], "Pa": ki.J_Pa[k]}


def merge_entry_into_next(ki: KfImu, k, nxt) -> KfImu:
    """Merge entry `k` (prev(k) -> k) into entry `nxt` (k -> nxt); entry k
    becomes invalid. `k`, `nxt` may be device scalars."""
    dt, dR, dV, dP, J, info, rw = compose_preintegration(
        ki.dt[k], ki.dR[k], ki.dV[k], ki.dP[k], _jac(ki, k), ki.info[k],
        ki.rw_info[k], ki.dt[nxt], ki.dR[nxt], ki.dV[nxt], ki.dP[nxt],
        _jac(ki, nxt), ki.info[nxt], ki.rw_info[nxt])
    K = ki.valid.shape[0]
    ar = torch.arange(K, device=ki.valid.device)
    at_k, at_n = ar == k, ar == nxt

    def setn(x, v):
        return torch.where(at_n.reshape((K,) + (1,) * (x.dim() - 1)),
                           v.to(x.dtype), x)
    return ki._replace(
        valid=ki.valid & ~at_k,
        prev=setn(ki.prev, ki.prev[k]),
        dt=setn(ki.dt, dt), dR=setn(ki.dR, dR), dV=setn(ki.dV, dV),
        dP=setn(ki.dP, dP), J_Rg=setn(ki.J_Rg, J["Rg"]),
        J_Vg=setn(ki.J_Vg, J["Vg"]), J_Va=setn(ki.J_Va, J["Va"]),
        J_Pg=setn(ki.J_Pg, J["Pg"]), J_Pa=setn(ki.J_Pa, J["Pa"]),
        info=setn(ki.info, info), rw_info=setn(ki.rw_info, rw))


def linear_alignment(ki: KfImu, R_wb, p_wb, kf_valid):
    """Closed-form visual-inertial alignment: s dp_vis = v_i dt + g dt^2 / 2
    + R_i dP and v_j = v_i + g dt + R_i dV are linear in (s, g, v_0..v_K);
    one least-squares solve. Returns (s, g_vis (3,), v (K, 3), rms)."""
    K = R_wb.shape[0]
    f32, dev = R_wb.dtype, R_wb.device
    prev = torch.clamp(ki.prev, min=0).long()
    w = (ki.valid & kf_valid & kf_valid[prev]).to(f32)
    dt = ki.dt
    dp = p_wb - p_wb[prev]
    Ri = R_wb[prev]
    RdP = lie.matvec(Ri, ki.dP)
    RdV = lie.matvec(Ri, ki.dV)
    n = 4 + 3 * K
    ks = torch.arange(K, device=dev)
    r3 = torch.arange(3, device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    Ap = torch.zeros((K, 3, n), dtype=f32, device=dev)
    Ap[:, :, 0] = dp
    Ap[:, :, 1:4] = -0.5 * (dt ** 2)[:, None, None] * eye3
    Ap[ks[:, None], r3[None, :], 4 + 3 * prev[:, None] + r3[None, :]] = \
        -dt[:, None].expand(K, 3)
    Av = torch.zeros((K, 3, n), dtype=f32, device=dev)
    Av[:, :, 1:4] = -dt[:, None, None] * eye3
    Av[ks[:, None], r3[None, :], 4 + 3 * prev[:, None] + r3[None, :]] = -1.0
    Av[ks[:, None], r3[None, :], 4 + 3 * ks[:, None] + r3[None, :]] = 1.0
    wk = w[:, None, None]
    A = torch.cat([(Ap * wk).reshape(-1, n), (Av * wk).reshape(-1, n)])
    b = torch.cat([(RdP * w[:, None]).reshape(-1),
                   (RdV * w[:, None]).reshape(-1)])
    AtA = A.T @ A + 1e-6 * torch.eye(n, dtype=f32, device=dev)
    x = torch.linalg.solve_ex(AtA, A.T @ b).result
    r = A @ x - b
    rms = torch.sqrt(torch.sum(r * r) / torch.clamp(torch.sum(w) * 6.0,
                                                    min=1.0))
    return x[0], x[1:4], x[4:].reshape(K, 3), rms


def gravity_rotation(g_vis):
    """R_wg with R_wg (0, 0, -9.81) ~ g_vis."""
    g0 = torch.zeros(3, dtype=g_vis.dtype, device=g_vis.device)
    g0[2] = -1.0
    gn = g_vis / torch.clamp(torch.linalg.norm(g_vis), min=1e-9)
    axis = torch.linalg.cross(g0, gn)
    sin = torch.clamp(torch.linalg.norm(axis), 0.0, 1.0)
    cos = torch.dot(g0, gn)
    ang = torch.atan2(sin, cos)
    small = sin < 1e-8
    axis = axis / torch.where(small, torch.ones_like(sin), sin)
    ex = torch.zeros_like(axis)
    ex[0] = 1.0
    axis = torch.where(small, ex, axis)
    return lie.so3_exp(axis * ang)


# per-slot constants packed for K17 (csrc/inertial_init.cu reads this
# layout): dt, dR, dV, dP, J_Rg, J_Vg, J_Va, J_Pg, J_Pa, bias0, the
# effective information and the edge weight
_PACK = ("dt", "dR", "dV", "dP", "J_Rg", "J_Vg", "J_Va", "J_Pg", "J_Pa",
         "bias0")
N_INIT_CONST = 149

INIT_LAUNCHES = {"kernel": 0, "plain": 0}


class InitProblem(NamedTuple):
    """One `inertial_only_optimize` problem with the poses fixed: the
    preintegration store, the visual poses, each slot's effective
    information (the noise floor added to its covariance) and edge weight
    w (valid, with both keyframes valid), the gravity base rotation, the
    bias prior weights and whether the scale is free; `cst` packs the
    per-slot constants for K17."""
    ki: KfImu
    R_wb: torch.Tensor
    p_wb: torch.Tensor
    info_eff: torch.Tensor
    w: torch.Tensor
    base: torch.Tensor
    opt_scale: bool
    prior_gyro: float
    prior_acc: float
    cst: torch.Tensor


def init_problem(ki: KfImu, R_wb, p_wb, kf_valid, opt_scale: bool = True,
                 prior_gyro: float = 1e2, prior_acc: float = 1e6,
                 R_wg0=None) -> InitProblem:
    K = R_wb.shape[0]
    f32, dev = R_wb.dtype, R_wb.device
    w = (ki.valid & kf_valid
         & kf_valid[torch.clamp(ki.prev, min=0).long()]).to(f32)
    # noise floor: the visual poses in the residuals carry their own error
    # (and early monocular maps drift in scale); without it the raw
    # preintegration information lets those errors collapse the scale
    floor = torch.diag(torch.tensor([9e-6] * 3 + [1e-4] * 3 + [2.5e-5] * 3,
                                    dtype=f32)).to(dev)
    cov_eff = torch.linalg.inv_ex(ki.info).inverse + floor[None]
    info_eff = torch.linalg.inv_ex(cov_eff).inverse
    info_eff = 0.5 * (info_eff + info_eff.transpose(-1, -2))
    base = torch.eye(3, dtype=f32, device=dev) if R_wg0 is None else R_wg0
    cst = torch.cat([getattr(ki, n).reshape(K, -1).to(f32) for n in _PACK]
                    + [info_eff.reshape(K, 81), w[:, None]], dim=1)
    return InitProblem(ki, R_wb, p_wb, info_eff, w, base, bool(opt_scale),
                       float(prior_gyro), float(prior_acc), cst)


def _residuals(ki: KfImu, R_wb, pi, pj, vi, vj, bg, ba, g_w):
    """(K, 9) [r_R, r_v, r_p] of every keyframe pair (zero where the entry
    is invalid): the bias-corrected preintegration (biases bg, ba) against
    the positions pi, pj and velocities vi, vj of each pair's ends, under
    gravity g_w; each argument (K, 3) or broadcast to it."""
    prev = torch.clamp(ki.prev, min=0).long()
    dbg = bg - ki.bias0[:, :3]
    dba = ba - ki.bias0[:, 3:]
    dR = lie.matmat(ki.dR, lie.so3_exp(lie.matvec(ki.J_Rg, dbg)))
    dV = ki.dV + lie.matvec(ki.J_Vg, dbg) + lie.matvec(ki.J_Va, dba)
    dP = ki.dP + lie.matvec(ki.J_Pg, dbg) + lie.matvec(ki.J_Pa, dba)
    Ri, Rj = R_wb[prev], R_wb
    dt = ki.dt[:, None]
    RiT = Ri.transpose(-1, -2)
    r_R = lie.so3_log(lie.matmat(dR.transpose(-1, -2), lie.matmat(RiT, Rj)))
    r_v = lie.matvec(RiT, vj - vi - g_w * dt) - dV
    r_p = lie.matvec(RiT, pj - pi - vi * dt - 0.5 * g_w * dt * dt) - dP
    r = torch.cat([r_R, r_v, r_p], dim=-1)
    return torch.where(ki.valid[:, None], r, torch.zeros_like(r))


def inertial_residuals(ki: KfImu, R_wb, p_wb, v, bg, ba, g_world, scale):
    """9-dim preintegration residuals of every keyframe pair (the reference
    package's `inertial_residuals`): R_wb (K, 3, 3) body-to-world, p_wb
    (K, 3) the visual map's body positions (scaled by `scale` here), v
    (K, 3), the biases bg, ba (3,) and gravity g_world (3,)."""
    prev = torch.clamp(ki.prev, min=0).long()
    return _residuals(ki, R_wb, p_wb[prev] * scale, p_wb * scale, v[prev], v,
                      bg[None, :], ba[None, :], g_world[None, :])


def _edge_residuals(p: InitProblem, XL):
    """(K, 9) residual of every keyframe pair at its 15 local parameters
    XL (K, 15) = [phi_g (2), log s, bg (3), ba (3), v_prev (3), v_k (3)]
    (zero where the entry is invalid): `inertial_residuals` with the
    globals per edge."""
    ki = p.ki
    K = XL.shape[0]
    f32, dev = XL.dtype, XL.device
    prev = torch.clamp(ki.prev, min=0).long()
    phi = torch.cat([XL[:, :2], torch.zeros((K, 1), dtype=f32, device=dev)],
                    dim=1)
    R_wg = lie.matmat(lie.so3_exp(phi), p.base[None])
    g0 = torch.zeros((1, 3), dtype=f32, device=dev)
    g0[0, 2] = -G
    g_w = lie.matvec(R_wg, g0)
    s = torch.exp(XL[:, 2:3]) if p.opt_scale else \
        torch.ones((K, 1), dtype=f32, device=dev)
    return _residuals(ki, p.R_wb, p.p_wb[prev] * s, p.p_wb * s, XL[:, 9:12],
                      XL[:, 12:15], XL[:, 3:6], XL[:, 6:9], g_w)


def _local_index(p: InitProblem):
    """(K, 15) column of each edge's local parameter in the global x."""
    K = p.w.shape[0]
    dev = p.w.device
    prev = torch.clamp(p.ki.prev, min=0).long()
    r3 = torch.arange(3, device=dev)
    return torch.cat([torch.arange(9, device=dev).expand(K, 9),
                      9 + 3 * prev[:, None] + r3,
                      9 + 3 * torch.arange(K, device=dev)[:, None] + r3],
                     dim=1)


def _edge_terms(p: InitProblem, x):
    """Each edge's residual r (K, 9) at x (n_par,), its Jacobian J (K, 9,
    15) over its 15 local columns by forward mode along each, and its
    weight w_k Omega_k (K, 9, 9)."""
    K = p.w.shape[0]
    f32, dev = x.dtype, x.device
    prev = torch.clamp(p.ki.prev, min=0).long()
    v = x[9:].reshape(K, 3)
    XL = torch.cat([x[:9].expand(K, 9), v[prev], v], dim=1)
    # the 15 jvps along each local column at once (dual.jvp: torch.func.jvp's
    # values and dtypes, without its per-operation dispatch)
    eye = torch.eye(15, dtype=f32, device=dev)
    r, J = dual.jvp(lambda xl: _edge_residuals(p, xl), XL,
                    eye[:, None].expand(15, K, 15))
    return r, J.movedim(0, -1).to(f32), p.info_eff * p.w[:, None, None]


def _assemble(p: InitProblem, r, J, W, x):
    """(H, g, cost) of the edge terms scattered into the n_par system,
    plus the bias priors at x."""
    K = p.w.shape[0]
    n = 9 + 3 * K
    f32, dev = x.dtype, x.device
    idx = _local_index(p)
    sg = torch.tensor([0.0] * 3 + [p.prior_gyro] * 3 + [p.prior_acc] * 3,
                      dtype=f32, device=dev)
    He = einsum('kap,kab,kbq->kpq', J, W, J)
    ge = einsum('kap,kab,kb->kp', J, W, r)
    H = torch.zeros((n, n), dtype=f32, device=dev).index_put_(
        (idx[:, :, None], idx[:, None, :]), He, accumulate=True)
    g = torch.zeros(n, dtype=f32, device=dev).index_put_(
        (idx,), ge, accumulate=True)
    ar9 = torch.arange(9, device=dev)
    H[ar9, ar9] += sg
    g[:9] += sg * x[:9]
    cost = torch.sum(einsum('ka,kab,kb->k', r, W, r)) + \
        torch.sum(sg * x[:9] * x[:9])
    return H, g, cost


def inertial_system_plain(p: InitProblem, x):
    """Plain version of K17: the Gauss-Newton system of the IMU
    initialization at x (n_par,): H = sum_k w_k J_k^T Omega_k J_k plus the
    bias priors, g = sum_k w_k J_k^T Omega_k r_k plus the priors' gradient
    and the cost sum_k w_k r_k^T Omega_k r_k plus the priors. Each edge's
    Jacobian has 15 columns (the 9 globals, v_prev and v_k). Returns (H
    (n_par, n_par), g (n_par,), cost ())."""
    INIT_LAUNCHES["plain"] += 1
    return _assemble(p, *_edge_terms(p, x), x)


def inertial_system(p: InitProblem, x):
    """K17: `inertial_system_plain(p, x)` (H, g, cost). CUDA tensors: the
    kernel (raises if it cannot run); CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return inertial_system_plain(p, x)
    if x.device.type != "cuda":
        raise ValueError(f"inertial_system: unsupported device {x.device}")
    K = p.w.shape[0]
    n = 9 + 3 * K
    f32 = torch.float32
    ins = [(p.cst, (K, N_INIT_CONST)), (p.R_wb, (K, 3, 3)),
           (p.p_wb, (K, 3)), (x, (n,)), (p.base, (3, 3))]
    if any(t.dtype != f32 or tuple(t.shape) != s or t.device != x.device
           for t, s in ins) or \
            p.ki.prev.dtype != torch.int32 or p.ki.prev.shape != (K,) or \
            p.ki.prev.device != x.device or K == 0:
        raise ValueError("inertial_system: needs float32 constants "
                         "(K, 149), poses (K, 3, 3), (K, 3), x (9 + 3K,) "
                         "and int32 prev (K,) on one device")
    ins = [t.contiguous() for t, _ in ins] + [p.ki.prev.contiguous()]
    dev = x.device
    He = torch.empty((K, 15, 15), dtype=f32, device=dev)
    ge = torch.empty((K, 15), dtype=f32, device=dev)
    ce = torch.empty(K, dtype=f32, device=dev)
    H = torch.empty((n, n), dtype=f32, device=dev)
    g = torch.empty(n, dtype=f32, device=dev)
    cost = torch.empty((), dtype=f32, device=dev)
    rc = _init_lib().inertial_init_system(
        *(t.data_ptr() for t in ins), K, int(p.opt_scale), p.prior_gyro,
        p.prior_acc, He.data_ptr(), ge.data_ptr(), ce.data_ptr(),
        H.data_ptr(), g.data_ptr(), cost.data_ptr(),
        cuda_build.stream_ptr(x))
    cuda_build.check(rc, "inertial_init")
    INIT_LAUNCHES["kernel"] += 1
    return H, g, cost


def _init_lib():
    lib = cuda_build.library("inertial_init")
    if lib.inertial_init_system.argtypes is None:
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.inertial_init_system.argtypes = [P] * 6 + [I, I, Fl, Fl] + \
            [P] * 7
        lib.inertial_init_system.restype = I
    return lib


@record_function("inertial_only_optimize")
def inertial_only_optimize(ki: KfImu, R_wb, p_wb, kf_valid,
                           n_iters: int = 30, opt_scale: bool = True,
                           prior_gyro: float = 1e2, prior_acc: float = 1e6,
                           s0=1.0, v0=None, R_wg0=None):
    """Gravity direction, scale, biases and velocities with poses fixed,
    by damped Gauss-Newton with accept / reject. The system at each point
    is K17 (`inertial_system`); the damping, the solve and the accept test
    stay on the device without a host read. Returns (R_wg, scale, bg, ba,
    v (K, 3), per-iteration mean chi2 per residual dimension)."""
    K = R_wb.shape[0]
    f32, dev = R_wb.dtype, R_wb.device
    n_par = 9 + 3 * K
    p = init_problem(ki, R_wb, p_wb, kf_valid, opt_scale, prior_gyro,
                     prior_acc, R_wg0)
    eye_n = torch.eye(n_par, dtype=f32, device=dev)
    x = torch.zeros(n_par, dtype=f32, device=dev)
    x[2] = torch.log(torch.as_tensor(s0, dtype=f32, device=dev))
    if v0 is not None:
        x[9:] = v0.reshape(-1)
    lam = torch.tensor(1e-2, dtype=f32, device=dev)
    # the system at the current point carries over a rejected step: the
    # next step damps the same H and g more strongly
    H, g, cost = inertial_system(p, x)
    costs = []
    for _ in range(n_iters):
        Hd = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-8)) \
            + 1e-4 * eye_n
        gd = g
        if not opt_scale:
            Hd[2, :] = 0.0
            Hd[:, 2] = 0.0
            Hd[2, 2] = 1.0
            gd = g.clone()
            gd[2] = 0.0
        x_new = x - torch.linalg.solve_ex(Hd, gd).result
        H_new, g_new, new_cost = inertial_system(p, x_new)
        accept = new_cost < cost
        x = torch.where(accept, x_new, x)
        H = torch.where(accept, H_new, H)
        g = torch.where(accept, g_new, g)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0),
                          1e-9, 1e6)
        costs.append(cost)
    R_wg = lie.matmat(lie.so3_exp(torch.cat([x[:2], x.new_zeros(1)])),
                      p.base)
    s = torch.exp(x[2]) if opt_scale else torch.ones((), dtype=f32,
                                                     device=dev)
    n_edges = torch.clamp(torch.sum(p.w), min=1.0)
    return (R_wg, s, x[3:6], x[6:9], x[9:].reshape(K, 3),
            torch.stack(costs) / (9.0 * n_edges))


def apply_gauge(kf_R, kf_t, lm_pos, v, R_wg, scale):
    """Rotate the world so gravity is -z and rescale to metric: R' = R R_wg,
    t' = s t, X' = s R_gw X, v' = R_gw v. Returns (kf_R', kf_t', lm', v')."""
    R_gw = R_wg.T
    return (lie.matmat(kf_R, R_wg[None]), kf_t * scale,
            scale * lie.matvec(R_gw[None], lm_pos),
            lie.matvec(R_gw[None], v))
