"""Sim(3) / SE(3) pose-graph optimization over the essential graph
(counterpart of `morb_slam_tpu/optim/pose_graph.py`).

Gauss-Newton on the product of Sim(3) node poses with per-edge residuals
r_ij = log(S_ij S_jw S_iw^-1). Each edge's 7 x 14 Jacobian comes from
forward-mode autodiff at zero tangent (`torch.func` jvp per tangent
direction), the dense
(7K, 7K) normal equations are assembled by `index_put_(accumulate=True)` and
solved by Cholesky. `fix_scale` freezes every node's scale; `four_dof`
updates nodes on the world side and frees only [tx, ty, tz, yaw]. Plain
PyTorch under the profiler range "pose_graph.optimize".
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap
from torch.profiler import record_function

from .. import lie
from . import linalg


class PoseGraph(NamedTuple):
    """Node poses s (K,), R (K, 3, 3), t (K, 3) (S_iw, world -> keyframe);
    edges edge_i, edge_j (E,) int32 with measured S_ij (edge_s, edge_R,
    edge_t: j's frame -> i's frame) and weight edge_w (E,) (0 = padding);
    fixed (K,) bool nodes held constant."""
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_s: torch.Tensor
    edge_R: torch.Tensor
    edge_t: torch.Tensor
    edge_w: torch.Tensor
    fixed: torch.Tensor


def relative_sim3(s_i, R_i, t_i, s_j, R_j, t_j):
    """S_ij = S_iw S_jw^-1."""
    return lie.sim3_mul(s_i, R_i, t_i, *lie.sim3_inv(s_j, R_j, t_j))


def _edge_residual(xi_i, xi_j, Si, Sj, Sij, world_side: bool = False):
    """r = log(S_ij S_jw' S_iw'^-1) (7,), with S' = exp(xi) S (camera side)
    or S exp(xi) (world side, the 4-DoF graph's parametrization)."""
    ds_i, dR_i, dt_i = lie.sim3_exp(xi_i)
    ds_j, dR_j, dt_j = lie.sim3_exp(xi_j)
    if world_side:
        a = lie.sim3_mul(*Sj, ds_j, dR_j, dt_j)
        b = lie.sim3_mul(*Si, ds_i, dR_i, dt_i)
    else:
        a = lie.sim3_mul(ds_j, dR_j, dt_j, *Sj)
        b = lie.sim3_mul(ds_i, dR_i, dt_i, *Si)
    c = lie.sim3_mul(*Sij, *a)
    d = lie.sim3_mul(*c, *lie.sim3_inv(*b))
    return lie.sim3_log(*d)


def edge_terms(Si, Sj, Sij, world_side: bool = False):
    """Residuals (E, 7) and Jacobians (E, 7, 14) of every edge at zero
    tangent; Si, Sj, Sij are (s, R, t) tuples batched over the edges.

    The Jacobian is jacfwd's construction (a jvp per tangent direction,
    vmapped over the 14 directions) with the edges as the batch of one
    primal: under a vmap over the edges each edge's scalars are 0-dim,
    and torch's forward mode then carries their tangents in float64, which
    `linalg.solve`'s forward rule in `sim3_log` refuses."""
    E = Si[0].shape[0]
    f32 = Si[2].dtype
    z = torch.zeros((E, 14), dtype=f32, device=Si[2].device)

    def f(x):
        return _edge_residual(x[:, :7], x[:, 7:], Si, Sj, Sij, world_side)
    basis = torch.eye(14, dtype=f32, device=z.device)[:, None, :] \
        .expand(14, E, 14)
    J = vmap(lambda v: jvp(f, (z,), (v,))[1], out_dims=-1)(basis)
    return f(z), J.to(f32)


@record_function("pose_graph.optimize")
def optimize(g: PoseGraph, n_iters: int = 15, fix_scale: bool = False,
             four_dof: bool = False, damping: float = 1e-6):
    """Gauss-Newton essential-graph optimization. Returns (s, R, t, costs)
    with costs (n_iters,) the weighted squared residual before each step."""
    K = g.s.shape[0]
    f32, dev = g.t.dtype, g.t.device
    ei, ej = g.edge_i.long(), g.edge_j.long()
    free_rep = (~g.fixed).to(f32).repeat_interleave(7)
    if four_dof:
        # free: rho (0..2) and world yaw (5); roll / pitch and scale frozen
        dmask = torch.tensor([1, 1, 1, 0, 0, 1, 0], dtype=f32, device=dev)
    elif fix_scale:
        dmask = torch.tensor([1.0] * 6 + [0.0], dtype=f32, device=dev)
    else:
        dmask = None
    eye = torch.eye(7 * K, dtype=f32, device=dev)
    w = g.edge_w[:, None, None]
    a7 = torch.arange(7, device=dev)
    s, R, t = g.s, g.R, g.t
    costs = []
    for _ in range(n_iters):
        r, J = edge_terms((s[ei], R[ei], t[ei]), (s[ej], R[ej], t[ej]),
                          (g.edge_s, g.edge_R, g.edge_t), four_dof)
        Ji, Jj = J[:, :, :7], J[:, :, 7:]
        H = torch.zeros((K, 7, K, 7), dtype=f32, device=dev)
        for (ra, ca, A, B) in ((ei, ei, Ji, Ji), (ej, ej, Jj, Jj),
                               (ei, ej, Ji, Jj), (ej, ei, Jj, Ji)):
            blk = torch.einsum('eai,eaj->eij', A * w, B)
            H.index_put_((ra[:, None, None], a7[None, :, None],
                          ca[:, None, None], a7[None, None, :]), blk,
                         accumulate=True)
        b = torch.zeros((K, 7), dtype=f32, device=dev)
        b.index_add_(0, ei, torch.einsum('eai,ea->ei', Ji * w, r))
        b.index_add_(0, ej, torch.einsum('eai,ea->ei', Jj * w, r))
        Hd = H.reshape(7 * K, 7 * K)
        bd = -b.reshape(7 * K)
        Hd = Hd * free_rep[:, None] * free_rep[None, :] + \
            torch.diag(1.0 - free_rep)
        bd = bd * free_rep
        if dmask is not None:
            sc = dmask.repeat(K)
            Hd = Hd * sc[:, None] * sc[None, :] + torch.diag(1.0 - sc)
            bd = bd * sc
        dx = linalg.solve_spd(Hd + damping * eye, bd).reshape(K, 7)
        ds, dR, dt = lie.sim3_exp(dx)
        if four_dof:
            s, R, t = lie.sim3_mul(s, R, t, ds, dR, dt)
        else:
            s, R, t = lie.sim3_mul(ds, dR, dt, s, R, t)
        costs.append(torch.sum(g.edge_w * torch.sum(r * r, dim=-1)))
    return s, R, t, torch.stack(costs)
