"""Sim(3) / SE(3) pose-graph optimization over the essential graph
(counterpart of `morb_slam_tpu/optim/pose_graph.py`).

Gauss-Newton on the product of Sim(3) node poses with per-edge residuals
r_ij = log(S_ij S_jw S_iw^-1). `fix_scale` freezes every node's scale;
`four_dof` updates nodes on the world side and frees only [tx, ty, tz, yaw].
Each iteration's edge terms and dense (7K, 7K) normal equations are kernel
K15 (`normal_equations`: `csrc/pose_graph.cu` on CUDA tensors, with the
edges sorted by target block once per `optimize` call; on CPU tensors
`normal_equations_plain`, whose 7 x 14 Jacobians come from forward-mode
autodiff at zero tangent, `torch.func` jvp per tangent direction, and whose
blocks are assembled by `index_put_(accumulate=True)`). The masks and the
Cholesky solve are torch, under the profiler range "pose_graph.optimize".
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.func import jvp, vmap
from torch.profiler import record_function

from .. import lie
from ..ops import cuda_build
from . import linalg

LAUNCHES = {"kernel": 0, "plain": 0}


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


def normal_equations_plain(g: PoseGraph, s, R, t, four_dof: bool = False):
    """The normal equations of one Gauss-Newton iteration at the node poses
    (s, R, t): H (7K, 7K) = sum_e J^T w J over the edges' (i,i), (j,j),
    (i,j), (j,i) blocks, b (7K,) = -sum_e J^T w r and the cost
    sum_e w |r|^2 (K15's function)."""
    LAUNCHES["plain"] += 1
    K = g.s.shape[0]
    f32, dev = g.t.dtype, g.t.device
    ei, ej = g.edge_i.long(), g.edge_j.long()
    w = g.edge_w[:, None, None]
    a7 = torch.arange(7, device=dev)
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
    cost = torch.sum(g.edge_w * torch.sum(r * r, dim=-1))
    return H.reshape(7 * K, 7 * K), -b.reshape(7 * K), cost


class BlockOrder(NamedTuple):
    """K15's layout of one graph (fixed across an optimize call): the edges
    of nonzero weight (n,); the touched 7 x 7 blocks blk_row, blk_col (nb,)
    with their contributions in blk_start (nb + 1,); each contribution's
    edge and kind con_edge, con_kind (nc,) (0: (i,i) Ji Ji, 1: (j,j) Jj Jj,
    2: (i,j) Ji Jj, 3: (j,i) Jj Ji), in the plain version's order within a
    block (kind, then edge). All int32."""
    edges: torch.Tensor
    blk_row: torch.Tensor
    blk_col: torch.Tensor
    blk_start: torch.Tensor
    con_edge: torch.Tensor
    con_kind: torch.Tensor


def block_order(g: PoseGraph) -> BlockOrder:
    """Sort the edges' block contributions by target block (one host sync
    for the data-dependent sizes)."""
    K = g.s.shape[0]
    dev = g.t.device
    i32 = torch.int32
    act = torch.nonzero(g.edge_w != 0).reshape(-1)
    ei, ej = g.edge_i.long()[act], g.edge_j.long()[act]
    n = act.shape[0]
    rows = torch.cat([ei, ej, ei, ej])
    cols = torch.cat([ei, ej, ej, ei])
    key, perm = torch.sort(rows * K + cols, stable=True)
    blocks, counts = torch.unique_consecutive(key, return_counts=True)
    start = torch.zeros(blocks.shape[0] + 1, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(counts, 0)
    kind = torch.arange(4, device=dev).repeat_interleave(n)
    return BlockOrder(
        edges=act.to(i32), blk_row=(blocks // K).to(i32),
        blk_col=(blocks % K).to(i32), blk_start=start.to(i32),
        con_edge=act.repeat(4)[perm].to(i32), con_kind=kind[perm].to(i32))


@record_function("K15 normal_equations")
def normal_equations(g: PoseGraph, s, R, t, four_dof: bool = False,
                     order: BlockOrder = None):
    """K15: `normal_equations_plain`'s function. CUDA tensors: one call of
    `csrc/pose_graph.cu` (zero fill, a warp per edge, a warp per touched
    block, the cost), over `order` (`block_order(g)` when not given); CPU
    tensors: the plain version."""
    if t.device.type == "cpu":
        return normal_equations_plain(g, s, R, t, four_dof)
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"pose_graph: unsupported device {dev}")
    K, E = g.s.shape[0], g.edge_i.shape[0]
    f32 = torch.float32
    floats = {"s": (s, (K,)), "R": (R, (K, 3, 3)), "t": (t, (K, 3)),
              "edge_s": (g.edge_s, (E,)), "edge_R": (g.edge_R, (E, 3, 3)),
              "edge_t": (g.edge_t, (E, 3)), "edge_w": (g.edge_w, (E,))}
    bad = [k for k, (x, shp) in floats.items()
           if x.dtype != f32 or x.device != dev or tuple(x.shape) != shp]
    if bad or any(x.dtype != torch.int32 or x.device != dev or
                  x.shape != (E,) for x in (g.edge_i, g.edge_j)):
        raise ValueError(f"pose_graph: needs float32 poses and edges of "
                         f"their shapes and int32 edge_i / edge_j on one "
                         f"card (bad: {bad})")
    if order is None:
        order = block_order(g)
    keep = [x.contiguous() for x in (g.edge_i, g.edge_j, s, R, t, g.edge_s,
                                     g.edge_R, g.edge_t, g.edge_w)]
    D = 7 * K
    J = torch.empty((E, 7, 14), dtype=f32, device=dev)
    r = torch.empty((E, 7), dtype=f32, device=dev)
    H = torch.empty((D, D), dtype=f32, device=dev)
    b = torch.empty(D, dtype=f32, device=dev)
    cost = torch.empty((), dtype=f32, device=dev)
    rc = _lib().pose_graph_normal(
        K, order.edges.shape[0], order.edges.data_ptr(),
        *(x.data_ptr() for x in keep), int(four_dof),
        order.blk_row.shape[0], order.blk_row.data_ptr(),
        order.blk_col.data_ptr(), order.blk_start.data_ptr(),
        order.con_edge.data_ptr(), order.con_kind.data_ptr(), J.data_ptr(),
        r.data_ptr(), H.data_ptr(), b.data_ptr(), cost.data_ptr(),
        cuda_build.stream_ptr(t))
    cuda_build.check(rc, "pose_graph_normal")
    LAUNCHES["kernel"] += 1
    return H, b, cost


def _lib():
    lib = cuda_build.library("pose_graph")
    if lib.pose_graph_normal.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pose_graph_normal.argtypes = [I, I] + [P] * 10 + [I, I] + \
            [P] * 11
        lib.pose_graph_normal.restype = I
    return lib


@record_function("pose_graph.optimize")
def optimize(g: PoseGraph, n_iters: int = 15, fix_scale: bool = False,
             four_dof: bool = False, damping: float = 1e-6):
    """Gauss-Newton essential-graph optimization. Returns (s, R, t, costs)
    with costs (n_iters,) the weighted squared residual before each step."""
    K = g.s.shape[0]
    f32, dev = g.t.dtype, g.t.device
    free_rep = (~g.fixed).to(f32).repeat_interleave(7)
    if four_dof:
        # free: rho (0..2) and world yaw (5); roll / pitch and scale frozen
        dmask = torch.tensor([1, 1, 1, 0, 0, 1, 0], dtype=f32, device=dev)
    elif fix_scale:
        dmask = torch.tensor([1.0] * 6 + [0.0], dtype=f32, device=dev)
    else:
        dmask = None
    eye = torch.eye(7 * K, dtype=f32, device=dev)
    order = block_order(g) if dev.type == "cuda" else None
    s, R, t = g.s, g.R, g.t
    costs = []
    for _ in range(n_iters):
        Hd, bd, cost = normal_equations(g, s, R, t, four_dof, order)
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
        costs.append(cost)
    return s, R, t, torch.stack(costs)
