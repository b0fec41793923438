"""Multi-device bundle adjustment over `torch.distributed` (counterpart of
`morb_slam_tpu/parallel/sharded_ba.py`).

The reference runs these solvers as `shard_map` programs over a 1-D mesh
whose axis is OBS_AXIS. Here every rank of a 1-D `DeviceMesh` holds the
whole problem, as a replicated array, and takes its own contiguous block
of the sharded arrays (the observations; the landmarks too in the
landmark-sharded form); a `psum` is an `all_reduce` over the mesh's group.
Every rank ends with the same R, t and X and an `info` dict with the
reference's keys. Sums taken across ranks run in another order than on one
device, so the results equal the single-device solvers' to rounding, not
bit for bit.

The kernels are the single-device solvers': K4 assembles each rank's
observation shard (`optim/ba.py:assemble`, its dense mode for
`ba_solve_sharded`, its per-observation mode for the PCG solvers) and
K14's two passes (`schur_lm_pass`, `schur_kf_pass`) form each rank's part
of the implicit Schur product. K14's one-launch `pcg_solve` cannot serve
here: every CG step needs a collective between its passes, so the CG loop
runs in torch around the pass launches. On CPU tensors (the `gloo`
backend) every kernel wrapper runs its plain version; on CUDA tensors
(`nccl`) it launches its kernel.

The dense coupling of `ba_solve_sharded` is K4's, weighted by lm_opt as
the single-device `ba_solve`'s is; the reference's sharded form keeps the
coupling of landmarks that are not optimized. The two agree whenever every
landmark is optimized. Nothing in the pipeline calls this module, as in
the reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..optim import ba

OBS_AXIS = "obs"


def _axis(mesh):
    """(process group, size, this rank's index) of a 1-D DeviceMesh."""
    return mesh.get_group(), mesh.size(), mesh.get_local_rank()


def _psum(tensors, group):
    """Each tensor summed over the group, in one all_reduce of their
    concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def _rows(x, lo, hi):
    # a fresh allocation: the kernels read some arrays in 8- or 16-byte
    # words, which a view at an odd offset would not align
    return x[lo:hi].clone()


def _shard(p: ba.BAProblem, n: int, rank: int, lm_block: int = 0):
    """Rank `rank`'s contiguous block of the observations; with lm_block,
    also its block of lm_block landmarks, obs_lm made local."""
    O = p.obs_uv.shape[0]
    if O % n:
        raise ValueError(f"sharded_ba: {O} observations do not divide into "
                         f"{n} shards (pad_problem_for_mesh)")
    lo, hi = rank * (O // n), (rank + 1) * (O // n)
    obs_lm = _rows(p.obs_lm, lo, hi)
    X, lm_opt = p.X, p.lm_opt
    if lm_block:
        a = rank * lm_block
        obs_lm = obs_lm - a
        X = _rows(p.X, a, a + lm_block)
        lm_opt = _rows(p.lm_opt, a, a + lm_block)
    return p._replace(X=X, lm_opt=lm_opt, obs_kf=_rows(p.obs_kf, lo, hi),
                      obs_lm=obs_lm, obs_uv=_rows(p.obs_uv, lo, hi),
                      obs_ur=_rows(p.obs_ur, lo, hi),
                      obs_info=_rows(p.obs_info, lo, hi),
                      obs_mask=_rows(p.obs_mask, lo, hi))


def _order(p: ba.BAProblem):
    return ba.obs_order(p) if p.obs_uv.device.type == "cuda" else None


def _assemble(pl: ba.BAProblem, R, t, X, order, per_obs: bool):
    """K4 on a rank's shard; a shard without observations launches nothing
    and contributes zeros."""
    if pl.obs_uv.shape[0]:
        return ba.assemble(pl, R, t, X, order, per_obs=per_obs)
    K, L = R.shape[0], X.shape[0]
    z = lambda *s: torch.zeros(s, dtype=X.dtype, device=X.device)  # noqa
    if per_obs:
        return ba.ObsBlocks(z(K, 6, 6), z(K, 6), z(0, 6, 3), z(L, 3, 3),
                            z(L, 3), z())
    return ba.BlockSums(z(K, 6, 6), z(K, 6), z(L, K, 6, 3), z(L, 3, 3),
                        z(L, 3), z())


def _lm_pass(pl, Wpl, x, Hll_inv, order, c=None):
    """K14's landmark pass on a rank's shard (zeros, or c's share, without
    observations: lm_opt Hll_inv c)."""
    if Wpl.shape[0]:
        return ba.schur_lm_pass(pl, Wpl, x, Hll_inv, order, c)
    if c is None:
        return torch.zeros_like(Hll_inv[:, :, 0])
    return torch.einsum('lab,lb->la', Hll_inv, c) * \
        pl.lm_opt.to(c.dtype)[:, None]


def _neg_kf_pass(pl, Wpl, y, order):
    """-kf_opt (B y) over a rank's observations: K14's keyframe pass with
    a = 0."""
    zK = torch.zeros((pl.R.shape[0], 6), dtype=y.dtype, device=y.device)
    if Wpl.shape[0]:
        return ba.schur_kf_pass(pl, Wpl, y, order, a=zK)
    return zK


def _cg(rhs, matvec, Minv, kf_opt_f, cg_iters: int):
    """`cg_iters` iterations of CG preconditioned by Minv from x0 = 0, no
    early exit (the reference's scan). Returns kf_opt x."""
    tiny = torch.tensor(1e-20, dtype=rhs.dtype, device=rhs.device)

    def guard(v):
        return torch.where(torch.abs(v) < 1e-20, tiny, v)

    def precond(v):
        return torch.einsum('kab,kb->ka', Minv, v) * kf_opt_f
    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(rhs)
    pdir = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        Ap = matvec(pdir)
        alpha = rz / guard(torch.sum(pdir * Ap))
        x = x + alpha * pdir
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        pdir = z + rz_new / guard(rz) * pdir
        rz = rz_new
    return x * kf_opt_f


def pad_problem_for_mesh(p: ba.BAProblem, n_devices: int):
    """Pad the observation arrays so their length divides the mesh size:
    zeros, obs_ur NaN and obs_mask False."""
    O = p.obs_uv.shape[0]
    pad = (-O) % n_devices
    if pad == 0:
        return p

    def f(x, fill=0):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])
    return p._replace(obs_kf=f(p.obs_kf), obs_lm=f(p.obs_lm),
                      obs_uv=f(p.obs_uv), obs_ur=f(p.obs_ur, float("nan")),
                      obs_info=f(p.obs_info), obs_mask=f(p.obs_mask, False))


def ba_solve_sharded(p: ba.BAProblem, mesh, n_iters: int = 10,
                     lambda0: float = 1e-4):
    """LM bundle adjustment with observation-sharded assembly: each rank's
    K4 (dense mode) on its shard, one all_reduce of (Hpp, bp, Bt, Hll, bl)
    and one of the cost a state, the reduced system solved on every rank
    as in `ba.ba_solve`. For local windows: Bt is (L, K, 6, 3) on every
    rank. p: observations divisible by the mesh size
    (`pad_problem_for_mesh`); mesh: a 1-D DeviceMesh. Returns (R, t, X,
    info) like `ba.ba_solve`."""
    group, n, rank = _axis(mesh)
    pl = _shard(p, n, rank)
    order = _order(pl)
    f32 = p.obs_uv.dtype

    def blocks(R, t, X):
        bs = _assemble(pl, R, t, X, order, per_obs=False)
        sums = _psum(bs[:5], group)
        cost, = _psum([bs.cost], group)
        return ba.BlockSums(*sums, cost.reshape(()))

    def step(bs, R, t, X, lam):
        return ba.dense_step(p, bs, R, t, X, lam)

    bs = blocks(p.R, p.t, p.X)
    lam = torch.tensor(lambda0, dtype=f32, device=p.obs_uv.device)
    R, t, X, _, lam, _, costs, _ = ba._lm_loop(
        blocks, step, p.R, p.t, p.X, bs, lam, bs.cost, n_iters)
    return R, t, X, {"cost0": bs.cost, "costs": torch.stack(costs),
                     "lambda": lam}


def partition_problem_by_lm(p: ba.BAProblem, n_devices: int):
    """Host-side repartition for the landmark-sharded solver: device d owns
    a contiguous landmark-id range, cut at equal observation counts, and
    every observation of those landmarks.

    Returns (problem, lm_new2old): the landmark arrays a block-padded
    permutation of the input (length n_devices * Lb), `lm_new2old[j]` the
    original id of packed row j (-1 for padding); the observations
    n_devices equal contiguous blocks (a multiple of 8 each), padded rows
    masked out with zero info, keyframe 0 and their block's first
    landmark. The same permutation and boundaries as the reference."""
    dev = p.obs_uv.device
    L = int(p.X.shape[0])
    obs_lm = p.obs_lm.cpu().numpy()
    obs_mask = p.obs_mask.cpu().numpy()
    counts = np.bincount(obs_lm[obs_mask], minlength=L).astype(np.int64)
    cum = np.cumsum(counts)
    total = int(cum[-1])
    # boundary[d] = first landmark id of device d's range
    targets = (np.arange(1, n_devices) * total) // n_devices
    bounds = np.concatenate([[0], np.searchsorted(cum, targets, "left") + 1,
                             [L]])
    bounds = np.maximum.accumulate(np.clip(bounds, 0, L))
    starts, ends = bounds[:-1], bounds[1:]
    Lb = max(int((ends - starts).max()), 1)
    lm_new2old = np.full(n_devices * Lb, -1, np.int64)
    lm_old2new = np.zeros(L, np.int64)
    for d in range(n_devices):
        ln = ends[d] - starts[d]
        lm_new2old[d * Lb:d * Lb + ln] = np.arange(starts[d], ends[d])
        lm_old2new[starts[d]:ends[d]] = d * Lb + np.arange(ln)
    src = np.where(lm_new2old < 0, 0, lm_new2old)

    owner = np.where(obs_mask, np.searchsorted(ends, obs_lm, "right"), 0)
    ocounts = np.bincount(owner[obs_mask], minlength=n_devices)
    cap = max(int(ocounts.max()), 1)
    cap = -(-cap // 8) * 8
    sel = np.full((n_devices, cap), -1, np.int64)
    for d in range(n_devices):
        rows = np.nonzero(obs_mask & (owner == d))[0]
        sel[d, :len(rows)] = rows
    sel_flat = sel.reshape(-1)
    pad = sel_flat < 0
    idx = torch.as_tensor(np.where(pad, 0, sel_flat), device=dev)
    pad_t = torch.as_tensor(pad, device=dev)

    def take(x, fill=None):
        out = x[idx]
        if fill is not None:
            out[pad_t] = fill
        return out

    # padded rows: mask False, landmark = first row of the owning block
    # (keeps the local index in range), kf = 0, zero info
    own_first = np.repeat(np.arange(n_devices) * Lb, cap)
    obs_lm_new = lm_old2new[obs_lm[np.where(pad, 0, sel_flat)]]
    obs_lm_new[pad] = own_first[pad]
    src_t = torch.as_tensor(src, device=dev)
    p_new = p._replace(
        X=p.X[src_t],
        lm_opt=p.lm_opt[src_t] & torch.as_tensor(lm_new2old >= 0,
                                                 device=dev),
        obs_kf=take(p.obs_kf, 0),
        obs_lm=torch.as_tensor(obs_lm_new, dtype=p.obs_lm.dtype, device=dev),
        obs_uv=take(p.obs_uv),
        obs_ur=take(p.obs_ur),
        obs_info=take(p.obs_info, 0.0),
        obs_mask=~pad_t)
    return p_new, torch.as_tensor(lm_new2old, device=dev)


def ba_solve_pcg_lm_sharded(p: ba.BAProblem, mesh, n_iters: int = 8,
                            cg_iters: int = 40, lambda0: float = 1e-4):
    """Landmark-sharded implicit-Schur PCG global BA on the layout of
    `partition_problem_by_lm`: rank d owns landmark block d and all of its
    observations, so everything landmark-sized (Hll, bl, Hll_inv, dxl, X)
    stays on its rank and K14's landmark pass needs no collective. The
    collectives: one (K, 6, 6) + (K, 6) all_reduce a state (the pose
    blocks), one (K, 6) a matvec (after K14's keyframe pass), one scalar a
    state (the cost). The landmark blocks are gathered once at the end, so
    every rank returns the whole (n Lb, 3) X. Returns (R, t, X, info)."""
    group, n, rank = _axis(mesh)
    L = p.X.shape[0]
    if L % n:
        raise ValueError("ba_solve_pcg_lm_sharded: the landmarks do not "
                         "divide into the mesh's blocks "
                         "(partition_problem_by_lm)")
    Lb = L // n
    pl = _shard(p, n, rank, lm_block=Lb)
    order = _order(pl)
    f32 = p.obs_uv.dtype
    kf_opt_f = p.kf_opt.to(f32)[:, None]

    def blocks(R, t, X_l):
        ob = _assemble(pl, R, t, X_l, order, per_obs=True)
        Hpp, bp = _psum([ob.Hpp, ob.bp], group)
        cost, = _psum([ob.cost], group)
        return ob._replace(Hpp=Hpp, bp=bp, cost=cost.reshape(()))

    def step(ob, R, t, X_l, lam):
        _, Wpl, Hpp, Minv, Hll_inv, bp, bl, _ = ba.pcg_args(pl, ob, lam)

        def neg_By(y):
            return _psum([_neg_kf_pass(pl, Wpl, y, order)], group)[0]

        def S_matvec(x):
            y = _lm_pass(pl, Wpl, x, Hll_inv, order)
            return torch.einsum('kab,kb->ka', Hpp, x * kf_opt_f) * kf_opt_f \
                + neg_By(y)
        y0 = torch.einsum('lab,lb->la', Hll_inv, bl)
        rhs = bp * kf_opt_f + neg_By(y0)
        dxp = _cg(rhs, S_matvec, Minv, kf_opt_f, cg_iters)
        dxl = _lm_pass(pl, Wpl, dxp, Hll_inv, order, c=bl)
        return ba.apply_step(dxp, dxl, R, t, X_l)

    X_l = pl.X
    ob = blocks(p.R, p.t, X_l)
    lam = torch.tensor(lambda0, dtype=f32, device=p.obs_uv.device)
    R, t, X_l, _, lam, _, costs, _ = ba._lm_loop(
        blocks, step, p.R, p.t, X_l, ob, lam, ob.cost, n_iters)
    parts = [torch.empty_like(X_l) for _ in range(n)]
    dist.all_gather(parts, X_l.contiguous(), group=group)
    return R, t, torch.cat(parts), {"cost0": ob.cost,
                                    "costs": torch.stack(costs),
                                    "lambda": lam}


def ba_solve_pcg_sharded(p: ba.BAProblem, mesh, n_iters: int = 8,
                         cg_iters: int = 40, lambda0: float = 1e-4):
    """Observation-sharded implicit-Schur PCG global BA: nothing landmark x
    keyframe sized is formed. Each rank keeps its shard's coupling blocks
    Wpl (K4's per-observation mode); a state's (Hpp, Hll, bp, bl) and its
    cost are each one all_reduce; every CG matvec is K14's landmark pass on
    the rank's shard (B^T x), an all_reduce of the (L, 3) vector, Hll^-1
    on every rank, K14's keyframe pass (B y) and an all_reduce of the
    (K, 6) vector. Keyframe and landmark state stays replicated. p:
    observations divisible by the mesh size (`pad_problem_for_mesh`).
    Returns (R, t, X, info) like `ba.ba_solve_pcg`."""
    group, n, rank = _axis(mesh)
    pl = _shard(p, n, rank)
    order = _order(pl)
    f32, dev = p.obs_uv.dtype, p.obs_uv.device
    L = p.X.shape[0]
    kf_opt_f = p.kf_opt.to(f32)[:, None]
    lm_opt_f = p.lm_opt.to(f32)[:, None]
    # the landmark pass with Hll^-1 = I gives lm_opt B^T x' alone
    eyeL = torch.eye(3, dtype=f32, device=dev).expand(L, 3, 3).contiguous()

    def blocks(R, t, X):
        ob = _assemble(pl, R, t, X, order, per_obs=True)
        Hpp, Hll, bp, bl = _psum([ob.Hpp, ob.Hll, ob.bp, ob.bl], group)
        cost, = _psum([ob.cost], group)
        return ob._replace(Hpp=Hpp, Hll=Hll, bp=bp, bl=bl,
                           cost=cost.reshape(()))

    def step(ob, R, t, X, lam):
        _, Wpl, Hpp, Minv, Hll_inv, bp, bl, _ = ba.pcg_args(p, ob, lam)

        def Btx(x):
            return _psum([_lm_pass(pl, Wpl, x, eyeL, order)], group)[0]

        def neg_By(y):
            return _psum([_neg_kf_pass(pl, Wpl, y, order)], group)[0]

        def S_matvec(x):
            xp = x * kf_opt_f
            y = torch.einsum('lab,lb->la', Hll_inv, Btx(xp)) * lm_opt_f
            return torch.einsum('kab,kb->ka', Hpp, xp) * kf_opt_f + neg_By(y)
        y0 = torch.einsum('lab,lb->la', Hll_inv, bl)
        rhs = bp * kf_opt_f + neg_By(y0)
        dxp = _cg(rhs, S_matvec, Minv, kf_opt_f, cg_iters)
        dxl = torch.einsum('lab,lb->la', Hll_inv, bl - Btx(dxp)) * lm_opt_f
        return ba.apply_step(dxp, dxl, R, t, X)

    ob = blocks(p.R, p.t, p.X)
    lam = torch.tensor(lambda0, dtype=f32, device=dev)
    R, t, X, _, lam, _, costs, _ = ba._lm_loop(
        blocks, step, p.R, p.t, p.X, ob, lam, ob.cost, n_iters)
    return R, t, X, {"cost0": ob.cost, "costs": torch.stack(costs),
                     "lambda": lam}
