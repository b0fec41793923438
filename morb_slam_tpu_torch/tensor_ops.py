"""Functional array updates and reductions with the reference package's
semantics, shared by the port's modules.

The reference writes with JAX's `x.at[idx].set(v)`: a new array, indices out
of range dropped, and (as XLA runs the scatter in order on the CPU) the last
of several writes to one index wins. `put` does the same on a copy, with no
host synchronisation and the same result on every device. `topk` is
`jax.lax.top_k`: a stable descending sort, so ties keep the lower index.
"""
from __future__ import annotations

import torch


def put(x, idx, vals):
    """Copy of x with x[idx] = vals along dim 0; idx outside [0, n) is
    dropped and among duplicate indices the last write wins."""
    n = x.shape[0]
    idx = idx.reshape(-1).long()
    m = idx.numel()
    vals = torch.as_tensor(vals, dtype=x.dtype, device=x.device)
    shape = (m,) + tuple(x.shape[1:])
    if vals.dim() > 0 and vals.numel() == m * x[:1].numel():
        vals = vals.reshape(shape)
    else:
        vals = torch.broadcast_to(vals, shape)
    ok = (idx >= 0) & (idx < n)
    tgt = torch.where(ok, idx, torch.full_like(idx, n))
    pos = torch.arange(m, device=x.device)
    last = torch.full((n + 1,), -1, dtype=torch.long, device=x.device)
    last = last.scatter_reduce(0, tgt, pos, "amax", include_self=True)
    keep = ok & (last[tgt] == pos)
    tgt = torch.where(keep, tgt, torch.full_like(tgt, n))
    out = torch.cat([x, x[:1]])
    out[tgt] = vals
    return out[:n]


def put2(x, i, j, vals):
    """x.at[i, j].set(vals) for a (K, F, ...) tensor (i, j broadcast)."""
    K, F = x.shape[:2]
    i, j = torch.broadcast_tensors(torch.as_tensor(i, device=x.device),
                                   torch.as_tensor(j, device=x.device))
    lin = torch.where((i >= 0) & (i < K) & (j >= 0) & (j < F),
                      i.long() * F + j.long(),
                      torch.full_like(i, -1, dtype=torch.long))
    flat = x.reshape((K * F,) + tuple(x.shape[2:]))
    return put(flat, lin, vals).reshape(x.shape)


def add_at(x, idx, vals):
    """x.at[idx].add(vals) on a copy, out-of-range indices dropped."""
    n = x.shape[0]
    idx = idx.reshape(-1).long()
    vals = torch.as_tensor(vals, dtype=x.dtype, device=x.device)
    vals = vals.expand((idx.numel(),) + tuple(x.shape[1:]))
    ok = (idx >= 0) & (idx < n)
    out = torch.cat([x, torch.zeros_like(x[:1])])
    out = out.index_add(0, torch.where(ok, idx, torch.full_like(idx, n)),
                        vals)
    return out[:n]


def topk(x, k: int):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index (jax.lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def mask_first(mask, k: int):
    """Indices of top_k(mask.astype(int32), k): the True entries in index
    order, then the False ones."""
    return torch.sort((~mask).to(torch.uint8), stable=True)[1][:k]


def segment_sum(vals, seg, n: int):
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add(0, seg.long(), vals)


def segment_min(vals, seg, n: int):
    """jax.ops.segment_min: empty segments hold the dtype's maximum."""
    fill = torch.iinfo(vals.dtype).max if not vals.is_floating_point() \
        else float("inf")
    out = torch.full((n,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, seg.long(), vals, "amin", include_self=True)


def segment_max(vals, seg, n: int):
    """jax.ops.segment_max: empty segments hold the dtype's minimum."""
    fill = torch.iinfo(vals.dtype).min if not vals.is_floating_point() \
        else float("-inf")
    out = torch.full((n,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, seg.long(), vals, "amax", include_self=True)
