"""Hamming distances over packed 256-bit descriptors, best / second-best
search and the nearest-neighbour matcher (counterpart of
`morb_slam_tpu/ops/hamming.py`).

Descriptors are (N, 8) int32, the bit view of the reference's uint32 words.
`hamming_top2` is kernel K3: on CUDA tensors it launches
`csrc/hamming_top2.cu`, which keeps the N x M distance matrix out of device
memory; on CPU tensors it runs the plain version (`hamming_matrix` +
`top2_min`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build
from .orb_descriptor import unpack_bits

TH_HIGH = 100
TH_LOW = 50
BIG = 1 << 20

LAUNCHES = {"kernel": 0, "plain": 0}

_ROW_CHUNK = 1024


def hamming_matrix(a, b):
    """(N, 8) x (M, 8) int32 words -> (N, M) int32 Hamming distances.

    Popcount of a ^ b, computed as (256 - <sa, sb>) / 2 over +-1 bit
    vectors: every partial sum is a small integer, so the float32 product
    is exact (PyTorch has no popcount op on the CPU)."""
    sb = unpack_bits(b).to(torch.float32) * 2 - 1               # (M, 256)
    out = []
    for i in range(0, a.shape[0], _ROW_CHUNK):
        sa = unpack_bits(a[i:i + _ROW_CHUNK]).to(torch.float32) * 2 - 1
        out.append(((256.0 - sa @ sb.T) * 0.5).round().to(torch.int32))
    if not out:
        return torch.zeros((0, b.shape[0]), dtype=torch.int32,
                           device=a.device)
    return torch.cat(out)


def top2_min(d, big: int = BIG):
    """Row-wise best, best index (first on ties) and second best, the
    minimum over the other columns."""
    best_idx = torch.argmin(d, dim=1).to(torch.int32)
    best = torch.gather(d, 1, best_idx[:, None].long())[:, 0]
    cols = torch.arange(d.shape[1], device=d.device, dtype=torch.int32)
    second = torch.amin(torch.where(cols[None, :] == best_idx[:, None],
                                    torch.full_like(d, big), d), dim=1)
    return best, best_idx, second


def hamming_top2_plain(a, b, mask):
    LAUNCHES["plain"] += 1
    d = torch.where(mask, hamming_matrix(a, b),
                    torch.full((), BIG, dtype=torch.int32, device=a.device))
    return top2_min(d)


def hamming_top2(a, b, mask):
    """K3: (best, best_idx, second) per row of the Hamming matrix of a
    (N, 8) against b (M, 8), with BIG where mask (N, M) is False. CUDA
    tensors: the kernel; CPU tensors: the plain version."""
    if a.device.type == "cpu":
        return hamming_top2_plain(a, b, mask)
    if a.device.type != "cuda":
        raise ValueError(f"hamming_top2: unsupported device {a.device}")
    n, m = a.shape[0], b.shape[0]
    if a.dtype != torch.int32 or b.dtype != torch.int32 or \
            mask.dtype != torch.bool or a.shape[1:] != (8,) or \
            b.shape[1:] != (8,) or mask.shape != (n, m):
        raise ValueError("hamming_top2: needs int32 (N, 8), (M, 8) and a "
                         "bool (N, M) mask")
    if m == 0:
        raise ValueError("hamming_top2: empty column set")
    a, b, mask = (_aligned(t) for t in (a, b, mask))
    best = torch.empty(n, dtype=torch.int32, device=a.device)
    idx = torch.empty(n, dtype=torch.int32, device=a.device)
    second = torch.empty(n, dtype=torch.int32, device=a.device)
    rc = _lib().hamming_top2(a.data_ptr(), b.data_ptr(), mask.data_ptr(),
                             n, m, best.data_ptr(), idx.data_ptr(),
                             second.data_ptr(), cuda_build.stream_ptr(a))
    cuda_build.check(rc, "hamming_top2")
    LAUNCHES["kernel"] += 1
    return best, idx, second


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lib():
    lib = cuda_build.library("hamming_top2")
    if lib.hamming_top2.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.hamming_top2.argtypes = [P, P, P, I, I, P, P, P, P]
        lib.hamming_top2.restype = I
    return lib


def match_nn(a, b, cand, a_valid, b_valid, max_dist=TH_LOW, ratio=1.0,
             cross_check=True):
    """Nearest-neighbour matching with Lowe ratio and cross check over the
    masked Hamming matrix of descriptors a (N, 8), b (M, 8), candidate gate
    cand (N, M). Returns (idx (N,) int32 match in b or -1, best dist).

    The cross check (argmin over rows for each column, first row on ties)
    is a second K3 launch on the transposed problem."""
    gate = cand & a_valid[:, None] & b_valid[None, :]
    best, best_idx, second = hamming_top2(a, b, gate)
    ok = (best <= max_dist) & (best.to(torch.float32)
                               < ratio * second.to(torch.float32))
    if cross_check:
        _, rev_best, _ = hamming_top2(b, a, gate.T.contiguous())
        rows = torch.arange(a.shape[0], device=a.device, dtype=torch.int32)
        ok &= rev_best[best_idx.long()] == rows
    ok &= a_valid
    return torch.where(ok, best_idx, torch.full_like(best_idx, -1)), best


def rotation_consistency_mask(angles_a, angles_b, idx, n_bins: int = 30,
                              n_keep: int = 3):
    """Keep matches whose angle difference falls in the 3 dominant
    histogram bins (bins under 0.1 x the top count dropped)."""
    matched = idx >= 0
    rot = angles_a - angles_b[torch.clamp(idx, min=0).long()]
    frac = torch.remainder(rot / (2 * math.pi), 1.0)
    bins = torch.clamp((frac * n_bins).to(torch.int32), 0, n_bins - 1)
    hist = torch.zeros(n_bins, dtype=torch.int32, device=idx.device)
    hist = hist.index_add(0, bins.long(), matched.to(torch.int32))
    top_vals, top_bins = torch.sort(hist, descending=True, stable=True)
    top_vals, top_bins = top_vals[:n_keep], top_bins[:n_keep]
    keep_bin = top_vals >= (0.1 * top_vals[0]).to(torch.int32)
    in_top = torch.any((bins[:, None].long() == top_bins[None, :])
                       & keep_bin[None, :], dim=-1)
    return matched & in_top
