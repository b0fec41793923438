"""Hamming distances over packed 256-bit descriptors, best / second-best
search and the nearest-neighbour matcher (counterpart of
`morb_slam_tpu/ops/hamming.py`).

Descriptors are (N, 8) int32, the bit view of the reference's uint32 words.
`hamming_top2` is kernel K3: on CUDA tensors it launches
`csrc/hamming_top2.cu`, which keeps the N x M distance matrix out of device
memory; on CPU tensors it runs the plain version (`hamming_matrix` +
`top2_min`, or at a sparse mask the same result from the masked-in pairs
alone). `hamming_top2_gated` is K3's gated mode: it takes the searches'
per-row and per-column window inputs instead of an (N, M) mask and tests
each pair in the kernel's registers (`gate_mask` is the plain gate, the
dense composition the searches built before). `hamming_matrix_mxu` is
kernel K19 (`csrc/hamming_mxu.cu`): the whole distance matrix as a +-1
product on the int8 tensor cores; no pipeline code calls it.
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
MXU_LAUNCHES = {"kernel": 0, "plain": 0}     # K19
# the gated mode's pair tests (csrc/hamming_top2.cu GATE_*)
GATE_MODES = {"window": 0, "window_nan": 1, "row_band": 2}

_ROW_CHUNK = 1024
# the number of set bits of each byte value
_POPCOUNT8 = torch.tensor([bin(v).count("1") for v in range(256)],
                          dtype=torch.int32)


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


def hamming_matrix_mxu_plain(a, b):
    """`hamming_matrix_mxu`'s function: the bits unpacked to +-1 float32
    and one product, d = (256 - <sa, sb>) / 2. Every partial sum is an
    integer of magnitude <= 256, so the float32 product is exact."""
    MXU_LAUNCHES["plain"] += 1
    sa = unpack_bits(a).to(torch.float32) * 2 - 1
    sb = unpack_bits(b).to(torch.float32) * 2 - 1
    return ((256 - sa @ sb.T) * 0.5).to(torch.int32)


def hamming_matrix_mxu(a, b):
    """K19: (N, 8) x (M, 8) int32 words -> (N, M) int32 Hamming distances,
    equal to `hamming_matrix`, as a +-1 product over the 256 bits. CUDA
    tensors: one launch of the int8 tensor-core kernel; CPU tensors: the
    plain version."""
    if a.device.type == "cpu":
        return hamming_matrix_mxu_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"hamming_matrix_mxu: unsupported device {a.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32 or \
            a.dim() != 2 or b.dim() != 2 or a.shape[1] != 8 or \
            b.shape[1] != 8 or b.device != a.device:
        raise ValueError("hamming_matrix_mxu: needs int32 (N, 8) and (M, 8) "
                         "on one card")
    n, m = a.shape[0], b.shape[0]
    out = torch.empty((n, m), dtype=torch.int32, device=a.device)
    if n == 0 or m == 0:
        return out
    a, b = _aligned(a), _aligned(b)
    rc = _mxu_lib().hamming_mxu(a.data_ptr(), b.data_ptr(), n, m,
                                out.data_ptr(), cuda_build.stream_ptr(a))
    cuda_build.check(rc, "hamming_mxu")
    MXU_LAUNCHES["kernel"] += 1
    return out


def top2_min(d, big: int = BIG):
    """Row-wise best, best index (first on ties) and second best, the
    minimum over the other columns."""
    best_idx = torch.argmin(d, dim=1).to(torch.int32)
    best = torch.gather(d, 1, best_idx[:, None].long())[:, 0]
    cols = torch.arange(d.shape[1], device=d.device, dtype=torch.int32)
    second = torch.amin(torch.where(cols[None, :] == best_idx[:, None],
                                    torch.full_like(d, big), d), dim=1)
    return best, best_idx, second


def _masked_top2(a, b, mask):
    """top2_min of the Hamming matrix with BIG where `mask` is False: the
    dense composition."""
    return top2_min(torch.where(mask, hamming_matrix(a, b), torch.full(
        (), BIG, dtype=torch.int32, device=a.device)))


def _sparse_top2(a, b, i, j):
    """`_masked_top2` on the mask that is True at the distinct pairs (i, j)
    alone, from those pairs' distances (XOR and a byte popcount, exact as
    the product); the matrix is never formed. Needs M > 0."""
    n, m = a.shape[0], b.shape[0]
    dev = a.device
    i = i.long()
    x = (a[i] ^ b[j]).contiguous().view(torch.uint8)          # (P, 32)
    d = _POPCOUNT8.to(dev)[x.long()].sum(1, dtype=torch.int32)
    big = torch.full((n,), BIG, dtype=torch.int32, device=dev)
    best = big.scatter_reduce(0, i, d, "amin")
    # the row's first column at its best (column 0 in a row of no pair)
    at = d == best[i]
    idx = torch.full((n,), m, dtype=torch.int64, device=dev).scatter_reduce(
        0, i[at], j[at].long(), "amin")
    idx = torch.where(idx == m, torch.zeros_like(idx), idx)
    # the minimum over the row's other columns: its other pairs, or BIG
    other = j.long() != idx[i]
    second = big.scatter_reduce(0, i[other], d[other], "amin")
    return best, idx.to(torch.int32), second


def _pair_top2(a, b, i, j, mask=None):
    """top2_min of the (N, M) matrix holding the Hamming distance at the
    distinct pairs (i, j) and BIG elsewhere: `_sparse_top2` where the pairs
    are at most a 16th of the matrix, else `_masked_top2` on `mask` (built
    from the pairs if not given). A 16th is where the two cross on the CPU
    (tests/k3_plain_crossover.py); the searches by projection and the
    triangulation search fall below it, the initializer's, relocalization's
    and the merge check's all-pairs matches above."""
    n, m = a.shape[0], b.shape[0]
    if m > 0 and 16 * i.numel() <= n * m:
        return _sparse_top2(a, b, i, j)
    if mask is None:
        mask = torch.zeros((n, m), dtype=torch.bool, device=a.device)
        mask[i, j] = True
    return _masked_top2(a, b, mask)


def hamming_top2_plain(a, b, mask):
    LAUNCHES["plain"] += 1
    i, j = torch.nonzero(mask, as_tuple=True)
    return _pair_top2(a, b, i, j, mask)


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


def gate_mask(row_uv, row_r, row_oct, row_ok, col_uv, col_oct, col_ok,
              mode: str, max_d: float = 0.0):
    """The plain gate of K3's gated mode, the (N, M) bool composition the
    searches build:

    - "window" (`matching.search_by_projection`): max |row_uv - col_uv| <=
      row_r, col_oct in [row_oct - 1, row_oct + 1], both flags;
    - "window_nan" (`matching.search_last_frame`): the same with NaN
      differences taken as 1e9 (`nan_to_num`);
    - "row_band" (`stereo.row_search`): |row_v - col_v| <= row_r (the band),
      0 <= row_u - col_u <= max_d, |row_oct - col_oct| <= 1, both flags."""
    if mode == "row_band":
        dy = torch.abs(row_uv[:, 1:2] - col_uv[None, :, 1])
        disp = row_uv[:, 0:1] - col_uv[None, :, 0]
        oct_ok = torch.abs(row_oct[:, None] - col_oct[None, :]) <= 1
        return ((dy <= row_r[:, None]) & (disp >= 0.0) & (disp <= max_d)
                & oct_ok & row_ok[:, None] & col_ok[None, :])
    if mode not in ("window", "window_nan"):
        raise ValueError(f"gate_mask: unknown mode {mode!r}")
    d_uv = row_uv[:, None, :] - col_uv[None, :, :]
    if mode == "window_nan":
        d_uv = torch.nan_to_num(d_uv, nan=1e9)
    close = torch.amax(torch.abs(d_uv), dim=-1) <= row_r[:, None]
    oct_ok = (col_oct[None, :] >= row_oct[:, None] - 1) & \
             (col_oct[None, :] <= row_oct[:, None] + 1)
    return close & oct_ok & row_ok[:, None] & col_ok[None, :]


def hamming_top2_gated_plain(a, b, row_uv, row_r, row_oct, row_ok, col_uv,
                             col_oct, col_ok, mode: str, max_d: float = 0.0):
    """`hamming_top2_plain` on `gate_mask`'s gate, the gate evaluated on the
    flagged rows and columns alone (it is False elsewhere)."""
    LAUNCHES["plain"] += 1
    rows = torch.nonzero(row_ok)[:, 0]
    cols = torch.nonzero(col_ok)[:, 0]
    ii, jj = torch.nonzero(gate_mask(
        row_uv[rows], row_r[rows], row_oct[rows], row_ok[rows], col_uv[cols],
        col_oct[cols], col_ok[cols], mode, max_d), as_tuple=True)
    return _pair_top2(a, b, rows[ii], cols[jj])


def hamming_top2_gated(a, b, row_uv, row_r, row_oct, row_ok, col_uv, col_oct,
                       col_ok, mode: str, max_d: float = 0.0):
    """K3's gated mode: `hamming_top2(a, b, gate_mask(...))` without the
    mask. Per row (N): uv (N, 2) float32, the window radius or row band
    `row_r` (N,) float32, octave (N,) int32, flag (N,) bool; per column
    (M): uv, octave, flag; `mode` and `max_d` as in `gate_mask`. CUDA
    tensors: the kernel tests each pair's gate in registers; CPU tensors:
    the plain version."""
    if a.device.type == "cpu":
        return hamming_top2_gated_plain(a, b, row_uv, row_r, row_oct, row_ok,
                                        col_uv, col_oct, col_ok, mode, max_d)
    if a.device.type != "cuda":
        raise ValueError(f"hamming_top2_gated: unsupported device {a.device}")
    n, m = a.shape[0], b.shape[0]
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    want = ((a, i32, (n, 8)), (b, i32, (m, 8)), (row_uv, f32, (n, 2)),
            (row_r, f32, (n,)), (row_oct, i32, (n,)), (row_ok, u8, (n,)),
            (col_uv, f32, (m, 2)), (col_oct, i32, (m,)), (col_ok, u8, (m,)))
    if mode not in GATE_MODES or any(
            t.dtype != dt or tuple(t.shape) != sh or t.device != a.device
            for t, dt, sh in want):
        raise ValueError("hamming_top2_gated: needs int32 (N, 8), (M, 8) "
                         "descriptors, float32 (N, 2) / (M, 2) uv, float32 "
                         "(N,) radii, int32 octaves, bool flags, one device "
                         f"and a mode of {sorted(GATE_MODES)}")
    if m == 0:
        raise ValueError("hamming_top2_gated: empty column set")
    a, b, row_uv, row_r, row_oct, row_ok, col_uv, col_oct, col_ok = (
        _aligned(t) for t, _, _ in want)
    out = torch.empty((3, n), dtype=torch.int32, device=a.device)
    rc = _lib().hamming_top2_gated(
        a.data_ptr(), b.data_ptr(), row_uv.data_ptr(), row_r.data_ptr(),
        row_oct.data_ptr(), row_ok.data_ptr(), col_uv.data_ptr(),
        col_oct.data_ptr(), col_ok.data_ptr(), n, m, GATE_MODES[mode],
        max_d, out.data_ptr(), cuda_build.stream_ptr(a))
    cuda_build.check(rc, "hamming_top2_gated")
    LAUNCHES["kernel"] += 1
    return out[0], out[1], out[2]


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lib():
    lib = cuda_build.library("hamming_top2")
    if lib.hamming_top2.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.hamming_top2.argtypes = [P, P, P, I, I, P, P, P, P]
        lib.hamming_top2.restype = I
        lib.hamming_top2_gated.argtypes = [P] * 9 + [I, I, I,
                                                     ctypes.c_float, P, P]
        lib.hamming_top2_gated.restype = I
    return lib


def _mxu_lib():
    lib = cuda_build.library("hamming_mxu")
    if lib.hamming_mxu.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.hamming_mxu.argtypes = [P, P, I, I, P, P]
        lib.hamming_mxu.restype = I
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
