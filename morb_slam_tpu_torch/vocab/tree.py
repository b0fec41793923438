"""Hierarchical binary vocabulary: training, transform, BoW vectors and L1
scoring (counterpart of `morb_slam_tpu/vocab/tree.py`).

The k-ary tree of binary centroids is kept as dense per-level center arrays:
level l holds k^(l+1) centers, as (k^(l+1), 8) int32 tensors, the bit view
of the reference's uint32 words (as the descriptors are). `train` is host
numpy, a copy of the reference's, and gives the identical tree for a seed.

Two functions here are kernels of the port:

- `transform` is K9: on CUDA tensors it launches `csrc/vocab_transform.cu`
  (the descent through every level in one launch), on CPU tensors it runs
  `transform_plain`;
- `l1_score` is K10: on CUDA tensors it launches `csrc/bow_l1.cu`, which
  also applies the database's row mask, on CPU tensors `l1_score_plain`.

Each counts its launches in `LAUNCHES[name]`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..ops import cuda_build

LAUNCHES = {"vocab_transform": {"kernel": 0, "plain": 0},
            "bow_l1": {"kernel": 0, "plain": 0}}


class Vocabulary(NamedTuple):
    """centers: tuple of per-level (k^(l+1), 8) int32 tensors; weights:
    (n_words,) float32 idf word weights; k: branching factor."""
    centers: tuple
    weights: torch.Tensor
    k: int

    @property
    def depth(self):
        return len(self.centers)

    @property
    def n_words(self):
        return self.centers[-1].shape[0]

    def to(self, device):
        return Vocabulary(centers=tuple(c.to(device) for c in self.centers),
                          weights=self.weights.to(device), k=self.k)


def from_arrays(centers, weights, k: int) -> Vocabulary:
    """Vocabulary of CPU tensors from uint32 centers and float weights."""
    return Vocabulary(
        centers=tuple(torch.from_numpy(np.array(c, np.uint32).view(np.int32))
                      for c in centers),
        weights=torch.from_numpy(np.asarray(weights, np.float32).copy()),
        k=int(k))


def to_arrays(voc: Vocabulary):
    """(uint32 center arrays, float32 weights) of a vocabulary."""
    return ([c.cpu().numpy().view(np.uint32) for c in voc.centers],
            voc.weights.cpu().numpy())


# ---------------------------------------------------------------------------
# training (host numpy, as the reference)
# ---------------------------------------------------------------------------

def _np_popcount32(x):
    """Popcount of uint32 arrays (SWAR)."""
    x = x.astype(np.uint32)
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + \
        ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int32)


def _np_majority(members, weights):
    """Weighted per-bit majority vote -> (8,) uint32."""
    bits = np.unpackbits(
        members.astype(np.uint32).view(np.uint8), axis=1, bitorder="little"
    ).astype(np.float32)                                    # (M, 256)
    s = bits.T @ weights
    maj = (2.0 * s > np.sum(weights)).astype(np.uint8)
    return np.packbits(maj, bitorder="little").view(np.uint32)


def train(descs, k: int = 10, depth: int = 4, iters: int = 8,
          seed: int = 0) -> Vocabulary:
    """Hierarchical binary k-means over training descriptors (N, 8), uint32
    words or their int32 view, as numpy or a tensor. The same seed gives
    the reference's tree bit for bit. Returns CPU tensors."""
    if torch.is_tensor(descs):
        descs = descs.cpu().numpy()
    rng = np.random.default_rng(seed)
    d_np = np.ascontiguousarray(descs).view(np.uint32) \
        if np.asarray(descs).dtype == np.int32 else np.asarray(descs, np.uint32)
    N = d_np.shape[0]
    assign = np.zeros(N, np.int64)        # node index at the current level
    centers_all = []
    for level in range(depth):
        n_parent = k ** level
        new_centers = np.zeros((n_parent * k, 8), np.uint32)
        new_assign = assign.copy()
        for p in range(n_parent):
            mask = assign == p
            members = d_np[mask]
            if len(members) == 0:
                # empty branch: seed with random training descriptors
                members = d_np[rng.integers(0, N, k)]
            init_idx = rng.choice(len(members), size=min(k, len(members)),
                                  replace=False)
            c = members[init_idx]
            if len(c) < k:
                c = np.concatenate([c, members[rng.integers(0, len(members),
                                                            k - len(c))]])
            for _ in range(iters):
                dist = _np_popcount32(
                    members[:, None, :] ^ c[None, :, :]).sum(-1)  # (M, k)
                a = np.argmin(dist, axis=1)
                c = np.stack([
                    _np_majority(members, (a == j).astype(np.float32))
                    for j in range(k)])
            dist = _np_popcount32(
                members[:, None, :] ^ c[None, :, :]).sum(-1)
            a = np.argmin(dist, axis=1)
            new_centers[p * k:(p + 1) * k] = c
            if mask.any():
                # (the reference raises here for an empty branch: its
                # random stand-in members are no training descriptors)
                new_assign[mask] = p * k + a
        centers_all.append(new_centers)
        assign = new_assign
    # idf weights from the training distribution (TF-IDF weighting)
    n_words = k ** depth
    counts = np.bincount(assign, minlength=n_words)
    idf = np.log(N / np.maximum(counts, 1.0))
    idf[counts == 0] = 0.0
    return from_arrays(centers_all, idf.astype(np.float32), k)


# ---------------------------------------------------------------------------
# K9: transform
# ---------------------------------------------------------------------------

def _popcount32(x):
    """Bit counts of int32 words (SWAR on their unsigned value)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def transform_plain(voc: Vocabulary, descs, valid=None):
    """Descriptors (N, 8) int32 -> leaf word ids (N,) int32: per level the
    Hamming argmin (first on ties) over the node's k children; -1 where
    valid is False."""
    LAUNCHES["vocab_transform"]["plain"] += 1
    N = descs.shape[0]
    k = voc.k
    node = torch.zeros(N, dtype=torch.long, device=descs.device)
    for level in range(voc.depth):
        cand = voc.centers[level][node[:, None] * k
                                  + torch.arange(k, device=descs.device)]
        d = torch.sum(_popcount32(cand ^ descs[:, None, :]), dim=-1)
        node = node * k + torch.argmin(d, dim=1)
    node = node.to(torch.int32)
    if valid is not None:
        node = torch.where(valid, node, torch.full_like(node, -1))
    return node


@record_function("K9 vocab_transform")
def transform(voc: Vocabulary, descs, valid=None):
    """K9: leaf word ids of descriptors (N, 8) int32, -1 where valid (N,)
    is False. CUDA tensors: the kernel; CPU tensors: the plain version."""
    if descs.device.type == "cpu":
        return transform_plain(voc, descs, valid)
    if descs.device.type != "cuda":
        raise ValueError(f"vocab_transform: unsupported device {descs.device}")
    n = descs.shape[0]
    if descs.dtype != torch.int32 or descs.shape[1:] != (8,) or \
            any(c.dtype != torch.int32 or c.device != descs.device
                for c in voc.centers) or \
            (valid is not None and (valid.dtype != torch.bool
                                    or valid.shape != (n,))):
        raise ValueError("vocab_transform: needs int32 (N, 8) descriptors, "
                         "int32 centers on their device and a bool (N,) "
                         "valid mask")
    for level, c in enumerate(voc.centers):
        if c.shape != (voc.k ** (level + 1), 8):
            raise ValueError("vocab_transform: level centers must be "
                             "(k^(l+1), 8)")
    centers = torch.cat(voc.centers) if voc.depth > 1 else \
        voc.centers[0].contiguous()
    n_upper = centers.shape[0] - voc.n_words
    descs = _aligned(descs)
    words = torch.empty(n, dtype=torch.int32, device=descs.device)
    rc = _lib("vocab_transform").vocab_transform(
        descs.data_ptr(), None if valid is None else valid.contiguous()
        .data_ptr(), n, _aligned(centers).data_ptr(), voc.k, voc.depth,
        n_upper, words.data_ptr(), cuda_build.stream_ptr(descs))
    cuda_build.check(rc, "vocab_transform")
    LAUNCHES["vocab_transform"]["kernel"] += 1
    return words


def bow_vector(voc: Vocabulary, word_ids):
    """Word ids -> dense L1-normalized tf-idf BoW vector (n_words,)."""
    W = voc.n_words
    ok = word_ids >= 0
    idx = torch.where(ok, word_ids, torch.full_like(word_ids, W)).long()
    w = torch.zeros(W + 1, dtype=torch.float32, device=word_ids.device)
    w = w.index_add(0, idx, torch.ones_like(idx, dtype=torch.float32))[:W]
    v = w * voc.weights
    n = torch.sum(torch.abs(v))
    return v / torch.where(n < 1e-12, torch.ones_like(n), n)


# ---------------------------------------------------------------------------
# K10: L1 scoring (with the database's row mask)
# ---------------------------------------------------------------------------

def l1_score_plain(q, db, ok=None):
    """s = 1 - 0.5 |q - d|_1 of L1-normalized BoW vectors q (W,) or (B, W)
    against db (K, W); -1 where ok (K,) is False. (K,) or (B, K)."""
    LAUNCHES["bow_l1"]["plain"] += 1
    qb = q if q.dim() == 2 else q[None]
    diff = torch.sum(torch.abs(qb[:, None, :] - db[None, :, :]), dim=-1)
    s = 1.0 - 0.5 * diff
    if ok is not None:
        s = torch.where(ok[None, :], s, torch.full_like(s, -1.0))
    return s if q.dim() == 2 else s[0]


@record_function("K10 bow_l1")
def l1_score(q, db, ok=None):
    """K10: L1 similarity of q (W,) or (B, W) against db (K, W), -1 where
    the optional row mask ok (K,) is False. CUDA tensors: the kernel; CPU
    tensors: the plain version."""
    if q.device.type == "cpu":
        return l1_score_plain(q, db, ok)
    if q.device.type != "cuda":
        raise ValueError(f"bow_l1: unsupported device {q.device}")
    qb = q if q.dim() == 2 else q[None]
    if q.dim() not in (1, 2) or db.dim() != 2 or \
            q.dtype != torch.float32 or db.dtype != torch.float32 or \
            qb.shape[1] != db.shape[1] or db.device != q.device or \
            (ok is not None and (ok.dtype != torch.bool
                                 or ok.shape != (db.shape[0],))):
        raise ValueError("bow_l1: needs float32 (W,) or (B, W) queries, a "
                         "float32 (K, W) database and a bool (K,) mask")
    B, W = qb.shape
    K = db.shape[0]
    qb, db = _aligned(qb), _aligned(db)
    out = torch.empty((B, K), dtype=torch.float32, device=q.device)
    rc = _lib("bow_l1").bow_l1(
        qb.data_ptr(), db.data_ptr(),
        None if ok is None else ok.contiguous().data_ptr(), B, K, W,
        out.data_ptr(), cuda_build.stream_ptr(q))
    cuda_build.check(rc, "bow_l1")
    LAUNCHES["bow_l1"]["kernel"] += 1
    return out if q.dim() == 2 else out[0]


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lib(name: str):
    lib = cuda_build.library(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, P, I, I, I, P, P] if name == "vocab_transform" \
            else [P, P, P, I, I, I, P, P]
        fn.restype = I
    return lib


# ---------------------------------------------------------------------------
# ORBvoc text-format interchange (DBoW2 TemplatedVocabulary loadFromTextFile
# / saveToTextFile): header "k L scoring weighting", then one node per line
# "parent_id is_leaf b0 .. b31 weight" in creation order (root implicit)
# ---------------------------------------------------------------------------

def _bytes_to_u32(b):
    """(N, 32) uint8 descriptor bytes -> (N, 8) uint32 (little-endian)."""
    b = np.ascontiguousarray(b, np.uint8)
    return b.view("<u4").reshape(b.shape[0], 8)


def _u32_to_bytes(w):
    """(N, 8) uint32 -> (N, 32) uint8 (little-endian)."""
    return np.ascontiguousarray(np.asarray(w, "<u4")).view(np.uint8) \
        .reshape(-1, 32)


def load_orbvoc_text(path: str) -> Vocabulary:
    """Import a DBoW2 text vocabulary into the dense tree. An incomplete
    DBoW2 tree is completed so that its descent is reproduced exactly: a
    parent's missing children copy its first real child (ties pick the lower
    index, so a copy is never chosen), and an early leaf continues to the
    bottom level as a chain of self-copies that carries its weight. Word
    ids are positional."""
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        parents, byte_rows, wts_in = [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            byte_rows.append([int(float(x)) for x in parts[2:34]])
            wts_in.append(float(parts[34]))
    n = len(parents)
    if n == 0:
        raise ValueError(f"{path}: no vocabulary nodes")
    desc_u32 = np.zeros((n + 1, 8), np.uint32)
    desc_u32[1:] = _bytes_to_u32(np.asarray(byte_rows, np.uint8))
    node_w = np.zeros(n + 1, np.float32)
    node_w[1:] = np.asarray(wts_in, np.float32)
    children = {}
    for i, p in enumerate(parents):
        children.setdefault(p, []).append(i + 1)   # ids 1..n, root = 0

    centers = [np.zeros((k ** (l + 1), 8), np.uint32) for l in range(depth)]
    frontier = [(0, 0)]                            # (node id, position)
    for l in range(depth):
        C = centers[l]
        nxt = []
        for node, p in frontier:
            ch = children.get(node, [])[:k]
            if ch:
                for s_i, c_id in enumerate(ch):
                    C[p * k + s_i] = desc_u32[c_id]
                    nxt.append((c_id, p * k + s_i))
                for s_i in range(len(ch), k):
                    C[p * k + s_i] = desc_u32[ch[0]]
            else:
                # early leaf: self-copy chain down to the word level
                for s_i in range(k):
                    C[p * k + s_i] = desc_u32[node]
                nxt.append((node, p * k))
        frontier = nxt
    weights = np.zeros(k ** depth, np.float32)
    for node, p in frontier:
        weights[p] = node_w[node]
    return from_arrays(centers, weights, k)


def save_orbvoc_text(voc: Vocabulary, path: str):
    """Export in the DBoW2 text layout (scoring 0 = L1, weighting 0 =
    TF-IDF), node ids level by level, position-major (root = 0)."""
    k, depth = voc.k, voc.depth
    centers, w_leaf = to_arrays(voc)
    lines = [f"{k} {depth} 0 0"]
    next_id = 1
    id_of = {(-1, 0): 0}
    for l in range(depth):
        C = _u32_to_bytes(centers[l])
        for p in range(centers[l].shape[0]):
            id_of[(l, p)] = next_id
            next_id += 1
            parent = id_of[(l - 1, p // k)]
            is_leaf = 1 if l == depth - 1 else 0
            w = float(w_leaf[p]) if is_leaf else 0.0
            byte_s = " ".join(str(int(b)) for b in C[p])
            lines.append(f"{parent} {is_leaf} {byte_s} {w:.6f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
