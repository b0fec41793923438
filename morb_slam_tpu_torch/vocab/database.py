"""Keyframe place-recognition database: a dense (K, n_words) BoW matrix
scored in one pass (counterpart of `morb_slam_tpu/vocab/database.py`).

`query` is K10 (`tree.l1_score` with the row mask fused in); the top-n
selection stays `tensor_ops.topk`. `top_candidates_grouped` is the
covisibility-group scoring that loop closing uses;
`top_candidates_sharded` splits the scoring over the ranks of a
`torch.distributed` mesh (nothing in the pipeline calls it).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..tensor_ops import put, segment_max, topk
from . import tree


class KeyframeDatabase(NamedTuple):
    bow: torch.Tensor      # (K, W) float32 L1-normalized tf-idf
    valid: torch.Tensor    # (K,) bool


def empty(max_kf: int, n_words: int, device="cpu") -> KeyframeDatabase:
    return KeyframeDatabase(
        bow=torch.zeros((max_kf, n_words), dtype=torch.float32, device=device),
        valid=torch.zeros(max_kf, dtype=torch.bool, device=device))


def add_keyframe(db: KeyframeDatabase, kf_id, bow) -> KeyframeDatabase:
    """A new database with row kf_id set to bow and marked valid."""
    ki = torch.as_tensor(kf_id, device=db.bow.device).reshape(1)
    return KeyframeDatabase(bow=put(db.bow, ki, bow[None]),
                            valid=put(db.valid, ki, True))


def _ok(db: KeyframeDatabase, exclude):
    return db.valid if exclude is None else db.valid & ~exclude


def query(db: KeyframeDatabase, bow_q, exclude=None):
    """(K,) scores of a query BoW against every keyframe, -1 where a row is
    invalid or excluded (exclude: optional (K,) bool)."""
    return tree.l1_score(bow_q, db.bow, _ok(db, exclude))


def top_candidates(db: KeyframeDatabase, bow_q, n: int, exclude=None,
                   min_score: float = 0.0):
    """Top-n candidate keyframes: (ids (n,), scores (n,), ok (n,))."""
    vals, ids = topk(query(db, bow_q, exclude), n)
    return ids, vals, vals > min_score


def top_candidates_grouped(db: KeyframeDatabase, bow_q, n: int, covis,
                           exclude=None, min_score: float = 0.0):
    """Covisibility-group scoring: candidates share > 0.8 x the most words
    any keyframe shares with the query; each candidate's group score adds
    the excess scores (over the map's mean score) of its top-10 covisible
    neighbours that are candidates too; groups under 0.75 x the best are
    dropped and each kept group is represented by its best member. covis:
    the (K, K) covisibility weights. Returns (ids (n,), the winners' own
    scores (n,), ok (n,))."""
    K = db.bow.shape[0]
    dev = db.bow.device
    s = tree.l1_score(bow_q, db.bow)                       # (K,)
    ok = _ok(db, exclude)
    shared = torch.sum((db.bow > 0) & (bow_q > 0)[None, :], dim=1)
    max_shared = torch.max(torch.where(ok, shared, torch.zeros_like(shared)))
    cand = ok & (shared > 0.8 * max_shared) & (shared > 0)
    # excess over the map's baseline similarity: with a compact vocabulary
    # every keyframe scores ~0.5 against everything, and a raw sum turns
    # into a contest of cluster sizes
    n_ok = torch.sum(ok)
    s_base = torch.sum(torch.where(ok, s, torch.zeros_like(s))) / \
        torch.clamp(n_ok, min=1)
    sc = torch.where(cand, torch.clamp(s - s_base, min=0.0),
                     torch.zeros_like(s))

    G = min(10, K)
    w_nb, nb = topk(covis, G)                              # (K, G)
    nb_ok = (w_nb > 0) & cand[nb]
    sc_nb = torch.where(nb_ok, sc[nb], torch.zeros_like(w_nb,
                                                        dtype=sc.dtype))
    acc = sc + torch.sum(sc_nb, dim=1)                     # group score
    nb_best_pos = torch.argmax(sc_nb, dim=1)
    nb_best_val = torch.gather(sc_nb, 1, nb_best_pos[:, None])[:, 0]
    self_wins = sc >= nb_best_val
    best_id = torch.where(self_wins, torch.arange(K, device=dev),
                          torch.gather(nb, 1, nb_best_pos[:, None])[:, 0])
    acc = torch.where(cand, acc, torch.full_like(acc, -1.0))
    retained = cand & (acc >= 0.75 * torch.max(acc))
    # per keyframe: the best group score among the groups it represents
    winner = segment_max(torch.where(retained, acc, torch.full_like(acc, -1.0)),
                         torch.where(retained, best_id,
                                     torch.full_like(best_id, K)), K + 1)[:K]
    winner = torch.clamp(winner, min=-1.0)
    vals, ids = topk(winner, n)
    return ids, s[ids], (vals > 0) & (s[ids] > min_score)


def top_candidates_sharded(db: KeyframeDatabase, bow_q, n: int, mesh,
                           exclude=None, min_score: float = 0.0,
                           axis: str = "kf"):
    """Multi-device place-recognition scoring: the (K, n_words) BoW matrix
    split into contiguous keyframe blocks over the ranks of `mesh` (a 1-D
    DeviceMesh whose dimension is named `axis`; every rank holds the whole
    database). Each rank scores its block (K10, through `query`) and takes
    its top n; one all_gather of the n scores and global ids a rank, then
    the global top n, ties to the lower id. K must divide by the mesh size.
    Returns (ids (n,), scores (n,), ok (n,)) on every rank."""
    import torch.distributed as dist
    K = db.bow.shape[0]
    size, rank = mesh.size(), mesh.get_local_rank()
    if K % size:
        raise ValueError(f"top_candidates_sharded: {K} keyframes do not "
                         f"divide into {size} blocks")
    kb = K // size
    lo = rank * kb
    blk = KeyframeDatabase(bow=db.bow[lo:lo + kb].contiguous(),
                           valid=db.valid[lo:lo + kb].contiguous())
    exc = None if exclude is None else exclude[lo:lo + kb].contiguous()
    vals, ids = topk(query(blk, bow_q, exc), n)
    group = mesh.get_group(axis)
    all_vals = [torch.empty_like(vals) for _ in range(size)]
    all_ids = [torch.empty_like(ids) for _ in range(size)]
    dist.all_gather(all_vals, vals.contiguous(), group=group)
    dist.all_gather(all_ids, (ids + lo).contiguous(), group=group)
    best, sel = topk(torch.cat(all_vals), n)
    return torch.cat(all_ids)[sel], best, best > min_score
