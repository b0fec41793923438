"""Vocabulary files (counterpart of `save_vocabulary` / `load_vocabulary`
in `morb_slam_tpu/io/serialization.py`; atlas and map checkpoints come with
the persistence slice of the port).

Both formats are the reference package's: a `.npz` of `k`, `depth`,
`weights` and `centers_<l>` (uint32 words), and the DBoW2 / ORBvoc text
format for paths ending in `.txt`. A file written by either package loads
in the other.
"""
from __future__ import annotations

import numpy as np

from ..vocab import tree


def save_vocabulary(path: str, voc: tree.Vocabulary):
    centers, weights = tree.to_arrays(voc)
    np.savez_compressed(
        path, k=voc.k, depth=voc.depth, weights=weights,
        **{f"centers_{i}": c for i, c in enumerate(centers)})


def load_vocabulary(path: str) -> tree.Vocabulary:
    """A vocabulary of CPU tensors from a `.npz` or an ORBvoc `.txt`."""
    if path.endswith(".txt"):
        return tree.load_orbvoc_text(path)
    d = np.load(path)
    depth = int(d["depth"])
    return tree.from_arrays([d[f"centers_{i}"] for i in range(depth)],
                            d["weights"], int(d["k"]))
