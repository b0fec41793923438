"""ORB feature extraction: pyramid, FAST, grid-balanced selection,
orientation and rotated BRIEF (counterpart of `morb_slam_tpu/frontend.py`).

Per level: K1 (`ops.fast.fast_select`) scores every pixel and keeps the two
best keys of each 16x16 cell; a stable descending sort keeps the level's
best `n_keep` of those; the 7x7 blur runs in plain PyTorch; K2
(`ops.orb_descriptor.orb_describe`) computes angles and descriptors.
Outputs are fixed-capacity masked tensors, as in the reference package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .ops import fast as fast_ops
from .ops import image as image_ops
from .ops import orb_descriptor as orb_desc

BORDER = fast_ops.BORDER
CELL = fast_ops.CELL
CELL_K = fast_ops.CELL_K
STRONG_BOOST = fast_ops.STRONG_BOOST


@dataclass(frozen=True)
class OrbConfig:
    n_features: int = 1200
    n_levels: int = 8
    scale: float = 1.2
    th_fast_hi: float = 20.0
    th_fast_lo: float = 7.0

    def per_level_counts(self):
        """Geometric feature budget per level."""
        f = 1.0 / self.scale
        total = (1 - f ** self.n_levels) / (1 - f)
        counts = [int(round(self.n_features / total * f ** l))
                  for l in range(self.n_levels)]
        counts[-1] = max(0, self.n_features - sum(counts[:-1]))
        return counts


class Features(NamedTuple):
    """Fixed-capacity extracted features (capacity = n_features).

    uv (N, 2) float32 level-0 pixel coords (x, y); response (N,) FAST score
    (meaningful on valid slots only); angle (N,) radians; octave (N,) int32;
    size (N,) float32; desc (N, 8) int32 words; valid (N,) bool.
    """
    uv: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor
    octave: torch.Tensor
    size: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def n(self):
        return int(self.valid.sum())


def select_level_keypoints(level, n_keep: int, cfg: OrbConfig):
    """K1 + the level's global top-n_keep (stable, so ties keep the lower
    cell slot as jax.lax.top_k does). Returns (yx (n_keep, 2) int32 with 0
    on invalid slots, key (n_keep,), response (n_keep,), valid (n_keep,))."""
    w = level.shape[1]
    key, idx, score = fast_ops.fast_select(level, cfg.th_fast_lo,
                                           cfg.th_fast_hi, STRONG_BOOST,
                                           BORDER)
    vals, order = torch.sort(key.reshape(-1), descending=True, stable=True)
    top_vals, top_i = vals[:n_keep], order[:n_keep]
    pix = idx.reshape(-1)[top_i]
    valid = top_vals > -math.inf
    yx = torch.stack([pix // w, pix % w], dim=-1).to(torch.int32)
    yx = torch.where(valid[:, None], yx, torch.zeros_like(yx))
    return yx, top_vals, score.reshape(-1)[top_i], valid


def extract_orb(img, cfg: OrbConfig = OrbConfig()) -> Features:
    """Grayscale (H, W) float32 in [0, 255] -> Features."""
    levels = image_ops.build_pyramid(img, cfg.n_levels, cfg.scale)
    counts = cfg.per_level_counts()
    out = {k: [] for k in Features._fields}
    for l, (lvl, n_keep) in enumerate(zip(levels, counts)):
        if n_keep == 0:
            continue
        lvl = lvl.contiguous()
        yx, _, resp, valid = select_level_keypoints(lvl, n_keep, cfg)
        blurred = image_ops.gaussian_blur(lvl).contiguous()
        ang, desc = orb_desc.orb_describe(lvl, blurred, yx.contiguous())
        s = cfg.scale ** l
        out["uv"].append(torch.stack([yx[:, 1].to(torch.float32) * s,
                                      yx[:, 0].to(torch.float32) * s], dim=-1))
        out["response"].append(resp)
        out["angle"].append(ang)
        out["octave"].append(torch.full((n_keep,), l, dtype=torch.int32,
                                        device=img.device))
        out["size"].append(torch.full((n_keep,), 31.0 * s,
                                      dtype=torch.float32, device=img.device))
        out["desc"].append(desc)
        out["valid"].append(valid)
    return Features(**{k: torch.cat(v) for k, v in out.items()})
