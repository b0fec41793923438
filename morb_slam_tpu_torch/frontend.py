"""ORB feature extraction: pyramid, FAST, grid-balanced selection,
orientation and rotated BRIEF (counterpart of `morb_slam_tpu/frontend.py`).

K6 (`ops.image.pyramid_blur`, one launch an image) builds the pyramid
and blurs every level (7x7). K1 (`ops.fast.fast_select_levels`) scores every
pixel of every level, keeps the two best keys of each 16x16 cell and of
those each level's best `n_keep`, with their level-0 coordinates, octave
and size. Then K2 (`ops.orb_descriptor.orb_describe_levels`) computes the
angles and descriptors of every level's keypoints on the raw and the
blurred levels in one launch.
Outputs are fixed-capacity masked tensors, as in the reference package.
"""
from __future__ import annotations

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


def extract_orb(img, cfg: OrbConfig = OrbConfig()) -> Features:
    """Grayscale (H, W) float32 in [0, 255] -> Features."""
    levels, blurred = image_ops.pyramid_blur(img, cfg.n_levels, cfg.scale)
    counts = cfg.per_level_counts()
    kp = fast_ops.fast_select_levels(levels, counts, cfg)
    ang, desc = orb_desc.orb_describe_levels(levels, blurred, kp.level_yx())
    return Features(uv=kp.uv, response=kp.response, angle=ang,
                    octave=kp.octave, size=kp.size, desc=desc,
                    valid=kp.valid)
