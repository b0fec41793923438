"""Robust kernel weights for iteratively-reweighted least squares
(counterpart of `morb_slam_tpu/optim/robust.py`)."""
from __future__ import annotations

import torch


def huber_weight(chi2, delta2):
    """w = 1 inside the Huber threshold, delta/|r| outside."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def cauchy_weight(chi2, delta2):
    """w = 1 / (1 + chi2 / delta2), the Cauchy kernel's IRLS weight."""
    return 1.0 / (1.0 + chi2 / delta2)
