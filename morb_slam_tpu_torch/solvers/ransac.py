"""Batched-hypothesis RANSAC (counterpart of `morb_slam_tpu/solvers/ransac.py`).

A fixed budget of hypotheses is fitted and scored at once. The sample table
is an input: `sample_indices` draws one from a `torch.Generator` (Gumbel
top-k over the valid entries, as the reference does from its JAX key), and
callers that must reproduce another run pass that run's table instead.
"""
from __future__ import annotations

import torch

from ..tensor_ops import topk


def sample_indices(generator, n_hyp: int, k: int, valid):
    """(n_hyp, k) index samples from the valid entries, approximately
    without replacement inside a hypothesis."""
    n = valid.shape[0]
    u = torch.rand((n_hyp, n), generator=generator, device=valid.device)
    g = -torch.log(-torch.log(u.clamp(min=1e-20)))
    g = torch.where(valid[None, :], g, torch.full_like(g, float("-inf")))
    return topk(g, k)[1]


def run(idx, fit_fn, score_fn):
    """Fit every hypothesis of the sample table idx (n_hyp, k), score them
    and keep the best. fit_fn maps (n_hyp, k) indices to a batch of models;
    score_fn maps the batch to (scores (n_hyp,), inliers (n_hyp, n)).
    Returns (best_model, best_score, best_inliers, scores)."""
    models = fit_fn(idx)
    scores, inliers = score_fn(models)
    best = torch.argmax(scores)
    return models[best], scores[best], inliers[best], scores
