"""Failure-tolerant rank weights for updates ranked on the host.

Counterpart of ``estorch_tpu/utils/fault.py``: a member whose evaluation
produced no usable fitness (NaN or ±inf) is dropped and the survivors'
weights are rescaled by n/n_valid, so the engine's fixed 1/n
normalization gives the mean over the members that contributed.
"""

from __future__ import annotations

import numpy as np

from ..ops.ranks import centered_rank_np


def valid_mask(fitness: np.ndarray) -> np.ndarray:
    """Members whose evaluation produced a usable fitness."""
    return np.isfinite(np.asarray(fitness))


def mask_and_renormalize(weights: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Zero invalid members and rescale the survivors by n/n_valid.
    Raises when fewer than 2 members survived."""
    weights = np.asarray(weights, dtype=np.float32)
    valid = np.asarray(valid, dtype=bool)
    n = weights.shape[0]
    n_valid = int(valid.sum())
    if n_valid < 2:
        raise RuntimeError(
            f"only {n_valid}/{n} population members produced valid fitness — "
            "cannot form an update; check env/rollout health")
    out = np.where(valid, weights, 0.0).astype(np.float32)
    return out * (n / n_valid)


def rank_weights_with_failures(fitness: np.ndarray) -> np.ndarray:
    """Centered ranks over the valid members only, failures weighted 0."""
    fitness = np.asarray(fitness)
    valid = valid_mask(fitness)
    if valid.all():
        return centered_rank_np(fitness)
    ranks = np.zeros(fitness.shape[0], dtype=np.float32)
    ranks[valid] = centered_rank_np(fitness[valid])
    return mask_and_renormalize(ranks, valid)
