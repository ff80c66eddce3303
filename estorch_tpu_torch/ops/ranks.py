"""Centered rank transformation (fitness shaping).

Counterpart of ``estorch_tpu/ops/ranks.py``: raw returns become centered
ranks in [-0.5, 0.5], so the update is invariant to reward scale.  Ties
break by position (stable sort), as in the JAX package.
"""

from __future__ import annotations

import torch


def _positions(x: torch.Tensor) -> torch.Tensor:
    """Rank of each element under a stable ascending sort (int64)."""
    order = torch.argsort(x, stable=True)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(x.shape[0], device=x.device)
    return pos


def compute_ranks(x: torch.Tensor) -> torch.Tensor:
    """Integer ranks in [0, n): the smallest element has rank 0."""
    return _positions(x).to(torch.int32)


def centered_rank(x: torch.Tensor) -> torch.Tensor:
    """``rank(x_i)/(n-1) - 0.5``; sums to zero."""
    n = x.shape[0]
    if n < 2:
        return torch.zeros_like(x, dtype=torch.float32)
    return compute_ranks(x).to(torch.float32) / (n - 1) - 0.5


def centered_rank_safe(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Centered ranks that tolerate non-finite fitness.

    NaN/±inf members sort as +inf and get weight 0; valid members are
    ranked among themselves and rescaled by n/n_valid, so the engine's
    fixed 1/n normalization gives the mean over real contributors.  Fewer
    than 2 valid members give all-zero weights.  Equal to
    :func:`centered_rank` when every entry is finite.  Returns
    ``(weights, n_valid)`` with ``n_valid`` a 0-d int32 tensor; nothing here
    waits for the device.
    """
    n = x.shape[0]
    valid = torch.isfinite(x)
    n_valid = valid.sum().to(torch.int32)
    if n < 2:
        return torch.zeros_like(x, dtype=torch.float32), n_valid
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    pos = _positions(torch.where(valid, x, inf))
    denom = torch.clamp(n_valid - 1, min=1).to(torch.float32)
    sub = pos.to(torch.float32) / denom - 0.5
    scale = torch.tensor(float(n), dtype=torch.float32, device=x.device) / torch.clamp(
        n_valid, min=1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    weights = torch.where(valid, sub * scale, zero)
    weights = torch.where(n_valid >= 2, weights, zero)
    return weights, n_valid
