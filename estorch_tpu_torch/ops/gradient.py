"""ES gradient estimator: rank-weighted noise reduction (plain PyTorch).

Counterpart of ``estorch_tpu/ops/gradient.py``:

    ∇̂_θ E[f] = (1 / (n·σ)) Σ_i w_i · ε_i

Mirrored pairs are folded first: members 2k (+ε_k) and 2k+1 (−ε_k) share
table row k, so Σ_i w_i s_i ε_i = Σ_k (w_2k − w_2k+1) ε_k.  The engine's
update uses the streamed kernel ``noise_kernels.weighted_noise_sum``; these
are the chunked plain forms the JAX package uses without it.
"""

from __future__ import annotations

import torch

from .noise import NoiseTable, gather_rows


def rank_weighted_noise_sum(table: NoiseTable, offsets: torch.Tensor,
                            weights: torch.Tensor, dim: int,
                            chunk: int = 256, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Σ_i weights_i · ε_i, gathering at most ``chunk`` rows at a time.
    ``dtype`` (default the table's) is the accumulator's: float64 sums
    the float32 products exactly enough that any order rounds alike."""
    n = offsets.shape[0]
    dtype = table.data.dtype if dtype is None else dtype
    acc = torch.zeros((dim,), dtype=dtype, device=table.data.device)
    weights = weights.to(dtype)
    for lo in range(0, n, chunk):
        rows = gather_rows(table.data, offsets[lo:lo + chunk], dim).to(dtype)
        acc += weights[lo:lo + chunk] @ rows  # in place: one (dim,) buffer
    return acc


def fold_mirrored_weights(rank_weights: torch.Tensor) -> torch.Tensor:
    """Per-pair weights (w_2k − w_2k+1) from per-member rank weights."""
    return rank_weights[0::2] - rank_weights[1::2]


def es_gradient(table: NoiseTable, pair_offsets: torch.Tensor,
                rank_weights: torch.Tensor, sigma, population_size: int,
                dim: int, chunk: int = 256) -> torch.Tensor:
    """Ascent direction (1/(n·σ)) Σ_i w_i s_i ε_i from per-pair offsets and
    per-member weights in the mirrored layout."""
    pw = fold_mirrored_weights(rank_weights)
    total = rank_weighted_noise_sum(table, pair_offsets, pw, dim=dim, chunk=chunk)
    return total / (population_size * sigma)
