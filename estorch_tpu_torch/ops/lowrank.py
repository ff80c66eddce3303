"""Low-rank perturbations: per-layer kernel noise E = A·Bᵀ/√r.

Counterpart of the MLP form in ``estorch_tpu/ops/lowrank.py``.  Each
member's noise is one contiguous (noise_dim,) table slice laid out
``A‖B‖dense‖bias``, exactly as in the JAX package, so one table offset
addresses the same floats on both sides:

- a layer (m, n) is factored, A (m, r) and B (n, r), only where that saves
  noise floats, r·(m+n) < m·n; otherwise it carries exact dense noise
  E (m, n);
- biases always carry dense noise.

The update never forms a member's E: ΔW = einsum('kmr,knr->mn', w·A, B)/√r,
one contraction per layer over the population.  The tree form for
recurrent policies waits for ROADMAP.md port queue item 3, the in-program
factors of the sharded engine for item 7.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class LowRankSpec:
    """Static layout of one member's low-rank noise vector.

    ``lr_layers``: (name, m, n, a_off, b_off) — factors A (m, r) and
    B (n, r) at those offsets; ``dense_layers``: (name, m, n, off) — exact
    dense kernel noise; ``biases``: (name, n, off) — dense bias noise.
    """

    rank: int
    noise_dim: int
    lr_layers: tuple
    dense_layers: tuple
    biases: tuple

    def unpack(self, noise_vec: torch.Tensor) -> dict:
        """(..., noise_dim) slices → {name: (A, B, bias)} for factored
        layers and {name: (E, None, bias)} for dense ones; leading axes (a
        stack of members) are kept: A (..., m, r), E (..., m, n)."""
        r = self.rank
        lead = tuple(noise_vec.shape[:-1])
        out: dict[str, list] = {}
        for name, m, n, a_off, b_off in self.lr_layers:
            a = noise_vec[..., a_off:a_off + m * r].reshape(lead + (m, r))
            b = noise_vec[..., b_off:b_off + n * r].reshape(lead + (n, r))
            out[name] = [a, b, None]
        for name, m, n, off in self.dense_layers:
            out[name] = [noise_vec[..., off:off + m * n].reshape(lead + (m, n)), None, None]
        for name, n, off in self.biases:
            out[name][2] = noise_vec[..., off:off + n]
        return {k: tuple(v) for k, v in out.items()}


def make_lowrank_spec(params: Any, rank: int) -> LowRankSpec:
    """Layout from an MLP param dict ({name: {kernel, bias}})."""
    from ..models.decomposed import _ordered_dense_names

    if rank < 1:
        raise ValueError(f"low_rank must be >= 1, got {rank}")
    names = _ordered_dense_names(params)
    lr_layers, dense_layers, biases = [], [], []
    off = 0
    for name in names:
        m, n = (int(s) for s in params[name]["kernel"].shape)
        # factor only where it saves floats (this also implies r < min(m, n))
        if rank * (m + n) < m * n:
            lr_layers.append((name, m, n, off, off + m * rank))
            off += (m + n) * rank
        else:
            dense_layers.append((name, m, n, off))
            off += m * n
    for name in names:
        (n,) = (int(s) for s in params[name]["bias"].shape)
        biases.append((name, n, off))
        off += n
    return LowRankSpec(rank=rank, noise_dim=off, lr_layers=tuple(lr_layers),
                       dense_layers=tuple(dense_layers), biases=tuple(biases))


def dense_kernel(rank: int, a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """One layer's dense E from its unpacked factors (a dense layer's ``a``
    is E itself)."""
    if b is None:
        return a
    root = torch.sqrt(torch.tensor(float(rank), dtype=torch.float32, device=a.device))
    return (a @ b.transpose(-1, -2)) / root


def lowrank_noise_tree(lr_spec: LowRankSpec, noise_vec: torch.Tensor) -> dict:
    """The dense noise dict {name: {kernel, bias}} that one member's
    (noise_dim,) slice stands for — for snapshots, not the hot path."""
    return {name: {"kernel": dense_kernel(lr_spec.rank, a, b), "bias": nb}
            for name, (a, b, nb) in lr_spec.unpack(noise_vec).items()}


def lowrank_weighted_sum(lr_spec: LowRankSpec, noise_mat: torch.Tensor,
                         weights: torch.Tensor) -> dict:
    """Σ_k w_k · dense(noise_k) as a {name: {kernel, bias}} dict, never
    forming a member's dense E.

    ``noise_mat`` (k, noise_dim) stacks the rows' slices; ``weights`` (k,)
    are per row (mirrored: already folded, w⁺ − w⁻, since a pair shares one
    slice).
    """
    r = lr_spec.rank
    k = noise_mat.shape[0]
    # 1/√r formed in float32, as the JAX package forms it
    scale = 1.0 / torch.sqrt(torch.tensor(float(r), dtype=torch.float32,
                                          device=noise_mat.device))
    out: dict[str, dict] = {}
    for name, m, n, a_off, b_off in lr_spec.lr_layers:
        a = noise_mat[:, a_off:a_off + m * r].reshape(k, m, r)
        b = noise_mat[:, b_off:b_off + n * r].reshape(k, n, r)
        kernel = torch.einsum("kmr,knr->mn", a * weights[:, None, None], b) * scale
        out[name] = {"kernel": kernel}
    for name, m, n, off in lr_spec.dense_layers:
        out[name] = {"kernel": (weights @ noise_mat[:, off:off + m * n]).reshape(m, n)}
    for name, n, off in lr_spec.biases:
        out[name]["bias"] = weights @ noise_mat[:, off:off + n]
    return out
