"""Low-rank perturbations: per-layer kernel noise E = A·Bᵀ/√r.

Counterpart of ``estorch_tpu/ops/lowrank.py``, its MLP form and its tree
form.  Each
member's noise is one contiguous (noise_dim,) table slice laid out
``A‖B‖dense‖bias``, exactly as in the JAX package, so one table offset
addresses the same floats on both sides:

- a layer (m, n) is factored, A (m, r) and B (n, r), only where that saves
  noise floats, r·(m+n) < m·n; otherwise it carries exact dense noise
  E (m, n);
- biases always carry dense noise.

The update never forms a member's E: ΔW = einsum('kmr,knr->mn', w·A, B)/√r,
one contraction per layer over the population.

The tree form (``LowRankTreeSpec``) serves any param dict, the recurrent
policies' among them, whose forward cannot be restructured around the
factors: every 2-D leaf where r·(m+n) < m·n is factored, every other leaf
(biases, the learned carry ``carry0_*``) takes dense noise, in
``ravel_pytree``'s leaf order; each member's dense perturbation is formed
once an episode and the rollout is the standard one.  The param-sharded
engine (``parallel/sharded.py``) generates its factors instead of slicing
them: :func:`lowrank_program_factors` on the program noise stream
(``ops/noise.py``), by the same r·(m+n) < m·n rule.
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


def lowrank_factors_save(rank: int, m: int, n: int) -> bool:
    """Whether an (m, n) leaf factors at rank r: only where it saves noise
    floats, r·(m+n) < m·n (which also implies r < min(m, n))."""
    return int(rank) * (m + n) < m * n


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
        if lowrank_factors_save(rank, m, n):
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


# ---- the tree form (recurrent and other policies) --------------------------


@dataclasses.dataclass(frozen=True)
class LowRankTreeSpec:
    """Static layout of one member's low-rank noise vector over a param
    dict, leaves in ``ravel_pytree``'s order (``ops/params.py``).

    ``paths``: each leaf's key path; ``lr_leaves``: (leaf index, m, n,
    a_off, b_off) — factored 2-D leaves; ``dense_leaves``: (leaf index,
    shape, size, off) — exact dense noise.
    """

    rank: int
    noise_dim: int
    paths: tuple
    lr_leaves: tuple
    dense_leaves: tuple

    def tree(self, leaves: list) -> dict:
        """The nested dict of ``leaves`` in this spec's order."""
        out: dict = {}
        for path, leaf in zip(self.paths, leaves):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return out


def make_lowrank_tree_spec(params: dict, rank: int) -> LowRankTreeSpec:
    """Layout from any param dict — the recurrent policies' entry point."""
    from .params import make_param_spec

    if rank < 1:
        raise ValueError(f"low_rank must be >= 1, got {rank}")
    _, spec = make_param_spec(params)
    lr_leaves, dense_leaves = [], []
    off = 0
    for i, shape in enumerate(spec.shapes):
        if len(shape) == 2 and lowrank_factors_save(rank, *shape):
            m, n = shape
            lr_leaves.append((i, m, n, off, off + m * rank))
            off += (m + n) * rank
        else:
            size = 1
            for s in shape:
                size *= s
            dense_leaves.append((i, shape, size, off))
            off += size
    return LowRankTreeSpec(rank=rank, noise_dim=off, paths=spec.paths,
                           lr_leaves=tuple(lr_leaves), dense_leaves=tuple(dense_leaves))


def _inv_sqrt_rank(rank: int, device) -> torch.Tensor:
    """1/√r, formed in float32 as the JAX package forms it."""
    return 1.0 / torch.sqrt(torch.tensor(float(rank), dtype=torch.float32, device=device))


def lowrank_tree_noise(spec: LowRankTreeSpec, noise_vec: torch.Tensor) -> dict:
    """The dense noise dict that (..., noise_dim) slices stand for; leading
    axes (a stack of members) are kept: a leaf is (..., *shape)."""
    r = spec.rank
    lead = tuple(noise_vec.shape[:-1])
    scale = _inv_sqrt_rank(r, noise_vec.device)
    leaves: list = [None] * len(spec.paths)
    for i, m, n, a_off, b_off in spec.lr_leaves:
        a = noise_vec[..., a_off:a_off + m * r].reshape(lead + (m, r))
        b = noise_vec[..., b_off:b_off + n * r].reshape(lead + (n, r))
        leaves[i] = (a @ b.transpose(-1, -2)) * scale
    for i, shape, size, off in spec.dense_leaves:
        leaves[i] = noise_vec[..., off:off + size].reshape(lead + tuple(shape))
    return spec.tree(leaves)


def lowrank_tree_perturb(spec: LowRankTreeSpec, params: dict, noise_vec: torch.Tensor,
                         scale: torch.Tensor) -> dict:
    """``params + scale · dense(noise_vec)``: the members' perturbed trees,
    formed once an episode.  ``noise_vec`` (k, noise_dim) and ``scale``
    (k,) give leaves (k, *shape); (noise_dim,) and a scalar, one tree."""
    noise = lowrank_tree_noise(spec, noise_vec)
    out_leaves = []
    for path in spec.paths:
        w, e = params, noise
        for key in path:
            w, e = w[key], e[key]
        c = scale.reshape(scale.shape + (1,) * (e.ndim - scale.ndim))
        out_leaves.append(w + c * e)
    return spec.tree(out_leaves)


def lowrank_tree_weighted_sum(spec: LowRankTreeSpec, noise_mat: torch.Tensor,
                              weights: torch.Tensor) -> dict:
    """Σ_k w_k · dense(noise_k) as a param dict, never forming a member's
    dense noise — the tree twin of :func:`lowrank_weighted_sum`.
    ``noise_mat`` (k, noise_dim), ``weights`` (k,) per row (mirrored:
    folded)."""
    r = spec.rank
    k = noise_mat.shape[0]
    scale = _inv_sqrt_rank(r, noise_mat.device)
    leaves: list = [None] * len(spec.paths)
    for i, m, n, a_off, b_off in spec.lr_leaves:
        a = noise_mat[:, a_off:a_off + m * r].reshape(k, m, r)
        b = noise_mat[:, b_off:b_off + n * r].reshape(k, n, r)
        leaves[i] = torch.einsum("kmr,knr->mn", a * weights[:, None, None], b) * scale
    for i, shape, size, off in spec.dense_leaves:
        leaves[i] = (weights @ noise_mat[:, off:off + size]).reshape(shape)
    return spec.tree(leaves)


def lowrank_program_factors(rank: int, leaf_key: tuple, rows: torch.Tensor,
                            a_elements: torch.Tensor, b_elements: torch.Tensor):
    """Program-noise factors of one (m, n) leaf for noise rows ``rows``:
    A (k, ·, r) and B (k, ·, r), the entries ``a_elements`` of A (m, r) and
    ``b_elements`` of B (n, r), row-major indices (all of a factor, or the
    rank's rows of the one on the sharded dim).  ``leaf_key`` is the leaf's
    (``ops/noise.py`` ``leaf_noise_keys``); the sharded engine's table-free
    counterpart of :meth:`LowRankSpec.unpack`.  Entries of
    :func:`dense_kernel` of the pair are zero-mean with unit variance."""
    from .noise import factor_keys, program_noise

    ka, kb = factor_keys(leaf_key)
    k = rows.shape[0]
    return (program_noise(ka, rows, a_elements).view(k, -1, rank),
            program_noise(kb, rows, b_elements).view(k, -1, rank))
