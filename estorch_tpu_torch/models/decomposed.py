"""Decomposed member forward: one shared product plus a noise term.

Counterpart of ``estorch_tpu/models/decomposed.py``.  For a dense layer
with shared weights W and member noise E_i,

    z_i = x_i @ (W + c_i E_i) = x_i @ W + c_i (x_i @ E_i),   c_i = σ s_i

— the same contractions reordered, not an approximation.  The per-member
form is what ``ops.noise_kernels.mlp_streamed_apply`` is held against; the
population-batched forms below run the engine's ``decomposed`` and
``low_rank`` paths.
"""

from __future__ import annotations

from typing import Any

import torch


def _ordered_dense_names(params: Any) -> list[str]:
    """Layers in forward order: ``dense_i`` by number (so ``dense_2``
    before ``dense_10``, unlike the flat layout's string order), then
    ``head``."""
    names = sorted((n for n in params if n.startswith("dense_")),
                   key=lambda n: int(n.split("_")[1]))
    names.append("head")
    return names


def supports_decomposed(module) -> bool:
    """True for modules whose forward this file reproduces exactly."""
    from .policies import MLPPolicy

    # exact type: a subclass may override forward, which this file would
    # silently fail to reproduce
    return type(module) is MLPPolicy and not module.use_vbn


def mlp_decomposed_apply(module, shared_params: Any, noise_params: Any, scale,
                         obs: torch.Tensor) -> torch.Tensor:
    """One member's exact ``MLPPolicy`` forward with weights
    (shared + scale·noise), never forming the sum.

    ``noise_params`` is the member's ε unraveled into the shape of
    ``shared_params``; ``scale`` is σ·sign.
    """
    x = obs
    for name in _ordered_dense_names(shared_params):
        w = shared_params[name]["kernel"]
        b = shared_params[name]["bias"]
        nw = noise_params[name]["kernel"]
        nb = noise_params[name]["bias"]
        x = (x @ w) + scale * (x @ nw) + b + scale * nb
        if name != "head":
            x = module.activation(x)
    if not module.discrete:
        x = torch.tanh(x) * module.action_scale
    return x


def mlp_lowrank_apply(module, shared_params: Any, lr_noise: dict, scale,
                      obs: torch.Tensor) -> torch.Tensor:
    """One member's exact ``MLPPolicy`` forward with weights
    (shared + scale·A Bᵀ/√r), never forming a dense noise matrix.

    ``lr_noise`` is {name: (A, B, bias_noise)} from ``LowRankSpec.unpack``
    (``ops/lowrank.py``); a dense-fallback layer carries (E, None, bias).
    x @ (W + c·A Bᵀ/√r) = x@W + (c/√r)·((x@A) @ Bᵀ).
    """
    x = obs
    for name in _ordered_dense_names(shared_params):
        w = shared_params[name]["kernel"]
        b = shared_params[name]["bias"]
        a, bt, nb = lr_noise[name]
        if bt is None:
            noise_term = scale * (x @ a)
        else:
            c = scale / torch.sqrt(torch.tensor(float(a.shape[-1]), dtype=x.dtype,
                                                device=x.device))
            noise_term = c * ((x @ a) @ bt.transpose(-1, -2))
        x = (x @ w) + noise_term + b + scale * nb
        if name != "head":
            x = module.activation(x)
    if not module.discrete:
        x = torch.tanh(x) * module.action_scale
    return x


# -- population-batched forms ------------------------------------------------
#
# The JAX package vmaps the per-member forms above over the population.
# Here the population is an explicit leading axis: obs (n, e, d) holds e
# episodes of each of n members, the noise leaves carry the member axis
# ((n, m, h) kernels, (n, m, r) factors, (n, h) biases) and ``scale`` is
# (n,).  The shared x @ W stays ONE product over all n·e rows; only the
# noise term is a batched product per member.  The additions run in the
# per-member forms' order, so each member computes what its form computes.


def mlp_decomposed_population_apply(module, shared_params: Any, noise_params: Any,
                                    scale: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """:func:`mlp_decomposed_apply` for n members at once: (n, e, d) →
    (n, e, out)."""
    c = scale[:, None, None]
    x = obs
    for name in _ordered_dense_names(shared_params):
        w = shared_params[name]["kernel"]
        b = shared_params[name]["bias"]
        nw = noise_params[name]["kernel"]
        nb = noise_params[name]["bias"]
        x = (x @ w) + c * torch.bmm(x, nw) + b + c * nb[:, None, :]
        if name != "head":
            x = module.activation(x)
    if not module.discrete:
        x = torch.tanh(x) * module.action_scale
    return x


def mlp_lowrank_population_apply(module, shared_params: Any, lr_noise: dict,
                                 scale: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """:func:`mlp_lowrank_apply` for n members at once: (n, e, d) →
    (n, e, out); ``lr_noise`` from ``LowRankSpec.unpack`` of an (n,
    noise_dim) stack."""
    c = scale[:, None, None]
    x = obs
    for name in _ordered_dense_names(shared_params):
        w = shared_params[name]["kernel"]
        b = shared_params[name]["bias"]
        a, bt, nb = lr_noise[name]
        if bt is None:
            noise_term = c * torch.bmm(x, a)
        else:
            root = torch.sqrt(torch.tensor(float(a.shape[-1]), dtype=x.dtype, device=x.device))
            noise_term = (c / root) * torch.bmm(torch.bmm(x, a), bt.transpose(1, 2))
        x = (x @ w) + noise_term + b + c * nb[:, None, :]
        if name != "head":
            x = module.activation(x)
    if not module.discrete:
        x = torch.tanh(x) * module.action_scale
    return x
