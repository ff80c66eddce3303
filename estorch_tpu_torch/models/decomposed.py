"""Decomposed member forward: one shared product plus a noise term.

Counterpart of ``estorch_tpu/models/decomposed.py``.  For a dense layer
with shared weights W and member noise E_i,

    z_i = x_i @ (W + c_i E_i) = x_i @ W + c_i (x_i @ E_i),   c_i = σ s_i

— the same contractions reordered, not an approximation.  This is the plain
form that ``ops.noise_kernels.mlp_streamed_apply`` is held against.
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
