"""VirtualBatchNorm: frozen reference-batch statistics and a learned affine.

Counterpart of ``estorch_tpu/models/vbn.py``.  The statistics are computed
once from a fixed reference batch and then frozen; every forward
normalizes with them and a per-layer ``scale``/``bias``.  The frozen
``mean``/``var`` live outside the params dict, in a ``vbn_stats`` dict
(``{"vbn_i": {"mean", "var"}}``) that the whole population shares and ES
never perturbs; ``scale``/``bias`` are params, so each member carries its
own.  As in flax, the variance is the biased one (``jnp.var``) and the
normalization ``(x - mean)·rsqrt(var + 1e-5)·scale + bias``.

A policy with VBN layers takes ``captured``: a dict that its forward fills
with each layer's statistics of that forward's input (normalizing with
them), which is how :func:`capture_reference_stats` reads them.
"""

from __future__ import annotations

from typing import Sequence

import torch

EPS = 1e-5


class VirtualBatchNorm:
    """One VBN layer of ``num_features`` channels (eps 1e-5, flax's)."""

    def __init__(self, num_features: int):
        self.num_features = int(num_features)

    def init_params(self, device) -> dict:
        """``bias`` zeros, ``scale`` ones (flax's initializers)."""
        return {"bias": torch.zeros((self.num_features,), device=device),
                "scale": torch.ones((self.num_features,), device=device)}


def moments(x: torch.Tensor, dims: Sequence[int]) -> dict:
    """Mean and biased variance of ``x`` over ``dims`` (float32)."""
    x = x.to(torch.float32)
    return {"mean": x.mean(dim=tuple(dims)),
            "var": x.var(dim=tuple(dims), correction=0)}


def normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """``(x - mean)·rsqrt(var + eps)·scale + bias``, in the JAX package's
    order of operations; the caller shapes the four vectors to broadcast."""
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def layer(name: str, x: torch.Tensor, params: dict, stats: dict | None,
          captured: dict | None, feature_axis: int = -1) -> torch.Tensor:
    """Layer ``name`` of a policy's VBN stack on ``x``.

    ``stats`` holds the frozen statistics; with ``captured`` a dict, the
    statistics of ``x`` over every axis but ``feature_axis`` are computed,
    stored there and used instead.  ``params[name]`` holds ``scale`` and
    ``bias``, (C,) or with leading member axes that broadcast against the
    axes of ``x`` before ``feature_axis``.
    """
    nd = x.ndim
    feature_axis %= nd
    if captured is not None:
        captured[name] = moments(x, [d for d in range(nd) if d != feature_axis])
        s = captured[name]
    elif stats is None:
        raise RuntimeError(
            "VirtualBatchNorm has no frozen statistics; capture them with "
            "capture_reference_stats and set the policy's vbn_stats")
    else:
        s = stats[name]
    trailing = (1,) * (nd - 1 - feature_axis)  # the axes after the features

    def bc(v):
        return v.reshape(v.shape + trailing)

    p = params[name]
    return normalize(x, bc(s["mean"]), bc(s["var"]), bc(p["scale"]), bc(p["bias"]))


def capture_reference_stats(module, params: dict, reference_batch: torch.Tensor) -> dict:
    """Run the reference batch through ``module`` once with ``params`` and
    return the frozen ``vbn_stats`` it measured, layer by layer (each
    layer's statistics are those of its input after the layers before it
    normalized with theirs, as flax's ``update_stats=True`` pass gives)."""
    captured: dict = {}
    module.apply_params(params, reference_batch, captured=captured)
    return captured
