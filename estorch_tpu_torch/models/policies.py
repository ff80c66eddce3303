"""Bundled policy networks.

Counterpart of ``MLPPolicy`` in ``estorch_tpu/models/policies.py``.  The
parameters are a dict in the JAX tree's names (``dense_i``, ``head``; each
with ``kernel`` stored (in, out) and ``bias``), held in one flat buffer in
``ravel_pytree``'s layout so that noise-table offsets address it.  For that
reason this module does not use ``nn.Linear``, whose weight is (out, in).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn

from ..ops.params import ParamSpec

# flax's default Dense kernel init (lecun_normal): a normal truncated to
# ±2 standard deviations, rescaled so that the variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


class MLPPolicy(nn.Module):
    """Tanh MLP policy.

    ``action_dim`` is the number of discrete actions (``discrete=True``;
    the output is logits) or the action size (continuous; the output is
    ``tanh(x)·action_scale``).
    """

    is_recurrent = False

    def __init__(self, action_dim: int, hidden: Sequence[int] = (64, 64),
                 discrete: bool = True, action_scale: float = 1.0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
                 use_vbn: bool = False):
        super().__init__()
        if use_vbn:
            raise NotImplementedError(
                "use_vbn=True is not ported yet (ROADMAP.md, port queue: "
                "recurrent and VBN)")
        self.action_dim = int(action_dim)
        self.hidden = tuple(int(h) for h in hidden)
        self.discrete = bool(discrete)
        self.action_scale = float(action_scale)
        self.activation = activation
        self.use_vbn = False
        self.spec: ParamSpec | None = None
        self.register_buffer("params_flat", torch.empty(0))

    def init_params(self, obs_dim: int, generator: torch.Generator) -> dict:
        """A fresh param dict on the generator's device: kernels
        lecun-normal (truncated), biases zero."""
        sizes = (int(obs_dim),) + self.hidden + (self.action_dim,)
        names = [f"dense_{i}" for i in range(len(self.hidden))] + ["head"]
        params = {}
        for name, fan_in, fan_out in zip(names, sizes[:-1], sizes[1:]):
            kernel = torch.empty((fan_in, fan_out), dtype=torch.float32,
                                 device=generator.device)
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            params[name] = {
                "bias": torch.zeros((fan_out,), dtype=torch.float32,
                                    device=generator.device),
                "kernel": kernel,
            }
        return params

    def set_params(self, params_flat: torch.Tensor, spec: ParamSpec) -> "MLPPolicy":
        """Make ``params_flat`` (in ``spec``'s layout) the module's center."""
        self.spec = spec
        self.params_flat = params_flat
        return self

    @property
    def params(self) -> dict:
        if self.spec is None:
            raise RuntimeError("MLPPolicy has no parameters yet; call set_params")
        return self.spec.unravel(self.params_flat)

    def apply_params(self, params: dict, obs: torch.Tensor) -> torch.Tensor:
        """The forward with the given param dict; ``obs`` (..., obs_dim)."""
        x = obs
        for i in range(len(self.hidden)):
            p = params[f"dense_{i}"]
            x = self.activation(x @ p["kernel"] + p["bias"])
        x = x @ params["head"]["kernel"] + params["head"]["bias"]
        if not self.discrete:
            x = torch.tanh(x) * self.action_scale
        return x

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.apply_params(self.params, obs)
