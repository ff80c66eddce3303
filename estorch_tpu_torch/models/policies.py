"""Bundled policy networks.

Counterparts of ``MLPPolicy`` and ``NatureCNN`` in
``estorch_tpu/models/policies.py``.  The parameters are a dict in the JAX
tree's names, held in one flat buffer in ``ravel_pytree``'s layout so that
noise-table offsets address it: keys sorted (``conv_0``, ``conv_1``,
``conv_2``, ``fc``, ``head``, ``vbn_0`` …; within a key ``bias`` before
``kernel`` and before ``scale``), a dense kernel stored (in, out) and a
conv kernel in flax's HWIO order.  For that reason these modules use no
``nn.Linear``/``nn.Conv2d``, whose weights are laid out otherwise.

With ``use_vbn`` a VirtualBatchNorm layer (``models/vbn.py``) follows each
hidden dense or conv layer; its frozen statistics are the module's
``vbn_stats``, shared by every member, and its ``scale``/``bias`` are
params.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.params import ParamSpec
from . import vbn

# flax's default kernel init (lecun_normal): a normal truncated to ±2
# standard deviations, rescaled so that the variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


def _lecun_kernel(shape: tuple, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    kernel = torch.empty(shape, dtype=torch.float32, device=generator.device)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return kernel


def _zeros(n: int, generator: torch.Generator) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.float32, device=generator.device)


class _FlatParamsPolicy(nn.Module):
    """A policy whose center lives in one flat vector in a ``ParamSpec``'s
    layout, with frozen VBN statistics beside it."""

    is_recurrent = False

    def __init__(self):
        super().__init__()
        self.spec: ParamSpec | None = None
        self.vbn_stats: dict | None = None  # set once from a reference batch
        self.register_buffer("params_flat", torch.empty(0))

    def set_params(self, params_flat: torch.Tensor, spec: ParamSpec):
        """Make ``params_flat`` (in ``spec``'s layout) the module's center."""
        self.spec = spec
        self.params_flat = params_flat
        return self

    @property
    def params(self) -> dict:
        if self.spec is None:
            raise RuntimeError(f"{type(self).__name__} has no parameters yet; call set_params")
        return self.spec.unravel(self.params_flat)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.apply_params(self.params, obs)


def _dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``x @ kernel + bias``; mixed dtypes promote first, as flax's Dense
    does (a bf16 kernel after a float32 VBN output computes in float32)."""
    k, b = p["kernel"], p["bias"]
    if x.dtype != k.dtype:
        dt = torch.promote_types(x.dtype, k.dtype)
        x, k, b = x.to(dt), k.to(dt), b.to(dt)
    return x @ k + b


class MLPPolicy(_FlatParamsPolicy):
    """Tanh MLP policy.

    ``action_dim`` is the number of discrete actions (``discrete=True``;
    the output is logits) or the action size (continuous; the output is
    ``tanh(x)·action_scale``).  ``use_vbn`` runs on the pooled backend.
    """

    def __init__(self, action_dim: int, hidden: Sequence[int] = (64, 64),
                 discrete: bool = True, action_scale: float = 1.0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
                 use_vbn: bool = False):
        super().__init__()
        self.action_dim = int(action_dim)
        self.hidden = tuple(int(h) for h in hidden)
        self.discrete = bool(discrete)
        self.action_scale = float(action_scale)
        self.activation = activation
        self.use_vbn = bool(use_vbn)

    def init_params(self, obs_shape: int | tuple, generator: torch.Generator) -> dict:
        """A fresh param dict on the generator's device: kernels
        lecun-normal (truncated), biases zeros, VBN scales ones.  The first
        layer reads the observation's last axis, as flax's Dense does."""
        obs_dim = obs_shape[-1] if isinstance(obs_shape, tuple) else obs_shape
        sizes = (int(obs_dim),) + self.hidden + (self.action_dim,)
        names = [f"dense_{i}" for i in range(len(self.hidden))] + ["head"]
        params = {}
        for name, fan_in, fan_out in zip(names, sizes[:-1], sizes[1:]):
            params[name] = {"bias": _zeros(fan_out, generator),
                            "kernel": _lecun_kernel((fan_in, fan_out), fan_in, generator)}
        if self.use_vbn:
            for i, h in enumerate(self.hidden):
                params[f"vbn_{i}"] = vbn.VirtualBatchNorm(h).init_params(generator.device)
        return params

    def apply_params(self, params: dict, obs: torch.Tensor,
                     captured: dict | None = None) -> torch.Tensor:
        """The forward with the given param dict; ``obs`` (..., obs_dim).
        ``captured`` collects the VBN statistics of this forward
        (``models/vbn.py``)."""
        x = obs
        for i in range(len(self.hidden)):
            x = _dense(x, params[f"dense_{i}"])
            if self.use_vbn:
                x = vbn.layer(f"vbn_{i}", x, params, self.vbn_stats, captured)
            x = self.activation(x)
        x = _dense(x, params["head"])
        if not self.discrete:
            x = torch.tanh(x) * self.action_scale
        return x


# the Nature-DQN trunk: (features, kernel size, stride), "VALID" padding
_CONV_STACK = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
_FC = 512


class NatureCNN(_FlatParamsPolicy):
    """Nature-DQN CNN policy for (84, 84, C) observations: convolutions
    32×8s4, 64×4s2, 64×3s1 (each followed by VBN with ``use_vbn``, then a
    ReLU), a ReLU dense layer of 512 and a linear head of ``action_dim``
    logits.  Float pixels pass through; integer pixels are divided by 255.

    The population forward (:meth:`population_apply`) runs each layer of
    every member as one ``torch.bmm`` (the convolutions over their patches),
    over weights laid out once a generation by :meth:`population_layout`.
    """

    def __init__(self, action_dim: int, use_vbn: bool = True, discrete: bool = True):
        super().__init__()
        self.action_dim = int(action_dim)
        self.use_vbn = bool(use_vbn)
        self.discrete = bool(discrete)
        self.obs_shape: tuple | None = None  # (H, W, C), set by init_params

    def init_params(self, obs_shape: tuple, generator: torch.Generator) -> dict:
        """Fresh params for observations of ``obs_shape`` (H, W, C)."""
        if len(obs_shape) != 3:
            raise ValueError(f"NatureCNN needs (H, W, C) observations, got {obs_shape}")
        self.obs_shape = tuple(int(s) for s in obs_shape)
        h, w, cin = self.obs_shape
        params = {}
        for i, (feat, k, stride) in enumerate(_CONV_STACK):
            params[f"conv_{i}"] = {"bias": _zeros(feat, generator),
                                   "kernel": _lecun_kernel((k, k, cin, feat), k * k * cin,
                                                           generator)}
            if self.use_vbn:
                params[f"vbn_{i}"] = vbn.VirtualBatchNorm(feat).init_params(generator.device)
            h, w, cin = (h - k) // stride + 1, (w - k) // stride + 1, feat
        flat = h * w * cin
        params["fc"] = {"bias": _zeros(_FC, generator),
                        "kernel": _lecun_kernel((flat, _FC), flat, generator)}
        params["head"] = {"bias": _zeros(self.action_dim, generator),
                          "kernel": _lecun_kernel((_FC, self.action_dim), _FC, generator)}
        return params

    def population_layout(self, members: dict) -> dict:
        """The population forward's weights from member param dicts (each
        leaf with a leading axis of P members), laid out once: conv kernels
        HWIO → (P, out, in·kh·kw), a patch's order in the forward;
        every leaf float32 (a bf16 member computes in float32 with its
        bf16-rounded weights, as flax's dtype promotion does with
        NatureCNN's float32 input)."""
        p = members["head"]["kernel"].shape[0]
        layout: dict = {"members": p}
        for i, (feat, _, _) in enumerate(_CONV_STACK):
            conv = members[f"conv_{i}"]
            k = conv["kernel"].to(torch.float32)
            layout[f"conv_{i}"] = (k.permute(0, 4, 3, 1, 2).reshape(p, feat, -1).contiguous(),
                                   conv["bias"].to(torch.float32)[:, :, None])
            if self.use_vbn:  # (P, 1, C): one member axis, then the batch's
                layout[f"vbn_{i}"] = {name: v.to(torch.float32)[:, None, :]
                                      for name, v in members[f"vbn_{i}"].items()}
        for name in ("fc", "head"):
            layout[name] = (members[name]["kernel"].to(torch.float32),
                            members[name]["bias"].to(torch.float32)[:, None, :])
        return layout

    def population_apply(self, layout: dict, obs: torch.Tensor,
                         captured: dict | None = None) -> torch.Tensor:
        """Logits (P, B, action_dim) of the P laid-out members, each on its
        own B observations: ``obs`` (P, B, H, W, C), or (P, H·W·C) flat
        rows (B = 1) as the pools give them.  Each convolution is one copy
        of every member's patches out of a strided view and one
        ``torch.bmm`` with the members' kernels: on CUDA, cuDNN's grouped
        ``F.conv2d`` and ``F.unfold`` both launch a kernel a member."""
        p = layout["members"]
        x = obs.reshape((p, -1) + self.obs_shape)
        x = x.to(torch.float32) / 255.0 if not torch.is_floating_point(x) else x.to(torch.float32)
        b = x.shape[1]
        x = x.permute(0, 1, 4, 2, 3)  # (P, B, C, H, W)
        for i, (feat, k, stride) in enumerate(_CONV_STACK):
            # every member's patches as one strided view (P, B, C, H', W', k, k),
            # copied once into (P, C·k·k, B·H'·W')
            patches = x.unfold(3, k, stride).unfold(4, k, stride)
            h, w = patches.shape[3], patches.shape[4]
            cols = patches.permute(0, 2, 5, 6, 1, 3, 4).reshape(p, -1, b * h * w)
            weight, bias = layout[f"conv_{i}"]
            x = (torch.bmm(weight, cols) + bias).view(p, feat, b, h, w).transpose(1, 2)
            if self.use_vbn:
                x = vbn.layer(f"vbn_{i}", x, layout, self.vbn_stats, captured, feature_axis=2)
            x = F.relu(x)
        # flax flattens the NHWC activation: (P, B, 64, 7, 7) → (P, B, 7·7·64)
        x = x.permute(0, 1, 3, 4, 2).reshape(p, b, -1)
        weight, bias = layout["fc"]
        x = F.relu(torch.bmm(x, weight) + bias)
        weight, bias = layout["head"]
        return torch.bmm(x, weight) + bias

    def apply_params(self, params: dict, obs: torch.Tensor,
                     captured: dict | None = None) -> torch.Tensor:
        """One policy's logits for one observation (H, W, C) → (A,) or a
        batch (N, H, W, C) → (N, A)."""
        single = obs.ndim == 3
        x = obs[None] if single else obs
        if self.obs_shape is None:
            self.obs_shape = tuple(int(s) for s in x.shape[1:])
        members = {k: {n: v[None] for n, v in leaves.items()} for k, leaves in params.items()}
        out = self.population_apply(self.population_layout(members), x[None], captured)[0]
        return out[0] if single else out
