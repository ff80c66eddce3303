"""Bundled policy networks.

Counterparts of ``MLPPolicy``, ``RecurrentPolicy``, ``RecurrentNatureCNN``
and ``NatureCNN`` in ``estorch_tpu/models/policies.py``.  The parameters
are a dict in the JAX tree's names, held in one flat buffer in
``ravel_pytree``'s layout so that noise-table offsets address it: keys
sorted (``conv_0``, ``conv_1``, ``conv_2``, ``fc``, ``head``, ``vbn_0`` …;
within a key ``bias`` before ``kernel`` and before ``scale``), a dense
kernel stored (in, out) and a conv kernel in flax's HWIO order.  For that
reason these modules use no ``nn.Linear``/``nn.Conv2d``/``nn.GRU``, whose
weights are laid out otherwise.

With ``use_vbn`` a VirtualBatchNorm layer (``models/vbn.py``) follows each
hidden dense or conv layer; its frozen statistics are the module's
``vbn_stats``, shared by every member, and its ``scale``/``bias`` are
params.

The recurrent policies follow flax's cells, not torch's: ``GRUCell`` has
biases on ``ir``, ``iz``, ``in`` and ``hn`` only, and
``n = tanh(in(x) + r·hn(h))``; ``OptimizedLSTMCell`` has biases on the
hidden kernels ``hi``/``hf``/``hg``/``ho`` only, and its carry is
``(c, h)``.  Their apply takes and returns the carry:
``population_apply(layout, obs, carry) -> (out, carry')``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..envs.rollout import map_carry
from ..ops.params import ParamSpec, map_tree
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


def _orthogonal_kernel(n: int, generator: torch.Generator) -> torch.Tensor:
    """flax's recurrent-kernel init family: an orthogonal (n, n) matrix."""
    kernel = torch.empty((n, n), dtype=torch.float32, device=generator.device)
    return nn.init.orthogonal_(kernel, generator=generator)


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


_GRU_GATES = (("ir", "iz", "in"), ("hr", "hz", "hn"))  # input side, hidden side
_LSTM_GATES = (("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho"))


def _cell_layout(cell: str, p: dict) -> tuple:
    """One cell's gate kernels concatenated along the output axis, so each
    side is one product: ``(w_in, b_in, w_hid, b_hid)``, biases with an axis
    before the features (``None`` where the side has none).  The GRU's
    hidden bias is zero on ``hr``/``hz`` and ``hn``'s own on the third
    block; adding a zero leaves those gates exact."""
    ins, hids = _GRU_GATES if cell == "gru" else _LSTM_GATES
    w_in = torch.cat([p[g]["kernel"] for g in ins], dim=-1)
    w_hid = torch.cat([p[g]["kernel"] for g in hids], dim=-1)
    if cell == "gru":
        b_in = torch.cat([p[g]["bias"] for g in ins], dim=-1).unsqueeze(-2)
        bn = p["hn"]["bias"]
        b_hid = torch.cat([torch.zeros_like(bn), torch.zeros_like(bn), bn], dim=-1).unsqueeze(-2)
        return w_in, b_in, w_hid, b_hid
    b_hid = torch.cat([p[g]["bias"] for g in hids], dim=-1).unsqueeze(-2)
    return w_in, None, w_hid, b_hid


def _gru_step(layout: tuple, x: torch.Tensor, h: torch.Tensor):
    """flax ``GRUCell``: r, z = σ(ir(x) + hr(h)), σ(iz(x) + hz(h));
    n = tanh(in(x) + r·hn(h)); h' = (1 − z)·n + z·h.  Returns (h', h')."""
    w_in, b_in, w_hid, b_hid = layout
    gi = x @ w_in + b_in
    gh = h @ w_hid + b_hid
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    new_h = (1.0 - z) * n + z * h
    return new_h, new_h


def _lstm_step(layout: tuple, x: torch.Tensor, carry: tuple):
    """flax ``OptimizedLSTMCell`` on the carry (c, h): the gates i, f, g, o
    from the hidden side (with its biases) plus the input side; c' = f·c +
    i·g, h' = o·tanh(c').  Returns ((c', h'), h')."""
    w_in, _, w_hid, b_hid = layout
    c, h = carry
    gh = h @ w_hid + b_hid
    gi = x @ w_in
    h_i, h_f, h_g, h_o = gh.chunk(4, dim=-1)
    i_i, i_f, i_g, i_o = gi.chunk(4, dim=-1)
    i = torch.sigmoid(h_i + i_i)
    f = torch.sigmoid(h_f + i_f)
    g = torch.tanh(h_g + i_g)
    o = torch.sigmoid(h_o + i_o)
    new_c = f * c + i * g
    new_h = o * torch.tanh(new_c)
    return (new_c, new_h), new_h


def _cell_params(cell: str, fan_in: int, size: int, generator: torch.Generator) -> dict:
    """Fresh params of one cell, flax's initializer families: lecun-normal
    input kernels, orthogonal hidden kernels, zero biases."""
    ins, hids = _GRU_GATES if cell == "gru" else _LSTM_GATES
    params = {}
    for g in ins:
        params[g] = {"kernel": _lecun_kernel((fan_in, size), fan_in, generator)}
        if cell == "gru":
            params[g]["bias"] = _zeros(size, generator)
    for g in hids:
        params[g] = {"kernel": _orthogonal_kernel(size, generator)}
        if cell == "lstm" or g == "hn":
            params[g]["bias"] = _zeros(size, generator)
    return params


class _RecurrentForward:
    """The single-policy entry points of a recurrent policy over its
    population forward: ``apply_params(params, obs, carry)`` and
    ``forward(obs, carry=None)`` (``None`` starts an episode)."""

    is_recurrent = True

    def forward(self, obs: torch.Tensor, carry=None):
        params = self.params
        if carry is None:
            carry = map_carry(lambda t: t.to(obs.device), self.carry_init(params))
        return self.apply_params(params, obs, carry)


class RecurrentPolicy(_RecurrentForward, _FlatParamsPolicy):
    """MLP trunk + recurrent core (GRU or LSTM stack) + action head.

    ``carry_init(params=None)`` gives the episode-start carry: a (gru_size,)
    tensor for the GRU, a ``(c, h)`` tuple for the LSTM, and a tuple of
    per-layer carries when ``n_layers > 1``.  With ``learned_carry`` the
    episode-start carry is params (``carry0_{j}``, or ``carry0_c_{j}`` and
    ``carry0_h_{j}`` for the LSTM), perturbed and updated like any weight;
    ``carry_init(params)`` reads them (from a member-batched tree they come
    with the member axis), and zeros without params.  Layer 0 is named
    ``gru``/``lstm``, layer j > 0 ``gru_j``/``lstm_j``.

    The population forward lays each layer out once
    (:meth:`population_layout`) and then computes a cell's gates with one
    product for the input side and one for the hidden side.
    """

    def __init__(self, action_dim: int, hidden: Sequence[int] = (64,), gru_size: int = 64,
                 discrete: bool = True, action_scale: float = 1.0,
                 activation: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
                 cell: str = "gru", n_layers: int = 1, learned_carry: bool = False):
        super().__init__()
        self.action_dim = int(action_dim)
        self.hidden = tuple(int(h) for h in hidden)
        self.gru_size = int(gru_size)
        self.discrete = bool(discrete)
        self.action_scale = float(action_scale)
        self.activation = activation
        self.cell = cell
        self.n_layers = int(n_layers)
        self.learned_carry = bool(learned_carry)
        self._check_cell()

    def _check_cell(self) -> None:
        if self.cell not in ("gru", "lstm"):
            raise ValueError(f"cell must be 'gru' or 'lstm', got {self.cell!r}")
        if self.n_layers < 1:
            raise ValueError(f"n_layers must be >= 1, got {self.n_layers}")

    def _cell_name(self, j: int) -> str:
        return self.cell if j == 0 else f"{self.cell}_{j}"

    def _carry0_names(self, j: int) -> tuple[str, ...]:
        if self.cell == "lstm":
            return (f"carry0_c_{j}", f"carry0_h_{j}")
        return (f"carry0_{j}",)

    def init_params(self, obs_shape: int | tuple, generator: torch.Generator) -> dict:
        """Fresh params on the generator's device: dense and input-side
        kernels lecun-normal, hidden-side kernels orthogonal, biases and
        the learned carry zeros."""
        obs_dim = obs_shape[-1] if isinstance(obs_shape, tuple) else obs_shape
        fan_in = int(obs_dim)
        params = {}
        for i, h in enumerate(self.hidden):
            params[f"dense_{i}"] = {"bias": _zeros(h, generator),
                                    "kernel": _lecun_kernel((fan_in, h), fan_in, generator)}
            fan_in = h
        for j in range(self.n_layers):
            params[self._cell_name(j)] = _cell_params(self.cell, fan_in, self.gru_size,
                                                      generator)
            fan_in = self.gru_size
        if self.learned_carry:
            for j in range(self.n_layers):
                for name in self._carry0_names(j):
                    params[name] = _zeros(self.gru_size, generator)
        params["head"] = {"bias": _zeros(self.action_dim, generator),
                          "kernel": _lecun_kernel((fan_in, self.action_dim), fan_in, generator)}
        return params

    def carry_init(self, params: dict | None = None):
        """The episode-start carry: the ``carry0_*`` params with
        ``learned_carry`` and ``params`` given (a variables dict with a
        ``"params"`` key works too), else float32 zeros on the CPU."""
        self._check_cell()
        if self.learned_carry and params is not None:
            p = params["params"] if "params" in params else params

            def one(j):
                vals = tuple(p[name] for name in self._carry0_names(j))
                return vals if self.cell == "lstm" else vals[0]
        else:
            z = torch.zeros((self.gru_size,), dtype=torch.float32)

            def one(j):
                return (z, z) if self.cell == "lstm" else z
        per = [one(j) for j in range(self.n_layers)]
        return per[0] if self.n_layers == 1 else tuple(per)

    def population_layout(self, members: dict) -> dict:
        """The forward's weights from a param dict, laid out once: dense
        layers as (kernel, bias), each cell's gate kernels concatenated
        (``_cell_layout``).  Leaves with a leading member axis give a
        member-batched layout; a single policy's leaves, a shared one."""
        layout = {}
        for name in [f"dense_{i}" for i in range(len(self.hidden))] + ["head"]:
            layout[name] = (members[name]["kernel"], members[name]["bias"].unsqueeze(-2))
        for j in range(self.n_layers):
            name = self._cell_name(j)
            layout[name] = _cell_layout(self.cell, members[name])
        return layout

    def population_apply(self, layout: dict, obs: torch.Tensor, carry):
        """``(out, carry')`` of the laid-out policies: ``obs`` (P, B,
        obs_dim) against a member-batched layout of P members (carry leaves
        (P, B, gru_size)), or any (..., obs_dim) against a shared one."""
        step = _gru_step if self.cell == "gru" else _lstm_step
        x = obs
        for i in range(len(self.hidden)):
            kernel, bias = layout[f"dense_{i}"]
            x = self.activation(x @ kernel + bias)
        carries = (carry,) if self.n_layers == 1 else tuple(carry)
        new_carries = []
        for j in range(self.n_layers):
            c, x = step(layout[self._cell_name(j)], x, carries[j])
            new_carries.append(c)
        kernel, bias = layout["head"]
        x = x @ kernel + bias
        if not self.discrete:
            x = torch.tanh(x) * self.action_scale
        return x, new_carries[0] if self.n_layers == 1 else tuple(new_carries)

    def apply_params(self, params: dict, obs: torch.Tensor, carry):
        """One policy: obs (obs_dim,) with carry leaves (gru_size,), or a
        batch (N, obs_dim) with leaves (N, gru_size)."""
        single = obs.ndim == 1
        if single:
            obs, carry = obs[None], map_carry(lambda t: t[None], carry)
        out, carry = self.population_apply(self.population_layout(params), obs, carry)
        if single:
            out, carry = out[0], map_carry(lambda t: t[0], carry)
        return out, carry


# the Nature-DQN trunk: (features, kernel size, stride), "VALID" padding
_CONV_STACK = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
_FC = 512


def _conv_params(obs_shape: tuple, use_vbn: bool, generator: torch.Generator) -> tuple:
    """Fresh conv (and VBN) params of the trunk and the flat size of its
    output, for (H, W, C) observations."""
    if len(obs_shape) != 3:
        raise ValueError(
            f"the Nature-DQN trunk needs (H, W, C) observations, got {obs_shape}: a flat "
            "observation cannot feed its convolutions")
    h, w, cin = obs_shape
    params = {}
    for i, (feat, k, stride) in enumerate(_CONV_STACK):
        params[f"conv_{i}"] = {"bias": _zeros(feat, generator),
                               "kernel": _lecun_kernel((k, k, cin, feat), k * k * cin, generator)}
        if use_vbn:
            params[f"vbn_{i}"] = vbn.VirtualBatchNorm(feat).init_params(generator.device)
        h, w, cin = (h - k) // stride + 1, (w - k) // stride + 1, feat
    return params, h * w * cin


def _conv_layout(members: dict, dtype: torch.dtype | None, use_vbn: bool) -> dict:
    """The trunk's weights laid out once from member param dicts (leaves
    with a leading axis of P members): conv kernels HWIO → (P, out,
    in·kh·kw), a patch's order in the forward; cast to ``dtype`` unless
    None."""
    p = members["conv_0"]["kernel"].shape[0]

    def cast(t):
        return t if dtype is None else t.to(dtype)

    layout: dict = {"members": p}
    for i, (feat, _, _) in enumerate(_CONV_STACK):
        conv = members[f"conv_{i}"]
        layout[f"conv_{i}"] = (cast(conv["kernel"]).permute(0, 4, 3, 1, 2).reshape(p, feat, -1)
                               .contiguous(), cast(conv["bias"])[:, :, None])
        if use_vbn:  # (P, 1, C): one member axis, then the batch's
            layout[f"vbn_{i}"] = {name: cast(v)[:, None, :]
                                  for name, v in members[f"vbn_{i}"].items()}
    return layout


def _conv_trunk(layout: dict, x: torch.Tensor, vbn_stats: dict | None = None,
                captured: dict | None = None, use_vbn: bool = False) -> torch.Tensor:
    """The P laid-out members' convolutions (each followed by VBN with
    ``use_vbn``, then a ReLU) on ``x`` (P, B, H, W, C), flattened as flax
    flattens NHWC: (P, B, H'·W'·C').  Each convolution is one copy of every
    member's patches out of a strided view and one ``torch.bmm`` with the
    members' kernels: on CUDA, cuDNN's grouped ``F.conv2d`` and ``F.unfold``
    both launch a kernel a member."""
    p, b = x.shape[0], x.shape[1]
    x = x.permute(0, 1, 4, 2, 3)  # (P, B, C, H, W)
    for i, (feat, k, stride) in enumerate(_CONV_STACK):
        # every member's patches as one strided view (P, B, C, H', W', k, k),
        # copied once into (P, C·k·k, B·H'·W')
        patches = x.unfold(3, k, stride).unfold(4, k, stride)
        h, w = patches.shape[3], patches.shape[4]
        cols = patches.permute(0, 2, 5, 6, 1, 3, 4).reshape(p, -1, b * h * w)
        weight, bias = layout[f"conv_{i}"]
        x = (torch.bmm(weight, cols) + bias).view(p, feat, b, h, w).transpose(1, 2)
        if use_vbn:
            x = vbn.layer(f"vbn_{i}", x, layout, vbn_stats, captured, feature_axis=2)
        x = F.relu(x)
    # flax flattens the NHWC activation: (P, B, 64, 7, 7) → (P, B, 7·7·64)
    return x.permute(0, 1, 3, 4, 2).reshape(p, b, -1)


class RecurrentNatureCNN(_RecurrentForward, _FlatParamsPolicy):
    """Nature-DQN conv trunk + GRU core + head, for pixel policies with
    memory on the pooled path; the recurrent apply contract of
    :class:`RecurrentPolicy`.  No VBN, as in the JAX package.  Pixels are
    scaled into the carry's dtype (integer pixels divided by 255), so a
    bf16 carry keeps the whole forward in bf16; ``carry_init`` is always
    float32 zeros."""

    def __init__(self, action_dim: int, gru_size: int = 256, discrete: bool = True,
                 action_scale: float = 1.0):
        super().__init__()
        self.action_dim = int(action_dim)
        self.gru_size = int(gru_size)
        self.discrete = bool(discrete)
        self.action_scale = float(action_scale)
        self.obs_shape: tuple | None = None  # (H, W, C), set by init_params

    def init_params(self, obs_shape, generator: torch.Generator) -> dict:
        """Fresh params for observations of ``obs_shape`` (H, W, C)."""
        shape = tuple(obs_shape) if isinstance(obs_shape, (tuple, list)) else (obs_shape,)
        params, flat = _conv_params(shape, False, generator)
        self.obs_shape = tuple(int(s) for s in shape)
        params["fc"] = {"bias": _zeros(_FC, generator),
                        "kernel": _lecun_kernel((flat, _FC), flat, generator)}
        params["gru"] = _cell_params("gru", _FC, self.gru_size, generator)
        params["head"] = {"bias": _zeros(self.action_dim, generator),
                          "kernel": _lecun_kernel((self.gru_size, self.action_dim),
                                                  self.gru_size, generator)}
        return params

    def carry_init(self, params: dict | None = None) -> torch.Tensor:
        return torch.zeros((self.gru_size,), dtype=torch.float32)

    def population_layout(self, members: dict) -> dict:
        """Member param dicts (leaves with a leading member axis) laid out
        once, in their own dtype."""
        layout = _conv_layout(members, None, False)
        for name in ("fc", "head"):
            layout[name] = (members[name]["kernel"], members[name]["bias"][:, None, :])
        layout["gru"] = _cell_layout("gru", members["gru"])
        return layout

    def population_apply(self, layout: dict, obs: torch.Tensor, carry: torch.Tensor):
        """``(out (P, B, A), carry' (P, B, gru_size))`` of the P laid-out
        members, each on its own B observations: ``obs`` (P, B, H, W, C) or
        (P, B, H·W·C), ``carry`` (P, B, gru_size)."""
        p = layout["members"]
        x = obs.reshape((p, -1) + self.obs_shape)
        target = carry.dtype
        x = x.to(target) / 255.0 if not torch.is_floating_point(x) else x.to(target)
        x = _conv_trunk(layout, x)
        weight, bias = layout["fc"]
        x = F.relu(torch.bmm(x, weight) + bias)
        carry, x = _gru_step(layout["gru"], x, carry)
        weight, bias = layout["head"]
        x = torch.bmm(x, weight) + bias
        if not self.discrete:
            x = torch.tanh(x) * self.action_scale
        return x, carry

    def apply_params(self, params: dict, obs: torch.Tensor, carry: torch.Tensor):
        """One policy on one observation (H, W, C) with carry (gru_size,),
        or a batch (N, H, W, C) with (N, gru_size)."""
        single = obs.ndim == 3
        x, h = (obs[None], carry[None]) if single else (obs, carry)
        if self.obs_shape is None:
            self.obs_shape = tuple(int(s) for s in x.shape[1:])
        layout = self.population_layout(map_tree(lambda v: v[None], params))
        out, h = self.population_apply(layout, x[None], h[None])
        return (out[0, 0], h[0, 0]) if single else (out[0], h[0])


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

    def init_params(self, obs_shape, generator: torch.Generator) -> dict:
        """Fresh params for observations of ``obs_shape`` (H, W, C); a flat
        observation (a device env's) raises ``ValueError``, as flax's
        convolution does in the JAX package."""
        shape = tuple(obs_shape) if isinstance(obs_shape, (tuple, list)) else (obs_shape,)
        params, flat = _conv_params(shape, self.use_vbn, generator)
        self.obs_shape = tuple(int(s) for s in shape)
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
        layout = _conv_layout(members, torch.float32, self.use_vbn)
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
        ``torch.bmm`` with the members' kernels (``_conv_trunk``)."""
        p = layout["members"]
        x = obs.reshape((p, -1) + self.obs_shape)
        x = x.to(torch.float32) / 255.0 if not torch.is_floating_point(x) else x.to(torch.float32)
        x = _conv_trunk(layout, x, self.vbn_stats, captured, self.use_vbn)
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
        layout = self.population_layout(map_tree(lambda v: v[None], params))
        out = self.population_apply(layout, x[None], captured)[0]
        return out[0] if single else out
