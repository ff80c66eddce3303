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

The feedforward policies (``MLPPolicy``, ``NatureCNN``) describe their
forward as a sequence of :class:`Layer` (``layers()``), each run by
:func:`layer_linear` and :func:`layer_post`; the param-sharded engine
(``parallel/sharded.py``) runs the same sequence on a rank's channels.

The recurrent policies follow flax's cells, not torch's: ``GRUCell`` has
biases on ``ir``, ``iz``, ``in`` and ``hn`` only, and
``n = tanh(in(x) + r·hn(h))``; ``OptimizedLSTMCell`` has biases on the
hidden kernels ``hi``/``hf``/``hg``/``ho`` only, and its carry is
``(c, h)``.  Their apply takes and returns the carry:
``population_apply(layout, obs, carry) -> (out, carry')``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

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
    return _matmul(x, p["kernel"], p["bias"])


def _matmul(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    if x.dtype != k.dtype:
        dt = torch.promote_types(x.dtype, k.dtype)
        x, k = x.to(dt), k.to(dt)
        b = None if b is None else b.to(dt)
    return x @ k if b is None else x @ k + b


class Layer(NamedTuple):
    """One layer of a feedforward policy's forward: the param key of its
    ``kernel`` and ``bias``, its kind (``"dense"``, or ``"conv"`` with its
    kernel size and stride, "VALID" padding), the VBN layer after it (its
    param key, or None) and its activation (or None)."""

    name: str
    kind: str
    vbn: str | None
    activation: Callable[[torch.Tensor], torch.Tensor] | None
    ksize: int = 0
    stride: int = 0

    @property
    def channel_axis(self) -> int:
        """The axis of the layer's output channels in its activations:
        (P, B, C, H, W) after a convolution, (..., C) after a dense layer."""
        return 2 if self.kind == "conv" else -1


def conv_kernel_layout(kernel: torch.Tensor) -> torch.Tensor:
    """P members' HWIO conv kernels (P, kh, kw, in, out) as (P, out,
    in·kh·kw), a patch's order in :func:`conv_layer`."""
    p, out = kernel.shape[0], kernel.shape[-1]
    return kernel.permute(0, 4, 3, 1, 2).reshape(p, out, -1).contiguous()


def conv_layer(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
               ksize: int, stride: int) -> torch.Tensor:
    """P members' convolutions of ``x`` (P, B, C, H, W) with their laid-out
    kernels ``weight`` (P, out, C·k·k) and ``bias`` (P, out, 1) or None:
    (P, B, out, H', W').  Every member's patches are one strided view (P, B,
    C, H', W', k, k), copied once into (P, C·k·k, B·H'·W'), then one
    ``torch.bmm``: on CUDA, cuDNN's grouped ``F.conv2d`` and ``F.unfold``
    both launch a kernel a member."""
    p, b = x.shape[0], x.shape[1]
    patches = x.unfold(3, ksize, stride).unfold(4, ksize, stride)
    h, w = patches.shape[3], patches.shape[4]
    cols = patches.permute(0, 2, 5, 6, 1, 3, 4).reshape(p, -1, b * h * w)
    y = torch.bmm(weight, cols)
    if bias is not None:
        y = y + bias
    return y.view(p, weight.shape[1], b, h, w).transpose(1, 2)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(P, B, C, H, W) activations flattened as flax flattens NHWC: (P, B,
    H·W·C)."""
    return x.permute(0, 1, 3, 4, 2).reshape(x.shape[0], x.shape[1], -1)


class PairKernel(NamedTuple):
    """A dense kernel of k mirrored members in pair form: member 2j's is
    W + σε_j and member 2j+1's W − σε_j, neither formed.  ``center`` (in,
    out) is W, ``noise`` (k/2, in, out) each pair's ε_j, ``scale`` (k, 1,
    1) each member's c_i = σ·s_i."""

    center: torch.Tensor
    noise: torch.Tensor
    scale: torch.Tensor


def pair_linear(x: torch.Tensor, kernel: PairKernel, bias: torch.Tensor) -> torch.Tensor:
    """x_i @ (W + c_i ε_j) + b_i for the k members' rows ``x`` (k, B, in):
    the shared product x @ W + b_i over all k·B rows, then the noise term
    c_i (x_i @ ε_j) from one batched product a pair, whose two members' 2B
    rows read ε_j once — the same contractions reordered
    (``models/decomposed.py``).  ``bias`` (k, 1, out) is each member's own.

    The noise term is taken transposed, ε_jᵀ @ x_jᵀ (k/2, out, 2B): for that
    operand order cuBLAS picks kernels that read ε at 2.3–2.5 TB/s on an
    H100, against 1.8–2.3 TB/s for x_j @ ε_j (PERF.md)."""
    k, rows, m = x.shape
    x = x.reshape(k * rows, m)
    y = torch.addmm(bias.expand(k, rows, -1).reshape(k * rows, -1), x, kernel.center)
    noise_t = torch.bmm(kernel.noise.transpose(1, 2),
                        x.view(k // 2, 2 * rows, m).transpose(1, 2))
    scale = kernel.scale.expand(k, rows, 1).reshape(k // 2, 2 * rows, 1)
    y.view(k // 2, 2 * rows, -1).addcmul_(scale, noise_t.transpose(1, 2))
    return y.view(k, rows, -1)


def pair_members(layers: Sequence[Layer], center: dict, noise: dict,
                 scale: torch.Tensor) -> dict:
    """The param tree of k mirrored members (member 2j = θ + σε_j, 2j+1 =
    θ − σε_j) from the center θ and the k/2 pairs' noise ε (leaves with a
    leading pair axis), ``scale`` (k,) each member's c_i = σ·s_i.  A dense
    layer takes one input row a member, so its kernel stays in pair form
    (:class:`PairKernel`, run by :func:`pair_linear`); every other leaf (a
    bias, a conv kernel read by hundreds of patch rows, VBN's scale and
    bias) is formed per member, θ + c_i·ε_j, as the member form forms it."""
    pairs = scale.shape[0] // 2

    def member(theta: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        c = scale.view((pairs, 2) + (1,) * theta.ndim)
        return (theta + c * eps[:, None]).reshape((2 * pairs,) + tuple(theta.shape))

    dense = {layer.name for layer in layers if layer.kind == "dense"}
    tree = {name: {leaf: member(v, noise[name][leaf]) for leaf, v in leaves.items()
                   if not (name in dense and leaf == "kernel")}
            for name, leaves in center.items()}
    for name in dense:
        tree[name]["kernel"] = PairKernel(center[name]["kernel"], noise[name]["kernel"],
                                          scale[:, None, None])
    return tree


def layer_linear(layer: Layer, x: torch.Tensor, kernel: torch.Tensor | PairKernel,
                 bias: torch.Tensor | None) -> torch.Tensor:
    """The layer's kernel (and bias, unless None) on ``x``: a conv's kernel
    laid out by :func:`conv_kernel_layout`, a dense kernel (in, out),
    member-batched (P, in, out) or in pair form (:class:`PairKernel`); conv
    activations reaching a dense layer are flattened first."""
    if layer.kind == "conv":
        return conv_layer(x, kernel, bias, layer.ksize, layer.stride)
    if x.ndim == 5:
        x = flatten_nhwc(x)
    if isinstance(kernel, PairKernel):
        return pair_linear(x, kernel, bias)
    return _matmul(x, kernel, bias)


def layer_post(layer: Layer, x: torch.Tensor, params: dict, stats: dict | None,
               captured: dict | None = None) -> torch.Tensor:
    """The layer's VBN (``params[layer.vbn]`` and the frozen ``stats``) and
    activation on its linear output."""
    if layer.vbn is not None:
        x = vbn.layer(layer.vbn, x, params, stats, captured, feature_axis=layer.channel_axis)
    return x if layer.activation is None else layer.activation(x)


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
        for layer in self.layers():
            p = params[layer.name]
            x = layer_post(layer, layer_linear(layer, x, p["kernel"], p["bias"]), params,
                           self.vbn_stats, captured)
        return self.population_output(x)

    def layers(self) -> tuple:
        """The forward's :class:`Layer` sequence: the hidden dense layers
        (each with its VBN layer with ``use_vbn``), then the head."""
        hidden = tuple(Layer(f"dense_{i}", "dense", f"vbn_{i}" if self.use_vbn else None,
                             self.activation) for i in range(len(self.hidden)))
        return hidden + (Layer("head", "dense", None, None),)

    def population_input(self, obs: torch.Tensor, members: int) -> torch.Tensor:
        """``obs`` (members, …, obs_dim) as (members, B, obs_dim) float32."""
        return obs.to(torch.float32).reshape(members, -1, obs.shape[-1])

    def population_output(self, x: torch.Tensor) -> torch.Tensor:
        """The head's output as actions: logits, or ``tanh(x)·action_scale``."""
        return x if self.discrete else torch.tanh(x) * self.action_scale


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


def _conv_layers(use_vbn: bool) -> tuple:
    """The trunk's :class:`Layer` sequence: each convolution followed by
    VBN with ``use_vbn``, then a ReLU."""
    return tuple(Layer(f"conv_{i}", "conv", f"vbn_{i}" if use_vbn else None, F.relu, k, stride)
                 for i, (_, k, stride) in enumerate(_CONV_STACK))


def _conv_layout(members: dict, dtype: torch.dtype | None, use_vbn: bool) -> dict:
    """The trunk's weights laid out once from member param dicts (leaves
    with a leading axis of P members): conv kernels HWIO → (P, out,
    in·kh·kw) (:func:`conv_kernel_layout`); cast to ``dtype`` unless None."""
    p = members["conv_0"]["kernel"].shape[0]

    def cast(t):
        return t if dtype is None else t.to(dtype)

    layout: dict = {"members": p}
    for layer in _conv_layers(use_vbn):
        conv = members[layer.name]
        layout[layer.name] = (conv_kernel_layout(cast(conv["kernel"])),
                              cast(conv["bias"])[:, :, None])
        if use_vbn:  # (P, 1, C): one member axis, then the batch's
            layout[layer.vbn] = {name: cast(v)[:, None, :]
                                 for name, v in members[layer.vbn].items()}
    return layout


def _run_layers(layers: tuple, layout: dict, x: torch.Tensor, vbn_stats: dict | None = None,
                captured: dict | None = None) -> torch.Tensor:
    """``layers`` in order over their laid-out weights ``layout[name]``
    ((kernel, bias)), the VBN params ``layout[vbn]``."""
    for layer in layers:
        kernel, bias = layout[layer.name]
        x = layer_post(layer, layer_linear(layer, x, kernel, bias), layout, vbn_stats, captured)
    return x


def _pixels(obs: torch.Tensor, members: int, obs_shape: tuple,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Observations (members, B, H, W, C) or flat (members, H·W·C) as the
    trunk's input (members, B, C, H, W) in ``dtype``: integer pixels
    divided by 255, float pixels passed through."""
    x = obs.reshape((members, -1) + tuple(obs_shape))
    x = x.to(dtype) / 255.0 if not torch.is_floating_point(x) else x.to(dtype)
    return x.permute(0, 1, 4, 2, 3)


def _conv_trunk(layout: dict, x: torch.Tensor) -> torch.Tensor:
    """The P laid-out members' convolutions (each followed by a ReLU) on
    ``x`` (P, B, C, H, W), flattened as flax flattens NHWC: (P, B,
    H'·W'·C')."""
    return flatten_nhwc(_run_layers(_conv_layers(False), layout, x))


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
        x = _conv_trunk(layout, _pixels(obs, layout["members"], self.obs_shape, carry.dtype))
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
    over weights laid out once a generation by :meth:`population_layout`;
    ``fc`` and ``head`` in pair form (:func:`pair_members`) run as
    :func:`pair_linear`.
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

    def layers(self) -> tuple:
        """The forward's :class:`Layer` sequence: the three convolutions
        (each with its VBN layer with ``use_vbn``, then a ReLU), ``fc``
        (ReLU) and the linear ``head``."""
        return _conv_layers(self.use_vbn) + (Layer("fc", "dense", None, F.relu),
                                             Layer("head", "dense", None, None))

    def population_layout(self, members: dict) -> dict:
        """The population forward's weights from member param dicts (each
        leaf with a leading axis of P members), laid out once: conv kernels
        HWIO → (P, out, in·kh·kw), a patch's order in the forward;
        every leaf float32 (a bf16 member computes in float32 with its
        bf16-rounded weights, as flax's dtype promotion does with
        NatureCNN's float32 input).  A kernel in pair form
        (:func:`pair_members`) stays so."""
        layout = _conv_layout(members, torch.float32, self.use_vbn)
        for name in ("fc", "head"):
            kernel = members[name]["kernel"]
            if not isinstance(kernel, PairKernel):
                kernel = kernel.to(torch.float32)
            layout[name] = (kernel, members[name]["bias"].to(torch.float32)[:, None, :])
        return layout

    def population_input(self, obs: torch.Tensor, members: int) -> torch.Tensor:
        """Observations (members, B, H, W, C) or flat (members, H·W·C) as
        the trunk's float32 input (members, B, C, H, W)."""
        return _pixels(obs, members, self.obs_shape)

    def population_output(self, x: torch.Tensor) -> torch.Tensor:
        """The head's logits."""
        return x

    def population_apply(self, layout: dict, obs: torch.Tensor,
                         captured: dict | None = None) -> torch.Tensor:
        """Logits (P, B, action_dim) of the P laid-out members, each on its
        own B observations: ``obs`` (P, B, H, W, C), or (P, H·W·C) flat
        rows (B = 1) as the pools give them.  Each convolution is one copy
        of every member's patches out of a strided view and one
        ``torch.bmm`` with the members' kernels (:func:`conv_layer`)."""
        x = self.population_input(obs, layout["members"])
        return _run_layers(self.layers(), layout, x, self.vbn_stats, captured)

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
