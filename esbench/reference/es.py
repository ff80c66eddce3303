"""Plain PyTorch ES, the yardstick that decides ``correct``.

OpenAI-ES (Salimans et al. 2017) as a configuration file states it, written
from the algorithm and the configuration alone: it imports nothing of the
program and takes nothing the program made.  It works out again, from the
run's seed, what the program derives from it:

- the shared noise table, ``size`` standard normals from a CPU
  ``torch.Generator`` seeded with the seed;
- the initial params, flax's truncated LeCun normal for every kernel in the
  policy's layer order, zero biases, unit VBN scales, laid out flat with the
  keys sorted (``ravel_pytree``'s order) so that a table offset addresses
  them;
- the frozen VBN statistics (Nature CNN), from one random-action episode
  of 128 steps on a generator of their own;
- generation g's pair offsets and initial states, from a generator seeded
  by a hash of ``(seed, g)``;

and then runs each generation: mirrored members θ ± σ·ε, every member's
episode over the horizon (materialized weights, one batched product a
layer, in blocks of members), centered ranks, the folded rank-weighted sum
of the pairs' noise in float64, weight decay and Adam.

``precision="tf32"`` rounds both operands of every product to TF32 (10
mantissa bits, round to nearest even), as a float32 product with TF32 on
computes: the control that has to come out not correct.
``precision="float64"`` runs everything in float64 from the same draws: a
witness of what float32's rounding alone does to the compared numbers.  ``fault``
plants a fault of the timed path in the reference put in the program's
place (``"half_batch"``: the update and the loss over the first half of the
pairs alone).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# flax's lecun_normal: a normal truncated to ±2 standard deviations, rescaled
# so that the variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978
_VBN_EPS = 1e-5
_VBN_STEPS = 128
_VBN_STREAM = 3
# the Nature DQN trunk: (features, kernel size, stride), "VALID" padding
NATURE_CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
NATURE_FC = 512


def seed_of(*words: int) -> int:
    """A 63-bit generator seed hashed from ``words`` (``SeedSequence``)."""
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def make_table(size: int, seed: int) -> torch.Tensor:
    """The shared noise table, on the CPU."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn((int(size),), generator=gen, dtype=torch.float32)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32: 10 mantissa bits, to nearest even."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 0x80000000, bits - 0x100000000, bits)
    return bits.to(torch.int32).view(torch.float32)


# ------------------------------------------------------------------ params


def param_shapes(policy: dict, obs_shape: tuple) -> dict:
    """``{layer: {leaf: shape}}`` of a configuration's policy."""
    if policy["kind"] == "mlp":
        sizes = (obs_shape[-1],) + tuple(policy["hidden"]) + (policy["action_dim"],)
        names = [f"dense_{i}" for i in range(len(policy["hidden"]))] + ["head"]
        return {n: {"bias": (o,), "kernel": (i, o)}
                for n, i, o in zip(names, sizes[:-1], sizes[1:])}
    if policy["kind"] == "nature_cnn":
        h, w, cin = obs_shape
        shapes = {}
        for i, (feat, k, s) in enumerate(NATURE_CONVS):
            shapes[f"conv_{i}"] = {"bias": (feat,), "kernel": (k, k, cin, feat)}
            if policy["use_vbn"]:
                shapes[f"vbn_{i}"] = {"bias": (feat,), "scale": (feat,)}
            h, w, cin = (h - k) // s + 1, (w - k) // s + 1, feat
        shapes["fc"] = {"bias": (NATURE_FC,), "kernel": (h * w * cin, NATURE_FC)}
        shapes["head"] = {"bias": (policy["action_dim"],),
                          "kernel": (NATURE_FC, policy["action_dim"])}
        return shapes
    raise ValueError(f"unknown policy kind {policy['kind']!r}")


def flat_layout(shapes: dict) -> list:
    """``[(layer, leaf, shape, start)]`` in the flat vector's order: layers
    and leaves sorted by name, each leaf row-major."""
    out, pos = [], 0
    for layer in sorted(shapes):
        for leaf in sorted(shapes[layer]):
            shape = tuple(shapes[layer][leaf])
            out.append((layer, leaf, shape, pos))
            pos += math.prod(shape)
    return out


def layout_dim(layout: list) -> int:
    _, _, shape, start = layout[-1]
    return start + math.prod(shape)


def init_params(policy: dict, shapes: dict, seed: int) -> torch.Tensor:
    """The initial flat params: kernels drawn in the policy's layer order
    from one CPU generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    values = {}
    order = ([f"dense_{i}" for i in range(len(policy["hidden"]))] + ["head"]
             if policy["kind"] == "mlp"
             else [f"conv_{i}" for i in range(len(NATURE_CONVS))] + ["fc", "head"])
    for layer in order:
        shape = tuple(shapes[layer]["kernel"])
        fan_in = math.prod(shape[:-1])
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        kernel = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        values[(layer, "kernel")] = kernel
    parts = []
    for layer, leaf, shape, _ in flat_layout(shapes):
        if leaf == "kernel":
            parts.append(values[(layer, leaf)].reshape(-1))
        elif leaf == "scale":
            parts.append(torch.ones(shape, dtype=torch.float32).reshape(-1))
        else:
            parts.append(torch.zeros(shape, dtype=torch.float32).reshape(-1))
    return torch.cat(parts)


def unflatten(theta: torch.Tensor, layout: list) -> dict:
    """Member-batched leaves ``{layer: {leaf: (B, *shape)}}`` of ``theta``
    (B, dim)."""
    out: dict = {}
    for layer, leaf, shape, start in layout:
        out.setdefault(layer, {})[leaf] = theta[:, start:start + math.prod(shape)].reshape(
            (theta.shape[0],) + shape)
    return out


# ---------------------------------------------------------------- forwards


class _Products:
    """Batched products at the configuration's precision: ``x`` @ a kernel
    that :meth:`kernels` has already rounded."""

    def __init__(self, precision: str):
        if precision not in ("float32", "tf32", "float64"):
            raise ValueError(f"precision must be float32, tf32 or float64, got {precision!r}")
        self.round = tf32 if precision == "tf32" else (lambda t: t)

    def kernels(self, params: dict) -> dict:
        """``params`` with every kernel rounded (once a block of members)."""
        return {layer: {leaf: self.round(v) if leaf == "kernel" else v
                        for leaf, v in leaves.items()}
                for layer, leaves in params.items()}

    def bmm(self, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        return torch.bmm(self.round(x), kernel)


def mlp_forward(policy: dict, p: dict, obs: torch.Tensor, mm: _Products) -> torch.Tensor:
    """Each of B members' tanh MLP on its own observation (B, obs_dim)."""
    x = obs[:, None, :]
    names = [f"dense_{i}" for i in range(len(policy["hidden"]))] + ["head"]
    for name in names:
        x = mm.bmm(x, p[name]["kernel"]) + p[name]["bias"][:, None, :]
        if name != "head":
            x = torch.tanh(x)
    out = x[:, 0]
    if policy["discrete"]:
        return out
    return torch.tanh(out) * float(policy["action_scale"])


def _conv_nhwc(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, k: int, s: int,
               mm: _Products) -> torch.Tensor:
    """Member b's "VALID" convolution of its images ``x[b]`` (B, N, H, W, C)
    with its HWIO kernel ``kernel[b]`` (B, k, k, C, O): (B, N, H', W', O)."""
    b, n = x.shape[0], x.shape[1]
    patches = x.unfold(2, k, s).unfold(3, k, s)  # (B, N, H', W', C, kh, kw)
    ho, wo = patches.shape[2], patches.shape[3]
    cols = patches.permute(0, 1, 2, 3, 5, 6, 4).reshape(b, n * ho * wo, -1)
    y = mm.bmm(cols, kernel.reshape(b, -1, kernel.shape[-1])) + bias[:, None, :]
    return y.view(b, n, ho, wo, -1)


def _vbn(x: torch.Tensor, mean, var, scale, bias) -> torch.Tensor:
    """Frozen-statistics batch norm over the last (channel) axis."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return ((x - mean) * torch.rsqrt(var + _VBN_EPS) * scale.view(shape)
            + bias.view(shape))


def nature_cnn_forward(policy: dict, p: dict, images: torch.Tensor, stats: dict | None,
                       mm: _Products, capture: dict | None = None) -> torch.Tensor:
    """Logits (B, N, A) of B members, each on its own N images (B, N, 84, 84,
    4): three convolutions (each then VBN and a ReLU), fc 512 (ReLU) and the
    head.  ``capture`` takes each VBN layer's statistics of its input (mean
    and biased variance over every axis but the channels) and uses them."""
    x = images
    for i, (_, k, s) in enumerate(NATURE_CONVS):
        conv = p[f"conv_{i}"]
        x = _conv_nhwc(x, conv["kernel"], conv["bias"], k, s, mm)
        if policy["use_vbn"]:
            name = f"vbn_{i}"
            if capture is not None:
                flat = x.reshape(-1, x.shape[-1])
                capture[name] = {"mean": flat.mean(dim=0), "var": flat.var(dim=0, correction=0)}
            st = capture[name] if capture is not None else stats[name]
            x = _vbn(x, st["mean"], st["var"], p[name]["scale"], p[name]["bias"])
        x = torch.relu(x)
    b, n = x.shape[0], x.shape[1]
    x = x.reshape(b, n, -1)  # flattened as (H', W', C): flax's NHWC order
    x = torch.relu(mm.bmm(x, p["fc"]["kernel"]) + p["fc"]["bias"][:, None, :])
    return mm.bmm(x, p["head"]["kernel"]) + p["head"]["bias"][:, None, :]


# ---------------------------------------------------------------- the run


class ReferenceES:
    """One configuration's ES from ``seed`` on ``device``: call
    :meth:`generation` for generations 0, 1, 2, … in order."""

    def __init__(self, config: dict, seed: int, env, device="cpu", precision: str = "float32",
                 fault: str | None = None, block: int = 1024):
        if fault not in (None, "half_batch"):
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg = config
        self.policy = config["policy"]
        self.env = env
        self.seed = int(seed)
        self.device = torch.device(device)
        self.mm = _Products(precision)
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.fault = fault
        self.block = int(block)
        self.n = int(config["population_size"])
        if not config.get("mirrored", True) or self.n % 2:
            raise ValueError("the reference runs mirrored sampling over an even population")
        self.rows = self.n // 2
        self.sigma = torch.tensor(float(config["sigma"]), dtype=self.dtype, device=self.device)
        self.horizon = int(config["horizon"])
        self.obs_shape = self._obs_shape()
        self.shapes = param_shapes(self.policy, self.obs_shape)
        self.layout = flat_layout(self.shapes)
        self.dim = layout_dim(self.layout)
        self.table_size = int(config["table_size"])
        self.table = make_table(self.table_size, self.seed).to(self.device, self.dtype)
        self.theta = init_params(self.policy, self.shapes, self.seed).to(self.device, self.dtype)
        self.theta0 = self.theta.clone()
        opt = config["optimizer"]
        self.lr, self.b1, self.b2, self.eps = (float(opt["learning_rate"]), float(opt["b1"]),
                                               float(opt["b2"]), float(opt["eps"]))
        self.mu = torch.zeros_like(self.theta)
        self.nu = torch.zeros_like(self.theta)
        self.count = 0
        self.vbn_stats = self._vbn_stats() if self.policy.get("use_vbn") else None

    def _obs_shape(self) -> tuple:
        _, obs = self.env.reset(torch.Generator().manual_seed(0), 1)
        return tuple(int(d) for d in obs.shape[1:])

    def _vbn_stats(self) -> dict:
        """The frozen statistics: the center's forward over the observations
        of one random-action episode (the reset frame, then one frame a
        step), drawn on the CPU."""
        env = self.env
        gen = torch.Generator().manual_seed(seed_of(self.seed, 0, _VBN_STREAM))
        state, _ = env.reset(gen, 1)
        actions = torch.randint(0, env.action_dim, (_VBN_STEPS,), generator=gen)
        obs, rows = env.observe(state), []
        for t in range(_VBN_STEPS):
            rows.append(obs[0])
            nstate, nobs, _, done = env.step(state, actions[t:t + 1])
            state = torch.where(done[:, None], state, nstate)
            obs = torch.where(done.view((1,) * obs.ndim), obs, nobs)
        batch = torch.stack(rows).to(self.device, self.dtype)
        captured: dict = {}
        params = self.mm.kernels(unflatten(self.theta[None], self.layout))
        nature_cnn_forward(self.policy, params, batch[None], None, self.mm, captured)
        return captured

    def draws(self, generation: int):
        """Generation ``generation``'s pair offsets (rows,) int32 and the
        pairs' initial states, on the CPU."""
        gen = torch.Generator().manual_seed(seed_of(self.seed, generation))
        offsets = torch.randint(0, self.table_size - self.dim + 1, (self.rows,),
                                generator=gen, dtype=torch.int32)
        states, _ = self.env.reset(gen, self.rows)
        return offsets, states

    def _noise(self, offsets: torch.Tensor) -> torch.Tensor:
        return self.table.unfold(0, self.dim, 1)[offsets.to(self.device, torch.int64)]

    def _outputs(self, params: dict, obs: torch.Tensor) -> torch.Tensor:
        """The policy's outputs: actions (continuous) or logits (discrete)."""
        if self.policy["kind"] == "mlp":
            return mlp_forward(self.policy, params, obs.reshape(obs.shape[0], -1), self.mm)
        return nature_cnn_forward(self.policy, params, obs[:, None], self.vbn_stats, self.mm)[:, 0]

    def _episodes(self, theta: torch.Tensor, states: torch.Tensor,
                  given: torch.Tensor | None = None):
        """``(returns, actions, widest gap, flipped)`` of one episode of each
        member ``theta`` (B, dim) from its initial state; a member that ends
        keeps its state and earns nothing more.  A discrete policy takes the
        argmax of its logits, or replays ``given`` (B, horizon) actions; the
        widest gap is then the most by which a given action's logit lies
        below this policy's best (0 for its own argmax), and ``flipped`` (B,)
        marks the members of which some given action is not this policy's
        argmax: up to its first such step a member's replayed episode is the
        one this policy would take itself, so an unflipped member's whole
        episode is the same both ways."""
        env, params = self.env, self.mm.kernels(unflatten(theta, self.layout))
        obs = env.observe(states)
        total = torch.zeros((states.shape[0],), dtype=self.dtype, device=self.device)
        done = torch.zeros((states.shape[0],), dtype=torch.bool, device=self.device)
        taken, gap = [], torch.zeros((), dtype=self.dtype, device=self.device)
        flipped = torch.zeros_like(done)
        for t in range(self.horizon):
            alive = ~done
            out = self._outputs(params, obs)
            if self.policy["discrete"]:
                if given is None:
                    action = torch.argmax(out, dim=-1)
                else:
                    action = given[:, t].to(self.device)
                    chosen = out.gather(1, action[:, None])[:, 0]
                    below = torch.where(alive, out.max(dim=-1).values - chosen, 0.0)
                    gap = torch.maximum(gap, below.max())
                    flipped |= below > 0
                taken.append(action)
            else:
                action = out
            nstates, nobs, reward, ndone = env.step(states, action)
            total += reward * alive.to(self.dtype)
            states = torch.where(alive[:, None], nstates, states)
            obs = torch.where(alive.view((-1,) + (1,) * (obs.ndim - 1)), nobs, obs)
            done = done | ndone
        actions = torch.stack(taken, dim=1) if taken else None
        return total, actions, gap, flipped

    def fitness(self, offsets: torch.Tensor, states: torch.Tensor,
                given: torch.Tensor | None = None):
        """``(returns, actions, widest gap, members flipped)`` of every
        member (``_episodes``; ``given`` (n, horizon) actions to replay):
        member 2k is θ + σ·ε_k, 2k+1 θ − σ·ε_k, both from pair k's initial
        state."""
        signs = torch.tensor([1.0, -1.0], dtype=self.dtype, device=self.device).repeat(self.rows)
        member_off = torch.repeat_interleave(offsets, 2)
        member_states = torch.repeat_interleave(states.to(self.device, self.dtype), 2, dim=0)
        returns, actions, gap = [], [], torch.zeros((), dtype=self.dtype, device=self.device)
        flipped = 0
        for lo in range(0, self.n, self.block):
            hi = min(lo + self.block, self.n)
            theta = self._noise(member_off[lo:hi])
            theta.mul_((self.sigma * signs[lo:hi])[:, None]).add_(self.theta)
            r, a, g, f = self._episodes(theta, member_states[lo:hi],
                                        None if given is None else given[lo:hi])
            returns.append(r)
            actions.append(a)
            gap = torch.maximum(gap, g)
            flipped += int(f.sum())
            del theta
        return (torch.cat(returns), None if actions[0] is None else torch.cat(actions).cpu(),
                float(gap), flipped)

    def generation(self, generation: int, given: torch.Tensor | None = None) -> dict:
        """One generation from the current center: ``{"loss": the mean
        return, "grad": the gradient Adam is given, "fitness": every
        member's return, "actions": a discrete policy's (n, horizon),
        "action_gap": with ``given`` actions replayed, the widest gap by
        which one's logit lies below the best, "flip_share": the share of
        members with a replayed action that is not this policy's argmax};
        the center moves."""
        offsets, states = self.draws(generation)
        fit, actions, action_gap, flipped = self.fitness(offsets, states, given)
        rows, n = self.rows, self.n
        if self.fault == "half_batch":
            rows, n = self.rows // 2, 2 * (self.rows // 2)
            fit, offsets = fit[:n], offsets[:rows]
        weights = centered_ranks(fit)
        pair_w = (weights[0::2] - weights[1::2]).to(torch.float64)
        total = torch.zeros((self.dim,), dtype=torch.float64, device=self.device)
        for lo in range(0, rows, self.block):
            eps = self._noise(offsets[lo:lo + self.block])
            w = pair_w[lo:lo + self.block]
            if self.mm.round is tf32:
                eps, w = tf32(eps), tf32(w.to(torch.float32)).to(torch.float64)
            total += w @ eps.to(torch.float64)
            del eps
        ascent = total.to(self.dtype) / (n * self.sigma)
        wd = float(self.cfg.get("weight_decay", 0.0))
        if wd > 0.0:
            ascent = ascent - wd * self.theta
        grad = -ascent
        self.count += 1
        self.mu = (1 - self.b1) * grad + self.b1 * self.mu
        self.nu = (1 - self.b2) * grad * grad + self.b2 * self.nu
        # the bias corrections 1 - b**count formed in float32, as optax does
        b1 = torch.tensor(self.b1, dtype=self.dtype, device=self.device)
        b2 = torch.tensor(self.b2, dtype=self.dtype, device=self.device)
        mu_hat = self.mu / (1 - b1 ** self.count)
        nu_hat = self.nu / (1 - b2 ** self.count)
        self.theta = self.theta - self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return {"loss": float(fit.to(torch.float64).mean()), "grad": grad, "fitness": fit,
                "actions": actions, "action_gap": action_gap, "flip_share": flipped / self.n}


def centered_ranks(x: torch.Tensor) -> torch.Tensor:
    """rank/(n−1) − 0.5, ties broken by position; a non-finite return ranks
    last with weight 0, the others rescaled by n/n_valid."""
    n = x.shape[0]
    valid = torch.isfinite(x)
    n_valid = int(valid.sum())
    if n_valid < 2:
        return torch.zeros_like(x)
    order = torch.argsort(torch.where(valid, x, float("inf")), stable=True)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n, device=x.device)
    w = (pos.to(x.dtype) / (n_valid - 1) - 0.5) * (n / n_valid)
    return torch.where(valid, w, torch.zeros_like(w))
