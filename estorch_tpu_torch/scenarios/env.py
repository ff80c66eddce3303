"""ScenarioEnv — a device env whose physics are a per-episode draw.

Counterpart of ``estorch_tpu/scenarios/env.py``, on the port's batched
contract (``envs/base.py``).  It wraps any parameterized native family (an
env with ``step_p(params, states, actions)`` and ``SCENARIO_FIELDS``) so
that every episode runs under a drawn variant of the physics:

- **State.** The port's rollout freezes a finished member with one
  ``torch.where`` over its ``(n, k)`` state rows, so the scenario state is
  one float32 row a member::

      [ base state | drawn params (sorted names) | variant | stream | step ]

  The variant, the noise stream id (< 2^24) and the step count (< 2^24)
  are integers, exact in float32.
- **Variants.** ``reset`` draws each episode's variant from the generator
  it is given and gathers the variant's params out of the distribution's
  table into the state.  ``step`` reads them back as (n,) column views, so
  the number of variants changes values, never the operations an env step
  launches.  The engine draws the initial states on the CPU, one per noise
  row, so the two members of a mirrored pair share their variant, as the
  JAX package's twins share a reset key.
- **Observation noise** (``obs_noise``, applied here on reset and on every
  step; the dynamics never see it).  JAX threads a noise key through the
  state.  Here the noise is a function of the state: a counter-based hash
  of (the row's stream id, its step count, the component) gives two 23-bit
  uniforms a component, and Box-Muller turns them into one standard normal.
  The stream id is drawn at reset from the same generator as the variant,
  so the twins of a pair see the same noise on every step, and the integer
  hash gives the same bits on the CPU and on the card (the ``log``, ``sqrt``
  and ``cos`` after it round within an ulp or two of each other).  A noise
  block drawn on the CPU would need the horizon and an index outside the
  state; ``torch.randn`` on a CUDA generator gives the twins different
  noise and the card other numbers than the CPU.  The plain ES path draws
  nothing new, so its streams stay as they were.
- ``behavior`` appends the variant id as the last float column (``bc_dim +
  1``), the channel per-variant fitness reaches the host through
  (``record["scenarios"]``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .distribution import ScenarioDistribution
from .params import OBS_NOISE, ScenarioParams

# passthrough static facts; bc_dim is NOT here (it grows by one)
_STATIC_ATTRS = ("obs_dim", "action_dim", "discrete", "default_horizon")
# optional protocol attrs copied when the base env has them
_OPTIONAL_ATTRS = ("action_bound",)
# the columns after the params: variant, noise stream, step count
_TAIL = 3
_STREAMS = 1 << 24  # stream ids, exact in float32

# the hash: a 32-bit integer mix (two multiply-xorshift rounds, constant
# 0x45d9f3b) in int64 arithmetic, every product kept below 2^63
_MASK32 = 0xFFFFFFFF
_MIX = 0x45D9F3B


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = ((x >> 16) ^ x) * _MIX & _MASK32
    x = ((x >> 16) ^ x) * _MIX & _MASK32
    return (x >> 16) ^ x


_COMPONENTS: dict[tuple[torch.device, int], torch.Tensor] = {}  # the arange, per device


def obs_noise_normals(ids: torch.Tensor, obs_dim: int) -> torch.Tensor:
    """(n, obs_dim) standard normals, a function of ``ids`` (n, 2): each
    row's (stream id, step count) as exact integers in float32."""
    ids = ids.to(torch.int64)
    key = torch.add(ids[:, 1], ids[:, 0], alpha=_STREAMS)  # < 2^48
    comp = _COMPONENTS.get((ids.device, obs_dim))
    if comp is None:
        comp = torch.arange(2 * obs_dim, dtype=torch.int64, device=ids.device)
        _COMPONENTS[(ids.device, obs_dim)] = comp
    x = torch.add(comp, key[:, None], alpha=2 * obs_dim)
    x = _mix32((x ^ (x >> 32)) & _MASK32)
    # the top 23 bits, centred in their cell: u in (0, 1), exact in float32
    u = (x >> 9).to(torch.float32).mul_(2.0 ** -23).add_(2.0 ** -24)
    u1, u2 = u[:, :obs_dim], u[:, obs_dim:]
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2 * math.pi) * u2)


class ScenarioEnv:
    """A batched device env over ``[base | params | variant | stream |
    step]`` state rows."""

    def __init__(self, env, distribution: ScenarioDistribution):
        if not hasattr(env, "step_p"):
            raise ValueError(
                f"{type(env).__name__} has no step_p(params, state, "
                "action) form — only the parameterized native families "
                "support scenario randomization (docs/scenarios.md)")
        distribution.validate_for(env)
        self.base = env
        self.distribution = distribution
        for a in _STATIC_ATTRS:
            setattr(self, a, getattr(env, a))
        for a in _OPTIONAL_ATTRS:
            if hasattr(env, a):
                setattr(self, a, getattr(env, a))
        self.bc_dim = int(env.bc_dim) + 1  # +1: the variant-id column
        self._noisy = OBS_NOISE in distribution.ranges
        self._names = distribution.names
        self._noise_col = self._names.index(OBS_NOISE) if self._noisy else None
        distribution.table()  # drawn here, once, not inside a generation
        if hasattr(env, "step_metrics"):
            self._install_gait()

    @property
    def n_variants(self) -> int:
        return self.distribution.n_variants

    # ---- the layout ------------------------------------------------------

    def _split(self, states: torch.Tensor):
        """(base states, params as (n,) column views, the tail's column 0)."""
        sb = states.shape[1] - len(self._names) - _TAIL
        params = ScenarioParams({n: states[:, sb + i] for i, n in enumerate(self._names)})
        return states[:, :sb], params, sb + len(self._names)

    def _noised(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        if not self._noisy:
            return obs
        sb = states.shape[1] - len(self._names) - _TAIL
        scale = states[:, sb + self._noise_col, None]
        return obs + scale * obs_noise_normals(states[:, -2:], obs.shape[1])

    # ---- the DeviceEnv protocol -----------------------------------------

    def reset(self, generator: torch.Generator, n: int):
        """The base's reset, then each episode's variant and noise stream,
        all from ``generator`` (on its device)."""
        dev = generator.device
        base_states, _ = self.base.reset(generator, n)
        variant = torch.randint(0, self.n_variants, (n,), generator=generator, device=dev)
        stream = torch.randint(0, _STREAMS, (n,), generator=generator, device=dev)
        states = torch.cat([
            base_states, self.distribution.table().to(dev)[variant],
            variant.to(torch.float32)[:, None],
            stream.to(torch.float32)[:, None],
            torch.zeros((n, 1), dtype=torch.float32, device=dev)], dim=1)
        return states, self.observe(states)

    def observe(self, states: torch.Tensor) -> torch.Tensor:
        base_states, _, _ = self._split(states)
        return self._noised(states, self.base.observe(base_states))

    def step(self, states: torch.Tensor, actions: torch.Tensor):
        base_states, params, _ = self._split(states)
        nbase, obs, reward, done = self.base.step_p(params, base_states, actions)
        nstates = torch.cat([nbase, states[:, base_states.shape[1]:]], dim=1)
        nstates[:, -1] += 1.0  # the step count: the next noise draw
        return nstates, self._noised(nstates, obs), reward, done

    def behavior(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        base_states, _, tail = self._split(states)
        base_bc = self.base.behavior(base_states, obs).to(torch.float32)
        return torch.cat([base_bc.reshape(states.shape[0], -1), states[:, tail, None]], dim=1)

    # gait-metrics passthrough (locomotion family) is installed per
    # INSTANCE in _install_gait so ``hasattr(env, "step_metrics")`` — the
    # protocol probe evaluate_policy uses — stays honest for base envs
    # without the protocol (a class-level method would always answer yes)

    def _install_gait(self) -> None:
        base = self.base

        def step_metrics(states):
            return base.step_metrics(self._split(states)[0])

        def episode_metrics(bc, steps, sums):
            # the base conversion expects its OWN bc layout; strip the
            # appended variant column before delegating
            return base.episode_metrics(np.asarray(bc)[:-1], steps, sums)

        self.metric_names = base.metric_names
        self.step_metrics = step_metrics
        self.episode_metrics = episode_metrics


def variant_of_bc(bc) -> np.ndarray:
    """The variant-id column of a (n, bc_dim) batch of ScenarioEnv BCs
    (the last column, by the ``behavior`` contract above)."""
    if isinstance(bc, torch.Tensor):
        bc = bc.detach().cpu().numpy()
    return np.asarray(bc)[:, -1]
