"""Agents: name what the engine steps; the agent steps nothing itself.

Counterparts of ``JaxAgent``, ``PooledAgent`` and
``collect_reference_batch`` in ``estorch_tpu/envs/agent.py``: a
``DeviceAgent`` names a batched device env and a horizon, a ``PooledAgent``
a pool env (``envs/native_pool.py``, or ``gym:<EnvId>``) whose envs step on
the host while the card runs the population's forward
(``parallel/pooled.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class DeviceAgent:
    """Wraps a batched device env (``envs/base.py``) for the engine."""

    env: Any
    horizon: int | None = None

    @property
    def rollout_horizon(self) -> int:
        return int(self.horizon or self.env.default_horizon)


@dataclasses.dataclass
class PooledAgent:
    """Pooled-backend agent: the population's envs step in a host pool
    while the card runs one batched policy forward an env step."""

    env_name: str
    horizon: int = 500
    n_threads: int = 0
    double_buffer: bool = False  # overlap the card's forwards with env
    # stepping (two half-population pools; see parallel/pooled.py)
    env_kwargs: dict | None = None  # forwarded to gym.make for gym: envs
    bc_indices: tuple | None = None  # the BC is these final-observation dims
    # (e.g. (0,): the final x-position) instead of the whole final obs
    # ALE-standard preprocessing (envs/atari_wrappers.py); the defaults pass
    # observations through
    frame_stack: int = 1
    action_repeat: int = 1
    sticky_prob: float = 0.0
    max_pool2: bool = False

    @property
    def prep(self) -> dict | None:
        """The wrapper's kwargs, or None when every one is at pass-through."""
        if (self.frame_stack, self.action_repeat, self.sticky_prob,
                self.max_pool2) == (1, 1, 0.0, False):
            return None
        return {
            "frame_stack": self.frame_stack,
            "action_repeat": self.action_repeat,
            "sticky_prob": self.sticky_prob,
            "max_pool2": self.max_pool2,
        }


def collect_reference_batch(env: Any, n_steps: int = 128,
                            generator: torch.Generator | None = None,
                            actions: torch.Tensor | None = None,
                            state0: torch.Tensor | None = None) -> torch.Tensor:
    """Observations of one random-action episode, for VirtualBatchNorm's
    frozen statistics: (n_steps, *obs_shape) ((n_steps, obs_dim) for a flat
    env), row t the observation before step t (row 0 the reset frame).  Where a step ends the episode, the old
    state and obs are kept, not reset, so the shapes stay fixed.

    ``state0`` (1, state_dim) and ``actions`` (n_steps,) integers or
    (n_steps, action_dim) in [-1, 1] are drawn from ``generator`` unless
    given (tests hand in the JAX package's draws).
    """
    if generator is None:
        generator = torch.Generator()
    if state0 is None:
        state0, _ = env.reset(generator, 1)
    if actions is None:
        if env.discrete:
            actions = torch.randint(0, env.action_dim, (n_steps,), generator=generator,
                                    device=generator.device)
        else:
            u = torch.rand((n_steps, env.action_dim), generator=generator,
                           device=generator.device)
            actions = u * 2.0 - 1.0
    state, obs = state0, env.observe(state0)
    rows = []
    for t in range(n_steps):
        rows.append(obs[0])
        nstate, nobs, _, done = env.step(state, actions[t:t + 1])
        state = torch.where(done[:, None], state, nstate)
        obs = torch.where(done.view((1,) * obs.ndim), obs, nobs)
    return torch.stack(rows)
