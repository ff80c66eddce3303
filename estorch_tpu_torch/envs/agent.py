"""Agents: name what the engine steps; the agent steps nothing itself.

Counterparts of ``JaxAgent`` and ``PooledAgent`` in
``estorch_tpu/envs/agent.py``: a ``DeviceAgent`` names a batched device
env and a horizon, a ``PooledAgent`` a pool env (``envs/native_pool.py``,
or ``gym:<EnvId>``) whose envs step on the host while the card runs the
population's forward (``parallel/pooled.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any


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
