"""The batched device environment contract.

Counterpart of ``estorch_tpu/envs/base.py``.  The JAX envs are pure
functions of one member's state, vmapped over the population; the port's
envs take the whole population at once, with states as tensors whose
leading axis is the member:

    states, obs = env.reset(generator, n)
    states, obs, reward, done = env.step(states, actions)
    obs = env.observe(states)
    bc = env.behavior(states, obs)

Envs are frozen dataclasses of Python scalars.
"""

from __future__ import annotations

from typing import Protocol

import torch


class DeviceEnv(Protocol):
    """Structural type for batched device envs."""

    obs_dim: int
    action_dim: int  # number of discrete actions, or continuous action size
    discrete: bool
    default_horizon: int
    bc_dim: int  # behavior-characterization size

    def reset(self, generator: torch.Generator, n: int) -> tuple[torch.Tensor, torch.Tensor]: ...

    def observe(self, states: torch.Tensor) -> torch.Tensor: ...

    def step(self, states: torch.Tensor, actions: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]: ...

    def behavior(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor: ...
