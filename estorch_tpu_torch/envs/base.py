"""The batched device environment contract.

Counterpart of ``estorch_tpu/envs/base.py``.  The JAX envs are pure
functions of one member's state, vmapped over the population; the port's
envs take the whole population at once, with states as tensors whose
leading axis is the member:

    states, obs = env.reset(generator, n)
    states, obs, reward, done = env.step(states, actions)
    obs = env.observe(states)
    bc = env.behavior(states, obs)

Envs are frozen dataclasses of Python scalars.  The parameterized families
(Pendulum, CartPole, Acrobot, both MountainCars, the planar chains) also
declare ``SCENARIO_FIELDS``, ``scenario_defaults()`` and ``step_p(params,
states, actions)``, with ``step = step_p(None, ...)``: ``params`` maps a
field to one value per member, shape (n,) (``scenarios/params.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import torch


def scenario_value(params, name: str, default: float):
    """The lookup rule of every parameterized env family: the members'
    drawn values (n,) when the draw includes ``name``, else the env's
    constant.  ``params is None`` (the plain ``step``) returns the Python
    float, so the plain path computes and launches exactly what it did
    before scenarios existed."""
    if params is None:
        return default
    return params.get(name, default)


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


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Static facts the engine needs about an env (shapes, modes)."""

    obs_dim: int
    action_dim: int
    discrete: bool
    horizon: int
    bc_dim: int

    @staticmethod
    def of(env: DeviceEnv, horizon: int | None = None) -> "EnvSpec":
        return EnvSpec(obs_dim=env.obs_dim, action_dim=env.action_dim, discrete=env.discrete,
                       horizon=int(horizon or env.default_horizon), bc_dim=env.bc_dim)
