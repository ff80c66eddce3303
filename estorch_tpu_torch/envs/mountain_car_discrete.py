"""Batched MountainCar-v0 (discrete), the Gym dynamics.

Counterpart of ``estorch_tpu/envs/mountain_car_discrete.py``.  State and
obs (n, 2) are (position, velocity); actions are integers in {0, 1, 2}
(push left, no push, push right).
"""

from __future__ import annotations

import dataclasses

import torch

from .base import scenario_value as sv
from .mountain_car import _left_wall, _reset_on_the_valley_floor


@dataclasses.dataclass(frozen=True)
class MountainCar:
    min_position: float = -1.2
    max_position: float = 0.6
    max_speed: float = 0.07
    goal_position: float = 0.5
    goal_velocity: float = 0.0
    force: float = 0.001
    gravity: float = 0.0025

    obs_dim: int = 2
    action_dim: int = 3  # push left / no-op / push right
    discrete: bool = True
    default_horizon: int = 200
    bc_dim: int = 1

    # the constants a scenario distribution may randomize (scenarios/)
    SCENARIO_FIELDS = ("force", "gravity", "max_speed")

    def scenario_defaults(self) -> dict:
        return {n: float(getattr(self, n)) for n in self.SCENARIO_FIELDS}

    def observe(self, states: torch.Tensor) -> torch.Tensor:
        return states

    def reset(self, generator: torch.Generator, n: int):
        """position ~ U(-0.6, -0.4), velocity 0."""
        return _reset_on_the_valley_floor(generator, n)

    def step(self, states: torch.Tensor, actions: torch.Tensor):
        return self.step_p(None, states, actions)

    def step_p(self, params, states: torch.Tensor, actions: torch.Tensor):
        """One dynamics definition for both forms (see ``Pendulum.step_p``)."""
        force_c = sv(params, "force", self.force)
        gravity = sv(params, "gravity", self.gravity)
        max_speed = sv(params, "max_speed", self.max_speed)
        position, velocity = states[:, 0], states[:, 1]
        velocity = velocity + (actions.reshape(-1) - 1) * force_c + torch.cos(
            3 * position
        ) * (-gravity)
        velocity = torch.clamp(velocity, -max_speed, max_speed)
        position = torch.clamp(position + velocity, self.min_position, self.max_position)
        velocity = _left_wall(position, velocity, self.min_position)
        done = (position >= self.goal_position) & (velocity >= self.goal_velocity)
        reward = torch.full_like(position, -1.0)
        new_states = torch.stack([position, velocity], dim=1)
        return new_states, new_states, reward, done

    def behavior(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """BC = final position (how far up the hill it got)."""
        return states[:, :1]
