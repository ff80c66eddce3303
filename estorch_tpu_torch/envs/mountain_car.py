"""Batched MountainCarContinuous-v0, the Gym dynamics.

Counterpart of ``estorch_tpu/envs/mountain_car.py``.  State and obs (n, 2)
are (position, velocity); the action (n, 1) is a force clipped to ±1.
"""

from __future__ import annotations

import dataclasses

import torch

from .base import scenario_value as sv


@dataclasses.dataclass(frozen=True)
class MountainCarContinuous:
    min_position: float = -1.2
    max_position: float = 0.6
    max_speed: float = 0.07
    goal_position: float = 0.45
    goal_velocity: float = 0.0
    power: float = 0.0015

    obs_dim: int = 2
    action_dim: int = 1
    discrete: bool = False
    default_horizon: int = 999
    bc_dim: int = 1
    action_bound: float = 1.0  # force clipped to ±1

    # the constants a scenario distribution may randomize (scenarios/)
    SCENARIO_FIELDS = ("power", "max_speed")

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
        power = sv(params, "power", self.power)
        max_speed = sv(params, "max_speed", self.max_speed)
        position, velocity = states[:, 0], states[:, 1]
        force = torch.clamp(actions.reshape(-1), -1.0, 1.0)

        velocity = velocity + force * power - 0.0025 * torch.cos(3 * position)
        velocity = torch.clamp(velocity, -max_speed, max_speed)
        position = position + velocity
        position = torch.clamp(position, self.min_position, self.max_position)
        velocity = _left_wall(position, velocity, self.min_position)

        done = (position >= self.goal_position) & (velocity >= self.goal_velocity)
        reward = torch.where(done, 100.0, 0.0) - 0.1 * force**2

        new_states = torch.stack([position, velocity], dim=1)
        return new_states, new_states, reward, done

    def behavior(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """BC = final position (the NS-ES paper's BC for deceptive mazes)."""
        return states[:, :1]


def _reset_on_the_valley_floor(generator: torch.Generator, n: int):
    u = torch.rand((n,), generator=generator, dtype=torch.float32, device=generator.device)
    states = torch.stack([u * 0.2 - 0.6, torch.zeros_like(u)], dim=1)
    return states, states


def _left_wall(position: torch.Tensor, velocity: torch.Tensor,
               min_position: float) -> torch.Tensor:
    """A car clipped to the left wall while moving left stops there.  The
    float32 position equals the wall after the clip: the Python float is
    cast to float32 for the comparison, as in JAX."""
    return torch.where((position == min_position) & (velocity < 0), 0.0, velocity)
