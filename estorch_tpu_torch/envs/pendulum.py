"""Batched Pendulum-v1 (continuous control), the Gym dynamics.

Counterpart of ``estorch_tpu/envs/pendulum.py``.  State (n, 2) is
(θ, θ̇); obs (n, 3) is (cos θ, sin θ, θ̇).
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    # floored modulo, as jnp's %: torch.remainder, not torch.fmod
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


@dataclasses.dataclass(frozen=True)
class Pendulum:
    max_speed: float = 8.0
    max_torque: float = 2.0
    dt: float = 0.05
    g: float = 10.0
    m: float = 1.0
    l: float = 1.0  # noqa: E741 (the Gym name)

    obs_dim: int = 3
    action_dim: int = 1
    discrete: bool = False
    default_horizon: int = 200
    bc_dim: int = 2
    action_bound: float = 2.0  # |torque| ≤ max_torque

    def observe(self, states: torch.Tensor) -> torch.Tensor:
        th, thdot = states[:, 0], states[:, 1]
        return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=1)

    def reset(self, generator: torch.Generator, n: int):
        """θ ~ U(-π, π), θ̇ ~ U(-1, 1), drawn on the generator's device."""
        hi = torch.tensor([math.pi, 1.0], dtype=torch.float32, device=generator.device)
        u = torch.rand((n, 2), generator=generator, dtype=torch.float32,
                       device=generator.device)
        states = u * (2 * hi) - hi
        return states, self.observe(states)

    def step(self, states: torch.Tensor, actions: torch.Tensor):
        th, thdot = states[:, 0], states[:, 1]
        u = torch.clamp(actions.reshape(-1), -self.max_torque, self.max_torque)
        cost = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2

        newthdot = thdot + (
            3 * self.g / (2 * self.l) * torch.sin(th) + 3.0 / (self.m * self.l**2) * u
        ) * self.dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt

        new_states = torch.stack([newth, newthdot], dim=1)
        done = torch.zeros(states.shape[0], dtype=torch.bool, device=states.device)
        return new_states, self.observe(new_states), -cost, done

    def behavior(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """BC = final angle (cos, sin)."""
        return torch.stack([torch.cos(states[:, 0]), torch.sin(states[:, 0])], dim=1)
