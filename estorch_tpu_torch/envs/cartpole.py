"""Batched CartPole-v1 (classic control), the Gym dynamics.

Counterpart of ``estorch_tpu/envs/cartpole.py``.  State and obs (n, 4) are
(x, ẋ, θ, θ̇); actions are integers in {0, 1}.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class CartPole:
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    length: float = 0.5  # half the pole's length
    force_mag: float = 10.0
    tau: float = 0.02
    theta_threshold: float = 12 * 2 * math.pi / 360
    x_threshold: float = 2.4

    obs_dim: int = 4
    action_dim: int = 2
    discrete: bool = True
    default_horizon: int = 500
    bc_dim: int = 2

    def observe(self, states: torch.Tensor) -> torch.Tensor:
        return states

    def reset(self, generator: torch.Generator, n: int):
        """Every state component ~ U(-0.05, 0.05)."""
        u = torch.rand((n, 4), generator=generator, dtype=torch.float32,
                       device=generator.device)
        states = u * 0.1 - 0.05
        return states, states

    def step(self, states: torch.Tensor, actions: torch.Tensor):
        x, x_dot, theta, theta_dot = states.unbind(dim=1)
        force = torch.where(actions.reshape(-1) == 1, self.force_mag, -self.force_mag).to(
            states.dtype)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length

        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass

        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc

        new_states = torch.stack([x, x_dot, theta, theta_dot], dim=1)
        done = (x.abs() > self.x_threshold) | (theta.abs() > self.theta_threshold)
        reward = torch.ones(states.shape[0], dtype=states.dtype, device=states.device)
        return new_states, new_states, reward, done

    def behavior(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """BC = final cart position and pole angle."""
        return torch.stack([states[:, 0], states[:, 2]], dim=1)
