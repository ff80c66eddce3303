"""Batched CartPole-v1 (classic control), the Gym dynamics.

Counterpart of ``estorch_tpu/envs/cartpole.py``.  State and obs (n, 4) are
(x, ẋ, θ, θ̇); actions are integers in {0, 1}.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .base import scenario_value as sv


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

    # the constants a scenario distribution may randomize (scenarios/)
    SCENARIO_FIELDS = ("gravity", "masscart", "masspole", "length", "force_mag")

    def scenario_defaults(self) -> dict:
        return {n: float(getattr(self, n)) for n in self.SCENARIO_FIELDS}

    def observe(self, states: torch.Tensor) -> torch.Tensor:
        return states

    def reset(self, generator: torch.Generator, n: int):
        """Every state component ~ U(-0.05, 0.05)."""
        u = torch.rand((n, 4), generator=generator, dtype=torch.float32,
                       device=generator.device)
        states = u * 0.1 - 0.05
        return states, states

    def step(self, states: torch.Tensor, actions: torch.Tensor):
        return self.step_p(None, states, actions)

    def step_p(self, params, states: torch.Tensor, actions: torch.Tensor):
        """One dynamics definition for both forms (see ``Pendulum.step_p``)."""
        gravity = sv(params, "gravity", self.gravity)
        masscart = sv(params, "masscart", self.masscart)
        masspole = sv(params, "masspole", self.masspole)
        length = sv(params, "length", self.length)
        force_mag = sv(params, "force_mag", self.force_mag)
        x, x_dot, theta, theta_dot = states.unbind(dim=1)
        force = torch.where(actions.reshape(-1) == 1, force_mag, -force_mag).to(states.dtype)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        total_mass = masscart + masspole
        polemass_length = masspole * length

        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (gravity * sintheta - costheta * temp) / (
            length * (4.0 / 3.0 - masspole * costheta**2 / total_mass)
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
