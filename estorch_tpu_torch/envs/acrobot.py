"""Batched Acrobot-v1 (classic control), the Gym 'book' dynamics.

Counterpart of ``estorch_tpu/envs/acrobot.py``: RK4 over one ``dt`` with a
constant torque, angles wrapped to [-π, π), velocities clipped.  State
(n, 4) is (θ1, θ2, θ̇1, θ̇2); obs (n, 6) is (cos θ1, sin θ1, cos θ2,
sin θ2, θ̇1, θ̇2); actions are integers in {0, 1, 2} (torque -1, 0, +1).
The expressions keep the JAX package's order of operations.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .base import scenario_value as sv


def _wrap(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # floored modulo, as jnp's %: torch.remainder, not torch.fmod
    return lo + torch.remainder(x - lo, hi - lo)


@dataclasses.dataclass(frozen=True)
class Acrobot:
    dt: float = 0.2
    link_length_1: float = 1.0
    link_mass_1: float = 1.0
    link_mass_2: float = 1.0
    link_com_1: float = 0.5
    link_com_2: float = 0.5
    link_moi: float = 1.0
    max_vel_1: float = 4 * math.pi
    max_vel_2: float = 9 * math.pi
    g: float = 9.8

    obs_dim: int = 6
    action_dim: int = 3
    discrete: bool = True
    default_horizon: int = 500
    bc_dim: int = 2

    # the constants a scenario distribution may randomize (scenarios/)
    SCENARIO_FIELDS = ("link_mass_1", "link_mass_2", "link_length_1", "link_com_1",
                       "link_com_2", "g")

    def scenario_defaults(self) -> dict:
        return {n: float(getattr(self, n)) for n in self.SCENARIO_FIELDS}

    def observe(self, states: torch.Tensor) -> torch.Tensor:
        t1, t2, dt1, dt2 = states.unbind(dim=1)
        return torch.stack([torch.cos(t1), torch.sin(t1), torch.cos(t2), torch.sin(t2),
                            dt1, dt2], dim=1)

    def reset(self, generator: torch.Generator, n: int):
        """Every state component ~ U(-0.1, 0.1)."""
        u = torch.rand((n, 4), generator=generator, dtype=torch.float32,
                       device=generator.device)
        states = u * 0.2 - 0.1
        return states, self.observe(states)

    def _dsdt(self, s: torch.Tensor, torque: torch.Tensor, params=None) -> torch.Tensor:
        m1 = sv(params, "link_mass_1", self.link_mass_1)
        m2 = sv(params, "link_mass_2", self.link_mass_2)
        l1 = sv(params, "link_length_1", self.link_length_1)
        lc1 = sv(params, "link_com_1", self.link_com_1)
        lc2 = sv(params, "link_com_2", self.link_com_2)
        I1 = I2 = self.link_moi  # noqa: N806 (the Gym names)
        g = sv(params, "g", self.g)
        t1, t2, dt1, dt2 = s.unbind(dim=1)

        d1 = (
            m1 * lc1**2
            + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * torch.cos(t2))
            + I1
            + I2
        )
        d2 = m2 * (lc2**2 + l1 * lc2 * torch.cos(t2)) + I2
        phi2 = m2 * lc2 * g * torch.cos(t1 + t2 - math.pi / 2.0)
        phi1 = (
            -m2 * l1 * lc2 * dt2**2 * torch.sin(t2)
            - 2 * m2 * l1 * lc2 * dt2 * dt1 * torch.sin(t2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(t1 - math.pi / 2.0)
            + phi2
        )
        # the 'book' equations (gymnasium default)
        ddt2 = (
            torque + d2 / d1 * phi1 - m2 * l1 * lc2 * dt1**2 * torch.sin(t2) - phi2
        ) / (m2 * lc2**2 + I2 - d2**2 / d1)
        ddt1 = -(d2 * ddt2 + phi1) / d1
        return torch.stack([dt1, dt2, ddt1, ddt2], dim=1)

    def step(self, states: torch.Tensor, actions: torch.Tensor):
        return self.step_p(None, states, actions)

    def step_p(self, params, states: torch.Tensor, actions: torch.Tensor):
        """One dynamics definition for both forms (see ``Pendulum.step_p``)."""
        torque = (actions.reshape(-1) - 1).to(torch.float32)  # {0,1,2} -> {-1,0,+1}

        # RK4 over one dt with constant torque (gymnasium's rk4)
        s = states
        h = self.dt
        k1 = self._dsdt(s, torque, params)
        k2 = self._dsdt(s + h / 2.0 * k1, torque, params)
        k3 = self._dsdt(s + h / 2.0 * k2, torque, params)
        k4 = self._dsdt(s + h * k3, torque, params)
        ns = s + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

        t1 = _wrap(ns[:, 0], -math.pi, math.pi)
        t2 = _wrap(ns[:, 1], -math.pi, math.pi)
        dt1 = torch.clamp(ns[:, 2], -self.max_vel_1, self.max_vel_1)
        dt2 = torch.clamp(ns[:, 3], -self.max_vel_2, self.max_vel_2)
        new_states = torch.stack([t1, t2, dt1, dt2], dim=1)

        done = -torch.cos(t1) - torch.cos(t2 + t1) > 1.0
        reward = torch.where(done, 0.0, -1.0)
        return new_states, self.observe(new_states), reward, done

    def behavior(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """BC = final tip position, in the downward-vertical angle convention
        of the terminal height check."""
        t1, t2 = states[:, 0], states[:, 1]
        x = torch.sin(t1) + torch.sin(t1 + t2)
        y = -torch.cos(t1) - torch.cos(t1 + t2)
        return torch.stack([x, y], dim=1)
