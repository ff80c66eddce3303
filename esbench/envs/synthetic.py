"""A frozen copy of the port's ``SyntheticEnv`` (``envs/synthetic.py``).

A MuJoCo-sized linear system: state' = a·state + b·roll(state, 1) +
0.1·scatter(action); obs = state; reward = −mean(state'²).  Never ends, so
every member takes every step of the horizon.  |a + b·e^{iθ}| ≤ 0.99 keeps
the state bounded under bounded actions.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SyntheticEnv:
    obs_dim: int = 376
    action_dim: int = 17
    discrete: bool = False
    default_horizon: int = 200
    bc_dim: int = 2
    decay: float = 0.95
    mix: float = 0.04

    def observe(self, states: torch.Tensor) -> torch.Tensor:
        return states

    def reset(self, generator: torch.Generator, n: int):
        """Every state component ~ 0.1·N(0, 1)."""
        states = 0.1 * torch.randn((n, self.obs_dim), generator=generator,
                                   dtype=torch.float32, device=generator.device)
        return states, states

    def step(self, states: torch.Tensor, actions: torch.Tensor):
        act = torch.clamp(actions.reshape(states.shape[0], -1), -1.0, 1.0)
        new_states = self.decay * states + self.mix * torch.roll(states, 1, dims=1)
        new_states[:, :self.action_dim] += 0.1 * act
        reward = -torch.mean(new_states**2, dim=1)
        done = torch.zeros(states.shape[0], dtype=torch.bool, device=states.device)
        return new_states, new_states, reward, done

    def behavior(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        return states[:, :self.bc_dim]
