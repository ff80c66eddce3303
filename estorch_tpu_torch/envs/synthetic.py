"""Batched synthetic envs: a throughput benchmark and a memory probe.

Counterpart of ``estorch_tpu/envs/synthetic.py``:

- :class:`SyntheticEnv` — a leaky shift register driven by the action, with
  a configurable observation size and negligible step cost, so that the
  policy forward dominates a step (the JAX bench's BIG and POP10K rows run
  it at Humanoid's obs 376 / action 17);
- :class:`RecallEnv` — a ±1 signal observable only in the reset frame;
  reward ``clip(action)·signal`` every step.

Neither terminates.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SyntheticEnv:
    """state' = a·state + b·roll(state, 1) + 0.1·scatter(action); obs = state;
    reward = -mean(state'²).  |a + b·e^{iθ}| ≤ 0.99, so bounded actions
    give a bounded state."""

    obs_dim: int = 376
    action_dim: int = 17
    discrete: bool = False
    default_horizon: int = 200
    bc_dim: int = 2
    action_bound: float = 1.0
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
        # the drive is 0 past the first action_dim slots, and x + 0 == x:
        # adding to the first slots alone gives the same floats
        new_states[:, :self.action_dim] += 0.1 * act
        reward = -torch.mean(new_states**2, dim=1)
        done = torch.zeros(states.shape[0], dtype=torch.bool, device=states.device)
        return new_states, new_states, reward, done

    def behavior(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        return states[:, :self.bc_dim]


@dataclasses.dataclass(frozen=True)
class RecallEnv:
    """Memory probe: a memoryless policy sees the signal once and earns ~1
    over the symmetric ±1 episodes; one that keeps it earns ~horizon.
    State (n, 2) is (signal, t)."""

    obs_dim: int = 1
    action_dim: int = 1
    discrete: bool = False
    default_horizon: int = 32
    bc_dim: int = 1

    def observe(self, states: torch.Tensor) -> torch.Tensor:
        """The reset frame's observation, the signal; every later frame is
        zeros (:meth:`step` returns them)."""
        return states[:, :1]

    def reset(self, generator: torch.Generator, n: int):
        u = torch.rand((n,), generator=generator, dtype=torch.float32,
                       device=generator.device)
        sign = torch.where(u < 0.5, 1.0, -1.0)
        states = torch.stack([sign, torch.zeros_like(sign)], dim=1)
        return states, self.observe(states)

    def step(self, states: torch.Tensor, actions: torch.Tensor):
        sign, t = states[:, 0], states[:, 1]
        act = torch.clamp(actions.reshape(states.shape[0], -1), -1.0, 1.0)[:, 0]
        reward = act * sign
        new_states = torch.stack([sign, t + 1.0], dim=1)
        # the signal is gone from every post-reset observation
        obs = torch.zeros((states.shape[0], 1), dtype=torch.float32, device=states.device)
        done = torch.zeros(states.shape[0], dtype=torch.bool, device=states.device)
        return new_states, obs, reward, done

    def behavior(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        return states[:, :1]
