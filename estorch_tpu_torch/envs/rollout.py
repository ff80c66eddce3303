"""Population-batched episode rollouts with done masking.

Counterpart of ``make_batched_rollout`` in ``estorch_tpu/envs/rollout.py``:
one policy call per env step for the whole population, over a fixed
horizon.  After a member's episode ends its steps still run (fixed shapes),
but its reward is masked and its state and obs freeze, so the result equals
early termination; ``steps`` counts the alive steps only, and the BC reads
the final frame.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class RolloutResult(NamedTuple):
    total_reward: torch.Tensor  # (n,) float32 — the episode return (fitness)
    bc: torch.Tensor  # (n, bc_dim) float32 — behavior characterization
    steps: torch.Tensor  # (n,) int32 — alive steps actually taken


def select_action(policy_out: torch.Tensor, discrete: bool) -> torch.Tensor:
    """argmax for discrete policies; continuous outputs are the actions."""
    if discrete:
        return torch.argmax(policy_out, dim=-1)
    return policy_out


def make_batched_rollout(env: Any, horizon: int) -> Callable[..., RolloutResult]:
    """``rollout(batched_apply, states0, obs0) -> RolloutResult``.

    ``batched_apply(obs (n, obs_dim)) -> (n, act)`` closes over the members'
    parameterization.  The JAX form takes reset keys; this one takes the
    initial ``(states, obs)``, so a caller can hand in any start states.
    """
    discrete = bool(env.discrete)

    def rollout(batched_apply, states0: torch.Tensor, obs0: torch.Tensor) -> RolloutResult:
        n = obs0.shape[0]
        dev = obs0.device
        states, obs = states0, obs0
        done = torch.zeros((n,), dtype=torch.bool, device=dev)
        total = torch.zeros((n,), dtype=torch.float32, device=dev)
        steps = torch.zeros((n,), dtype=torch.int32, device=dev)
        for _ in range(horizon):
            action = select_action(batched_apply(obs), discrete)
            nstates, nobs, reward, ndone = env.step(states, action)
            alive = torch.logical_not(done)
            # the accumulators are the rollout's own: add in place, no new
            # (n,) tensor each step
            total += reward * alive.to(torch.float32)
            steps += alive.to(torch.int32)
            keep = alive[:, None]
            states = torch.where(keep, nstates, states)
            obs = torch.where(keep, nobs, obs)
            done = done | ndone
        bc = env.behavior(states, obs).to(torch.float32)
        return RolloutResult(total_reward=total, bc=bc, steps=steps)

    return rollout
