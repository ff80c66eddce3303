"""Population-batched episode rollouts with done masking.

Counterpart of ``make_batched_rollout`` in ``estorch_tpu/envs/rollout.py``:
one policy call per env step for the whole population, over a fixed
horizon.  After a member's episode ends its steps still run (fixed shapes),
but its reward is masked and its state and obs freeze, so the result equals
early termination; ``steps`` counts the alive steps only, and the BC reads
the final frame.

With ``with_obs_moments=True`` the same loop also sums each row's raw
observations over its alive steps, reset frame included — the obs_norm
probe's data, as ``make_rollout(with_obs_moments=True)`` and
``make_obs_probe`` accumulate it in the JAX package.  With
``with_env_metrics=True`` it sums the env's per-step gait metrics
(``env.step_metrics``) over the states each alive step reached, as
``make_rollout(with_env_metrics=True)`` does — the evaluation channel of
``ES.evaluate_policy``.

A recurrent policy's hidden carry is threaded through the loop when the
rollout is given the episode-start carry: ``batched_apply(obs, carry) ->
(out, carry')``, and the carry freezes after termination with the state and
obs, as ``make_rollout(carry_init=...)`` threads it in the JAX package.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, NamedTuple

import torch


def carry_init_takes_params(carry_init: Callable[..., Any]) -> bool:
    """Whether ``carry_init`` is the params-aware form (``carry_init(params)``,
    the learned episode-start carry) or the zero-argument form
    (``carry_init()``).  Where ``inspect.signature`` cannot tell, the
    zero-argument call is tried."""
    try:
        return bool(inspect.signature(carry_init).parameters)
    except (TypeError, ValueError):
        pass
    try:
        carry_init()
        return False
    except TypeError:
        return True


def map_carry(fn: Callable[..., torch.Tensor], *carries):
    """``fn`` over the tensors of one or more carries of the same structure
    (a tensor, or nested tuples: the LSTM's ``(c, h)``, per-layer stacks)."""
    if isinstance(carries[0], tuple):
        return tuple(map_carry(fn, *parts) for parts in zip(*carries))
    return fn(*carries)


class RolloutResult(NamedTuple):
    total_reward: torch.Tensor  # (n,) float32 — the episode return (fitness)
    bc: torch.Tensor  # (n, bc_dim) float32 — behavior characterization
    steps: torch.Tensor  # (n,) int32 — alive steps actually taken


class ObsMoments(NamedTuple):
    """Per-row raw-observation moments over the alive steps."""

    count: torch.Tensor  # (n,) float32
    obs_sum: torch.Tensor  # (n, obs_dim) float32
    obs_sumsq: torch.Tensor  # (n, obs_dim) float32


def select_action(policy_out: torch.Tensor, discrete: bool) -> torch.Tensor:
    """argmax for discrete policies; continuous outputs are the actions."""
    if discrete:
        return torch.argmax(policy_out, dim=-1)
    return policy_out


def member_params_apply(module, member_params: dict, obs: torch.Tensor, carry=None):
    """The standard forward with each member's own materialized params.

    ``member_params`` leaves carry a leading member axis (kernels (n, m, h),
    biases and VBN scales (n, h): θ_i unraveled from an (n, dim) stack);
    ``obs`` is (n, e, obs_dim), e episodes a member.  Each layer is one
    batched product over the members, x_i @ W_i + b_i, through the module's
    own forward.  A recurrent module also takes the carry (leaves (n, e,
    size)) and returns ``(out, carry')``; it lays its weights out here, so
    a caller that steps many times lays them out once itself
    (``module.population_layout``).
    """
    if carry is not None:
        return module.population_apply(module.population_layout(member_params), obs, carry)
    tree = {layer: {name: v if name == "kernel" else v.unsqueeze(-2)
                    for name, v in leaves.items()}
            for layer, leaves in member_params.items()}
    return module.apply_params(tree, obs)


def population_forward(module, member_params: dict) -> Callable[..., Any]:
    """``forward(obs (n, obs_dim)) -> (n, out)`` for n members, one
    observation each, with their materialized params (leaves with a leading
    member axis).  A policy with a population layout of its own
    (``NatureCNN``: a ``bmm`` a layer; the recurrent policies: a cell's
    gates in one product a side) lays the weights out here, once; the MLP
    runs :func:`member_params_apply`.  A recurrent policy's forward is
    ``forward(obs, carry (leaves (n, size))) -> (out, carry')``."""
    if getattr(module, "is_recurrent", False):
        layout = module.population_layout(member_params)

        def recurrent_forward(obs, carry):
            out, carry = module.population_apply(
                layout, obs[:, None], map_carry(lambda t: t[:, None], carry))
            return out[:, 0], map_carry(lambda t: t[:, 0], carry)

        return recurrent_forward
    if hasattr(module, "population_layout"):
        layout = module.population_layout(member_params)
        return lambda obs: module.population_apply(layout, obs)[:, 0]
    return lambda obs: member_params_apply(module, member_params, obs[:, None, :])[:, 0]


def make_batched_rollout(env: Any, horizon: int, with_obs_moments: bool = False,
                         with_env_metrics: bool = False) -> Callable[..., Any]:
    """``rollout(batched_apply, states0, obs0, carry0=None)``.

    ``batched_apply(obs (n, obs_dim)) -> (n, act)`` closes over the members'
    parameterization; with ``carry0`` (the episode-start carry, leaves (n,
    size)) it is ``batched_apply(obs, carry) -> (out, carry')``.  The JAX
    form takes reset keys; this one takes the initial ``(states, obs)``, so
    a caller can hand in any start states.
    Returns a :class:`RolloutResult`, or ``(RolloutResult, ObsMoments)``
    with ``with_obs_moments=True``, or ``(RolloutResult, metric_sums (n,
    k))`` with ``with_env_metrics=True`` (k = ``len(env.metric_names)``).
    """
    if with_env_metrics and with_obs_moments:
        raise ValueError("one aux channel per rollout: obs moments are the "
                         "training probe, env metrics the evaluation one")
    discrete = bool(env.discrete)

    def rollout(batched_apply, states0: torch.Tensor, obs0: torch.Tensor, carry0=None):
        n = obs0.shape[0]
        dev = obs0.device
        states, obs, carry = states0, obs0, carry0
        done = torch.zeros((n,), dtype=torch.bool, device=dev)
        total = torch.zeros((n,), dtype=torch.float32, device=dev)
        steps = torch.zeros((n,), dtype=torch.int32, device=dev)
        if with_obs_moments:
            count = torch.zeros((n,), dtype=torch.float32, device=dev)
            osum = torch.zeros(obs0.shape, dtype=torch.float32, device=dev)
            osumsq = torch.zeros(obs0.shape, dtype=torch.float32, device=dev)
        if with_env_metrics:
            msum = torch.zeros((n, len(env.metric_names)), dtype=torch.float32, device=dev)
        for _ in range(horizon):
            alive = torch.logical_not(done)
            alive_f = alive.to(torch.float32)
            if with_obs_moments:
                # the obs this step acts on, before the step: the reset frame
                # counts, a frozen post-termination frame does not
                of = obs.to(torch.float32)
                masked = alive_f[:, None] * of
                count += alive_f
                osum += masked
                osumsq += masked * of
            if carry is None:
                out = batched_apply(obs)
            else:
                out, new_carry = batched_apply(obs, carry)
            action = select_action(out, discrete)
            nstates, nobs, reward, ndone = env.step(states, action)
            if with_env_metrics:
                # metrics of the state this alive step reached; frozen
                # (post-termination) steps add nothing
                msum += alive_f[:, None] * env.step_metrics(nstates)
            # the accumulators are the rollout's own: add in place, no new
            # (n,) tensor each step
            total += reward * alive_f
            steps += alive.to(torch.int32)
            keep = alive[:, None]
            states = torch.where(keep, nstates, states)
            obs = torch.where(keep, nobs, obs)
            if carry is not None:
                carry = map_carry(lambda new, old: torch.where(keep, new, old), new_carry, carry)
            done = done | ndone
        bc = env.behavior(states, obs).to(torch.float32)
        res = RolloutResult(total_reward=total, bc=bc, steps=steps)
        if with_obs_moments:
            return res, ObsMoments(count, osum, osumsq)
        if with_env_metrics:
            return res, msum
        return res

    return rollout
