"""PooledEngine: host env pools and a population-batched forward on the card.

Counterpart of ``estorch_tpu/parallel/pooled.py``, for envs that do not
run on the device: the population's envs step in a host pool (the C++
envpool's threads, ``envs/native_pool.py``, or gymnasium workers) while the
card runs one batched forward for the whole population an env step,
(population, obs_dim) in, (population, act_dim) out.  Each member's
perturbed params are materialized once a generation from the shared noise
table (cast once to bf16 with ``compute_dtype="bfloat16"``) and laid out
for the forward once (``envs/rollout.py::population_forward``).  The
update is the device path's (``ESEngine`` in update-only mode), from the
same offsets, ranked on the host with ``utils/fault.py`` (NaN-safe, stable
ties).

Pool seeds are the JAX package's (``seed``; ``seed + 10_007`` for the
second half with ``double_buffer``; ``seed + 1`` for the center;
``20_011 + seed`` for held-out evaluation), so both packages step the same
env streams.  With ``obs_norm`` the observations are normalized on the
host, and every alive observation a member acts on feeds float64 raw
moments that :meth:`apply_weights` folds into the state's Welford triple
(only for the evaluation of that same generation and center).

A recurrent policy (``carry_init`` given) keeps a stacked (population, …)
carry across the generation's step loop, returned by the same batched
forward that computes the actions; it starts at ``carry_init()`` (the
pooled path has no learned carry), once for each half with
``double_buffer``, and the center's evaluations keep carries of their own.

``double_buffer`` splits the population into two halves with pools of
their own: while one half's envs step on the host, the other half's
forward runs on the card.  On CUDA each half's actions come back through a
``non_blocking`` copy into a pinned buffer and a CUDA event, so waiting
for one half never waits for the other half's forward.

The JAX package's chaos hook (``mutate_fitness``) belongs to ROADMAP.md
port item 6 and is not here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..envs.gym_vec_pool import make_pool
from ..envs.rollout import RolloutResult, map_carry, population_forward
from ..ops.noise import gather_rows, member_offsets, pair_signs
from ..ops.params import ParamSpec, map_tree
from ..utils.fault import rank_weights_with_failures
from .engine import EngineConfig, ESEngine, ESState, merge_obs_moments_np


@dataclasses.dataclass
class PooledEvalResult:
    fitness: np.ndarray  # (n,) float32 episode returns
    bc: np.ndarray  # (n, bc_dim) float32 final frames (or their bc_indices)
    steps: int  # alive env steps taken


class PooledEngine:
    """The engine interface of ``ESEngine`` with pooled evaluation."""

    def __init__(self, env_name: str, module: Any, spec: ParamSpec, table, optimizer,
                 config: EngineConfig, device: torch.device, n_threads: int = 0,
                 seed: int = 0, double_buffer: bool = False, prep: dict | None = None,
                 env_kwargs: dict | None = None, bc_indices=None, carry_init=None):
        if config.episodes_per_member != 1:
            raise ValueError("episodes_per_member is a device-path option; the pooled path "
                             "rolls one episode per member env")
        if config.streamed:
            raise ValueError("streamed is a device-path option; the pooled path's policy "
                             "forward runs per env step against materialized thetas")
        if config.decomposed:
            raise ValueError("decomposed is a device-path option; the pooled path "
                             "materializes per-member thetas for its batched forward")
        if config.low_rank:
            raise ValueError("low_rank is a device-path option (ops/lowrank.py); the pooled "
                             "path materializes per-member thetas")
        self.obs_norm = bool(config.obs_norm)
        self.prep = dict(prep) if prep else None
        if self.obs_norm and self.prep:
            raise ValueError("obs_norm + Atari preprocessing is unsupported: pixel policies "
                             "normalize via VBN / their own /255 scaling")
        self.env_name = env_name
        self.env_kwargs = dict(env_kwargs) if env_kwargs else None
        self.module = module
        self.spec = spec
        self.config = config
        self.device = torch.device(device)
        self._dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
        self._obs_clip = float(config.obs_clip)
        self._carry_init = carry_init
        self.recurrent = carry_init is not None
        self._pending_moments: list | None = None
        self._pending_moments_key: tuple | None = None
        # the update-only engine: the device path's offsets and update; the
        # obs stats are this engine's (host-side), so its config has no obs_norm
        self.core = ESEngine(None, module, spec, table, optimizer,
                             dataclasses.replace(config, obs_norm=False), self.device)
        self.double_buffer = bool(double_buffer)
        if self.double_buffer:
            half = config.population_size // 2
            if half * 2 != config.population_size or half == 0:
                raise ValueError("double_buffer needs an even population of at least 2")
            self.pool_a = self._make_pool(half, n_threads, seed)
            self.pool_b = self._make_pool(half, n_threads, seed + 10_007)
            self.pool = self.pool_a  # dims and metadata
            if self.device.type == "cuda":
                shape = (half,) if self.pool.discrete else (half, self.pool.act_dim)
                self._pinned = [torch.empty(shape, dtype=torch.float32, pin_memory=True)
                                for _ in range(2)]
        else:
            self.pool = self._make_pool(config.population_size, n_threads, seed)
        self.center_pool = self._make_pool(1, 0, seed + 1)
        self._bc_idx = np.asarray(bc_indices, np.intp) if bc_indices is not None else None
        if self._bc_idx is not None:
            if len(self.pool.obs_shape) != 1:
                raise ValueError(
                    f"bc_indices need a 1-D observation; got obs_shape {self.pool.obs_shape} "
                    "— pixel policies characterize behavior via the full final frame")
            if self._bc_idx.min() < 0 or self._bc_idx.max() >= self.pool.obs_dim:
                raise ValueError(f"bc_indices {list(self._bc_idx)} out of range for obs_dim "
                                 f"{self.pool.obs_dim}")
        self.bc_dim = len(self._bc_idx) if self._bc_idx is not None else self.pool.obs_dim

    def _make_pool(self, n_envs: int, n_threads: int, seed: int):
        pool = make_pool(self.env_name, n_envs, n_threads=n_threads, seed=seed,
                         env_kwargs=self.env_kwargs)
        if self.prep:
            from ..envs.atari_wrappers import AtariPreprocessPool

            pool = AtariPreprocessPool(pool, seed=seed, **self.prep)
        return pool

    # ------------------------------------------------------------ state

    def init_state(self, params_flat: torch.Tensor, seed: int) -> ESState:
        state = self.core.init_state(params_flat, seed)
        if self.obs_norm:
            # the device path's start: count 1, mean 0, m2 1 (var 1)
            d = self.pool.obs_dim
            state = state._replace(obs_stats=(
                torch.tensor(1.0, device=self.device),
                torch.zeros((d,), device=self.device),
                torch.ones((d,), device=self.device)))
        return state

    def all_pair_offsets(self, state: ESState) -> torch.Tensor:
        return self.core.all_pair_offsets(state)

    def member_params(self, state: ESState, member_index: int) -> torch.Tensor:
        return self.core.member_params(state, member_index)

    # ------------------------------------------------------- the forward

    def materialize(self, state: ESState, pair_offsets: torch.Tensor) -> dict:
        """Every member's params θ + σ·s·ε as a param dict whose leaves have
        a leading member axis, in the compute dtype.  Each leaf is gathered
        on its own, so every leaf is contiguous and nothing (P, dim)-sized
        is built twice; a row's start is resolved for the whole row first,
        as ``NoiseTable.slice`` resolves it."""
        cfg = self.config
        offs = pair_offsets.to(self.device)
        if cfg.mirrored:
            offs = member_offsets(offs)
            signs = pair_signs(cfg.population_size, self.device)
        else:
            signs = torch.ones((cfg.population_size,), dtype=torch.float32, device=self.device)
        table = self.core.table.data
        size, dim = table.shape[0], self.spec.dim
        starts = offs.to(torch.int64)
        starts = torch.where(starts < 0, starts + size, starts).clamp(0, size - dim)
        c = (state.sigma * signs)[:, None]
        tree: dict = {}
        for path, shape, off in zip(self.spec.paths, self.spec.shapes, self.spec.offsets):
            n = int(np.prod(shape))
            leaf = state.params_flat[off:off + n] + c * gather_rows(table, starts + off, n)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf.view((-1,) + shape).to(self._dtype)
        return tree

    def _center_members(self, params_flat: torch.Tensor, n: int) -> dict:
        """The center's params, in the compute dtype, as n identical members."""
        tree = self.spec.unravel(params_flat.to(self._dtype))
        return map_tree(lambda v: v.expand((n,) + v.shape), tree)

    def _carries(self, n: int):
        """The stacked episode-start carry of n episodes, leaves (n, size),
        in the compute dtype on the device (cast once)."""
        return map_carry(lambda x: x.to(self.device, self._dtype).expand((n,) + x.shape)
                         .contiguous(), self._carry_init())

    def _actions(self, fwd: Callable, obs: np.ndarray, norm, carry=None):
        """``(actions, carry')`` of one env step on the device: the host obs
        (normalized with ``norm``), copied to the card without a sync,
        through ``fwd`` (with a recurrent policy's ``carry``; None
        otherwise), then argmax (discrete) or the flat outputs, float32."""
        if norm is not None:
            obs = np.clip((obs - norm[0]) * norm[1], -self._obs_clip,
                          self._obs_clip).astype(np.float32)
        x = torch.from_numpy(obs).to(self.device, non_blocking=True)
        if torch.is_floating_point(x):
            x = x.to(self._dtype)
        if carry is not None:
            out, carry = fwd(x, carry)
        else:
            out = fwd(x)
        out = out.to(torch.float32)
        if self.pool.discrete:
            return torch.argmax(out, dim=-1).to(torch.float32), carry
        return out.reshape(out.shape[0], -1), carry

    def _norm_params(self, state: ESState):
        """(mean, 1/std) float32 numpy from the state's Welford triple."""
        c, m, m2 = (t.detach().cpu().numpy() for t in state.obs_stats)
        mean = np.asarray(m, np.float32)
        var = np.maximum(np.asarray(m2, np.float32) / float(c), 1e-8)
        return mean, (1.0 / np.sqrt(var)).astype(np.float32)

    def _accumulate_moments(self, obs: np.ndarray, alive: np.ndarray) -> None:
        raw = obs[alive]
        if len(raw):
            m = self._pending_moments
            m[0] += float(len(raw))
            m[1] += raw.sum(axis=0, dtype=np.float64)
            m[2] += (raw.astype(np.float64) ** 2).sum(axis=0)

    def _bc(self, final_obs: np.ndarray) -> np.ndarray:
        return final_obs if self._bc_idx is None else final_obs[..., self._bc_idx]

    # -------------------------------------------------------- evaluation

    def evaluate(self, state: ESState, pair_offsets: torch.Tensor | None = None
                 ) -> PooledEvalResult:
        """Every member's episode; ``pair_offsets`` replaces this
        generation's offsets (tests hand in the JAX package's)."""
        offs = self.all_pair_offsets(state) if pair_offsets is None else pair_offsets
        members = self.materialize(state, offs)
        norm = self._norm_params(state) if self.obs_norm else None
        if self.obs_norm:
            # moments of this evaluation, merged only into the update of the
            # same generation and center (the buffer itself is the key)
            d = self.pool.obs_dim
            self._pending_moments = [0.0, np.zeros(d, np.float64), np.zeros(d, np.float64)]
            self._pending_moments_key = (int(state.generation), state.params_flat)
        if self.double_buffer:
            return self._evaluate_double_buffered(members, norm)
        return self._run_pool(self.pool, population_forward(self.module, members),
                              self.config.population_size, norm, accumulate=norm is not None)

    def _run_pool(self, pool, fwd: Callable, n: int, norm, accumulate: bool) -> PooledEvalResult:
        """Step n episodes (one per pool env, one member each) to their end:
        host env steps and one batched forward an env step.  ``accumulate``
        feeds the alive observations into the pending obs moments (training
        evaluations only)."""
        obs = pool.reset()
        total = np.zeros(n, np.float32)
        alive = np.ones(n, bool)
        final_obs = obs.copy()
        steps = 0
        carry = self._carries(n) if self.recurrent else None
        for _ in range(self.config.horizon):
            if accumulate:
                self._accumulate_moments(obs, alive)
            acts, carry = self._actions(fwd, obs, norm, carry)
            actions = acts.cpu().numpy()
            next_obs, rew, done = pool.step(actions)
            total += rew * alive
            steps += int(alive.sum())
            just_died = alive & done
            if just_died.any():  # the BC frame: the observation acted on last
                final_obs[just_died] = obs[just_died]
            alive &= ~done
            obs = next_obs
            if not alive.any():
                break
        final_obs[alive] = obs[alive]  # survivors: the last frame
        return PooledEvalResult(fitness=total, bc=self._bc(final_obs.copy()), steps=steps)

    def _evaluate_double_buffered(self, members: dict, norm) -> PooledEvalResult:
        """The sync path's result, each half stepping its own pool while the
        other half's forward runs on the card."""
        n = self.config.population_size
        h = n // 2
        cuda = self.device.type == "cuda"
        halves = []
        for i, (pool, lo) in enumerate(((self.pool_a, 0), (self.pool_b, h))):
            half_members = map_tree(lambda v, lo=lo: v[lo:lo + h], members)
            halves.append({"pool": pool, "lo": lo, "i": i,
                           "fwd": population_forward(self.module, half_members),
                           "event": torch.cuda.Event() if cuda else None})
        total = np.zeros(n, np.float32)
        alive = np.ones(n, bool)
        steps = 0

        def dispatch(half):
            # moments are taken where a half steps, not here: the last
            # dispatch computes actions that are never stepped
            acts, half["carry"] = self._actions(half["fwd"], half["obs"], norm, half["carry"])
            if cuda:
                self._pinned[half["i"]].copy_(acts, non_blocking=True)
                half["event"].record()
            else:
                half["acts"] = acts

        def collect(half) -> np.ndarray:
            if cuda:
                half["event"].synchronize()
                return self._pinned[half["i"]].numpy()
            return half["acts"].numpy()

        for half in halves:
            half["obs"] = half["pool"].reset()
            half["carry"] = self._carries(h) if self.recurrent else None
            dispatch(half)
        final_obs = np.concatenate([halves[0]["obs"], halves[1]["obs"]], axis=0)
        for _ in range(self.config.horizon):
            if not alive.any():
                break
            for half in halves:
                actions = collect(half)
                sl = slice(half["lo"], half["lo"] + h)
                if norm is not None:
                    # exactly the observations that get stepped, as the sync path
                    self._accumulate_moments(half["obs"], alive[sl])
                next_obs, rew, done = half["pool"].step(actions)
                total[sl] += rew * alive[sl]
                steps += int(alive[sl].sum())
                just_died = alive[sl] & done
                if just_died.any():
                    final_obs[sl][just_died] = half["obs"][just_died]
                alive[sl] &= ~done
                half["obs"] = next_obs
                dispatch(half)
        for half in halves:
            sl = slice(half["lo"], half["lo"] + h)
            final_obs[sl][alive[sl]] = half["obs"][alive[sl]]
        return PooledEvalResult(fitness=total, bc=self._bc(final_obs), steps=steps)

    def evaluate_center_batch(self, state: ESState, n_episodes: int, seed: int = 0
                              ) -> PooledEvalResult:
        """``n_episodes`` episodes of the center policy in one pooled pass,
        from a fresh pool seeded ``20_011 + seed`` (pools seed on their
        first reset only, so a cached pool would not give the same episodes
        for the same seed).  Feeds no obs moments."""
        fwd = population_forward(self.module, self._center_members(state.params_flat,
                                                                   n_episodes))
        pool = self._make_pool(n_episodes, 0, 20_011 + int(seed))
        norm = self._norm_params(state) if self.obs_norm else None
        try:
            return self._run_pool(pool, fwd, n_episodes, norm, accumulate=False)
        finally:
            pool.close()

    def evaluate_center(self, state: ESState) -> RolloutResult:
        """One episode of the center in the center pool."""
        fwd = population_forward(self.module, self._center_members(state.params_flat, 1))
        norm = self._norm_params(state) if self.obs_norm else None
        obs = self.center_pool.reset()
        total, steps = 0.0, 0
        carry = self._carries(1) if self.recurrent else None
        for _ in range(self.config.horizon):
            acts, carry = self._actions(fwd, obs, norm, carry)
            a = acts.cpu().numpy()
            nobs, rew, done = self.center_pool.step(a)
            total += float(rew[0])
            steps += 1
            if bool(done[0]):
                # nobs is not this episode's frame (C++ pool: the fresh reset;
                # gym: the terminal obs): the BC keeps the pre-step frame
                break
            obs = nobs
        return RolloutResult(total_reward=torch.tensor(total, dtype=torch.float32),
                             bc=torch.from_numpy(self._bc(obs[0]).astype(np.float32)),
                             steps=torch.tensor(steps, dtype=torch.int32))

    # ------------------------------------------------------------ update

    def apply_weights(self, state: ESState, weights, pair_offsets: torch.Tensor | None = None):
        """The update from per-member rank weights: ``(new_state,
        grad_norm)``, with this generation's obs moments folded in (float64
        on the host) when they came from the evaluation of this state."""
        w = torch.as_tensor(np.asarray(weights, np.float32), device=self.device)
        new_state, gnorm = self.core.apply_weights(state, w, pair_offsets)
        key, self._pending_moments_key = self._pending_moments_key, None
        moments, self._pending_moments = self._pending_moments, None
        if (self.obs_norm and moments is not None and key is not None
                and key[0] == int(state.generation) and key[1] is state.params_flat
                and moments[0] > 0):
            new_state = new_state._replace(
                obs_stats=merge_obs_moments_np(new_state.obs_stats, *moments))
        return new_state, gnorm

    def generation_step(self, state: ESState, pair_offsets: torch.Tensor | None = None):
        """One generation: ``(new_state, metrics)``, metrics on the host.
        ``pair_offsets`` replaces this generation's offsets (tests)."""
        ev = self.evaluate(state, pair_offsets)
        fit = np.asarray(ev.fitness)
        n_valid = int(np.isfinite(fit).sum())
        base = {"fitness": fit, "bc": ev.bc, "steps": ev.steps, "n_valid": n_valid}
        if n_valid < 2:
            # a collapsed population: the state stays; ES.train rejects it
            return state, {**base, "grad_norm": float("nan"), "update_finite": True}
        weights = rank_weights_with_failures(fit)
        new_state, gnorm = self.apply_weights(state, weights, pair_offsets)
        gnorm = float(gnorm)
        finite = bool(np.isfinite(gnorm) and torch.isfinite(new_state.params_flat).all())
        return new_state, {**base, "grad_norm": gnorm, "update_finite": finite}

    def close(self) -> None:
        """Close every pool (``pool`` is ``pool_a`` with ``double_buffer``)."""
        pools = {id(p): p for p in (getattr(self, n, None)
                                    for n in ("pool", "pool_a", "pool_b", "center_pool"))
                 if p is not None}
        for pool in pools.values():
            pool.close()
