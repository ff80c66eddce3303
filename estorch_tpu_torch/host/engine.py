"""HostEngine: the reference's runtime, with the center and the update on the card.

Counterpart of ``estorch_tpu/host/engine.py``.  A user-supplied torch
policy class and an agent whose ``rollout(policy)`` returns ``reward`` or
``(reward, bc)`` run unchanged; a member's rollout is a Python loop that
steps the agent's env with the policy:

    es = ES(TorchPolicy, GymAgent, torch.optim.Adam, ...)
    es.train(n_steps, n_proc=8)

On ``device`` (the card unless the caller passes ``"cpu"``) live:

- the noise table, built as the JAX package's host path builds it,
  ``default_rng(seed).standard_normal(table_size, float32)``, so one seed
  gives both packages the same table;
- the center ``HostState.params_flat`` (float32) and the master policy,
  whose torch optimizer takes the update step;
- each member's θ = params + σ·sign·table[off : off + dim], formed there
  and loaded into the worker's scratch policy, with no host round trip;
- the update: the folded mirrored weights (or the per-member weights,
  unmirrored) reduced against the table by ``ops.noise_kernels.
  weighted_noise_sum`` (the CUDA kernel on the card, its plain version on
  the CPU), one launch a generation.

The offsets stay NumPy, keyed on ``(key, generation)`` by ``SeedSequence``
as in the JAX package, and cross to the card as int32.  ``n_proc`` thread
workers share the card's default stream; ``worker_mode="process"`` forks
CPU workers instead (``host/procpool.py``): they roll out on the CPU while
the parent's update runs on the card.

An agent's policy lives on ``device``: an agent that builds CPU tensors
must move them to ``next(policy.parameters()).device`` itself (or the run
passes ``device="cpu"``); nothing moves them behind its back.

The generation's phases (``sample``, ``eval``, ``update``) land on the
``telemetry`` hub ``ES`` points at its own, and the JAX package's chaos
hooks fire where they fire there (``resilience/chaos.py``):
``kill_workers`` at the start of a process-mode generation,
``member_fault`` in each member's rollout, ``mutate_fitness`` on the
gathered fitness and ``poison_update`` in :meth:`HostEngine.apply_grad`.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..obs.spans import NULL_TELEMETRY
from ..ops.noise_kernels import weighted_noise_sum
from ..resilience.chaos import kill_workers, member_fault, mutate_fitness, poison_update
from ..utils.backend import resolve_device
from ..utils.fault import rank_weights_with_failures


class HostState(NamedTuple):
    """Host twin of ``parallel.engine.ESState``."""

    params_flat: torch.Tensor  # (dim,) float32 on the engine's device
    opt_state: Any  # the torch optimizer's state_dict; None for a fresh center
    key: int
    generation: int
    sigma: float | None = None  # None: the engine's initial σ


class HostEvalResult(NamedTuple):
    fitness: np.ndarray
    bc: np.ndarray
    steps: int


class HostRolloutResult(NamedTuple):
    total_reward: float
    bc: np.ndarray
    steps: int


def member_sign_offset(offs: np.ndarray, i: int, mirrored: bool) -> tuple[float, int]:
    """Member i's perturbation sign and noise-table offset: the one rule
    that thread workers, fork workers and ``member_params`` share."""
    if mirrored:
        return (1.0 if i % 2 == 0 else -1.0), int(offs[i // 2])
    return 1.0, int(offs[i])


def call_rollout(agent, policy) -> HostRolloutResult:
    """One ``agent.rollout(policy)``, its ``reward`` or ``(reward, bc)``
    parsed, and the agent's ``last_episode_steps`` (0 when it has none)."""
    out = agent.rollout(policy)
    if isinstance(out, tuple):
        reward, bc = out[0], np.asarray(out[1], dtype=np.float32).reshape(-1)
    else:
        reward, bc = out, np.zeros(0, dtype=np.float32)
    steps = int(getattr(agent, "last_episode_steps", 0))
    return HostRolloutResult(float(reward), bc, steps)


def load_flat(policy, flat: torch.Tensor) -> None:
    """Load a flat vector into ``policy``'s parameters.  The clone matters:
    ``vector_to_parameters`` re-points each parameter at a view of the
    vector, so without it an optimizer step on the policy would write into
    the caller's (immutable) state."""
    with torch.no_grad():
        torch.nn.utils.vector_to_parameters(flat.clone(), policy.parameters())


class HostEngine:
    """The engine interface of ``ESEngine``, executed by host workers.

    ``policy_factory()`` returns a fresh policy (on the CPU; the engine moves
    it), ``agent_factory()`` a fresh agent.
    """

    telemetry = NULL_TELEMETRY  # ES points it at its hub

    def __init__(
        self,
        policy_factory: Callable[[], Any],
        agent_factory: Callable[[], Any],
        optimizer_ctor,  # a torch.optim class
        optimizer_kwargs: dict,
        population_size: int,
        sigma: float,
        table_size: int,
        seed: int,
        device: str | torch.device | None = None,
        prototype_agent: Any | None = None,
        weight_decay: float = 0.0,
        worker_mode: str = "thread",
        sigma_decay: float = 1.0,
        sigma_min: float = 0.0,
        mirrored: bool = True,
    ):
        self.mirrored = bool(mirrored)
        if mirrored and population_size % 2 != 0:
            raise ValueError(
                f"population_size must be even (mirrored sampling), got {population_size}")
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', got {worker_mode!r}")
        self.population_size = population_size
        self.n_pairs = population_size // 2
        self.sigma = float(sigma)
        self.sigma_decay = float(sigma_decay)
        self.sigma_min = float(sigma_min)
        self.weight_decay = float(weight_decay)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.policy_factory = policy_factory
        self.agent_factory = agent_factory

        self.master = policy_factory().to(self.device)
        self.dim = int(sum(p.numel() for p in self.master.parameters()))
        if self.dim > table_size:
            raise ValueError(f"parameter dim {self.dim} exceeds noise table size {table_size}")
        self.table = torch.from_numpy(
            np.random.default_rng(seed).standard_normal(table_size, dtype=np.float32)
        ).to(self.device)
        self.table_size = table_size
        self._optimizer_ctor = optimizer_ctor
        self._optimizer_kwargs = dict(optimizer_kwargs)
        self.optimizer = optimizer_ctor(self.master.parameters(), **optimizer_kwargs)

        self.worker_mode = worker_mode
        # process mode's deadline for a whole generation; slices still out
        # at the deadline are NaN-dropped
        self.proc_timeout_s = 600.0
        self._prototype_agent = prototype_agent
        self._workers: list[tuple[Any, Any]] = []  # (scratch policy, agent)
        self._pool: ThreadPoolExecutor | None = None
        self._proc_pool = None  # the fork pool, built at first use in process mode
        self.set_n_proc(1)

    # ---------------------------------------------------------------- setup

    def _new_scratch_policy(self):
        p = self.policy_factory().to(self.device)
        # buffers too (frozen VBN stats): parameter loads overwrite only parameters
        p.load_state_dict(self.master.state_dict())
        return p

    def set_n_proc(self, n_proc: int) -> None:
        """Grow the worker set (a scratch policy and an agent each) and keep
        one persistent thread pool.  Process mode builds only worker 0 (for
        ``evaluate_center``); the fork pool owns its workers' policies."""
        n_proc = max(1, int(n_proc))
        want_local = 1 if self.worker_mode == "process" else n_proc
        while len(self._workers) < want_local:
            agent = (self._prototype_agent
                     if not self._workers and self._prototype_agent is not None
                     else self.agent_factory())
            self._workers.append((self._new_scratch_policy(), agent))
        if self.worker_mode == "thread" and (
                self._pool is None or n_proc != getattr(self, "n_proc", None)):
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            self._pool = ThreadPoolExecutor(max_workers=n_proc)
        self.n_proc = n_proc

    def freeze_vbn(self, reference_batch) -> None:
        """(Re-)freeze the master's ``TorchVirtualBatchNorm`` statistics from
        a reference batch and copy the buffers to every scratch policy; a
        fork pool is rebuilt at its next use with the new buffers."""
        from ..models.vbn_torch import TorchVirtualBatchNorm

        for m in self.master.modules():
            if isinstance(m, TorchVirtualBatchNorm):
                m.initialized.fill_(False)  # the next batched forward freezes
        with torch.no_grad():
            self.master(torch.as_tensor(np.asarray(reference_batch), dtype=torch.float32,
                                        device=self.device))
        for policy, _ in self._workers:
            policy.load_state_dict(self.master.state_dict())
        if self._proc_pool is not None:
            self._proc_pool.close()
            self._proc_pool = None

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._proc_pool is not None:
            self._proc_pool.close()
            self._proc_pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def _flat(self) -> torch.Tensor:
        with torch.no_grad():
            return torch.nn.utils.parameters_to_vector(self.master.parameters())

    def init_state(self, params_flat=None, key: int | None = None) -> HostState:
        flat = (self._flat() if params_flat is None else
                torch.as_tensor(params_flat, dtype=torch.float32).to(self.device))
        return HostState(params_flat=flat, opt_state=None,
                         key=self.seed if key is None else int(key), generation=0,
                         sigma=self.sigma)

    # ------------------------------------------------------------ noise math

    def _pair_offsets(self, state: HostState) -> np.ndarray:
        """This generation's offsets, deterministic in (key, generation): one
        per antithetic pair when mirrored, one per member otherwise."""
        n = self.n_pairs if self.mirrored else self.population_size
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=state.key, spawn_key=(state.generation,)))
        return rng.integers(0, self.table_size - self.dim + 1, size=n, dtype=np.int64)

    def _state_sigma(self, state: HostState) -> float:
        # None (not 0.0) is the sentinel, so a fully decayed σ == 0 is honoured
        return self.sigma if state.sigma is None else float(state.sigma)

    def perturbed(self, params_flat: torch.Tensor, sigma: float, offs: np.ndarray,
                  i: int) -> torch.Tensor:
        """Member i's θ around the center ``params_flat`` (on the engine's
        device): the scaled slice, then the add, the rounding of the NumPy
        form ``params + σ·sign·eps`` with no fused multiply-add."""
        sign, off = member_sign_offset(offs, i, self.mirrored)
        return params_flat + self.table[off:off + self.dim] * (sigma * sign)

    def member_params(self, state: HostState, member_index: int) -> torch.Tensor:
        return self.perturbed(state.params_flat, self._state_sigma(state),
                              self._pair_offsets(state), member_index)

    # ------------------------------------------------------------- rollouts

    def proc_pool(self):
        """The fork pool of ``n_proc`` workers, built at first use and
        pointed at the hub.  The forked children never touch CUDA: they get
        the table, the master's state_dict and each center as CPU data."""
        from .procpool import ProcessPool

        if self._proc_pool is None or self._proc_pool.n_proc != self.n_proc:
            if self._proc_pool is not None:
                self._proc_pool.close()
            master_state = {k: v.detach().cpu() for k, v in self.master.state_dict().items()}
            self._proc_pool = ProcessPool(
                self.policy_factory, self.agent_factory, self.n_proc, self.population_size,
                self.dim, self.table.cpu().numpy(), master_state=master_state,
                mirrored=self.mirrored)
        self._proc_pool.telemetry = self.telemetry
        return self._proc_pool

    def chaos_kill_workers(self, generation: int) -> None:
        """The ``kill_worker`` hook at a process-mode generation's start."""
        killed = kill_workers(generation, self._proc_pool.worker_pids)
        if killed:
            self.telemetry.counters.inc("chaos_worker_kills", len(killed))
            self.telemetry.event("chaos_worker_kill", pids=killed, gen=int(generation))

    def _proc_evaluate(self, state: HostState, offs: np.ndarray) -> HostEvalResult:
        pool = self.proc_pool()
        # generation boundary: workers lost last generation come back now
        pool.respawn_dead()
        self.chaos_kill_workers(state.generation)
        fitness, bc, steps = pool.evaluate(
            state.params_flat.cpu().numpy(), self._state_sigma(state), offs,
            timeout_s=self.proc_timeout_s, generation=int(state.generation))
        return HostEvalResult(fitness=fitness, bc=bc, steps=int(steps))

    def evaluate(self, state: HostState, offs: np.ndarray | None = None) -> HostEvalResult:
        """Every member's rollout; ``offs`` are this generation's offsets
        when the caller has them already.  A member whose rollout raises
        gets NaN fitness, which the update drops."""
        if offs is None:
            offs = self._pair_offsets(state)
        if self.worker_mode == "process":
            return self._proc_evaluate(state, offs)
        sigma = self._state_sigma(state)
        results: list[HostRolloutResult | None] = [None] * self.population_size

        def run_slice(w: int) -> None:
            policy, agent = self._workers[w]
            for i in range(w, self.population_size, self.n_proc):
                load_flat(policy, self.perturbed(state.params_flat, sigma, offs, i))
                try:
                    member_fault(state.generation, i)
                    results[i] = call_rollout(agent, policy)
                except Exception:  # noqa: BLE001 — a dead member must not kill the generation
                    results[i] = HostRolloutResult(float("nan"), np.zeros(0, np.float32), 0)

        if self.n_proc == 1:
            run_slice(0)
        else:
            list(self._pool.map(run_slice, range(self.n_proc)))  # re-raises a worker's error

        fitness = np.array([r.total_reward for r in results], dtype=np.float32)
        bc_dim = max((r.bc.shape[0] for r in results), default=0)
        bc = np.zeros((self.population_size, bc_dim), dtype=np.float32)
        for i, r in enumerate(results):
            if r.bc.shape[0]:
                bc[i] = r.bc
        return HostEvalResult(fitness=fitness, bc=bc, steps=int(sum(r.steps for r in results)))

    def evaluate_center(self, state: HostState) -> HostRolloutResult:
        policy, agent = self._workers[0]
        load_flat(policy, state.params_flat)
        return call_rollout(agent, policy)

    # -------------------------------------------------------------- updates

    def apply_weights(self, state: HostState, weights,
                      offs: np.ndarray | None = None) -> tuple[HostState, float]:
        """The folded mirrored-pair estimator, reduced against the table on
        the device, then the torch optimizer step (:meth:`apply_grad`).  The
        optimizer's moments travel with the state (``opt_state``), so two
        centers never share them."""
        w = np.asarray(weights, dtype=np.float32)
        if offs is None:
            offs = self._pair_offsets(state)
        rows = w[0::2] - w[1::2] if self.mirrored else w
        grad = weighted_noise_sum(
            self.table, torch.from_numpy(np.ascontiguousarray(offs, np.int32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(rows)).to(self.device), self.dim)
        grad /= self.population_size * self._state_sigma(state)
        return self.apply_grad(state, grad)

    def apply_grad(self, state: HostState, grad_ascent) -> tuple[HostState, float]:
        """Torch optimizer step from an already scaled ascent direction, with
        weight decay, the ``nan_update`` chaos hook and σ annealing; the
        input state is left untouched.  ``apply_weights`` and the async
        scheduler's fold both end here."""
        grad_ascent = torch.as_tensor(grad_ascent, dtype=torch.float32).to(self.device)
        sigma = self._state_sigma(state)
        if self.weight_decay > 0.0:
            grad_ascent = grad_ascent - self.weight_decay * state.params_flat
        if poison_update(state.generation):
            grad_ascent = torch.full_like(grad_ascent, float("nan"))

        load_flat(self.master, state.params_flat)
        if state.opt_state is not None:
            # deepcopy matters: load_state_dict keeps the input tensors when
            # dtype and device match, so step() would mutate the caller's state
            self.optimizer.load_state_dict(copy.deepcopy(state.opt_state))
        else:  # a fresh center: no moments left from another state
            self.optimizer = self._optimizer_ctor(self.master.parameters(),
                                                  **self._optimizer_kwargs)
        self.optimizer.zero_grad()
        g = -grad_ascent  # torch optimizers minimize
        i = 0
        for p in self.master.parameters():
            n = p.numel()
            p.grad = g[i:i + n].view_as(p).clone()
            i += n
        self.optimizer.step()

        new_sigma = sigma
        if self.sigma_decay != 1.0:
            new_sigma = max(sigma * self.sigma_decay, self.sigma_min)
        new_state = HostState(params_flat=self._flat(),
                              opt_state=copy.deepcopy(self.optimizer.state_dict()),
                              key=state.key, generation=state.generation + 1, sigma=new_sigma)
        return new_state, float(torch.linalg.vector_norm(grad_ascent))

    def generation_step(self, state: HostState):
        """sample → eval → update, each a span.  Fewer than 2 valid members
        leave the state untouched (``n_valid`` says so; ES.train rejects and
        re-runs)."""
        obs = self.telemetry
        with obs.phase("sample"):
            offs = self._pair_offsets(state)
        with obs.phase("eval"):
            ev = self.evaluate(state, offs=offs)
        fitness = mutate_fitness(state.generation, ev.fitness)
        n_valid = int(np.isfinite(fitness).sum())
        base = {"fitness": fitness, "bc": ev.bc, "steps": ev.steps, "n_valid": n_valid}
        if n_valid < 2:
            return state, {**base, "grad_norm": float("nan"), "update_finite": True}
        with obs.phase("update"):
            weights = rank_weights_with_failures(fitness)
            new_state, gnorm = self.apply_weights(state, weights, offs=offs)
        finite = bool(np.isfinite(gnorm) and torch.isfinite(new_state.params_flat).all())
        return new_state, {**base, "grad_norm": gnorm, "update_finite": finite}
