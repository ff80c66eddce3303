"""Barrier-free async generations: the event-driven ES scheduler.

Counterpart of ``estorch_tpu/algo/scheduler.py`` (``GenerationScheduler``,
``AsyncEventLog``, ``train_overlap``).  ``ES.train`` is a barrier each
generation: one straggler sets the step time, and evaluation and update
costs add up.  ``ES.train_async`` removes it two ways:

**fold** (host backend, thread and process workers; IMPACT, arXiv
1912.00167, on the IW-ES ratios of ``algo/iwes.py``):

- member rollouts are tasks on an event queue; the scheduler keeps about
  two populations in flight, so a straggler holds one worker, not the
  generation;
- an update fires whenever one population's worth of results has arrived,
  whatever dispatch they came from.  Results sampled under an older center
  (θ_s, σ_s) fold in with importance weights normalized within their
  dispatch and clipped at ``iw_clip``;
- results staler than ``max_stale`` center versions are discarded and
  counted (``stale_discarded``, and the event log);
- the event log records every dispatch with the center version it sampled
  under, every update's consumed members with the fitness it ranked, and
  every discard and loss.  :meth:`GenerationScheduler.replay` re-drives it
  as pure math: bit-identical parameters on the same device.

The fold runs on the engine's device.  Each dispatch's center snapshot
stays there (``dim`` floats; :meth:`GenerationScheduler._prune_sources`
keeps at most ``max_stale + 1`` of them live).  An update sorts its batch
by (dispatch, member), the JAX package's canonical order; the stale
members' ε·d and ‖ε‖² come from one gather a stale dispatch (plain torch,
as the JAX package computes them outside Pallas), and the ε part of the
gradient, Σ w·λ·s·c·ε over every member of the batch, is one launch of
``weighted_noise_sum`` (the CUDA kernel on the card, its plain version on
the CPU), to which Σ_d (Σ coeff)·d is added.  The kernel sums in a fixed
order with no atomics, so a replay equals its live run bit for bit; the
JAX package sums row by row in float32, so the two packages agree to a
stated tolerance.  Process workers get each snapshot as NumPy (one copy
of ``dim`` floats a dispatch).

**overlap** (every backend): generation g+1 is queued from a one-thread
executor before g's metrics are read, so g's host tail (the metrics' copy,
best tracking, the record) runs while the card works on g+1.  On CUDA both
threads launch on the same stream, and a plain copy of g's fitness would
wait for g+1's kernels too; the worker thread records an event after g's
work, and the metrics are copied into pinned buffers on a side stream that
waits on that event alone (``ES._metrics_on_host``).  Same launches, same
states: bit-identical to ``ES.train``.

The rejection contract holds in both (``ES._update_anomaly``): the fold
re-applies the same batch with the center intact; overlap drains the
speculative step (``speculative_discarded``) and re-runs from the restored
state.  Chaos hooks fire with the same once-semantics, member faults keyed
on the dispatch index (the generation number of the synchronous loop).
The ``async/dispatch`` and ``async/fold`` spans, the ``overlap_efficiency``
and ``stale_reuse_ratio`` gauges, the ``results_folded`` /
``stale_discarded`` / ``results_lost`` / ``speculative_discarded``
counters and each fold record's ``async`` block land on the run's hub.
**elastic** (device backend, ``ES.train_elastic``): the same fold at host
granularity.  Each dispatch is a whole population evaluated by one remote
host of an ``ElasticCoordinator`` fleet (``parallel/elastic.py``), about one
population in flight a live host; the coordinator's update is this fold on
its device engine (the ε part one ``weighted_noise_sum`` launch, the stale
statistics in float64), and only the ``dim``-float center goes back to the
hosts after it.  A dead host's dispatches are counted lost and replaced;
joins and leaves land on the event log's ``membership``.  The JAX package
routes this update through its engine's ``apply_weights`` and
``apply_weights_reuse`` programs with float32 statistics; the two
packages' elastic runs agree to the fold's stated tolerance, each replays
its own log bit for bit, and a log crosses between them as JSON.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import itertools
import math
import queue
import threading
import time

import numpy as np
import torch

from ..host.engine import call_rollout, load_flat, member_sign_offset
from ..obs.spans import cuda_done_event
from ..ops.noise import gather_rows
from ..ops.noise_kernels import weighted_noise_sum
from ..resilience.chaos import member_fault, mutate_fitness
from ..utils.fault import rank_weights_with_failures
from .iwes import clipped_stale_lambdas

# every blocking point of the event loop waits at most this long, so the
# loop notices dead workers and shutdown
POLL_SLICE_S = 0.05


def _count_quantile(counts: dict[int, int], q: float) -> float:
    """Exact nearest-rank quantile over a value → count dict (the small
    integer staleness distribution)."""
    total = sum(counts.values())
    k = max(1, math.ceil(q * total))
    cum = 0
    for v in sorted(counts):
        cum += counts[v]
        if cum >= k:
            return float(v)
    return float(max(counts))


@dataclasses.dataclass(frozen=True)
class Source:
    """What one dispatch sampled under: the (θ, σ) every late result's
    importance ratio is keyed on."""

    dispatch: int  # dispatch index == the noise stream's generation number
    version: int  # center version (update count) at dispatch time
    params: torch.Tensor  # (dim,) float32 center snapshot, on the engine's device
    sigma: float
    offsets: np.ndarray  # per-pair (mirrored) or per-member table offsets
    t_dispatch: float = 0.0  # perf_counter at the snapshot (0 in replay)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One member's result on the event queue."""

    dispatch: int
    member: int
    fitness: float
    steps: int
    eval_s: float  # the worker's busy seconds (straggler sleeps included)
    t_arrival: float = 0.0  # perf_counter at the queue (0 in replay)


class AsyncEventLog:
    """The deterministic schedule of a fold run, JSON-able in the JAX
    package's schema (each package replays the other's logs).  Every
    dispatched member lands in exactly one of ``consumed`` (in the fold's
    canonical order, with the fitness and steps the update ranked),
    ``discarded`` (too stale, or past the run's end) and ``lost`` (its
    worker died)."""

    def __init__(self):
        self.dispatches: list[list] = []  # [dispatch, version]
        self.updates: list[dict] = []
        self.discarded: list[list] = []  # [dispatch, member]
        self.lost: list[list] = []  # [dispatch, member]
        self.membership: list[dict] = []  # elastic runs only (forensic)

    def to_dict(self) -> dict:
        out = {"schema": 1, "dispatches": [list(d) for d in self.dispatches],
               "updates": self.updates, "discarded": [list(d) for d in self.discarded],
               "lost": [list(d) for d in self.lost]}
        if self.membership:
            out["membership"] = [dict(m) for m in self.membership]
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "AsyncEventLog":
        log = cls()
        log.dispatches = [list(d) for d in data.get("dispatches", [])]
        log.updates = list(data.get("updates", []))
        log.discarded = [list(d) for d in data.get("discarded", [])]
        log.lost = [list(d) for d in data.get("lost", [])]
        log.membership = [dict(m) for m in data.get("membership", [])]
        return log


# ---------------------------------------------------------------------
# result sources: thread workers (member-granular) and fork workers
# (slice-granular, over the ProcessPool's async API)
# ---------------------------------------------------------------------


class _ThreadSource:
    """Member-granular tasks over scheduler-owned scratch workers.

    Each thread owns one (scratch policy, agent) pair and drains a shared
    task queue.  The pairs are built here, not borrowed from the engine:
    ``close()`` bounds its join, so a straggler may outlive the run as a
    daemon thread, and it must then hold only objects no later run loads
    a θ into."""

    def __init__(self, engine, events: "queue.Queue"):
        self.engine = engine
        self.events = events
        self._tasks: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._workers = [(engine._new_scratch_policy(), engine.agent_factory())
                         for _ in range(engine.n_proc)]
        self._threads = [threading.Thread(target=self._worker, args=(w,), daemon=True)
                         for w in range(engine.n_proc)]
        for t in self._threads:
            t.start()

    def notify_update(self, version: int, state) -> None:
        pass  # the workers read each snapshot from its Source

    def dispatch(self, source: Source) -> list[int]:
        """Queue every member of ``source``; returns the member list."""
        members = list(range(self.engine.population_size))
        for i in members:
            self._tasks.put((source, i))
        return members

    def _worker(self, w: int) -> None:
        policy, agent = self._workers[w]
        eng = self.engine
        while not self._stop.is_set():
            try:
                source, i = self._tasks.get(timeout=POLL_SLICE_S)
            except queue.Empty:
                continue
            load_flat(policy, eng.perturbed(source.params, source.sigma, source.offsets, i))
            t0 = time.perf_counter()
            try:
                # keyed on the dispatch index: a sync run's (generation, member)
                member_fault(source.dispatch, i)
                res = call_rollout(agent, policy)
                fit, steps = res.total_reward, res.steps
            except Exception:  # noqa: BLE001 — NaN marks the member failed
                fit, steps = float("nan"), 0
            t1 = time.perf_counter()
            self.events.put(Arrival(source.dispatch, i, float(fit), int(steps), t1 - t0, t1))

    def poll_lost(self, timeout_s: float = POLL_SLICE_S) -> list[tuple[int, int]]:
        return []  # threads do not die silently: exceptions became NaN

    def close(self) -> None:
        self._stop.set()
        for w, t in enumerate(self._threads):
            t.join(timeout=5.0)
            if t.is_alive():  # a straggler past the bounded join: leaked, with evidence
                self.engine.telemetry.counters.inc("worker_threads_leaked")
                self.engine.telemetry.event("worker_thread_leaked", worker=w)

    @property
    def n_workers(self) -> int:
        return len(self._threads)


class _ProcessSource:
    """Slice-granular dispatch over the ProcessPool's async API: one
    message a (dispatch, worker); late replies come back from ``poll``,
    and a worker that died with slices out surrenders them as lost."""

    def __init__(self, engine, events: "queue.Queue"):
        self.engine = engine
        self.events = events
        self.pool = engine.proc_pool()
        # seq -> (dispatch, member indices, worker), for loss accounting
        self._outstanding: dict[int, tuple[int, list[int], int]] = {}
        self._lost_now: list[tuple[int, int]] = []

    def notify_update(self, version: int, state) -> None:
        pass  # each dispatch carries its snapshot

    def dispatch(self, source: Source) -> list[int]:
        # a respawn closes dead workers' pipes and would orphan their
        # slices: drain what they buffered and surrender the rest first
        self._drain(0.0)
        self._sweep_dead(final=True)
        self.pool.respawn_dead()  # a dispatch boundary is a respawn boundary
        self.engine.chaos_kill_workers(source.dispatch)
        params = source.params.cpu().numpy()  # one copy of the snapshot a dispatch
        members: list[int] = []
        n, w_n = self.engine.population_size, self.pool.n_proc
        for w in range(w_n):
            indices = list(range(w, n, w_n))
            seq = self.pool.dispatch(w, params, source.sigma, source.offsets, source.dispatch)
            if seq is None:  # a dead pipe: the slice is lost up front
                self._lose(source.dispatch, indices)
                continue
            self._outstanding[seq] = (source.dispatch, indices, w)
            members.extend(indices)
        return members

    def _lose(self, dispatch: int, indices: list[int]) -> None:
        tel = self.engine.telemetry
        tel.counters.inc("results_lost", len(indices))
        tel.event("results_lost", dispatch=int(dispatch), n=len(indices))
        self._lost_now.extend((dispatch, i) for i in indices)

    def _drain(self, timeout_s: float) -> None:
        """Move buffered replies onto the event queue; one bounded wait,
        then drains until dry (a wait returns one message a connection)."""
        while True:
            got = self.pool.poll(timeout_s)
            for seq, indices, fitness, _bc, steps, eval_s in got:
                info = self._outstanding.pop(seq, None)
                if info is None:
                    continue  # a reply to a sequence from before this scheduler
                dispatch = info[0]
                k = max(len(indices), 1)
                base_steps, rem = divmod(int(steps), k)
                t_arr = time.perf_counter()
                for j, i in enumerate(indices):
                    # the remainder spread keeps the slice's step total exact
                    self.events.put(Arrival(dispatch, int(i), float(fitness[j]),
                                            base_steps + (1 if j < rem else 0),
                                            eval_s / k, t_arr))
            if not got:
                return
            timeout_s = 0.0

    def _sweep_dead(self, final: bool = False) -> None:
        """Account the slices of dead workers as lost; without ``final``,
        slices whose pipe still holds a reply wait for the next drain."""
        dead = {w for w in range(self.pool.n_proc) if not self.pool.worker_alive(w)}
        if not dead:
            return
        for seq in [s for s, (_, _, w) in self._outstanding.items() if w in dead]:
            dispatch, indices, w = self._outstanding[seq]
            if not final and self.pool.conn_has_data(w):
                continue
            del self._outstanding[seq]
            self._lose(dispatch, indices)

    def poll_lost(self, timeout_s: float = POLL_SLICE_S) -> list[tuple[int, int]]:
        """Drain arrived slices into the event queue; returns the members
        lost to dead workers since the last call."""
        self._drain(timeout_s)
        self._sweep_dead(final=False)
        out, self._lost_now = self._lost_now, []
        return out

    def close(self) -> None:
        pass  # the pool is the engine's; HostEngine.close owns it

    @property
    def n_workers(self) -> int:
        return self.pool.n_proc


# ---------------------------------------------------------------------
# the fold scheduler
# ---------------------------------------------------------------------


class GenerationScheduler:
    """Event-driven barrier-free generations on the host backend: ``run``
    is the live event loop, ``replay`` re-drives a recorded schedule."""

    def __init__(self, es, max_stale: int = 16, iw_clip: float = 2.0,
                 max_consecutive_rejections: int = 3):
        self._check_es(es)
        if max_stale < 1:
            raise ValueError(f"max_stale must be >= 1, got {max_stale}")
        if iw_clip < 1.0:
            raise ValueError(
                f"iw_clip must be >= 1 (1 = mean-normalized ratios fully truncated), "
                f"got {iw_clip}")
        self.es = es
        self.engine = es.engine
        self.obs = es.obs
        self.max_stale = int(max_stale)
        self.iw_clip = float(iw_clip)
        self.max_consecutive_rejections = int(max_consecutive_rejections)
        self.n = es.population_size
        self.log = AsyncEventLog()
        self._sources: dict[int, Source] = {}
        self._consumed_total = 0
        self._folded_total = 0
        self._discarded_total = 0
        self._n_workers = 0
        # the current update window's dispatches and discards, for the
        # record's async block
        self._dispatched_since_update: list[int] = []
        self._discards_since_update: dict[int, int] = {}
        self._staleness_counts: dict[int, int] = {}  # exact, bounded by max_stale + 1 keys

    # ------------------------------------------------------ backend hooks
    # (the elastic scheduler overrides these; pacing, staleness, the fold's
    # math, accounting and replay are shared)

    def _check_es(self, es) -> None:
        if es.backend != "host":
            raise ValueError(
                "GenerationScheduler folds partial host results; device/pooled backends "
                f"use the overlap scheduler (got backend={es.backend!r})")

    def _sigma_of(self, st) -> float:
        return self.engine._state_sigma(st)

    def _offsets_for(self, st, dispatch: int) -> np.ndarray:
        return self.engine._pair_offsets(st._replace(generation=dispatch))

    def _layout(self) -> tuple[torch.Tensor, int, bool]:
        """(table data, dim, mirrored) of the engine the fold runs on."""
        eng = self.engine
        return eng.table, eng.dim, eng.mirrored

    def _apply_grad(self, st, grad: torch.Tensor, version: int):
        return self.engine.apply_grad(st, grad)

    def _inflight_budget(self, src_pool) -> int:
        """Members to keep in flight: one population (a dispatch adds one,
        so about two stay out)."""
        return self.n

    # ------------------------------------------------------------ sources

    def _snapshot(self, dispatch: int, version: int) -> Source:
        """Freeze the center ``dispatch`` samples under.  Its offsets derive
        from (key, dispatch) as the sync loop's from (key, generation):
        dispatch d and generation d draw the same noise."""
        st = self.es.state
        src = Source(dispatch=dispatch, version=version, params=st.params_flat,
                     sigma=self._sigma_of(st), offsets=self._offsets_for(st, dispatch),
                     t_dispatch=time.perf_counter())
        self._sources[dispatch] = src
        self.log.dispatches.append([dispatch, version])
        self._dispatched_since_update.append(dispatch)
        self.obs.event("async_dispatch", trace=f"d{dispatch}", dispatch=int(dispatch),
                       version=int(version))
        return src

    def _prune_sources(self, version: int, referenced: set[int] = frozenset()) -> None:
        """Drop the snapshots no result can fold into any more (staler than
        ``max_stale``, the exact complement of the fold rule) that no result
        in flight or waiting refers to: bounded memory however long the run."""
        for d in [d for d, s in self._sources.items()
                  if s.version < version - self.max_stale and d not in referenced]:
            del self._sources[d]

    # ---------------------------------------------------------- fold math

    def _fold_batch(self, batch: list[Arrival], version: int):
        """One update from a mixed-staleness batch: ``(new_state, grad_norm,
        fitness, stats)``, or ``(None, None, fitness, stats)`` when fewer
        than 2 members are valid.

        A function of (center state, sources, batch) alone, shared by the
        live loop and :meth:`replay`.  Members go in (dispatch, member)
        order, so the sums depend on the batch's membership, not on the
        order results arrived in."""
        eng = self.engine
        table, dim, mirrored = self._layout()
        st = self.es.state
        batch = sorted(batch, key=lambda a: (a.dispatch, a.member))
        fit = np.asarray([a.fitness for a in batch], np.float32)
        # nan_fitness keyed on the state's generation, as the sync loop's
        fit = mutate_fitness(int(st.generation), fit)
        n_valid = int(np.isfinite(fit).sum())
        if n_valid < 2:
            return None, None, fit, {"n_valid": n_valid}
        w = rank_weights_with_failures(fit)
        sigma_u = self._sigma_of(st)
        center = st.params_flat

        by_dispatch: dict[int, list[int]] = {}
        for j, a in enumerate(batch):
            by_dispatch.setdefault(a.dispatch, []).append(j)
        row_offs: list[np.ndarray] = []
        row_w: list[np.ndarray] = []
        d_terms: list[tuple[float, torch.Tensor]] = []
        lam_stale: list[float] = []
        n_fresh = 0
        with self.obs.phase("async"), self.obs.phase("fold"):
            for d in sorted(by_dispatch):
                src = self._sources[d]
                idx = by_dispatch[d]
                k = len(idx)
                signs = np.empty(k, np.float32)
                offs = np.empty(k, np.int64)
                for kk, j in enumerate(idx):
                    signs[kk], offs[kk] = member_sign_offset(src.offsets, batch[j].member,
                                                             mirrored)
                if src.version == version:
                    lam, c = np.ones(k, np.float32), 1.0
                    n_fresh += k
                else:
                    # ε'_i = d + c·s_i·ε_i, the reused perturbation seen from
                    # the current center
                    d_vec = (src.params - center) / sigma_u
                    c = src.sigma / sigma_u
                    # the stats in float64: log λ is a difference of terms
                    # of size ‖d‖², and a float32 dot's rounding (which
                    # differs between the card's and the CPU's summation
                    # order) would move λ, and the update, by far more
                    eps = gather_rows(table, torch.from_numpy(offs).to(eng.device),
                                      dim).double()
                    d64 = d_vec.double()
                    stats = torch.stack([eps @ d64, (eps * eps).sum(dim=1)]).cpu().numpy()
                    lam = clipped_stale_lambdas(stats[0] * signs, stats[1],
                                                float(d64 @ d64), c, dim, self.iw_clip)
                    lam_stale.extend(float(x) for x in lam)
                coeff = w[idx] * lam
                row_offs.append(offs)
                row_w.append((coeff * signs * c).astype(np.float32))
                if src.version != version:
                    d_terms.append((float(coeff.sum()), d_vec))
            # the ε part of every member in one reduction launch
            grad = weighted_noise_sum(
                table, torch.from_numpy(np.concatenate(row_offs).astype(np.int32)).to(
                    eng.device),
                torch.from_numpy(np.concatenate(row_w)).to(eng.device), dim)
            for csum, d_vec in d_terms:
                grad = grad + csum * d_vec
        grad = grad / (len(batch) * sigma_u)
        with self.obs.phase("update"):
            new_state, gnorm = self._apply_grad(st, grad, version)
        stats = {
            "n_valid": n_valid,
            "fresh": n_fresh,
            "folded": len(batch) - n_fresh,
            "mean_lambda": round(float(np.mean(lam_stale)), 4) if lam_stale else None,
            "max_staleness": version - min(self._sources[d].version for d in by_dispatch),
            "consumed_by_dispatch": [[int(d), len(by_dispatch[d])] for d in sorted(by_dispatch)],
        }
        return new_state, gnorm, fit, stats

    def _best_theta(self, arrival: Arrival) -> torch.Tensor:
        src = self._sources[arrival.dispatch]
        return self.engine.perturbed(src.params, src.sigma, src.offsets, arrival.member)

    # -------------------------------------------------------- update step

    def _apply_update(self, batch: list[Arrival], version: int, t_start, log_fn,
                      verbose: bool, rejected_streak: int) -> tuple[bool, int]:
        """Rank, fold, guard and record one batch; ``t_start`` is when the
        previous update finished (None in replay).  Returns (applied,
        rejected_streak)."""
        es = self.es
        obs = self.obs
        new_state, gnorm, fit, stats = self._fold_batch(batch, version)
        dt = (time.perf_counter() - t_start) if t_start is not None else 0.0
        reason = es._update_anomaly({
            "n_valid": stats["n_valid"],
            "update_finite": bool(new_state is not None and np.isfinite(gnorm)
                                  and torch.isfinite(new_state.params_flat).all()),
        })
        if reason is not None:
            # apply_grad made a new state: the center is intact, and the
            # same batch re-applies (nan_update fires once)
            obs.counters.inc("generations_rejected")
            obs.event("generation_rejected", reason=reason, n_valid=int(stats["n_valid"]))
            obs.discard_phases()
            rejected_streak += 1
            if rejected_streak > self.max_consecutive_rejections:
                raise RuntimeError(f"{reason}; {rejected_streak} consecutive updates "
                                   "rejected — check env/rollout health")
            return False, rejected_streak

        # fit is in the fold's canonical (sorted) order
        batch_sorted = sorted(batch, key=lambda a: (a.dispatch, a.member))
        finite_any = bool(np.isfinite(fit).any())
        gen_best = float(np.nanmax(fit)) if finite_any else float("nan")
        improved = finite_any and gen_best > es.best_reward
        if improved:
            es.best_reward = gen_best
            es._best_flat = self._best_theta(batch_sorted[int(np.nanargmax(fit))])

        # per consumed member: staleness (pure math, replay too) and the
        # wall-clock legs (live only)
        t_now = time.perf_counter() if t_start is not None else None
        for a in batch:
            src = self._sources[a.dispatch]
            staleness = version - src.version
            self._staleness_counts[staleness] = self._staleness_counts.get(staleness, 0) + 1
            obs.hists.observe("async/staleness", staleness, lo=0.5, decades=4, per_decade=3)
            if t_now is not None:
                if a.t_arrival:
                    obs.hists.observe("async/queue_wait_s", t_now - a.t_arrival)
                if src.t_dispatch:
                    obs.hists.observe("async/fold_latency_s", t_now - src.t_dispatch)

        steps = int(sum(a.steps for a in batch))
        sigma = self._sigma_of(es.state)
        es.state = new_state
        # the log entry rides on the state transition: together they are
        # "this batch was consumed"
        self.log.updates.append({
            "u": version,
            "consumed": [[a.dispatch, a.member, float(fit[j]), a.steps]
                         for j, a in enumerate(batch_sorted)],
        })
        self._consumed_total += len(batch)
        self._folded_total += int(stats["folded"])
        oe = self._overlap_efficiency(sum(a.eval_s for a in batch), dt)
        record = {
            "generation": es.generation,
            "reward_max": gen_best,
            "reward_mean": float(np.nanmean(fit)) if finite_any else float("nan"),
            "reward_min": float(np.nanmin(fit)) if finite_any else float("nan"),
            "n_failed": int(np.size(fit) - np.isfinite(fit).sum()),
            "best_reward": es.best_reward,
            "improved_best": improved,
            "env_steps": steps,
            "env_steps_per_sec": steps / dt if dt > 0 else 0.0,
            "grad_norm": float(gnorm),
            "sigma": sigma,
            "wall_time_s": dt,
            "async": {
                "consumed": len(batch),
                "fresh": int(stats["fresh"]),
                "folded": int(stats["folded"]),
                "stale_discarded": int(sum(self._discards_since_update.values())),
                "max_staleness": int(stats["max_staleness"]),
                "mean_lambda": stats["mean_lambda"],
                "overlap_efficiency": oe,
                "dispatches": [int(d) for d in self._dispatched_since_update],
                "consumed_dispatches": stats["consumed_by_dispatch"],
                "discarded_dispatches": [[int(d), int(n)] for d, n in
                                         sorted(self._discards_since_update.items())],
            },
        }
        qw50 = obs.hists.quantile("async/queue_wait_s", 0.5)
        qw99 = obs.hists.quantile("async/queue_wait_s", 0.99)
        if qw50 is not None and qw99 is not None:
            record["async"]["queue_wait_s"] = {"p50": round(qw50, 6), "p99": round(qw99, 6)}
        if self._staleness_counts:
            record["async"]["staleness_q"] = {
                "p50": _count_quantile(self._staleness_counts, 0.5),
                "p99": _count_quantile(self._staleness_counts, 0.99)}
        self._dispatched_since_update = []
        self._discards_since_update = {}
        obs.counters.inc("async_updates")
        if stats["folded"]:
            obs.counters.inc("results_folded", int(stats["folded"]))
        obs.counters.gauge("overlap_efficiency", oe if oe is not None else 0.0)
        obs.counters.gauge("stale_reuse_ratio",
                           round(self._folded_total / max(self._consumed_total, 1), 4))
        # the logged fitness is the post-mutation value the fold ranked: a
        # replay reproduces a nan_fitness burst without firing it again
        es._emit_record(es._finalize_record(record), log_fn, verbose)
        return True, 0

    def _overlap_efficiency(self, busy_s: float, wall_s: float):
        """The workers' busy share of the update's wall window: (Σ eval
        seconds of the batch / workers) / wall, clipped to [0, 1].
        Approximate by construction: a late result's seconds were spent in
        earlier windows."""
        if wall_s <= 0 or not self._n_workers:
            return None
        return round(float(min(max((busy_s / self._n_workers) / wall_s, 0.0), 1.0)), 4)

    # ---------------------------------------------------------- live loop

    def _make_source(self, events: "queue.Queue"):
        cls = _ProcessSource if self.engine.worker_mode == "process" else _ThreadSource
        return cls(self.engine, events)

    def run(self, n_steps: int, log_fn=None, verbose: bool = True):
        es = self.es
        obs = self.obs
        obs.discard_phases()
        events: queue.Queue = queue.Queue()
        src_pool = self._make_source(events)
        self._n_workers = src_pool.n_workers
        self._discards_since_update = {}

        version = 0
        dispatched = 0
        # dispatch ids continue the state's generation numbering (so chaos
        # coordinates and noise streams mean the same as in a sync run),
        # past any earlier fold run's high-water mark
        base = max(int(es.state.generation), int(getattr(es, "_async_next_dispatch", 0)))
        inflight: dict[tuple[int, int], bool] = {}
        arrived: list[Arrival] = []
        updates_done = 0
        rejected_streak = 0
        lost = 0
        t_update = time.perf_counter()

        def discard(a: Arrival, staleness) -> None:
            obs.counters.inc("stale_discarded")
            obs.event("stale_discarded", dispatch=int(a.dispatch), member=int(a.member),
                      staleness=staleness, trace=f"d{a.dispatch}")
            self.log.discarded.append([a.dispatch, a.member])
            self._discarded_total += 1
            self._discards_since_update[a.dispatch] = (
                self._discards_since_update.get(a.dispatch, 0) + 1)
            if a.t_arrival:
                obs.hists.observe("async/discard_latency_s", time.perf_counter() - a.t_arrival)

        empty_dispatches = 0
        try:
            while updates_done < n_steps:
                # keep the workers fed: about 2 populations in flight, never
                # fewer results in the pipeline than the remaining updates
                # need (results lost to dead workers are re-dispatched)
                remaining = (n_steps - updates_done) * self.n - len(arrived)
                while len(inflight) < min(self._inflight_budget(src_pool), remaining):
                    with obs.trace_ctx(f"d{base + dispatched}"), obs.phase("async"):
                        with obs.phase("dispatch"):
                            src = self._snapshot(base + dispatched, version)
                            members = src_pool.dispatch(src)
                            for i in members:
                                inflight[(src.dispatch, i)] = True
                            dispatched += 1
                    empty_dispatches = 0 if members else empty_dispatches + 1
                    if empty_dispatches > 3:
                        raise RuntimeError(
                            f"async scheduler ran dry after {updates_done}/{n_steps} "
                            f"updates: {empty_dispatches} consecutive dispatches reached "
                            f"no live worker ({lost} results lost so far)")

                # collect arrivals: one bounded wait, then drain (a pure drain
                # when a population is waiting already)
                with obs.phase("eval"):
                    ready = len(arrived) >= self.n
                    for d, i in src_pool.poll_lost(0.0 if ready else POLL_SLICE_S):
                        inflight.pop((d, i), None)
                        self.log.lost.append([d, i])
                        lost += 1
                    try:
                        a = events.get_nowait() if ready else events.get(timeout=POLL_SLICE_S)
                    except queue.Empty:
                        a = None
                    while a is not None:
                        inflight.pop((a.dispatch, a.member), None)
                        obs.hists.observe("async/eval_s", a.eval_s)
                        arrived.append(a)
                        try:
                            a = events.get_nowait()
                        except queue.Empty:
                            a = None

                # staleness is judged when the batch forms: the center may
                # have moved while a result waited
                still: list[Arrival] = []
                for a in arrived:
                    s = self._sources.get(a.dispatch)
                    if s is None or s.version < version - self.max_stale:
                        discard(a, version - s.version if s else None)
                    else:
                        still.append(a)
                arrived = still

                if len(arrived) >= self.n:
                    batch, arrived = arrived[:self.n], arrived[self.n:]
                    n_logged = len(self.log.updates)
                    try:
                        applied, rejected_streak = self._apply_update(
                            batch, version, t_update, log_fn, verbose, rejected_streak)
                    except BaseException:
                        # an aborted update keeps its batch for the shutdown
                        # accounting, unless it was consumed already
                        if len(self.log.updates) == n_logged:
                            arrived = batch + arrived
                        raise
                    if applied:
                        t_update = time.perf_counter()
                        version += 1
                        updates_done += 1
                        # an elastic fleet gets the new center here
                        src_pool.notify_update(version, es.state)
                        self._prune_sources(version, {d for d, _ in inflight}
                                            | {a.dispatch for a in arrived})
                    else:  # rejected: the same batch again, a deterministic re-run
                        arrived = batch + arrived
        finally:
            try:  # a loss surrendered just before an aborting raise still lands
                for d, i in src_pool.poll_lost(0.0):
                    inflight.pop((d, i), None)
                    self.log.lost.append([d, i])
                    lost += 1
            except Exception:  # noqa: BLE001 — the run is over already
                obs.event("final_loss_drain_failed")
            src_pool.close()
            # results in flight or unconsumed at shutdown fold nowhere: they
            # are discarded, so dispatched == consumed + discarded + lost
            leftovers = list(inflight) + [(a.dispatch, a.member) for a in arrived]
            for d, i in leftovers:
                self.log.discarded.append([d, i])
            if leftovers:
                obs.counters.inc("stale_discarded", len(leftovers))
                obs.event("run_end_discard", n=len(leftovers))
                self._discarded_total += len(leftovers)
            es._async_next_dispatch = base + dispatched
            es._async_log = self.log  # the torn run's record, too
        return es

    # -------------------------------------------------------------- replay

    def replay(self, log: "AsyncEventLog | dict", log_fn=None, verbose: bool = False,
               n_steps: int | None = None):
        """Re-drive a recorded schedule as pure math: the same snapshots,
        the same batches in the same order, the same fold.  The recorded
        fitness is applied as it is (no rollout), so a member the live run
        saw NaN stays NaN.  ``n_steps``, when given, must equal the log's
        update count."""
        if isinstance(log, dict):
            log = AsyncEventLog.from_dict(log)
        if n_steps is not None and n_steps != len(log.updates):
            raise ValueError(
                f"replay drives the RECORDED schedule: n_steps={n_steps} but the log "
                f"holds {len(log.updates)} updates — pass the log's own count "
                "(or drop n_steps)")
        es = self.es
        es.obs.discard_phases()
        dispatch_iter = iter(log.dispatches)
        next_dispatch = next(dispatch_iter, None)
        version = 0
        rejected_streak = 0
        self._n_workers = 0
        self._dispatched_since_update = []
        self._discards_since_update = {}
        self._staleness_counts = {}
        for entry in log.updates:
            # every snapshot the schedule took at or before this version,
            # in recorded order
            while next_dispatch is not None and next_dispatch[1] <= version:
                self._snapshot(int(next_dispatch[0]), int(next_dispatch[1]))
                next_dispatch = next(dispatch_iter, None)
            batch = [Arrival(int(d), int(i), float(f), int(s), 0.0)
                     for d, i, f, s in entry["consumed"]]
            applied = False
            while not applied:
                applied, rejected_streak = self._apply_update(
                    batch, version, None, log_fn, verbose, rejected_streak)
            version += 1
            self._prune_sources(version)
        es._async_log = self.log
        return es


# ---------------------------------------------------------------------
# the elastic host-granular scheduler (parallel/elastic.py fleets)
# ---------------------------------------------------------------------


class _HostSource:
    """Host-granular source: each dispatch is a whole population evaluated
    by one remote host of an elastic fleet, its results arrive together,
    and a dead host's dispatches come back as lost.  The fleet
    (``ElasticCoordinator``) owns the sockets and the membership table;
    this adapter turns results into arrivals and keeps the event log's
    ``membership``, the per-host latency distributions and the counters."""

    def __init__(self, scheduler: "ElasticScheduler", fleet, events: "queue.Queue"):
        self.sched = scheduler
        self.fleet = fleet
        self.events = events
        self.n = scheduler.n
        self.obs = scheduler.obs
        self._fold_p99: dict[int, float] = {}
        self._lost_now: list[tuple[int, int]] = []

    def dispatch(self, source: Source) -> list[int]:
        host = self.fleet.dispatch(source.dispatch, source.version)
        if host is None:
            # the grace passed with no live host: the population is lost up
            # front (it is on the log already), and the empty member list
            # feeds the dry-out guard
            self.obs.counters.inc("results_lost", self.n)
            self.obs.event("results_lost", dispatch=int(source.dispatch), host=None, n=self.n)
            self._lost_now.extend((int(source.dispatch), i) for i in range(self.n))
            return []
        self.obs.event("elastic_dispatch", trace=f"d{source.dispatch}",
                       dispatch=int(source.dispatch), host=int(host))
        return list(range(self.n))

    def _note_membership(self, events: list[dict]) -> None:
        for m in events:
            self.sched.log.membership.append(
                dict(m, at_dispatch=len(self.sched.log.dispatches)))
            if m["event"] == "join":
                self.obs.counters.inc("hosts_joined")
            else:
                self.obs.counters.inc("hosts_lost")
                # a dead straggler's history must not pin the worst-host rollup
                if self._fold_p99.pop(int(m["host"]), None) is not None:
                    self.obs.counters.gauge(
                        "elastic_fold_p99_worst_s",
                        round(max(self._fold_p99.values()), 6) if self._fold_p99 else 0.0)
            self.obs.event(f"host_{m['event']}", host=int(m["host"]))
        self.obs.counters.gauge("elastic_hosts", self.fleet.n_live())

    def poll_lost(self, timeout_s: float = POLL_SLICE_S) -> list[tuple[int, int]]:
        results, lost_dispatches, membership = self.fleet.poll(timeout_s)
        if membership:
            self._note_membership(membership)
        t_arr = time.perf_counter()
        for r in results:
            d, host = int(r["dispatch"]), int(r["host"])
            src = self.sched._sources.get(d)
            if src is None:
                # a late answer to an earlier run on this fleet: not this log's
                # dispatch, so it is dropped outside the log, with evidence
                self.obs.counters.inc("foreign_results_dropped")
                self.obs.event("foreign_result_dropped", dispatch=d, host=host)
                continue
            fit = np.asarray(r["fitness"], np.float32)
            k = max(len(fit), 1)
            per = float(r["eval_s"]) / k
            base_steps, rem = divmod(int(r["steps"]), k)
            if src.t_dispatch:
                lat = t_arr - src.t_dispatch
                self.obs.hists.observe("elastic/fold_s", lat)
                self.obs.hists.observe(f"elastic/h{host}/fold_s", lat)
                p99 = self.obs.hists.quantile(f"elastic/h{host}/fold_s", 0.99)
                if p99 is not None:
                    self._fold_p99[host] = p99
                    self.obs.counters.gauge(f"elastic_fold_p99_s_h{host}", round(p99, 6))
                    self.obs.counters.gauge("elastic_fold_p99_worst_s",
                                            round(max(self._fold_p99.values()), 6))
            self.obs.event("elastic_result", trace=f"d{d}", dispatch=d, host=host,
                           eval_s=round(float(r["eval_s"]), 4))
            for i in range(len(fit)):
                self.events.put(Arrival(d, i, float(fit[i]),
                                        base_steps + (1 if i < rem else 0), per, t_arr))
        lost: list[tuple[int, int]] = []
        for d, host in lost_dispatches:
            if self.sched._sources.get(int(d)) is None:
                self.obs.event("foreign_loss_dropped", dispatch=int(d), host=int(host))
                continue
            self.obs.counters.inc("results_lost", self.n)
            self.obs.event("results_lost", dispatch=int(d), host=int(host), n=self.n)
            lost.extend((int(d), i) for i in range(self.n))
        out, self._lost_now = self._lost_now + lost, []
        return out

    def notify_update(self, version: int, state) -> None:
        self.fleet.push_center(version, state.params_flat.cpu().numpy(), float(state.sigma))

    def close(self) -> None:
        # the fleet outlives the run (its hosts stay joined for the next one)
        self.obs.counters.gauge("elastic_hosts", self.fleet.n_live())

    @property
    def n_workers(self) -> int:
        return max(self.fleet.n_live(), 1)


class ElasticScheduler(GenerationScheduler):
    """The fold at host granularity on the device engine: dispatches go to
    the hosts of an elastic fleet, each evaluating a whole population
    under the center it was sent; their fitness folds in with the host
    fold's clipped importance weights, an update fires a population's
    worth of arrivals, and only the center goes back to the hosts.  The
    event log, staleness discards, loss replacement, accounting and
    bit-exact ``replay`` are the base scheduler's."""

    def __init__(self, es, fleet, max_stale: int = 16, iw_clip: float = 2.0,
                 max_consecutive_rejections: int = 3):
        self.fleet = fleet
        super().__init__(es, max_stale=max_stale, iw_clip=iw_clip,
                         max_consecutive_rejections=max_consecutive_rejections)

    def _check_es(self, es) -> None:
        if es.backend != "device" or es._shard_params:
            raise ValueError(
                "ElasticScheduler runs on the coordinator's replicated "
                "device engine (table noise); hosts may run the sharded "
                "program, the coordinator's fold/update programs are the "
                f"replicated split path (got backend={es.backend!r}"
                f"{', shard_params=True' if es._shard_params else ''})")
        es.engine._require_dense_noise("elastic host fold")
        if es.config.obs_norm:
            raise ValueError(
                "elastic folding does not support obs_norm: a stale host's fitness was "
                "measured under OLDER running stats, so the density ratio's fixed-f(θ) "
                "assumption silently breaks (same refusal as IW_ES)")
        if es.mesh.devices.size > 1:
            raise ValueError("the elastic coordinator folds in one process; build its ES "
                             "without a multi-rank mesh (hosts may each run their own)")

    def _sigma_of(self, st) -> float:
        return float(st.sigma)

    def _offsets_for(self, st, dispatch: int) -> np.ndarray:
        # the dispatch's offsets drawn on the host: no wait on the card
        return self.engine._host_pair_offsets(st._replace(generation=int(dispatch))).numpy()

    def _layout(self) -> tuple[torch.Tensor, int, bool]:
        eng = self.engine
        return eng.table.data, eng.spec.dim, eng.config.mirrored

    def _apply_grad(self, st, grad: torch.Tensor, version: int):
        new_state, gnorm = self.engine._finish_update(st, grad)
        # the state's generation counts updates, as the host fold's does
        return new_state._replace(generation=version + 1), float(gnorm)

    def _best_theta(self, arrival: Arrival) -> torch.Tensor:
        table, dim, mirrored = self._layout()
        src = self._sources[arrival.dispatch]
        sign, off = member_sign_offset(src.offsets, arrival.member, mirrored)
        return src.params + src.sigma * sign * self.engine.table.slice(int(off), dim)

    def _make_source(self, events: "queue.Queue"):
        # the fleet's center (version 0), for hosts that joined already or
        # join during the run
        st = self.es.state
        self.fleet.push_center(0, st.params_flat.cpu().numpy(), self._sigma_of(st))
        return _HostSource(self, self.fleet, events)

    def _inflight_budget(self, src_pool) -> int:
        # a population in flight a live host: every host stays fed, a
        # straggler queues about one more
        return self.n * max(1, self.fleet.n_live())


# ---------------------------------------------------------------------
# the overlap scheduler (every backend)
# ---------------------------------------------------------------------


def train_overlap(es, n_steps: int, log_fn=None, verbose: bool = True,
                  max_consecutive_rejections: int = 3, step_timeout_s: float = 3600.0):
    """Pipelined generations: g+1 is queued from a background thread
    before g's metrics are read, so g's host tail runs while the card works
    on g+1.  The same generations from the same states as ``ES.train``:
    bit-identical parameters and records.  A rejected generation's
    speculative successor started from a poisoned state: it is drained,
    counted in ``speculative_discarded``, and the loop re-runs from the
    restored state."""
    obs = es.obs
    obs.discard_phases()
    ex = cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="estorch-overlap")
    dispatch_seq = itertools.count(int(es.state.generation))

    def step(state):
        new_state, metrics = es.engine.generation_step(state)
        # recorded by the thread that queued the generation, right after it
        return new_state, metrics, cuda_done_event(es.device)

    def submit(state):
        with obs.trace_ctx(f"d{next(dispatch_seq)}"), obs.phase("async"):
            with obs.phase("dispatch"):
                return ex.submit(step, state)

    def result_of(fut):
        deadline = time.monotonic() + step_timeout_s
        while True:  # bounded waits: a wedged generation must not hang the loop
            try:
                return fut.result(timeout=POLL_SLICE_S)
            except cf.TimeoutError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"generation silent for {step_timeout_s}s "
                                       "— wedged dispatch") from None

    try:
        done = 0
        rejected_streak = 0
        prev_state = es.state
        t0 = time.perf_counter()
        pending = submit(prev_state)
        while done < n_steps:
            new_state, metrics, queued = result_of(pending)
            # queue g+1 before touching g's metrics
            speculative = submit(new_state) if done + 1 < n_steps else None
            with obs.phase("host_sync"):
                metrics = es._metrics_on_host(metrics, queued, prev_state)
            dt = time.perf_counter() - t0

            reason = es._update_anomaly(metrics)
            if reason is not None:
                es._count_rejection(reason, metrics)
                rejected_streak += 1
                if rejected_streak > max_consecutive_rejections:
                    raise RuntimeError(f"{reason}; {rejected_streak} consecutive "
                                       "generations rejected — check env/rollout health")
                if es._shard_params:
                    # the sharded engine rolled back in place: new_state IS the
                    # input state, so the speculative run re-runs the same
                    # generation from it deterministically: keep it
                    es.state = prev_state = new_state
                    pending = speculative if speculative is not None else submit(new_state)
                else:
                    if speculative is not None:
                        result_of(speculative)  # drain, then drop
                        obs.counters.inc("speculative_discarded")
                        obs.event("speculative_discarded", gen=int(done))
                    pending = submit(prev_state)
                t0 = time.perf_counter()
                continue
            rejected_streak = 0
            es.state = new_state
            record = es._base_record(prev_state, metrics["fitness"], metrics["steps"],
                                     metrics["grad_norm"], dt, sigma=metrics["sigma"],
                                     metrics=metrics)
            es._attach_scenarios(record, metrics["fitness"], metrics)
            es._emit_record(record, log_fn, verbose)
            done += 1
            prev_state = new_state
            t0 = time.perf_counter()
            if speculative is not None:
                pending = speculative
    finally:
        ex.shutdown(wait=False)
    return es
