"""Forked host workers: ``worker_mode="process"``.

Counterpart of ``estorch_tpu/host/procpool.py``.  Thread workers serialize
on pure-Python rollout code; this pool forks persistent processes instead:

- fork inherits the policy and agent factories, the NumPy noise table
  (copy-on-write, never sent over a pipe) and a CPU copy of the master's
  ``state_dict`` (its buffers: frozen VBN statistics, running means);
- each worker builds its own policy, on the CPU, and agent once;
- a generation sends each worker (generation, params_flat, σ, offsets)
  once as NumPy and gets back its member slice's (indices, fitness, bc,
  steps, eval_s), ``eval_s`` the worker's busy seconds;
- the chaos hook ``member_fault`` runs inside the worker, keyed on the
  generation (``resilience/chaos.py``; forks inherit ``ESTORCH_CHAOS``).

The parent may have a live CUDA context (the update runs on the card);
a forked child must never touch CUDA, so everything it gets is CPU data
and the workers roll out on the CPU.

Failure handling: results are collected in short poll slices against one
deadline for the whole generation, and a worker gone with nothing buffered
is dropped at once; the members of a dead worker are retried once on the
survivors within the same generation; dead workers are replaced at the
next generation boundary (:meth:`ProcessPool.respawn_dead`); what has no
result at the deadline stays NaN and the update drops it
(``utils/fault.py``).  Stale replies of late workers are told apart by a
sequence tag and discarded.

A worker counts as dead once its pipe has reached EOF, whatever
``Process.is_alive()`` says: a live worker never closes its end, and a
SIGKILLed worker's pipe reaches EOF when the kernel closes its files,
before the process is a zombie that ``waitpid`` can see.  Under load that
window is wide; trusting ``is_alive()`` alone there left the dead worker's
members unretried (NaN) and the run parted from a clean one.

The asynchronous API (:meth:`ProcessPool.dispatch`, :meth:`ProcessPool.poll`,
``worker_alive``, ``conn_has_data``) serves the fold scheduler
(``algo/scheduler.py``): one slice message a worker, and every reply
returned, late ones included.  Respawns, retries and failed sends count
on the pool's ``telemetry`` hub (``workers_respawned``, ``slice_retries``,
``members_retried``, ``worker_send_failures``).
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import time
from typing import Any, Callable

import numpy as np

from ..obs.spans import NULL_TELEMETRY

# poll slice for result collection: a worker dying mid-generation is
# noticed after about this long, not after the whole deadline
POLL_SLICE_S = 0.1

# the worker's idle poll: how soon a worker whose parent died notices it
WORKER_POLL_S = 1.0

# the bound on reaping a worker whose pipe hit EOF before it was a zombie
REAP_TIMEOUT_S = 5.0


def _worker_main(conn, worker_id: int, policy_factory: Callable[[], Any],
                 agent_factory: Callable[[], Any], n_proc: int, population_size: int, dim: int,
                 table: np.ndarray, master_state: dict, mirrored: bool = True) -> None:
    """Build a policy and an agent once, then evaluate member slices until
    the parent sends None or goes away.

    Messages are ``(seq, generation, params_flat, sigma, offsets, indices)``;
    ``indices=None`` means the worker's own round-robin slice, an array a
    retry of another worker's members.
    """
    import torch

    from ..resilience.chaos import member_fault
    from .engine import call_rollout, load_flat, member_sign_offset

    torch.set_num_threads(1)  # workers parallelize across processes, not BLAS
    parent = os.getppid()
    policy = policy_factory()
    policy.load_state_dict(master_state)  # buffers: parameter loads write only parameters
    agent = agent_factory()

    while True:
        if not conn.poll(WORKER_POLL_S):
            # a SIGKILLed parent sends no EOF: each fork inherits the parent
            # ends of the pipes made before it (its own included), so the
            # pipe stays open.  Reparenting is what tells: an orphan exits
            # rather than hold its parent's stdout open forever
            if os.getppid() != parent:
                return
            continue
        try:
            msg = conn.recv()
        except EOFError:
            return  # the parent's end is closed
        if msg is None:
            return
        seq, generation, params_flat, sigma, offsets, indices = msg
        if indices is None:
            indices = list(range(worker_id, population_size, n_proc))
        else:
            indices = [int(i) for i in indices]
        fitness = np.full(len(indices), np.nan, np.float32)
        bcs: list[np.ndarray] = []
        steps = 0
        t0 = time.perf_counter()
        for j, i in enumerate(indices):
            sign, off = member_sign_offset(offsets, i, mirrored)
            load_flat(policy, torch.from_numpy(params_flat + sigma * sign * table[off:off + dim]))
            try:
                member_fault(generation, i)
                res = call_rollout(agent, policy)
            except Exception:  # noqa: BLE001 — NaN marks the member failed
                bcs.append(np.zeros(0, np.float32))
                continue
            fitness[j] = res.total_reward
            bcs.append(res.bc)
            steps += res.steps
        bc_dim = max((b.shape[0] for b in bcs), default=0)
        bc = np.zeros((len(indices), bc_dim), np.float32)
        for j, b in enumerate(bcs):
            if b.shape[0]:
                bc[j] = b
        conn.send((seq, np.asarray(indices, np.int64), fitness, bc, steps,
                   time.perf_counter() - t0))


class ProcessPool:
    """Persistent fork-based workers for HostEngine."""

    telemetry = NULL_TELEMETRY  # HostEngine points it at its hub

    def __init__(self, policy_factory, agent_factory, n_proc: int, population_size: int,
                 dim: int, table: np.ndarray, master_state: dict, mirrored: bool = True):
        if os.name != "posix":
            raise RuntimeError("process workers need fork (posix)")
        self._ctx = mp.get_context("fork")
        self.n_proc = int(n_proc)
        self.population_size = population_size
        self._seq = 0
        self._spawn_args = (policy_factory, agent_factory, self.n_proc, population_size, dim,
                            table, master_state, mirrored)
        self._procs: list[Any] = [None] * self.n_proc
        self._conns: list[Any] = [None] * self.n_proc
        self._retired: list[Any] = []  # replaced dead workers, joined at close
        self._eof: set[int] = set()  # workers whose pipe hit EOF: dead (see above)
        for w in range(self.n_proc):
            self._spawn(w)

    def _spawn(self, w: int) -> None:
        parent, child = self._ctx.Pipe()
        p = self._ctx.Process(target=_worker_main, args=(child, w, *self._spawn_args),
                              daemon=True)
        p.start()
        child.close()
        self._procs[w] = p
        self._conns[w] = parent
        self._eof.discard(w)

    @property
    def worker_pids(self) -> list[int]:
        return [p.pid for p in self._procs]

    def _dead(self, w: int) -> bool:
        return w in self._eof or not self._procs[w].is_alive()

    def respawn_dead(self) -> int:
        """Replace dead workers with fresh forks (at a generation boundary);
        a dead worker's pipe is closed, with any stale result in it, and a
        worker whose pipe hit EOF before it was reaped is joined (bounded).
        Returns the number replaced."""
        n = 0
        for w, p in enumerate(self._procs):
            if not self._dead(w):
                continue
            if p.is_alive():  # EOF came first: the kernel is still tearing it down
                p.join(timeout=REAP_TIMEOUT_S)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=REAP_TIMEOUT_S)
            try:
                self._conns[w].close()
            except OSError:
                # the pipe is gone with its worker either way; say so
                self.telemetry.event("respawn_conn_close_failed", worker=w)
            self._retired.append(p)
            self._spawn(w)
            n += 1
            self.telemetry.counters.inc("workers_respawned")
            self.telemetry.event("worker_respawned", worker=w, pid=self._procs[w].pid)
        return n

    def _send(self, w: int, msg) -> bool:
        try:
            self._conns[w].send(msg)
            return True
        except (BrokenPipeError, OSError):
            # a dead worker (its end is closed): the retry or NaN path
            # covers its slice
            self._eof.add(w)
            self.telemetry.counters.inc("worker_send_failures")
            return False

    def _collect(self, seq: int, pending: dict[int, Any], deadline: float, parts: list) -> None:
        """Drain results tagged ``seq`` from ``pending`` (worker → conn) until
        all answered, each dead worker with an empty pipe is dropped, or the
        deadline passes.  Results of earlier sequences are discarded."""
        conn_to_w = {id(c): w for w, c in pending.items()}
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                return
            ready = mpc.wait(list(pending.values()), timeout=min(left, POLL_SLICE_S))
            if not ready:
                # a corpse with an empty pipe never answers: do not wait for it
                for w in [w for w, c in pending.items()
                          if self._dead(w) and not c.poll(0)]:
                    del pending[w]
                continue
            for c in ready:
                w = conn_to_w[id(c)]
                try:
                    got = c.recv()
                except (EOFError, OSError):
                    del pending[w]  # the pipe closed under us: the worker died
                    self._eof.add(w)
                    continue
                if got[0] == seq:
                    parts.append(got[1:])
                    del pending[w]

    def evaluate(self, params_flat: np.ndarray, sigma: float, offsets: np.ndarray,
                 timeout_s: float = 600.0, generation: int = 0
                 ) -> tuple[np.ndarray, np.ndarray, int]:
        """One generation: (fitness, bc, steps).  ``timeout_s`` bounds the
        whole generation.  The members of workers that died are retried once
        on the survivors; what is unanswered at the deadline stays NaN."""
        self._seq += 1
        seq = self._seq
        deadline = time.monotonic() + timeout_s
        params_flat = np.asarray(params_flat, np.float32)
        offsets = np.asarray(offsets)
        generation = int(generation)
        msg = (seq, generation, params_flat, float(sigma), offsets, None)
        pending = {w: self._conns[w] for w in range(self.n_proc) if self._send(w, msg)}
        parts: list = []
        self._collect(seq, pending, deadline, parts)

        # members of DEAD workers: any worker computes the same θ for them.
        # Alive stragglers are not retried; their results may still come.
        covered = {int(i) for indices, *_ in parts for i in indices}
        missing = [i for i in range(self.population_size)
                   if i not in covered and self._dead(i % self.n_proc)]
        alive = [w for w in range(self.n_proc) if not self._dead(w)]
        if missing and alive and deadline - time.monotonic() > 0:
            self.telemetry.counters.inc("slice_retries")
            self.telemetry.counters.inc("members_retried", len(missing))
            self.telemetry.event("slice_retry", members=len(missing), survivors=len(alive),
                                 gen=generation)
            self._seq += 1
            rseq = self._seq
            retry: dict[int, Any] = {}
            for k, w in enumerate(alive):
                chunk = missing[k::len(alive)]
                if chunk and self._send(w, (rseq, generation, params_flat, float(sigma),
                                            offsets, np.asarray(chunk, np.int64))):
                    retry[w] = self._conns[w]
            self._collect(rseq, retry, deadline, parts)

        fitness = np.full(self.population_size, np.nan, np.float32)
        bc_dim = max((p[2].shape[1] for p in parts), default=0)
        bc = np.zeros((self.population_size, bc_dim), np.float32)
        steps = 0
        for indices, f, b, st, _eval_s in parts:
            fitness[indices] = f
            if b.shape[1]:
                bc[indices] = b
            steps += st
        return fitness, bc, steps

    # ------------------------------------------------- async (the scheduler)

    def dispatch(self, worker: int, params_flat: np.ndarray, sigma: float,
                 offsets: np.ndarray, generation: int, indices=None) -> int | None:
        """Send one slice message to ``worker``: its sequence tag, or None
        when the pipe is dead (the caller accounts the slice as lost).
        ``indices=None`` is the worker's own round-robin slice."""
        self._seq += 1
        msg = (self._seq, int(generation), np.asarray(params_flat, np.float32), float(sigma),
               np.asarray(offsets), None if indices is None else np.asarray(indices, np.int64))
        return self._seq if self._send(worker, msg) else None

    def poll(self, timeout_s: float) -> list[tuple]:
        """One bounded wait, then every buffered reply: ``(seq, indices,
        fitness, bc, steps, eval_s)`` of every sequence tag, late ones
        included (staleness is the scheduler's business)."""
        live = {id(c): w for w, c in enumerate(self._conns)
                if c is not None and not c.closed and w not in self._eof}
        if not live:
            time.sleep(min(timeout_s, POLL_SLICE_S))
            return []
        out: list[tuple] = []
        for c in mpc.wait([self._conns[w] for w in live.values()], timeout=timeout_s):
            w = live[id(c)]
            try:
                out.append(c.recv())
            except (EOFError, OSError):
                # a dead pipe stays out of later polls until its respawn, or
                # an EOF-readable corpse would turn poll into a spin
                self._eof.add(w)
        return out

    def worker_alive(self, w: int) -> bool:
        return not self._dead(w)

    def conn_has_data(self, w: int) -> bool:
        """A buffered reply outlives its writer: ``poll`` can still drain it."""
        try:
            return w not in self._eof and self._conns[w].poll(0)
        except (OSError, EOFError):
            return False

    def close(self) -> None:
        for c in self._conns:
            if c.closed:
                continue
            try:
                c.send(None)
            except OSError:
                pass  # the worker is dead already; the join below reaps it
            c.close()
        # join everything ever spawned, respawned workers' corpses included
        for p in (*self._procs, *self._retired):
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._retired.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
