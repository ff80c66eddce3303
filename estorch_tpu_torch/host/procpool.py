"""Forked host workers: ``worker_mode="process"``.

Counterpart of ``estorch_tpu/host/procpool.py``.  Thread workers serialize
on pure-Python rollout code; this pool forks persistent processes instead:

- fork inherits the policy and agent factories, the NumPy noise table
  (copy-on-write, never sent over a pipe) and a CPU copy of the master's
  ``state_dict`` (its buffers: frozen VBN statistics, running means);
- each worker builds its own policy, on the CPU, and agent once;
- a generation sends each worker (params_flat, σ, offsets) once as NumPy
  and gets back its member slice's (indices, fitness, bc, steps).

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

The JAX package's asynchronous API of this pool (``dispatch``, ``poll``)
serves its async scheduler, ROADMAP.md port item 5, and is not here.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import time
from typing import Any, Callable

import numpy as np

# poll slice for result collection: a worker dying mid-generation is
# noticed after about this long, not after the whole deadline
POLL_SLICE_S = 0.1

# the worker's idle poll: what makes a dead parent's EOF observable
WORKER_POLL_S = 1.0


def _worker_main(conn, worker_id: int, policy_factory: Callable[[], Any],
                 agent_factory: Callable[[], Any], n_proc: int, population_size: int, dim: int,
                 table: np.ndarray, master_state: dict, mirrored: bool = True) -> None:
    """Build a policy and an agent once, then evaluate member slices until
    the parent sends None or goes away.

    Messages are ``(seq, params_flat, sigma, offsets, indices)``;
    ``indices=None`` means the worker's own round-robin slice, an array a
    retry of another worker's members.
    """
    import torch

    from .engine import call_rollout, load_flat, member_sign_offset

    torch.set_num_threads(1)  # workers parallelize across processes, not BLAS
    policy = policy_factory()
    policy.load_state_dict(master_state)  # buffers: parameter loads write only parameters
    agent = agent_factory()

    while True:
        if not conn.poll(WORKER_POLL_S):
            continue
        try:
            msg = conn.recv()
        except EOFError:
            return  # the parent's end is closed
        if msg is None:
            return
        seq, params_flat, sigma, offsets, indices = msg
        if indices is None:
            indices = list(range(worker_id, population_size, n_proc))
        else:
            indices = [int(i) for i in indices]
        fitness = np.full(len(indices), np.nan, np.float32)
        bcs: list[np.ndarray] = []
        steps = 0
        for j, i in enumerate(indices):
            sign, off = member_sign_offset(offsets, i, mirrored)
            load_flat(policy, torch.from_numpy(params_flat + sigma * sign * table[off:off + dim]))
            try:
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
        conn.send((seq, np.asarray(indices, np.int64), fitness, bc, steps))


class ProcessPool:
    """Persistent fork-based workers for HostEngine."""

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

    def respawn_dead(self) -> None:
        """Replace dead workers with fresh forks (at a generation boundary);
        a dead worker's pipe is closed, with any stale result in it."""
        for w, p in enumerate(self._procs):
            if p.is_alive():
                continue
            try:
                self._conns[w].close()
            except OSError:
                pass  # the pipe is gone with its worker either way
            self._retired.append(p)
            self._spawn(w)

    def _send(self, w: int, msg) -> bool:
        try:
            self._conns[w].send(msg)
            return True
        except (BrokenPipeError, OSError):
            return False  # a dead worker: the retry or NaN path covers its slice

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
                          if not self._procs[w].is_alive() and not c.poll(0)]:
                    del pending[w]
                continue
            for c in ready:
                w = conn_to_w[id(c)]
                try:
                    got = c.recv()
                except (EOFError, OSError):
                    del pending[w]  # the pipe closed under us: the worker died
                    continue
                if got[0] == seq:
                    parts.append(got[1:])
                    del pending[w]

    def evaluate(self, params_flat: np.ndarray, sigma: float, offsets: np.ndarray,
                 timeout_s: float = 600.0) -> tuple[np.ndarray, np.ndarray, int]:
        """One generation: (fitness, bc, steps).  ``timeout_s`` bounds the
        whole generation.  The members of workers that died are retried once
        on the survivors; what is unanswered at the deadline stays NaN."""
        self._seq += 1
        seq = self._seq
        deadline = time.monotonic() + timeout_s
        params_flat = np.asarray(params_flat, np.float32)
        offsets = np.asarray(offsets)
        msg = (seq, params_flat, float(sigma), offsets, None)
        pending = {w: self._conns[w] for w in range(self.n_proc) if self._send(w, msg)}
        parts: list = []
        self._collect(seq, pending, deadline, parts)

        # members of DEAD workers: any worker computes the same θ for them.
        # Alive stragglers are not retried; their results may still come.
        covered = {int(i) for indices, *_ in parts for i in indices}
        missing = [i for i in range(self.population_size)
                   if i not in covered and not self._procs[i % self.n_proc].is_alive()]
        alive = [w for w in range(self.n_proc) if self._procs[w].is_alive()]
        if missing and alive and deadline - time.monotonic() > 0:
            self._seq += 1
            rseq = self._seq
            retry: dict[int, Any] = {}
            for k, w in enumerate(alive):
                chunk = missing[k::len(alive)]
                if chunk and self._send(w, (rseq, params_flat, float(sigma), offsets,
                                            np.asarray(chunk, np.int64))):
                    retry[w] = self._conns[w]
            self._collect(rseq, retry, deadline, parts)

        fitness = np.full(self.population_size, np.nan, np.float32)
        bc_dim = max((p[2].shape[1] for p in parts), default=0)
        bc = np.zeros((self.population_size, bc_dim), np.float32)
        steps = 0
        for indices, f, b, st in parts:
            fitness[indices] = f
            if b.shape[1]:
                bc[indices] = b
            steps += st
        return fitness, bc, steps

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
