"""Deterministic thread interleaving: races made replayable.

Counterpart of ``estorch_tpu/resilience/interleave.py`` (stdlib only, the
port's own copy).  Real threads hit a data race once in a thousand runs;
here the OS scheduler is taken out of it:

* every worker is a real ``threading.Thread``, but a baton (one
  ``threading.Event`` a worker) keeps exactly one of them runnable;
* a ``sys.settrace`` hook counts line events in the workers' own code
  and, on a schedule drawn from a seeded ``random.Random``, parks the
  current worker and hands the baton to another;
* since execution is serialized, the one RNG is consumed only by the
  baton's holder, so the interleaving is a pure function of the seed.

The same seed gives the same schedule and the same final state; a seed
that loses an update reproduces it.  :class:`CoopLock` is the fix side: a
lock whose blocked acquire yields through the scheduler, so guarded code
stays deterministic and correct under every seed.
"""

from __future__ import annotations

import random
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence


class DeadlockError(RuntimeError):
    """No runnable worker can make progress (all parked or spinning)."""


@dataclass(frozen=True)
class InterleaveResult:
    values: tuple[Any, ...]  # per-worker return values, in worker order
    schedule: tuple[int, ...]  # worker index at every baton handoff
    seed: int
    switches: int

    def replays(self, other: "InterleaveResult") -> bool:
        """Bit-identical replay: same seed produced the same handoffs."""
        return (self.seed == other.seed
                and self.schedule == other.schedule)


@dataclass
class _Worker:
    index: int
    fn: Callable[[], Any]
    baton: threading.Event = field(default_factory=threading.Event)
    thread: threading.Thread | None = None
    value: Any = None
    error: BaseException | None = None
    done: bool = False


class Interleaver:
    """Run ``fns`` as serialized threads under a seeded forced-yield
    scheduler.  ``granularity`` bounds how many traced lines a worker
    may run between handoff decisions (the RNG draws 1..granularity);
    ``max_steps`` bounds total handoffs so a livelock fails fast
    instead of hanging the test suite."""

    def __init__(self, fns: Sequence[Callable[[], Any]], seed: int = 0,
                 granularity: int = 3, max_steps: int = 100_000,
                 timeout: float = 30.0):
        if not fns:
            raise ValueError("need at least one worker")
        self._workers = [_Worker(i, fn) for i, fn in enumerate(fns)]
        self._seed = seed
        self._rng = random.Random(seed)
        self._granularity = max(1, granularity)
        self._max_steps = max_steps
        self._timeout = timeout
        self._schedule: list[int] = []
        self._countdown = 0
        self._local = threading.local()
        # frames from these files are scheduler/runtime plumbing, not
        # worker code — tracing them would make the schedule depend on
        # stdlib internals instead of the code under test
        self._skip_files = {__file__, threading.__file__, random.__file__}

    # -- scheduling core ----------------------------------------------

    def _runnable(self, exclude: int | None = None) -> list[_Worker]:
        return [w for w in self._workers
                if not w.done and w.index != exclude]

    def _handoff(self, me: _Worker, exclude_self: bool) -> None:
        """Park ``me`` and wake an RNG-chosen runnable worker.  Called
        only while holding the baton, so RNG access is serialized."""
        if len(self._schedule) >= self._max_steps:
            raise DeadlockError(
                f"no progress after {self._max_steps} handoffs "
                f"(seed={self._seed}) — livelock or runaway loop")
        candidates = self._runnable(me.index if exclude_self else None)
        if not candidates:
            if exclude_self:
                raise DeadlockError(
                    f"worker {me.index} is blocked and no other worker "
                    f"is runnable (seed={self._seed})")
            return  # alone: keep running
        target = self._rng.choice(candidates)
        self._schedule.append(target.index)
        me.baton.clear()
        target.baton.set()
        if not me.baton.wait(self._timeout):
            raise DeadlockError(
                f"worker {me.index} never got the baton back within "
                f"{self._timeout}s (seed={self._seed})")

    def _maybe_switch(self, me: _Worker) -> None:
        self._countdown -= 1
        if self._countdown <= 0:
            self._countdown = self._rng.randint(1, self._granularity)
            self._handoff(me, exclude_self=False)

    def yield_now(self) -> None:
        """Give the baton away unconditionally (CoopLock's spin step)."""
        self._handoff(self._me(), exclude_self=True)

    def _me(self) -> _Worker:
        return self._local.worker

    # -- tracing ------------------------------------------------------

    def _trace(self, frame, event, arg):
        if frame.f_code.co_filename in self._skip_files:
            return None
        return self._trace_lines

    def _trace_lines(self, frame, event, arg):
        if event == "line":
            self._maybe_switch(self._me())
        return self._trace_lines

    # -- worker lifecycle ---------------------------------------------

    def _run_worker(self, w: _Worker) -> None:
        self._local.worker = w
        w.baton.wait(self._timeout)
        sys.settrace(self._trace)
        try:
            w.value = w.fn()
        except BaseException as e:  # re-raised in run()
            w.error = e
        finally:
            sys.settrace(None)
            w.done = True
            # pass the baton on without expecting it back
            candidates = self._runnable()
            if candidates:
                target = self._rng.choice(candidates)
                self._schedule.append(target.index)
                target.baton.set()

    def run(self) -> InterleaveResult:
        for w in self._workers:
            w.thread = threading.Thread(
                target=self._run_worker, args=(w,),
                name=f"interleave-{w.index}", daemon=True)
            w.thread.start()
        self._countdown = self._rng.randint(1, self._granularity)
        self._workers[0].baton.set()
        for w in self._workers:
            w.thread.join(self._timeout)
            if w.thread.is_alive():
                raise DeadlockError(
                    f"worker {w.index} still running after "
                    f"{self._timeout}s (seed={self._seed})")
        for w in self._workers:
            if w.error is not None:
                raise w.error
        return InterleaveResult(
            values=tuple(w.value for w in self._workers),
            schedule=tuple(self._schedule), seed=self._seed,
            switches=len(self._schedule))


class CoopLock:
    """Mutual exclusion that cooperates with the interleaver: a blocked
    acquire yields through the scheduler (staying deterministic) rather
    than parking in the OS.  Usable only inside interleaved workers —
    which is the point: it exists so a racy fixture can be re-run with
    the SAME seed after adding locking and observe the race gone."""

    def __init__(self, interleaver: Interleaver):
        self._interleaver = interleaver
        self._owner: int | None = None

    def acquire(self) -> None:
        me = self._interleaver._me().index
        while self._owner is not None:
            self._interleaver.yield_now()
        self._owner = me

    def release(self) -> None:
        me = self._interleaver._me().index
        if self._owner != me:
            raise RuntimeError(
                f"worker {me} releasing a lock owned by {self._owner}")
        self._owner = None

    def __enter__(self) -> "CoopLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def run_interleaved(fns: Sequence[Callable[[], Any]], seed: int = 0,
                    granularity: int = 3,
                    max_steps: int = 100_000) -> InterleaveResult:
    """One-shot helper: schedule ``fns`` under ``seed`` and return the
    result.  Build the workers fresh per call — shared state captured in
    their closures is exactly what the harness is for."""
    return Interleaver(fns, seed=seed, granularity=granularity,
                       max_steps=max_steps).run()
