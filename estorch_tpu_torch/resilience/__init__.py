"""Resilience: supervised auto-resume, deterministic chaos and
per-generation fault containment (counterpart of the JAX package's
``resilience/``).

* :func:`run_resilient`: a faulted generation rolled back and re-run in
  process;
* :class:`Supervisor`: training in a spawned child, a heartbeat watchdog,
  and restarts from the latest checkpoint;
* :class:`ChaosPlan` / ``ESTORCH_CHAOS``: a deterministic fault schedule
  that exercises each of the above;
* :class:`Interleaver` / :func:`run_interleaved`: a seeded forced-yield
  thread scheduler that makes a data race replayable.
"""

from .chaos import CHAOS_ENV, ChaosError, ChaosPlan
from .interleave import CoopLock, DeadlockError, InterleaveResult, Interleaver, run_interleaved
from .supervisor import Supervisor, run_resilient

__all__ = [
    "CHAOS_ENV",
    "ChaosError",
    "ChaosPlan",
    "CoopLock",
    "DeadlockError",
    "InterleaveResult",
    "Interleaver",
    "Supervisor",
    "run_interleaved",
    "run_resilient",
]
