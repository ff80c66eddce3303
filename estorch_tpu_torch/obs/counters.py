"""Counters and gauges: the numeric facts of one run.

Counterpart of ``estorch_tpu/obs/counters.py`` (stdlib only; the port
keeps its own copy).  Counters are monotone (``inc``), gauges last-write-
wins (``gauge``); both live in one flat name → value dict, so a run's
registry exports with one ``snapshot()``.  Thread-safe: host worker
threads and the overlap scheduler's thread write beside the train loop.
"""

from __future__ import annotations

import threading


class Counters:
    """Flat registry of counters (monotone) and gauges (overwrite)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: dict[str, float] = {}

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._values[name] = value

    def get(self, name: str, default: float = 0) -> float:
        with self._lock:
            return self._values.get(name, default)

    def snapshot(self) -> dict[str, float]:
        """Point-in-time copy (safe to serialize while workers run)."""
        with self._lock:
            return dict(self._values)

    def sample_peak_rss(self) -> float:
        """Record the process's peak resident set as the ``peak_rss_mb``
        gauge: ``VmHWM`` of ``/proc/self/status`` where that file exists,
        else ``ru_maxrss`` (KiB on Linux, bytes on macOS).  Linux carries
        ``ru_maxrss`` across an exec, so a spawned child's would read its
        parent's peak (ROADMAP.md, F13); ``VmHWM`` is the child's own."""
        mb = None
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmHWM:"):
                        mb = int(line.split()[1]) / 2**10  # kB
                        break
        except OSError:
            pass
        if mb is None:
            import resource
            import sys

            div = 2**20 if sys.platform == "darwin" else 2**10
            mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / div
        self.gauge("peak_rss_mb", round(mb, 3))
        return mb


class NullCounters(Counters):
    """Inert registry of a disabled hub: engines write unconditionally,
    and the shared ``NULL_TELEMETRY`` default must not gather the writes
    of unrelated engines into one registry."""

    def inc(self, name: str, n: float = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def sample_peak_rss(self) -> float:
        return 0.0
