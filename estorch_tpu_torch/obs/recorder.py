"""Flight recorder (a ring of recent spans and events) and heartbeat file.

Counterpart of ``estorch_tpu/obs/recorder.py`` (stdlib only).  When a run
wedges, the recorder holds its last N spans and events in memory, and the
heartbeat is the half a supervisor can see from outside: a small JSON file
rewritten atomically at each phase entry, ``{"ts", "pid", "phase",
"generation", "counters", "hists"}``, written to ``path + ".tmp"`` and
``os.replace``-d over ``path``.  The path comes from the
``ESTORCH_OBS_HEARTBEAT`` environment variable, the JAX package's.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

HEARTBEAT_ENV = "ESTORCH_OBS_HEARTBEAT"


class FlightRecorder:
    """Bounded in-memory ring of recent telemetry events (oldest evicted)."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: collections.deque[dict] = collections.deque(maxlen=capacity)

    def add(self, kind: str, name: str, **extra) -> None:
        self._ring.append({"ts": time.time(), "kind": kind, "name": name, **extra})

    def events(self) -> list[dict]:
        """Oldest → newest copy of the ring."""
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)


class Heartbeat:
    """Atomic last-known-state file; thread-safe (two threads beat through
    one ``.tmp`` staging file in the overlap scheduler)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)

    def beat(self, phase: str, generation: int, counters: dict | None = None,
             hists: dict | None = None) -> None:
        payload = {"ts": time.time(), "pid": os.getpid(), "phase": phase,
                   "generation": int(generation)}
        if counters:
            payload["counters"] = counters
        if hists:
            payload["hists"] = hists
        tmp = self.path + ".tmp"
        with self._lock:
            with open(tmp, "w") as f:
                json.dump(payload, f, default=float)
            os.replace(tmp, self.path)
