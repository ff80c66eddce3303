"""Flight recorder (a ring of recent spans and events) and heartbeat file.

Counterpart of ``estorch_tpu/obs/recorder.py`` (stdlib only).  When a run
wedges, the recorder holds its last N spans and events in memory, and the
heartbeat is the half a supervisor can see from outside: a small JSON file
rewritten atomically at each phase entry, ``{"ts", "pid", "phase",
"generation", "counters", "hists"}``, written to ``path + ".tmp"`` and
``os.replace``-d over ``path``.  The path comes from the
``ESTORCH_OBS_HEARTBEAT`` environment variable, the JAX package's.
:func:`read_heartbeat` returns the beat with its ``age_s`` (None when the
file is missing or unreadable: "wedged before the first beat" is itself a
diagnosis), and a supervisor calls a beat older than its
``stale_after_s`` (default :data:`STALE_AFTER_S`) a wedge.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

HEARTBEAT_ENV = "ESTORCH_OBS_HEARTBEAT"
# a beat older than this is stale: generous against generation times
# (seconds), far below a stage's time limit
STALE_AFTER_S = 120.0


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

    def last(self) -> dict | None:
        return self._ring[-1] if self._ring else None

    def __len__(self) -> int:
        return len(self._ring)

    def dump_jsonl(self, path: str) -> None:
        """Append the ring to a JSONL file, atomically: the old content and
        the ring are written to ``path + ".tmp"``, which is renamed over
        ``path``.  A torn final line of the old file (a crash artifact) is
        dropped, not carried into the middle of the new one."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            if os.path.exists(path):
                with open(path) as old:
                    prev = old.read()
                if prev and not prev.endswith("\n"):
                    cut = prev.rfind("\n")
                    prev = prev[:cut + 1] if cut >= 0 else ""
                f.write(prev)
            for ev in self._ring:
                f.write(json.dumps(ev, default=float) + "\n")
        os.replace(tmp, path)


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


def read_heartbeat(path: str) -> dict | None:
    """The beat with ``age_s`` (now − ts), or None when it is absent or
    unreadable: the process never started telemetry or was not enabled."""
    try:
        with open(path) as f:
            hb = json.load(f)
        hb["age_s"] = max(0.0, time.time() - float(hb["ts"]))
        return hb
    except (OSError, ValueError, KeyError, TypeError):
        return None


def describe_heartbeat(path: str) -> str:
    """One diagnostic clause for failure lines: last phase, gen and age."""
    hb = read_heartbeat(path)
    if hb is None:
        return "no heartbeat written — wedged before the first phase?"
    return (f"last phase={hb.get('phase', '?')} gen={hb.get('generation', '?')} "
            f"heartbeat {hb['age_s']:.0f}s ago")
