"""Compile ledger: each program build as a structured run fact.

Counterpart of ``estorch_tpu/obs/profile/ledger.py`` (stdlib only).  A
compile costs seconds of wall time; the ledger keeps each one as an entry
that rides every export surface:

* the run JSONL — ``Telemetry.take_compile_events()`` flushes the entries
  recorded since the last generation record into
  ``record["compile_events"]``;
* Prometheus — :func:`ledger_counters` folds entries into the flat
  registry as ``compile_s_<program>`` gauges, which the sidecar renders
  and the validating parser round-trips;
* the Perfetto trace — ``obs trace`` renders each entry as an instant
  marker on a ``compiles`` lane.

In the port the programs are the native libraries built and loaded at
first use (``noise_kernels``, ``envpool``); their entries carry
``cached`` and ``library`` beside ``compile_s``.  Thread-safe: the overlap
scheduler's thread may trigger a load while the main thread reads.
"""

from __future__ import annotations

import re
import threading

LEDGER_SCHEMA = 1

# ledger fact -> flat registry prefix (gauges: last-write-wins per
# program; prometheus.is_gauge treats the compile_ prefix as gauge)
_FACT_PREFIX = {
    "compile_s": "compile_s",
    "xla_flops": "compile_xla_flops",
    "xla_bytes_accessed": "compile_xla_bytes",
    "peak_bytes": "compile_peak_bytes",
}

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


class CompileLedger:
    """Append-only record of compile events for one run/process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: list[dict] = []
        self._flushed = 0  # cursor for take_new (run-JSONL riding)

    def record(self, program: str, compile_s: float, generation: int = 0,
               **facts) -> dict:
        entry = {
            "program": str(program),
            "compile_s": round(float(compile_s), 6),
            "generation": int(generation),
        }
        for k, v in facts.items():
            if v is not None:
                entry[k] = v
        with self._lock:
            self._entries.append(entry)
        return entry

    def entries(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._entries]

    def take_new(self) -> list[dict]:
        """Entries recorded since the last call — the per-generation
        flush that lands in ``record["compile_events"]``."""
        with self._lock:
            new = [dict(e) for e in self._entries[self._flushed:]]
            self._flushed = len(self._entries)
        return new

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def ledger_counters(entries: list[dict]) -> dict[str, float]:
    """Fold ledger entries into flat registry names (per-program gauges,
    last entry wins) — the form the Prometheus exposition renders and
    its validating parser round-trips."""
    out: dict[str, float] = {}
    for e in entries:
        if not isinstance(e, dict) or "program" not in e:
            continue
        prog = _NAME_SANITIZE.sub("_", str(e["program"]))
        for fact, prefix in _FACT_PREFIX.items():
            v = e.get(fact)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[f"{prefix}_{prog}"] = float(v)
    return out


def collect_compile_events(records: list[dict]) -> list[dict]:
    """All ``compile_events`` entries across a run's records, in order."""
    out: list[dict] = []
    for r in records:
        ev = r.get("compile_events") if isinstance(r, dict) else None
        if isinstance(ev, list):
            out.extend(e for e in ev if isinstance(e, dict))
    return out
