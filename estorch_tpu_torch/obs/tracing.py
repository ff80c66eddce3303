"""Distributed tracing: per-process trace segments + tail-based sampling.

Counterpart of ``estorch_tpu/obs/tracing.py``, copied with its code
unchanged (stdlib only).  Every serving hop carries a causal id: the
server honors an incoming ``X-Trace-Id`` or mints one, and the batcher's
``batch_dispatch`` events list the member ids.  This module keeps each
process's spans as segments and decides at each trace's end which to keep.

Segment schema (one JSON object per line in ``<run_dir>/traces.jsonl``)::

    {"trace_id", "span_id", "parent_span_id", "proc", "name",
     "t0_mono", "dur_s", "ts", "seq", "attrs"}

``t0_mono`` is the process-local ``perf_counter`` start (exact intra-
process arithmetic); ``ts`` is the wall-clock start (the cross-process
alignment key — per-host monotonic clocks share no epoch).  ``seq`` is a
per-process monotonic cursor assigned when the sampler KEEPS the trace,
which is what makes the ``/traces?since=<seq>`` scrape endpoint
idempotent.  Parent span ids cross process boundaries in the
``X-Parent-Span`` header beside ``X-Trace-Id``; a hop that already knows
the trace is interesting (retry legs, hedge legs) forces the downstream
sampler via ``X-Trace-Sampled: 1``.

Tail-based sampling (:class:`TraceSampler`): the keep/drop decision is
made at trace END on each process, so the sampler can keep exactly the
traces worth keeping — every error / shed / retried / hedged /
breaker-touched trace, every trace slower than the live p99 of the
configured request histogram (read off the telemetry hub), and a
deterministic 1-in-N head-sampled baseline (``crc32(trace_id) % N``, so
every hop of a head-sampled trace keeps it WITHOUT coordination).
Everything else is dropped at the ring; ``traces_sampled`` /
``traces_dropped`` counters measure the shed.

Imports nothing of torch or of the package: the server and the batcher
(``serve/``) import it, and a process that only scrapes traces needs
neither.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import zlib

TRACING_SCHEMA = 1
TRACE_HEADER = "X-Trace-Id"
PARENT_SPAN_HEADER = "X-Parent-Span"
SAMPLED_HEADER = "X-Trace-Sampled"
TRACES_FILENAME = "traces.jsonl"

# sampler defaults: 1-in-16 head baseline, p99 rule armed once the live
# histogram holds enough mass to make its tail meaningful
DEFAULT_HEAD_EVERY = 16
DEFAULT_P99_MIN_COUNT = 64

_SEGMENT_KEYS = ("trace_id", "span_id", "proc", "name")


def head_sampled(trace_id: str, head_every: int = DEFAULT_HEAD_EVERY) -> bool:
    """Deterministic 1-in-N head sample on the trace id alone — every
    process reaches the same verdict for the same trace with zero
    coordination, so baseline traces assemble COMPLETE."""
    if head_every <= 1:
        return True
    return zlib.crc32(trace_id.encode()) % int(head_every) == 0


def make_segment(trace_id: str, span_id: str, parent_span_id: str | None,
                 proc: str, name: str, t0_mono: float, dur_s: float,
                 attrs: dict | None = None,
                 ts: float | None = None) -> dict:
    """One structured span segment (see module docstring).  ``ts``
    defaults to now minus the duration — callers record at span end."""
    return {
        "trace_id": str(trace_id),
        "span_id": str(span_id),
        "parent_span_id": str(parent_span_id) if parent_span_id else None,
        "proc": str(proc),
        "name": str(name),
        "t0_mono": float(t0_mono),
        "dur_s": max(0.0, float(dur_s)),
        "ts": float(ts) if ts is not None
        else time.time() - max(0.0, float(dur_s)),
        "attrs": dict(attrs or {}),
    }


def valid_segment(row) -> bool:
    """Is ``row`` a well-formed segment?  Readers (assembly, the
    collector) must skip foreign/torn lines, never choke on them."""
    if not isinstance(row, dict):
        return False
    for k in _SEGMENT_KEYS:
        if not isinstance(row.get(k), str) or not row[k]:
            return False
    for k in ("dur_s", "ts"):
        v = row.get(k)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            return False
    return True


def read_segments(path: str) -> list[dict]:
    """Segments from one ``traces.jsonl``, torn-tail / garbage tolerant
    (post-mortem inputs degrade, never crash)."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return []
    out: list[dict] = []
    for ln in text.splitlines():
        if not ln.strip():
            continue
        try:
            row = json.loads(ln)
        except ValueError:
            continue  # torn tail or foreign line
        if valid_segment(row):
            out.append(row)
    return out


class TraceSampler:
    """Tail-based keep/drop policy, decided at trace end (see module
    docstring).  ``hists`` is the hub's histogram registry (duck-typed:
    ``.get(name)`` → histogram with ``.count`` / ``.quantile(q)``) and
    may be None — the p99 rule simply stays disarmed."""

    def __init__(self, *, hists=None, hist_name: str | None = None,
                 head_every: int = DEFAULT_HEAD_EVERY,
                 p99_min_count: int = DEFAULT_P99_MIN_COUNT):
        self.hists = hists
        self.hist_name = hist_name
        self.head_every = int(head_every)
        self.p99_min_count = int(p99_min_count)

    def verdict(self, trace_id: str, dur_s: float | None = None, *,
                error: bool = False, shed: bool = False,
                retried: bool = False, hedged: bool = False,
                breaker: bool = False, forced: bool = False) -> str | None:
        """The keep REASON, or None to drop."""
        if forced:
            return "forced"
        if error:
            return "error"
        if shed:
            return "shed"
        if retried:
            return "retry"
        if hedged:
            return "hedge"
        if breaker:
            return "breaker"
        if dur_s is not None and self.hists is not None and self.hist_name:
            h = self.hists.get(self.hist_name)
            if h is not None and h.count >= self.p99_min_count:
                p99 = h.quantile(0.99)
                if p99 == p99 and float(dur_s) > p99:  # NaN-safe
                    return "p99"
        if head_sampled(trace_id, self.head_every):
            return "head"
        return None


class ProcessTracer:
    """Per-process segment buffer + sampler + atomic flush.

    Lifecycle: hops :meth:`add` segments as spans end (buffered per
    trace id — the keep/drop decision is TAIL-based), then :meth:`finish`
    the trace with its outcome flags; kept segments get a ``seq`` cursor
    and enter both the flush ring and the bounded ``recent`` window the
    ``/traces?since=`` endpoint serves.  :meth:`record` bypasses the
    sampler for spans that are per-dispatch rather than per-request (the
    batcher's ``batch`` span — one per coalesced dispatch, already
    bounded by construction).

    Thread-safe throughout: the router finishes traces from concurrent
    handler threads, and hedged attempts add segments from their racer
    threads.
    """

    def __init__(self, proc: str, *, counters=None, hists=None,
                 hist_name: str | None = None,
                 head_every: int = DEFAULT_HEAD_EVERY,
                 p99_min_count: int = DEFAULT_P99_MIN_COUNT,
                 path: str | None = None,
                 capacity: int = 4096,
                 recent_capacity: int = 4096,
                 max_pending: int = 512,
                 max_file_lines: int = 20000,
                 flush_every: int = 64):
        self.proc = str(proc)
        self.counters = counters
        self.path = os.path.abspath(path) if path else None
        self.sampler = TraceSampler(hists=hists, hist_name=hist_name,
                                    head_every=head_every,
                                    p99_min_count=p99_min_count)
        self.max_pending = int(max_pending)
        self.max_file_lines = int(max_file_lines)
        self.flush_every = int(flush_every)
        self._lock = threading.Lock()
        self._seq = 0
        self._span_seq = 0
        # pending: trace id → buffered segments awaiting the tail verdict
        self._pending: collections.OrderedDict[str, list[dict]] = \
            collections.OrderedDict()
        # decided: trace id → keep reason (or None = dropped), bounded.
        # A segment can arrive AFTER the verdict — a cancelled hedge
        # loser's leg lands when its aborted socket finally raises — and
        # must follow its trace's fate, not reopen a pending entry that
        # nobody will ever finish.
        self._decided: collections.OrderedDict[str, str | None] = \
            collections.OrderedDict()
        self._max_decided = 1024
        # ring: kept segments not yet flushed to disk (oldest evicted)
        self._ring: collections.deque[dict] = collections.deque(
            maxlen=int(capacity))
        # recent: kept segments the /traces?since= endpoint serves
        self._recent: collections.deque[dict] = collections.deque(
            maxlen=int(recent_capacity))

    # ------------------------------------------------------------- spans

    def span_id(self) -> str:
        """Mint one process-unique span id."""
        with self._lock:
            self._span_seq += 1
            return f"{self.proc}.{self._span_seq}"

    def add(self, segment: dict) -> None:
        """Buffer one finished span under its trace id, pending the tail
        verdict.  Overflowing the pending table drops the OLDEST trace
        (counted) — a hop that never finishes must not grow memory."""
        with self._lock:
            tid = segment["trace_id"]
            if tid in self._decided:
                # late segment for an already-judged trace: follow the
                # verdict (kept traces get the straggler leg, dropped
                # traces stay dropped)
                if self._decided[tid] is not None:
                    self._keep_locked([segment])
                return
            buf = self._pending.get(tid)
            if buf is None:
                while len(self._pending) >= self.max_pending:
                    self._pending.popitem(last=False)
                    self._inc("traces_dropped")
                buf = self._pending[tid] = []
            buf.append(segment)

    def record(self, segment: dict) -> None:
        """Keep one segment unconditionally (no per-trace buffering) —
        for per-dispatch spans like the batcher's ``batch``."""
        with self._lock:
            self._keep_locked([segment])

    def finish(self, trace_id: str, dur_s: float | None = None, *,
               error: bool = False, shed: bool = False,
               retried: bool = False, hedged: bool = False,
               breaker: bool = False, forced: bool = False) -> bool:
        """Apply the tail verdict to the trace's buffered segments.
        Returns True when kept (callers propagate it as
        ``X-Trace-Sampled`` on response headers if they care)."""
        reason = self.sampler.verdict(
            trace_id, dur_s, error=error, shed=shed, retried=retried,
            hedged=hedged, breaker=breaker, forced=forced)
        with self._lock:
            segs = self._pending.pop(trace_id, None) or []
            self._decided[trace_id] = reason
            while len(self._decided) > self._max_decided:
                self._decided.popitem(last=False)
            if reason is None:
                self._inc("traces_dropped")
                return False
            roots = [s for s in segs if not s.get("parent_span_id")]
            for s in roots or segs[:1]:
                s["attrs"]["sampled"] = reason
            self._keep_locked(segs)
            self._inc("traces_sampled")
        if self.path and len(self._ring) >= self.flush_every:
            self.flush()
        return True

    def _keep_locked(self, segs: list[dict]) -> None:
        for s in segs:
            self._seq += 1
            s["seq"] = self._seq
            self._ring.append(s)
            self._recent.append(s)

    def _inc(self, name: str) -> None:
        if self.counters is not None:
            self.counters.inc(name)

    # ------------------------------------------------------------- flush

    def flush(self) -> int:
        """Append the ring to ``traces.jsonl`` atomically and drain it.

        Same contract as the flight recorder's ``dump_jsonl``: stage the
        existing file into ``.tmp`` (dropping a torn tail), append the
        ring, ``os.replace`` — a crash leaves the previous or the new
        complete file, never a truncated one.  The retained tail is
        capped at ``max_file_lines`` so disk stays bounded by
        construction."""
        if not self.path:
            return 0
        with self._lock:
            segs = list(self._ring)
            self._ring.clear()
        if not segs:
            return 0
        with self._lock:  # serialize concurrent flushers on the file
            prev_lines: list[str] = []
            if os.path.exists(self.path):
                try:
                    with open(self.path) as old:
                        prev = old.read()
                except OSError:
                    prev = ""
                if prev and not prev.endswith("\n"):
                    cut = prev.rfind("\n")
                    prev = prev[:cut + 1] if cut >= 0 else ""
                prev_lines = prev.splitlines()
            keep_prev = max(0, self.max_file_lines - len(segs))
            prev_lines = prev_lines[-keep_prev:] if keep_prev else []
            tmp = self.path + ".tmp"
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                for ln in prev_lines:
                    f.write(ln + "\n")
                for s in segs:
                    f.write(json.dumps(s, default=float) + "\n")
            os.replace(tmp, self.path)
        return len(segs)

    # --------------------------------------------------------- scraping

    def since(self, cursor: int) -> tuple[list[dict], int]:
        """Kept segments with ``seq > cursor`` (bounded by the recent
        window) plus the new cursor — the ``/traces?since=`` payload."""
        cursor = int(cursor)
        with self._lock:
            segs = [s for s in self._recent if s.get("seq", 0) > cursor]
            top = self._seq
        return segs, top


def traces_payload(tracer: ProcessTracer | None, since: int,
                   hists=None) -> dict:
    """The ``/traces?since=`` response body: new segments + cursor +
    the hub's histogram bucket exemplars (how trace ids reach the
    collector's store without widening the Prometheus text format)."""
    if tracer is None:
        return {"proc": None, "segments": [], "cursor": int(since),
                "exemplars": {}}
    segs, cursor = tracer.since(since)
    exemplars: dict[str, dict] = {}
    if hists is not None:
        try:
            for name, snap in hists.snapshot(compact=True).items():
                ex = snap.get("exemplars")
                if ex:
                    exemplars[name] = ex
        except Exception:  # noqa: BLE001 — scrape answers degrade, not 500
            exemplars = {}
    return {"proc": tracer.proc, "segments": segs, "cursor": cursor,
            "exemplars": exemplars}
