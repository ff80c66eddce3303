"""Span telemetry: phase timers for the training loop.

Counterpart of ``estorch_tpu/obs/spans.py``.  A *span* is one timed phase
of a generation: ``sample`` / ``eval`` / ``update`` on the host and pooled
backends, ``dispatch`` / ``device`` / ``host_sync`` on the device backend,
whose generation is queued on the card as a whole.  Spans nest: a phase
entered inside another is recorded as ``parent/child`` (``update/
obsnorm_merge``), and the parent's time includes the child's.

Device honesty: CUDA launches return before the card has run them, so a
span around device work either ends in its own host copy or passes
``fence=``, a callable run before the clock stops.  The port's fences wait
on a CUDA event recorded right after the fenced work was queued, never on
``torch.cuda.synchronize()``: in the overlap scheduler another thread has
already queued the next generation on the same stream, and a device-wide
wait would time that too.

Span stacks are per thread and the accumulator is shared under a lock: the
overlap scheduler's thread emits the engine's spans while the main thread
emits ``host_sync`` and ``record``, and one shared stack would interleave
their names.  While a torch profiler collects, every span also opens the
range ``estorch.<name>`` on the profiler's timeline (``obs/trace.py``
``annotate``), whether the hub is on or off; a disabled hub's ``phase()``
otherwise returns the cached no-op.  ``ESTORCH_OBS=0`` disables the
default-on hub and ``ESTORCH_OBS_HEARTBEAT=<path>`` turns the heartbeat
file on, as in the JAX package.

The hub also carries the performance-attribution facts of
``obs/profile/``: the run's analytic cost model (``set_cost_model``; ES
writes it into its first record) and the compile ledger
(``compile_event``; flushed into each record's ``compile_events``).  The
port's compiles are its native libraries' builds and loads at first use
(``ops/_build.py``, ``envs/native_pool.py``), each recorded once a
process, by the ES whose engine loaded it.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

from .counters import Counters, NullCounters
from .hist import Histograms, NullHistograms
from .profile.ledger import CompileLedger, ledger_counters
from .recorder import HEARTBEAT_ENV, FlightRecorder, Heartbeat
from .trace import annotate

OBS_DISABLE_ENV = "ESTORCH_OBS"  # "0" disables the default-on hub


class Telemetry:
    """Per-run hub: spans, counters, histograms, flight recorder, heartbeat.

    One rides each ``ES`` (``es.obs``); the engines hold it as their
    ``telemetry`` attribute, so their phases land in the accumulator the
    train loop flushes into each record.
    """

    def __init__(self, enabled: bool = True, heartbeat_path: str | None = None,
                 recorder_capacity: int = 512):
        self.enabled = bool(enabled)
        self.counters = Counters() if self.enabled else NullCounters()
        self.hists = Histograms() if self.enabled else NullHistograms()
        self.recorder = FlightRecorder(recorder_capacity)
        self.heartbeat = Heartbeat(heartbeat_path) if heartbeat_path else None
        self.generation = 0
        self._acc: dict[str, float] = {}
        self._acc_lock = threading.Lock()
        self._tls = threading.local()
        # obs/profile/: the per-program compile ledger and the run's
        # analytic cost model, which `obs profile` joins with the spans
        self.compile_ledger = CompileLedger()
        self.cost_model: dict | None = None

    @classmethod
    def from_env(cls) -> "Telemetry":
        """On unless ``ESTORCH_OBS=0``; ``ESTORCH_OBS_HEARTBEAT`` names the
        heartbeat file."""
        enabled = os.environ.get(OBS_DISABLE_ENV, "1") != "0"
        hb = os.environ.get(HEARTBEAT_ENV) or None
        return cls(enabled=enabled, heartbeat_path=hb if enabled else None)

    # --------------------------------------------------------------- spans

    def phase(self, name: str, fence=None):
        """Time one phase; ``fence()`` (when given) runs before the clock
        stops.  Under a profiler the phase is also the range
        ``estorch.<name>``."""
        if not self.enabled:
            return annotate("estorch." + name)
        return self._phase_cm(name, fence)

    @property
    def _stack(self) -> list[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _beat(self, phase: str) -> None:
        self.heartbeat.beat(phase, self.generation, self.counters.snapshot(),
                            hists=self.hists.snapshot(compact=True))

    @contextlib.contextmanager
    def _phase_cm(self, name: str, fence):
        stack = self._stack
        full = f"{stack[-1]}/{name}" if stack else name
        stack.append(full)
        if self.heartbeat is not None:
            self._beat(full)  # on entry: a wedge inside leaves this name
        t0 = time.perf_counter()
        try:
            with annotate("estorch." + name):
                yield
                if fence is not None:
                    fence()
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            with self._acc_lock:
                self._acc[full] = self._acc.get(full, 0.0) + dt
            self.hists.observe("phase/" + full, dt)
            extra = {"generation": self.generation}
            trace = getattr(self._tls, "trace", None)
            if trace is not None:
                extra["trace"] = trace
            self.recorder.add("span", full, dur_s=dt, **extra)

    @contextlib.contextmanager
    def trace_ctx(self, trace_id: str):
        """Spans and events inside carry ``trace=trace_id`` into the
        recorder (the async scheduler's dispatch ids); per thread."""
        prev = getattr(self._tls, "trace", None)
        self._tls.trace = trace_id
        try:
            yield
        finally:
            self._tls.trace = prev

    def observe(self, name: str, value: float, n: int = 1,
                exemplar: str | None = None, **ladder) -> None:
        """Record ``n`` observations into the named histogram (ladder
        kwargs apply at its first observe; ``exemplar`` attaches a trace id
        to the value's bucket)."""
        self.hists.observe(name, value, n, exemplar=exemplar, **ladder)

    def take_phases(self) -> dict[str, float]:
        """Flush this generation's spans (into its record) and advance the
        generation counter."""
        if not self.enabled:
            return {}
        with self._acc_lock:
            out = {k: round(v, 6) for k, v in self._acc.items()}
            self._acc.clear()
        self.generation += 1
        self.counters.inc("generations")
        self.counters.sample_peak_rss()
        if self.heartbeat is not None:
            self._beat("between_generations")
        return out

    def discard_phases(self) -> None:
        """Drop the accumulated spans unemitted: a generation that raised
        or was rejected must not leak its spans into the next record (the
        recorder keeps them)."""
        with self._acc_lock:
            self._acc.clear()

    def note(self, phase: str) -> None:
        """A heartbeat-only marker for long stretches without spans."""
        if self.enabled and self.heartbeat is not None:
            self._beat(phase)

    # ------------------------------------------------------ compile ledger

    def set_cost_model(self, model: dict | None) -> None:
        """Attach the run's analytic FLOPs/bytes model
        (``obs/profile/costmodel.py``)."""
        if self.enabled:
            self.cost_model = dict(model) if model else None

    def compile_event(self, program: str, dur_s: float, compiled=None,
                      count_recompiles: int = 1, **extra):
        """Record one program build: the ledger entry (with the cost facts
        of ``compiled`` where it has any, and ``extra``), the
        ``recompiles`` counter (``count_recompiles`` programs), the
        ``compile_time_s`` gauge (the ledger's sum), the per-program
        gauges and a flight-recorder event.  Returns the entry, or None
        when the hub is disabled."""
        if not self.enabled:
            return None
        from .profile.costmodel import compiled_cost_facts

        facts = compiled_cost_facts(compiled) if compiled is not None else {}
        entry = self.compile_ledger.record(program, dur_s, generation=self.generation,
                                           **facts, **extra)
        if count_recompiles:
            self.counters.inc("recompiles", count_recompiles)
        self.counters.gauge("compile_time_s", round(sum(
            e.get("compile_s", 0.0) for e in self.compile_ledger.entries()), 6))
        for name, value in ledger_counters([entry]).items():
            self.counters.gauge(name, value)
        self.recorder.add("event", "compile", generation=self.generation, program=program,
                          dur_s=dur_s)
        return entry

    def take_compile_events(self) -> list[dict]:
        """Ledger entries recorded since the last flush: a record's
        ``compile_events``."""
        if not self.enabled:
            return []
        return self.compile_ledger.take_new()

    def event(self, name: str, **extra) -> None:
        """A non-span event in the ring; the current trace id rides along
        unless the caller passes ``trace=``."""
        if self.enabled:
            trace = getattr(self._tls, "trace", None)
            if trace is not None and "trace" not in extra:
                extra["trace"] = trace
            self.recorder.add("event", name, generation=self.generation, **extra)


class _NullTelemetry(Telemetry):
    """The shared disabled hub: every engine's default ``telemetry``."""

    def __init__(self):
        super().__init__(enabled=False)


NULL_TELEMETRY = _NullTelemetry()


def resolve_telemetry(telemetry) -> Telemetry:
    """``ES(telemetry=...)`` → a hub: None → on by environment, a bool
    forces it on or off, a ``Telemetry`` is used as it is."""
    if telemetry is None:
        return Telemetry.from_env()
    if isinstance(telemetry, Telemetry):
        return telemetry
    if telemetry is True:
        return Telemetry(enabled=True, heartbeat_path=os.environ.get(HEARTBEAT_ENV) or None)
    if telemetry is False:
        return Telemetry(enabled=False)
    raise TypeError(f"telemetry must be None, a bool, or a Telemetry, got {telemetry!r}")


def cuda_done_event(device):
    """A CUDA event recorded now on ``device``'s current stream (None off
    CUDA): ``event.synchronize()`` then waits for the work queued before
    it, and for none queued after."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def device_fence(device):
    """A span's ``fence=`` for device work: records a CUDA event when the
    span's body has queued its work and waits on it.  None off CUDA, where
    the work is done when the body returns."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    return lambda: cuda_done_event(device).synchronize()
