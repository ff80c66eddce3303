"""Device traces of a run's window, read into plain intervals.

``capture(fn, entries)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities) inside a ``record_function`` of the benchmark's own that marks
the window.  ``entries`` are the program's Python functions that the
per-layer metrics read (``"module:qualname"``): while the window runs, each
call to one of them is wrapped in a ``record_function`` of that name, from
here (``sys.monitoring`` events on those functions' code alone; the
program is not touched).  :class:`Trace` then holds

- ``device``: every kernel, memcpy and memset on the card, with its CUPTI
  correlation id and the id of the CPU op it was queued under;
- ``launches``: the CUDA API calls that queued them, joined
  to a device op by the correlation id;
- ``spans``: the entries' calls as intervals on the CPU's timeline,

so a device op is given to the Python entry that was running when its
launch was made, whatever the kernel is named, a library's or the
program's own launched through ``ctypes``.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import re
import sys
from typing import Callable

WINDOW = "esbench.window"
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    kind: str  # "kernel", "memcpy" or "memset"
    start_ns: int
    end_ns: int
    corr: int  # CUPTI correlation id, shared with the launch
    op: int  # correlation id of the CPU op it was queued under (0: none)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclasses.dataclass
class Trace:
    window: tuple[int, int]  # the window's (start, end) ns on the trace's clock
    device: list[DeviceOp]
    launches: dict[int, tuple[str, int]]  # corr -> (name, start ns on CUPTI's clock)
    op_names: dict[int, tuple[str, int, int]]  # CPU op correlation id -> (name, start, end)
    spans: dict[str, list[tuple[int, int]]]  # entry -> its calls' (start, end) ns
    counts: dict  # events by device type, for the record
    offset: int = 0  # the runtime calls' clock less the CPU ops' (ns): clock_offset()

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def in_window(self) -> list[DeviceOp]:
        lo, hi = self.window
        return [d for d in self.device if d.end_ns > lo and d.start_ns < hi]

    def kernels(self) -> list[DeviceOp]:
        return [d for d in self.in_window() if d.kind == "kernel"]

    def busy_s(self) -> float:
        """Seconds of the window in which any device op ran (the union)."""
        lo, hi = self.window
        busy, cur_s, cur_e = 0, None, None
        for s, e in sorted((max(d.start_ns, lo), min(d.end_ns, hi)) for d in self.in_window()):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy * 1e-9

    def top_ops(self, k: int = 10) -> list[list]:
        """The device ops that took the most time, summed by name."""
        tot: dict[str, float] = {}
        for d in self.in_window():
            tot[d.name] = tot.get(d.name, 0.0) + d.seconds
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The device's idle time in the window summed by what the host was
        launching when it ended: the CPU op (or runtime call) under which
        the op that ends each gap was queued."""
        lo, hi = self.window
        tot: dict[str, float] = {}
        last_end = lo
        for d in sorted(self.in_window(), key=lambda d: d.start_ns):
            if d.start_ns > last_end:
                label = (self.op_names.get(d.op) or self.launches.get(d.corr) or ("?",))[0]
                tot[label] = tot.get(label, 0.0) + (d.start_ns - last_end) * 1e-9
            last_end = max(last_end, d.end_ns)
        if hi > last_end:
            tot["(end of window)"] = tot.get("(end of window)", 0.0) + (hi - last_end) * 1e-9
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def launch_time(self, d: DeviceOp) -> int | None:
        """When the host queued ``d``, on the clock of the CPU ops and the
        spans: the start of the CPU op it was queued under, else (a launch
        through ``ctypes``, under no op) its runtime call moved onto that
        clock by ``offset``."""
        op = self.op_names.get(d.op)
        if op is not None:
            return op[1]
        launch = self.launches.get(d.corr)
        return None if launch is None else launch[1] - self.offset

    def calls(self, entry: str) -> list[list[DeviceOp]]:
        """The device ops of the window queued inside each call of
        ``entry``, call by call in time order."""
        spans = sorted(self.spans.get(entry, ()))
        starts = [s for s, _ in spans]
        out: list[list[DeviceOp]] = [[] for _ in spans]
        for d in self.in_window():
            t = self.launch_time(d)
            i = -1 if t is None else bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out[i].append(d)
        return out

    def under(self, entries) -> list[DeviceOp]:
        """The device ops of the window queued while a call to one of
        ``entries`` was running."""
        spans = sorted(s for e in entries for s in self.spans.get(e, ()))
        merged: list[list[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        starts = [m[0] for m in merged]
        out = []
        for d in self.in_window():
            t = self.launch_time(d)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= merged[i][1]:
                out.append(d)
        return out


def resolve(entry: str):
    """The code object of ``"module:qualname"``, or None where the program
    no longer has it (the metric that reads it then finds nothing)."""
    module, _, qualname = entry.partition(":")
    try:
        obj = importlib.import_module(module)
        for part in qualname.split("."):
            obj = getattr(obj, part)
    except (ImportError, AttributeError):
        return None
    return getattr(obj, "__code__", None)


class _Spans:
    """``record_function`` around each call of the watched functions, from
    ``sys.monitoring`` start and return events on their code alone."""

    def __init__(self, entries):
        self.codes = {}
        for e in entries:
            code = resolve(e)
            if code is not None:
                self.codes[code] = e
        self.open: list = []
        self.tool = None

    def __enter__(self):
        mon = sys.monitoring
        free = [i for i in (3, 4, 1, 0) if mon.get_tool(i) is None]
        if not self.codes or not free:
            return self
        self.tool = free[0]
        mon.use_tool_id(self.tool, "esbench")
        mon.register_callback(self.tool, mon.events.PY_START, self._start)
        mon.register_callback(self.tool, mon.events.PY_RETURN, self._return)
        for code in self.codes:
            mon.set_local_events(self.tool, code, mon.events.PY_START | mon.events.PY_RETURN)
        return self

    def _start(self, code, offset):
        from torch.autograd.profiler import record_function

        rf = record_function(self.codes[code])
        rf.__enter__()
        self.open.append(rf)

    def _return(self, code, offset, value):
        if self.open:
            self.open.pop().__exit__(None, None, None)

    def __exit__(self, *exc):
        if self.tool is None:
            return False
        mon = sys.monitoring
        for code in self.codes:
            mon.set_local_events(self.tool, code, 0)
        mon.register_callback(self.tool, mon.events.PY_START, None)
        mon.register_callback(self.tool, mon.events.PY_RETURN, None)
        mon.free_tool_id(self.tool)
        while self.open:  # a call that raised
            self.open.pop().__exit__(None, None, None)
        return False


def capture(fn: Callable[[], None], entries=()) -> Trace:
    """Run ``fn``, which ends in a ``torch.cuda.synchronize()``, under the
    profiler (the CPU's activity alone where there is no card), with spans
    around the calls of ``entries``, and read its events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=False) as prof:
        with record_function(WINDOW), _Spans(entries):
            fn()
    return read_events(prof.profiler.kineto_results.events(), entries)


def _get(e, name: str, default=None):
    f = getattr(e, name, None)
    if f is None:
        return default
    try:
        return f()
    except (RuntimeError, TypeError):
        return default


def read_events(events, entries=()) -> Trace:
    """A :class:`Trace` from the profiler's raw (kineto) events."""
    entries = set(entries)
    window = None
    device, launches, op_names, spans, counts = [], {}, {}, {}, {}
    for e in events:
        name = _get(e, "name", "")
        dev = str(_get(e, "device_type", "")).rsplit(".", 1)[-1]
        counts[dev] = counts.get(dev, 0) + 1
        start = int(_get(e, "start_ns", 0))
        end = _get(e, "end_ns", None)
        end = int(end) if end is not None else start + int(_get(e, "duration_ns", 0))
        corr = int(_get(e, "correlation_id", 0) or 0)
        if dev == "CUDA":
            # the annotations' copies on the device's timeline are not work
            if name == WINDOW or name in entries:
                continue
            low = name.lower()
            kind = "memcpy" if "memcpy" in low else "memset" if "memset" in low else "kernel"
            device.append(DeviceOp(name, kind, start, end, corr,
                                   int(_get(e, "linked_correlation_id", 0) or 0)))
        elif name == WINDOW:
            window = (start, end)
        elif name in entries:
            spans.setdefault(name, []).append((start, end))
        elif _RUNTIME.match(name):
            launches[corr] = (name, start)
        elif corr:
            op_names[corr] = (name, start, end)
    if window is None:
        lo = min((d.start_ns for d in device), default=0)
        window = (lo, max((d.end_ns for d in device), default=lo))
    trace = Trace(window, device, launches, op_names, spans, counts)
    trace.offset = clock_offset(trace)
    return trace


def clock_offset(trace: Trace) -> int:
    """The runtime calls' clock less the CPU ops' clock (ns), which the
    profiler converts apart.  A runtime call made inside a CPU op lies
    within that op's interval, so each such pair bounds the offset; this is
    the middle of the range that the most pairs allow."""
    edges = []
    for d in trace.device:
        op, launch = trace.op_names.get(d.op), trace.launches.get(d.corr)
        if op is not None and launch is not None:
            edges.append((launch[1] - op[2], 0))  # the least offset the pair allows
            edges.append((launch[1] - op[1], 1))  # the most
    edges.sort()
    best, depth, lo, hi = 0, 0, 0, 0
    for i, (x, kind) in enumerate(edges):
        depth += 1 if kind == 0 else -1
        if kind == 0 and depth > best:
            best, lo = depth, x
            hi = edges[i + 1][0] if i + 1 < len(edges) else x
    return (lo + hi) // 2
