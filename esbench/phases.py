"""The program's own ranges in a traced window, and the card's idle time
split by what the host was doing.

Under a profiler the port opens ranges named ``estorch.<phase>`` on the
CPU's timeline (``estorch_tpu_torch/obs/trace.py``): ``sample``, ``eval``,
``rank`` and ``update`` a generation, ``forward`` and ``step`` an env step,
and the hub's ``dispatch``, ``device``, ``host_sync`` and ``record``.  They
are CPU ops with correlation ids, so :func:`esbench.trace.read_events`
keeps them in ``Trace.op_names``; a program without them (an older commit)
has none, and the metrics that read them find nothing.
"""

from __future__ import annotations

import bisect

EVAL = "estorch.eval"
STEP = "estorch.step"


def ranges(trace, name: str) -> list[tuple[int, int]]:
    """The ranges ``name`` of the trace, (start, end) ns on the CPU ops'
    clock, sorted and merged where they overlap."""
    merged: list[list[int]] = []
    for s, e in sorted((s, e) for n, s, e in trace.op_names.values() if n == name):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_intervals(trace) -> list[tuple[int, int]]:
    """The window's stretches in which no kernel, memcpy or memset ran on
    the card: the window less the union ``Trace.busy_s`` sums."""
    lo, hi = trace.window
    gaps, last = [], lo
    for s, e in sorted((max(d.start_ns, lo), min(d.end_ns, hi)) for d in trace.in_window()):
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if hi > last:
        gaps.append((last, hi))
    return gaps


def overlap_ns(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def rollout_idle_ns(trace) -> int | None:
    """The card's idle ns in the window while the host was inside an
    ``estorch.eval`` range (moved onto the device's clock by
    ``Trace.offset``), or None where the trace has no such range."""
    evals = ranges(trace, EVAL)
    if not evals:
        return None
    shifted = [(s + trace.offset, e + trace.offset) for s, e in evals]
    return overlap_ns(idle_intervals(trace), shifted)


def launched_inside(trace, ops, spans: list[tuple[int, int]]) -> list:
    """The ops of ``ops`` whose launch (``Trace.launch_time``) lies inside
    one of the sorted, disjoint ``spans``."""
    starts = [s for s, _ in spans]
    out = []
    for d in ops:
        t = trace.launch_time(d)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            out.append(d)
    return out
