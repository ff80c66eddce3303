"""Local append-only time-series store for the fleet collector.

Every telemetry surface before this one answered a POINT-IN-TIME
question: a `/metrics` scrape, a heartbeat read, one run JSONL.  Fleet
decisions — "is this replica's p99 burning its SLO", "did that target
stop beating five ticks ago" — need *history*, so the collector lands
every scrape here and the rules engine / dash query the store, never a
live endpoint.

Layout (``<root>/``):

* ``seg-<NNNNNNNN>.jsonl`` — windowed segments, oldest index lowest.
  Line 1 is a header ``{"schema", "segment", "opened_ts"}``; every other
  line is one sample ``{"ts", "name", "labels", "value"}`` or — for
  histogram series — ``{"ts", "name", "labels", "hist": <to_dict>}``
  (the ``obs/hist.py`` snapshot shape, so windows merge with
  ``merge_snapshots`` instead of being resampled).
* the CURRENT segment is rewritten whole via tmp+``os.replace`` on every
  commit — a reader (dash, rules, a human with ``jq``) never sees a torn
  line, the same contract as the heartbeat;
* a segment rolls when it holds ``segment_max_samples`` samples or spans
  ``segment_window_s`` seconds; retention keeps the newest
  ``max_segments`` and unlinks the rest — disk use is bounded by
  construction, not by an operator remembering to prune.

Query API (reader side — works on a store some OTHER process writes):

* :meth:`SeriesStore.range` — raw ``(ts, labels, value)`` samples of one
  metric over a window, labels subset-matched;
* :meth:`SeriesStore.latest` — last sample per distinct label set;
* :meth:`SeriesStore.increase` / :meth:`SeriesStore.rate` — counter
  delta over a window with RESET DETECTION (a restart drops a counter to
  ~0; the increase since the reset still counts, Prometheus-style);
* :meth:`SeriesStore.hist_window` / :meth:`SeriesStore.quantile` —
  histogram-backed quantiles over stored history: snapshots are
  cumulative-since-process-start, so within a window the latest snapshot
  per series rules, and a detected restart (count decreased) folds the
  pre-restart snapshot in via ``merge_snapshots`` — the cross-restart
  composition rule the sidecar already proved, applied to the fleet.

Deliberately stdlib-only and importable WITHOUT the package (the
collector file-loads it beside itself, like the sidecar loads
``recorder.py``) — fleet observability must outlive a wedged CUDA
context.
"""

from __future__ import annotations

import json
import math
import os

if __package__:
    from ..hist import Histogram, merge_snapshots
else:  # file-run: collector.py already file-loaded hist as a sibling
    import importlib.util as _ilu

    _spec = _ilu.spec_from_file_location(
        "_estorch_torch_obs_hist",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     os.pardir, "hist.py"))
    _hist = _ilu.module_from_spec(_spec)
    _spec.loader.exec_module(_hist)
    Histogram = _hist.Histogram
    merge_snapshots = _hist.merge_snapshots

STORE_SCHEMA = 1
SEGMENT_PREFIX = "seg-"
DEFAULT_MAX_SEGMENTS = 12
DEFAULT_SEGMENT_MAX_SAMPLES = 20000
DEFAULT_SEGMENT_WINDOW_S = 300.0


def _subtract_snapshots(last: dict, anchor: dict | None) -> dict:
    """Bucket-wise ``last - anchor`` for cumulative histogram snapshots
    (the windowed-delta primitive).  No anchor → the whole snapshot.  A
    ladder mismatch or unparseable anchor degrades to the whole snapshot
    (an overcount, never a fabricated distribution); negative deltas
    clamp at 0 (clock skew / torn anchors must not go negative).  The
    raw ``exact`` list never survives subtraction — the delta is
    ladder-only, inside the documented bound."""
    if anchor is None:
        return last
    try:
        h_last = Histogram.from_dict(last)
        h_anchor = Histogram.from_dict(anchor)
        if not h_last._same_ladder(h_anchor):
            return last
    except (ValueError, KeyError, TypeError):
        return last
    h_last._counts = [max(0, a - b) for a, b in
                      zip(h_last._counts, h_anchor._counts)]
    h_last._count = sum(h_last._counts)
    h_last._sum = max(0.0, h_last.sum - h_anchor.sum)
    h_last._exact = None
    # exemplars survive only in buckets the window actually touched — a
    # bucket whose in-window delta is zero must not keep naming a trace
    # id from before the window
    h_last._exemplars = {i: ids for i, ids in h_last._exemplars.items()
                         if h_last._counts[i] > 0}
    return h_last.to_dict()


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def _matches(labels: dict, want: dict | None) -> bool:
    if not want:
        return True
    return all(str(labels.get(k)) == str(v) for k, v in want.items())


class SeriesStore:
    """One store root; writer methods and reader methods are independent
    (a read-only consumer just never calls :meth:`append`)."""

    def __init__(self, root: str, *,
                 max_segments: int = DEFAULT_MAX_SEGMENTS,
                 segment_max_samples: int = DEFAULT_SEGMENT_MAX_SAMPLES,
                 segment_window_s: float = DEFAULT_SEGMENT_WINDOW_S):
        if max_segments < 1 or segment_max_samples < 1:
            raise ValueError("max_segments and segment_max_samples must "
                             "be >= 1")
        self.root = os.path.abspath(root)
        self.max_segments = int(max_segments)
        self.segment_max_samples = int(segment_max_samples)
        self.segment_window_s = float(segment_window_s)
        # writer state: the current segment lives in memory and is
        # committed whole on every append batch (bounded by
        # segment_max_samples, so the rewrite stays cheap)
        self._seg_index: int | None = None
        self._seg_opened_ts: float = 0.0
        self._seg_lines: list[str] = []
        self._seg_samples: int = 0
        # reader cache: path -> (mtime_ns, size, parsed rows).  Rules
        # evaluate R×T queries per tick and the dash ~7 per target per
        # frame; re-JSON-parsing every retained segment for each query
        # would scale the collector's CPU with fleet size squared.  A
        # sealed segment never changes; the current one changes
        # (mtime, size) on every commit and re-parses then.
        self._read_cache: dict[str, tuple[int, int, list[dict]]] = {}

    # ------------------------------------------------------------ paths

    def _seg_path(self, index: int) -> str:
        return os.path.join(self.root, f"{SEGMENT_PREFIX}{index:08d}.jsonl")

    def segments(self) -> list[str]:
        """Retained segment paths, oldest first."""
        try:
            names = sorted(
                n for n in os.listdir(self.root)
                if n.startswith(SEGMENT_PREFIX) and n.endswith(".jsonl"))
        except OSError:
            return []
        return [os.path.join(self.root, n) for n in names]

    # ----------------------------------------------------------- writer

    def _next_index(self) -> int:
        segs = self.segments()
        if not segs:
            return 0
        tail = os.path.basename(segs[-1])[len(SEGMENT_PREFIX):-len(".jsonl")]
        try:
            return int(tail) + 1
        except ValueError:
            return len(segs)

    def _open_segment(self, ts: float) -> None:
        self._seg_index = self._next_index()
        self._seg_opened_ts = float(ts)
        self._seg_lines = [json.dumps({
            "schema": STORE_SCHEMA, "segment": self._seg_index,
            "opened_ts": float(ts)})]
        self._seg_samples = 0

    def _commit(self) -> None:
        os.makedirs(self.root, exist_ok=True)
        path = self._seg_path(self._seg_index)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(self._seg_lines) + "\n")
        os.replace(tmp, path)

    def _enforce_retention(self) -> None:
        segs = self.segments()
        for path in segs[:max(0, len(segs) - self.max_segments)]:
            try:
                os.remove(path)
            except OSError:
                continue  # another pruner won the race: goal state holds

    def append(self, samples: list[dict], ts: float) -> None:
        """Commit one batch of samples stamped ``ts`` (one collection
        tick).  Each sample: ``{"name", "labels", "value"}`` or
        ``{"name", "labels", "hist": <to_dict snapshot>}``."""
        ts = float(ts)
        rolled = False
        if self._seg_index is None:
            self._open_segment(ts)
        elif (self._seg_samples >= self.segment_max_samples
              or ts - self._seg_opened_ts >= self.segment_window_s):
            self._commit()  # seal the finished segment before rolling
            self._open_segment(ts)
            rolled = True
        for s in samples:
            row = {"ts": ts, "name": str(s["name"]),
                   "labels": dict(s.get("labels") or {})}
            if "hist" in s:
                row["hist"] = s["hist"]
            else:
                v = s.get("value")
                if not isinstance(v, (int, float)) or isinstance(v, bool) \
                        or not math.isfinite(v):
                    continue
                row["value"] = float(v)
            self._seg_lines.append(json.dumps(row, default=float))
            self._seg_samples += 1
        self._commit()
        if rolled:
            # prune AFTER the fresh current segment exists on disk, so
            # the retained count never exceeds max_segments even
            # transiently between commits
            self._enforce_retention()

    # ----------------------------------------------------------- reader

    def _segment_rows(self, path: str) -> list[dict]:
        """Parsed sample rows of one segment, memoized on (mtime, size);
        torn/garbage lines are skipped (a reader must never choke on a
        segment some other process is mid-rewrite on)."""
        try:
            st = os.stat(path)
            key = (st.st_mtime_ns, st.st_size)
            cached = self._read_cache.get(path)
            if cached is not None and cached[:2] == key:
                return cached[2]
            with open(path) as f:
                text = f.read()
        except OSError:
            self._read_cache.pop(path, None)
            return []
        rows: list[dict] = []
        for ln in text.splitlines():
            if not ln.strip():
                continue
            try:
                row = json.loads(ln)
            except ValueError:
                continue
            if not isinstance(row, dict) or "name" not in row:
                continue  # header or foreign line
            if isinstance(row.get("ts"), (int, float)):
                rows.append(row)
        self._read_cache[path] = (key[0], key[1], rows)
        return rows

    def _iter_rows(self, since_ts: float):
        """Samples with ts >= since_ts across retained segments, oldest
        first."""
        live = set()
        for path in self.segments():
            live.add(path)
            for row in self._segment_rows(path):
                if row["ts"] >= since_ts:
                    yield row
        for path in list(self._read_cache):
            if path not in live:  # pruned segment: drop its cache too
                del self._read_cache[path]

    def range(self, name: str, labels: dict | None = None,
              window_s: float = 60.0, now: float | None = None
              ) -> list[tuple[float, dict, float]]:
        """``(ts, labels, value)`` scalar samples of ``name`` in the
        window, oldest first; ``labels`` is a subset match."""
        if now is None:
            raise ValueError("range() needs an explicit now= timestamp")
        out = []
        for row in self._iter_rows(now - float(window_s)):
            if row["name"] != name or "value" not in row:
                continue
            if _matches(row.get("labels") or {}, labels):
                out.append((float(row["ts"]), row.get("labels") or {},
                            float(row["value"])))
        out.sort(key=lambda t: t[0])
        return out

    def latest(self, name: str, labels: dict | None = None,
               window_s: float = 60.0, now: float | None = None
               ) -> dict[tuple, tuple[float, dict, float]]:
        """Last sample per distinct full label set in the window."""
        out: dict[tuple, tuple[float, dict, float]] = {}
        for ts, lab, v in self.range(name, labels, window_s, now):
            out[_labels_key(lab)] = (ts, lab, v)
        return out

    def label_values(self, name: str, label: str,
                     window_s: float = 60.0, now: float | None = None
                     ) -> list[str]:
        """Distinct values one label takes on ``name`` samples in the
        window (how the dash discovers targets from the store alone)."""
        vals = set()
        for _ts, lab, _v in self.range(name, None, window_s, now):
            if label in lab:
                vals.add(str(lab[label]))
        return sorted(vals)

    def increase(self, name: str, labels: dict | None = None,
                 window_s: float = 60.0, now: float | None = None
                 ) -> float | None:
        """Counter increase over the window, reset-aware: per series,
        positive deltas accumulate; a drop (process restart zeroed the
        counter) contributes the post-reset value instead of a bogus
        negative.  None when the metric has NO sample in the window —
        "never reported" and "reported, delta 0" are different verdicts
        (the dash renders the former as ``-``)."""
        per_series: dict[tuple, float] = {}
        total = 0.0
        seen = False
        for _ts, lab, v in self.range(name, labels, window_s, now):
            seen = True
            key = _labels_key(lab)
            if key in per_series:
                prev = per_series[key]
                total += (v - prev) if v >= prev else v
            per_series[key] = v
        return total if seen else None

    def rate(self, name: str, labels: dict | None = None,
             window_s: float = 60.0, now: float | None = None) -> float:
        inc = self.increase(name, labels, window_s, now)
        return (inc or 0.0) / float(window_s)

    # ------------------------------------------------------- histograms

    def hist_series(self, name: str, labels: dict | None,
                    window_s: float, now: float | None):
        """``(series key, ts, snapshot)`` triples in ts order for
        histogram samples of ``name`` in the window."""
        if now is None:
            raise ValueError("hist_series() needs an explicit now=")
        for row in self._iter_rows(now - float(window_s)):
            if row["name"] != name or not isinstance(row.get("hist"), dict):
                continue
            if _matches(row.get("labels") or {}, labels):
                yield (_labels_key(row.get("labels") or {}),
                       float(row["ts"]), row["hist"])

    def hist_window(self, name: str, labels: dict | None = None,
                    window_s: float = 60.0, now: float | None = None
                    ) -> Histogram | None:
        """The merged histogram of observations MADE IN the window, or
        None.

        Snapshots are cumulative per source process, so a window's
        distribution is a DELTA: per series and per process incarnation
        (a count drop marks a restart), the last in-window snapshot
        minus the last snapshot from BEFORE the window — without the
        subtraction, a long-dead latency spike would sit in every short
        window forever and a burn-rate alert could never resolve.  A
        restart mid-window folds the buried incarnation's in-window
        delta in via ``merge_snapshots``; a ladder change between
        anchor and snapshot degrades to the whole snapshot (overcount,
        never a fabricated distribution)."""
        if now is None:
            raise ValueError("hist_window() needs an explicit now=")
        start = float(now) - float(window_s)
        # per series: the current incarnation's pre-window anchor +
        # last in-window snapshot, plus finished contributions
        anchor: dict[tuple, dict] = {}
        last_in: dict[tuple, dict] = {}
        prev: dict[tuple, dict] = {}
        contributions: list[dict] = []

        def finalize(key: tuple, buried: bool = False) -> None:
            last = last_in.pop(key, None)
            if last is not None:
                contrib = _subtract_snapshots(last, anchor.get(key))
                if buried and "exemplars" in contrib:
                    # a restart invalidated the source process's trace
                    # rings — its exemplar ids name traces nobody can
                    # assemble anymore, and they must NOT resurrect
                    # into the merged window
                    contrib = {k: v for k, v in contrib.items()
                               if k != "exemplars"}
                contributions.append(contrib)
            anchor.pop(key, None)

        for key, ts, snap in self.hist_series(name, labels,
                                              float(now), now):
            if ts > float(now):
                continue
            p = prev.get(key)
            if p is not None and int(snap.get("count", 0)) < int(
                    p.get("count", 0)):
                finalize(key, buried=True)  # restart: close buried incarnation
            prev[key] = snap
            if ts <= start:
                anchor[key] = snap
            else:
                last_in[key] = snap
        for key in list(last_in):
            finalize(key)
        total: dict | None = None
        for snap in contributions:
            total = merge_snapshots(total, {"_": snap})
        if not total or "_" not in total:
            return None
        try:
            return Histogram.from_dict(total["_"])
        except (ValueError, KeyError, TypeError):
            return None

    def quantile(self, name: str, q: float, labels: dict | None = None,
                 window_s: float = 60.0, now: float | None = None
                 ) -> float | None:
        h = self.hist_window(name, labels, window_s, now)
        if h is None or h.count == 0:
            return None
        return h.quantile(q)
