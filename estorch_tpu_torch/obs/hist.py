"""Streaming histograms: the tail-latency truth the flat registry can't hold.

Counterpart of ``estorch_tpu/obs/hist.py`` (stdlib only): the same
quantiles, snapshots, exports and merges for the same observations.
Counters sum and gauges overwrite — both erase the *distribution*, and
at async scale the distribution IS the product: a straggler ruins 1% of
generations without moving any mean, and a gauge keeps whichever value
was written last, which is precisely the sample the tail lives in.  This
module is the stdlib answer:

* **fixed log-spaced bucket ladder** — buckets at ratio
  ``r = 10^(1/per_decade)`` from ``lo`` upward, plus an underflow bucket
  (≤ ``lo``) and a +Inf overflow bucket.  Two histograms built with the
  same parameters always share bucket edges, which is what makes them
  mergeable across threads, processes, and restarts without resampling;
* **exact small-N path** — the first ``exact_cap`` (default 256) raw
  observations are kept verbatim, so quantiles of a short run are
  *exact* (nearest-rank), not bucket-approximate.  Past the cap the raw
  list is dropped and quantiles come from the ladder;
* **documented error bound** — a bucket-path quantile is the geometric
  midpoint of its bucket, so for values inside ``[lo, hi]`` the relative
  error is at most ``sqrt(r) - 1`` (~10% at the default 12
  buckets/decade); ``quantile_error_bound()`` returns the conservative
  one-bucket bound ``r - 1`` that tests and the honesty gate use;
* **mergeable + serializable** — ``merge`` is associative and
  commutative on same-ladder histograms; ``to_dict``/``from_dict`` round
  trip through JSON (sparse counts), which is how histograms ride
  heartbeats and the sidecar's cross-restart ``counters.json``
  composition (:func:`merge_snapshots`);
* **inert when disabled** — :class:`NullHistograms` swallows observes,
  mirroring ``NullCounters``: engine code never branches on the hub's
  state, and the shared NULL_TELEMETRY default must not aggregate
  distributions across unrelated engines.

Deliberately stdlib-only and importable WITHOUT the package: the metrics
sidecar loads it by file path, like ``recorder.py``.
"""

from __future__ import annotations

import math
import threading

HIST_SCHEMA = 1

# default ladder: 10µs .. 10^3 s at 12 buckets/decade — spans queue
# waits (µs) through chaos-straggler stalls (minutes) with a ~10%
# geometric-midpoint quantile error (sqrt(10^(1/12)) - 1)
DEFAULT_LO = 1e-5
DEFAULT_DECADES = 8
DEFAULT_PER_DECADE = 12
DEFAULT_EXACT_CAP = 256
# per-bucket exemplar capacity: the last K trace ids observed into each
# bucket — enough to name a tail sample, small enough to ride every
# snapshot
DEFAULT_EXEMPLAR_K = 4


class Histogram:
    """One thread-safe streaming histogram (see module docstring)."""

    def __init__(self, lo: float = DEFAULT_LO,
                 decades: int = DEFAULT_DECADES,
                 per_decade: int = DEFAULT_PER_DECADE,
                 exact_cap: int = DEFAULT_EXACT_CAP):
        if lo <= 0:
            raise ValueError(f"lo must be > 0, got {lo}")
        if decades < 1 or per_decade < 1:
            raise ValueError(
                f"decades/per_decade must be >= 1, got {decades}/"
                f"{per_decade}")
        self.lo = float(lo)
        self.per_decade = int(per_decade)
        self.n = int(decades) * int(per_decade)  # finite upper edges
        self.exact_cap = int(exact_cap)
        self._lock = threading.Lock()
        # counts[0] = underflow (<= lo); counts[i] = (bound[i-1], bound[i]]
        # for 1 <= i <= n; counts[n+1] = overflow (> bound[n-1], i.e. +Inf)
        self._counts = [0] * (self.n + 2)
        self._count = 0
        self._sum = 0.0
        self._exact: list[float] | None = []
        # bucket index → last K exemplar trace ids (newest last); only
        # buckets that ever saw an exemplar have a key
        self._exemplars: dict[int, list[str]] = {}

    # ------------------------------------------------------------ ladder

    def bound(self, i: int) -> float:
        """Upper edge of finite bucket ``i`` (0 = the underflow edge
        ``lo``; ``i`` in [0, n])."""
        return self.lo * 10.0 ** (i / self.per_decade)

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        # ceil with a tiny epsilon so v == bound(k) lands in bucket k
        # (le semantics) despite float log noise
        e = math.log10(v / self.lo) * self.per_decade
        return min(self.n + 1, max(1, math.ceil(e - 1e-9)))

    def quantile_error_bound(self) -> float:
        """Conservative relative error of a bucket-path quantile for
        values inside the ladder: one full bucket ratio, ``r - 1``."""
        return 10.0 ** (1.0 / self.per_decade) - 1.0

    # ----------------------------------------------------------- observe

    def observe(self, value: float, n: int = 1,
                exemplar: str | None = None) -> None:
        """Record ``n`` observations of ``value`` (the weighted form
        serves per-batch costs shared by every coalesced request).
        ``exemplar`` attaches a trace id to the value's bucket — the
        last :data:`DEFAULT_EXEMPLAR_K` per bucket survive, so a tail
        bucket can NAME recent requests that landed in it."""
        v = float(value)
        if not math.isfinite(v) or n < 1:
            return
        i = self._index(v)
        with self._lock:
            self._counts[i] += n
            self._count += n
            self._sum += v * n
            if self._exact is not None:
                if self._count <= self.exact_cap:
                    self._exact.extend([v] * n)
                else:
                    self._exact = None  # past the cap: ladder-only
            if exemplar:
                ids = self._exemplars.setdefault(i, [])
                ids.append(str(exemplar))
                del ids[:-DEFAULT_EXEMPLAR_K]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    # ---------------------------------------------------------- quantile

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile: exact while the raw list survives
        (count ≤ exact_cap), else the geometric midpoint of the bucket
        holding the rank.  The overflow bucket has no upper edge, so a
        rank landing there returns the ladder's top edge — a documented
        UNDERestimate (size the ladder to the workload).  NaN when
        empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return float("nan")
            if self._exact is not None:
                s = sorted(self._exact)
                k = max(1, math.ceil(q * len(s)))
                return s[k - 1]
            k = max(1, math.ceil(q * self._count))
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= k:
                    break
            if i == 0:
                # underflow: midpoint half a bucket below lo
                return self.lo * 10.0 ** (-0.5 / self.per_decade)
            if i >= self.n + 1:
                return self.bound(self.n)
            return math.sqrt(self.bound(i - 1) * self.bound(i))

    # --------------------------------------------------------- exemplars

    def exemplars(self) -> dict[int, list[str]]:
        """Copy of the per-bucket exemplar ids (bucket index → newest
        last)."""
        with self._lock:
            return {i: list(ids) for i, ids in self._exemplars.items()
                    if ids}

    def slow_exemplars(self, q: float = 0.99) -> list[str]:
        """Exemplar trace ids from buckets AT OR ABOVE the bucket holding
        quantile ``q`` — slowest bucket first, newest first within a
        bucket, deduplicated.  How a p99 breach gets a NAME."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0 or not self._exemplars:
                return []
            k = max(1, math.ceil(q * self._count))
            cum = 0
            qi = len(self._counts) - 1
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= k:
                    qi = i
                    break
            out: list[str] = []
            for i in sorted(self._exemplars, reverse=True):
                if i < qi:
                    break
                for tid in reversed(self._exemplars[i]):
                    if tid not in out:
                        out.append(tid)
            return out

    # ------------------------------------------------------------- merge

    def _same_ladder(self, other: "Histogram") -> bool:
        return (self.lo == other.lo and self.per_decade == other.per_decade
                and self.n == other.n)

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into self (in place; returns self).  Raises on
        a ladder mismatch — bucket-wise addition across different edges
        would silently fabricate a distribution."""
        if not self._same_ladder(other):
            raise ValueError(
                f"ladder mismatch: (lo={self.lo}, per_decade="
                f"{self.per_decade}, n={self.n}) vs (lo={other.lo}, "
                f"per_decade={other.per_decade}, n={other.n})")
        with other._lock:
            o_counts = list(other._counts)
            o_count, o_sum = other._count, other._sum
            o_exact = None if other._exact is None else list(other._exact)
            o_ex = {i: list(ids) for i, ids in other._exemplars.items()}
        with self._lock:
            for i, c in enumerate(o_counts):
                self._counts[i] += c
            self._count += o_count
            self._sum += o_sum
            if (self._exact is not None and o_exact is not None
                    and self._count <= self.exact_cap):
                self._exact.extend(o_exact)
            else:
                self._exact = None
            for i, ids in o_ex.items():
                mine = self._exemplars.setdefault(i, [])
                mine.extend(ids)
                del mine[:-DEFAULT_EXEMPLAR_K]
        return self

    # --------------------------------------------------------- serialize

    def to_dict(self, compact: bool = False) -> dict:
        """JSON-able snapshot (sparse counts keyed by bucket index).

        ``compact`` drops the raw ``exact`` list — the shape heartbeats
        carry, where re-serializing up to ``exact_cap`` floats per hist
        on every beat would tax a hot path for a list only small-N
        quantile EXACTNESS (not correctness) needs; a compact snapshot
        round-trips as bucket-only, inside the documented bound."""
        with self._lock:
            return {
                "schema": HIST_SCHEMA,
                "lo": self.lo,
                "per_decade": self.per_decade,
                "n": self.n,
                "count": self._count,
                "sum": self._sum,
                "counts": {str(i): c for i, c in enumerate(self._counts)
                           if c},
                **({"exact": list(self._exact)}
                   if self._exact is not None and not compact else {}),
                # exemplars ride BOTH shapes: ≤ K short ids per touched
                # bucket is heartbeat-cheap, and the /traces scrape path
                # only ever sees compact snapshots
                **({"exemplars": {str(i): list(ids) for i, ids in
                                  self._exemplars.items() if ids}}
                   if self._exemplars else {}),
            }

    @classmethod
    def from_dict(cls, data: dict) -> "Histogram":
        if data.get("schema") != HIST_SCHEMA:
            raise ValueError(
                f"unknown histogram schema {data.get('schema')!r}")
        per_decade = int(data["per_decade"])
        n = int(data["n"])
        if n % per_decade:
            raise ValueError(f"n {n} not a multiple of per_decade "
                             f"{per_decade}")
        h = cls(lo=float(data["lo"]), decades=n // per_decade,
                per_decade=per_decade)
        for key, c in (data.get("counts") or {}).items():
            i = int(key)
            if not 0 <= i < len(h._counts):
                raise ValueError(f"bucket index {i} outside ladder")
            h._counts[i] = int(c)
        h._count = int(data.get("count", 0))
        h._sum = float(data.get("sum", 0.0))
        exact = data.get("exact")
        h._exact = ([float(x) for x in exact]
                    if isinstance(exact, list) else None)
        ex = data.get("exemplars")
        if isinstance(ex, dict):
            for key, ids in ex.items():
                try:
                    i = int(key)
                except (TypeError, ValueError):
                    continue
                if 0 <= i < len(h._counts) and isinstance(ids, list):
                    h._exemplars[i] = [str(x) for x in
                                       ids[-DEFAULT_EXEMPLAR_K:]]
        return h

    def to_export(self) -> dict:
        """The Prometheus-facing shape: CUMULATIVE ``(le, count)`` pairs
        (zero-delta interior edges elided; +Inf always present) + sum +
        count — what ``render_exposition(histograms=...)`` consumes."""
        with self._lock:
            buckets: list[tuple[float, int]] = []
            cum = 0
            for i, c in enumerate(self._counts):
                if i > self.n:
                    break
                cum += c
                if c:  # elide zero-delta edges: cumulative stays valid
                    buckets.append((self.bound(i), cum))
            buckets.append((math.inf, self._count))
            return {"buckets": buckets, "sum": self._sum,
                    "count": self._count}


class Histograms:
    """Name → :class:`Histogram` registry riding the telemetry hub.

    ``observe(name, value)`` creates the histogram on first use (ladder
    kwargs apply then only — later observes reuse the existing ladder);
    thread-safe like the counters registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: dict[str, Histogram] = {}

    def observe(self, name: str, value: float, n: int = 1,
                exemplar: str | None = None, **ladder) -> None:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram(**ladder))
        h.observe(value, n, exemplar=exemplar)

    def get(self, name: str) -> Histogram | None:
        return self._hists.get(name)

    def quantile(self, name: str, q: float) -> float | None:
        """Quantile of one histogram, or None when absent/empty."""
        h = self._hists.get(name)
        if h is None or h.count == 0:
            return None
        return h.quantile(q)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._hists)

    def snapshot(self, compact: bool = False) -> dict[str, dict]:
        """Point-in-time ``{name: to_dict()}`` — the heartbeat /
        cross-restart composition payload (``compact`` drops the exact
        lists; see :meth:`Histogram.to_dict`)."""
        with self._lock:
            hists = dict(self._hists)
        return {name: h.to_dict(compact=compact)
                for name, h in sorted(hists.items())}

    def export(self) -> dict[str, dict]:
        """``{name: to_export()}`` for the Prometheus encoder."""
        with self._lock:
            hists = dict(self._hists)
        return {name: h.to_export() for name, h in sorted(hists.items())}


class NullHistograms(Histograms):
    """Inert registry for disabled telemetry (the NullCounters rule:
    instrumented code observes unconditionally, a disabled hub
    swallows)."""

    def observe(self, name: str, value: float, n: int = 1,
                exemplar: str | None = None, **ladder) -> None:
        pass


# ---------------------------------------------------------------------
# snapshot-level helpers: the cross-restart composition primitives the
# sidecar and supervisor use on plain dicts (no live Histogram needed)
# ---------------------------------------------------------------------


def merge_snapshots(total: dict | None, snaps: dict | None) -> dict:
    """Bucket-wise fold of ``snaps`` (name → to_dict) into ``total``
    (same shape; returns a NEW dict).  A per-name ladder mismatch keeps
    whichever side carries more observations — cross-restart composition
    must degrade, never crash a scrape."""
    out = {name: dict(snap) for name, snap in (total or {}).items()}
    for name, snap in (snaps or {}).items():
        if not isinstance(snap, dict):
            continue
        if name not in out:
            out[name] = dict(snap)
            continue
        try:
            merged = Histogram.from_dict(out[name]).merge(
                Histogram.from_dict(snap))
            out[name] = merged.to_dict()
        except (ValueError, KeyError, TypeError):
            if int(snap.get("count", 0)) > int(out[name].get("count", 0)):
                out[name] = dict(snap)
    return out


def snapshot_from_export(series: dict,
                         lo: float = DEFAULT_LO,
                         per_decade: int = DEFAULT_PER_DECADE,
                         decades: int = DEFAULT_DECADES) -> dict | None:
    """Scraped Prometheus histogram series (``histogram_series`` shape:
    cumulative ``(le, count)`` pairs + sum + count) → a ``to_dict``
    snapshot on the given ladder, or None when the ``le`` edges are not
    this ladder's (a foreign histogram must not be resampled into a
    fabricated distribution — the fleet collector stores it as scalars
    only).  The inverse of :meth:`Histogram.to_export` modulo the elided
    zero-delta edges, which is what lets a collector that only ever saw
    the text exposition still merge windows with :func:`merge_snapshots`."""
    h = Histogram(lo=lo, decades=decades, per_decade=per_decade)
    buckets = series.get("buckets") or []
    prev_cum = 0
    for le, cum in buckets:
        if math.isinf(le):
            i = h.n + 1
        else:
            if le <= 0:
                return None
            e = math.log10(le / h.lo) * h.per_decade
            i = round(e)
            if not 0 <= i <= h.n or abs(h.bound(i) - le) > 1e-9 * le:
                return None  # not this ladder's edge
        delta = int(cum) - prev_cum
        if delta < 0:
            return None  # cumulative counts must not decrease
        prev_cum = int(cum)
        if delta:
            h._counts[i] += delta
    h._count = int(series.get("count") or prev_cum)
    h._sum = float(series.get("sum") or 0.0)
    h._exact = None  # the exposition never carries raw samples
    return h.to_dict()


def export_snapshots(snaps: dict | None) -> dict[str, dict]:
    """Snapshot dicts → Prometheus export shape; unparseable entries are
    skipped (a foreign/hand-edited file must not take the scrape down)."""
    out: dict[str, dict] = {}
    for name, snap in (snaps or {}).items():
        try:
            out[name] = Histogram.from_dict(snap).to_export()
        except (ValueError, KeyError, TypeError):
            continue
    return out


# ---------------------------------------------------------------------
# selfcheck: the histogram math's gate (`obs hist --selfcheck`)
# ---------------------------------------------------------------------


def selfcheck(render=None, parse=None) -> list[str]:
    """Prove the histogram math ([] = healthy):

    * exact small-N path: quantiles of ≤ exact_cap observations are
      nearest-rank EXACT;
    * known-distribution bucket path: p50/p95/p99 of a deterministic
      exponential sample within the documented ``r - 1`` error bound of
      the offline exact quantiles;
    * merge associativity + all-at-once equivalence (bucket counts,
      count, sum, quantiles);
    * cross-restart composition round trip: to_dict → JSON →
      merge_snapshots equals the directly-merged histogram;
    * (when the CLI passes the prometheus encoder/parser) export →
      render → parse round trip preserves the +Inf count.
    """
    import json as _json
    import random

    problems: list[str] = []

    # ---- exact small-N -------------------------------------------------
    rng = random.Random(0)
    small = [rng.uniform(1e-4, 1e-1) for _ in range(100)]
    h = Histogram()
    for v in small:
        h.observe(v)
    s = sorted(small)
    for q in (0.5, 0.95, 0.99):
        exact = s[max(1, math.ceil(q * len(s))) - 1]
        if h.quantile(q) != exact:
            problems.append(f"small-N p{q * 100:g} {h.quantile(q)} != "
                            f"exact {exact}")

    # ---- known distribution, bucket path ------------------------------
    big = [rng.expovariate(1 / 0.01) for _ in range(5000)]
    hb = Histogram()
    for v in big:
        hb.observe(v)
    if hb._exact is not None:
        problems.append("5000 observations did not overflow the exact cap")
    sb = sorted(big)
    bound = hb.quantile_error_bound()
    for q in (0.5, 0.95, 0.99):
        exact = sb[max(1, math.ceil(q * len(sb))) - 1]
        got = hb.quantile(q)
        rel = abs(got - exact) / exact
        if rel > bound:
            problems.append(
                f"bucket-path p{q * 100:g} off by {rel:.1%} "
                f"(> documented bound {bound:.1%}): {got} vs exact {exact}")

    # ---- merge associativity ------------------------------------------
    parts = [big[0::3], big[1::3], big[2::3]]
    hs = []
    for part in parts:
        hh = Histogram()
        for v in part:
            hh.observe(v)
        hs.append(hh)

    def build(vals):
        hh = Histogram()
        for v in vals:
            hh.observe(v)
        return hh

    left = build(parts[0]).merge(build(parts[1])).merge(build(parts[2]))
    right = build(parts[2]).merge(build(parts[1])).merge(build(parts[0]))
    if left._counts != right._counts or left.count != right.count:
        problems.append("merge is not associative/commutative on counts")
    if not math.isclose(left.sum, right.sum, rel_tol=1e-9):
        problems.append("merge is not associative on sums")
    if left._counts != hb._counts or left.count != hb.count:
        problems.append("merged thirds != all-at-once histogram")
    for q in (0.5, 0.99):
        if left.quantile(q) != hb.quantile(q):
            problems.append(f"merged p{q * 100:g} != all-at-once")

    # ---- cross-restart composition round trip -------------------------
    snap_a = {"lat": hs[0].to_dict()}
    snap_b = {"lat": hs[1].to_dict()}
    composed = merge_snapshots(_json.loads(_json.dumps(snap_a)),
                               _json.loads(_json.dumps(snap_b)))
    direct = build(parts[0]).merge(build(parts[1]))
    back = Histogram.from_dict(composed["lat"])
    if back._counts != direct._counts or back.count != direct.count:
        problems.append("cross-restart snapshot composition != direct "
                        "merge")
    if back.quantile(0.99) != direct.quantile(0.99):
        problems.append("composed snapshot p99 != direct merge p99")
    # ladder mismatch must degrade (keep the bigger side), not raise
    odd = {"lat": Histogram(lo=1e-3).to_dict()}
    try:
        kept = merge_snapshots(snap_a, odd)["lat"]
        if kept["count"] != snap_a["lat"]["count"]:
            problems.append("ladder-mismatch compose dropped the bigger "
                            "side")
    except ValueError:
        problems.append("ladder-mismatch compose raised instead of "
                        "degrading")

    # ---- exposition round trip (CLI passes the prometheus half) -------
    if render is not None and parse is not None:
        body = render({}, None, up=True,
                      histograms={"lat": hb.to_export()})
        try:
            samples = parse(body)
        except ValueError as e:
            problems.append(f"histogram exposition did not parse: {e}")
        else:
            inf_rows = [v for name, labels, v in samples
                        if name == "estorch_lat_bucket"
                        and labels.get("le") == "+Inf"]
            if inf_rows != [float(hb.count)]:
                problems.append(
                    f"+Inf bucket {inf_rows} != count {hb.count}")
            counts = [v for name, _l, v in samples
                      if name == "estorch_lat_count"]
            if counts != [float(hb.count)]:
                problems.append(f"_count sample {counts} != {hb.count}")
    return problems
