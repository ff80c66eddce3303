"""Streaming histograms: the distributions that counters and gauges erase.

Counterpart of the parts of ``estorch_tpu/obs/hist.py`` the hub and the
async scheduler use (stdlib only):

* a fixed log-spaced bucket ladder, ratio ``r = 10^(1/per_decade)`` from
  ``lo`` upward, with an underflow bucket (≤ ``lo``) and an overflow
  bucket;
* an exact small-N path: the first ``exact_cap`` observations are kept
  verbatim and quantiles of a short run are exact (nearest rank); past
  the cap a quantile is the geometric midpoint of its bucket, within
  ``r - 1`` relative inside the ladder;
* ``to_dict`` snapshots (sparse counts) in the JAX package's schema 1, the
  shape the heartbeat carries, and :func:`merge_snapshots`, the
  bucket-wise fold with which the supervisor sums its children's.

Quantiles equal the JAX package's for the same observations.
"""

from __future__ import annotations

import math
import threading

HIST_SCHEMA = 1

# the default ladder: 10 µs .. 10^3 s at 12 buckets a decade
DEFAULT_LO = 1e-5
DEFAULT_DECADES = 8
DEFAULT_PER_DECADE = 12
DEFAULT_EXACT_CAP = 256


class Histogram:
    """One thread-safe streaming histogram (see the module docstring)."""

    def __init__(self, lo: float = DEFAULT_LO, decades: int = DEFAULT_DECADES,
                 per_decade: int = DEFAULT_PER_DECADE, exact_cap: int = DEFAULT_EXACT_CAP):
        if lo <= 0:
            raise ValueError(f"lo must be > 0, got {lo}")
        if decades < 1 or per_decade < 1:
            raise ValueError(f"decades/per_decade must be >= 1, got {decades}/{per_decade}")
        self.lo = float(lo)
        self.per_decade = int(per_decade)
        self.n = int(decades) * int(per_decade)  # finite upper edges
        self.exact_cap = int(exact_cap)
        self._lock = threading.Lock()
        # counts[0] underflow (<= lo); counts[i] (bound(i-1), bound(i)] for
        # 1 <= i <= n; counts[n+1] overflow
        self._counts = [0] * (self.n + 2)
        self._count = 0
        self._sum = 0.0
        self._exact: list[float] | None = []

    def bound(self, i: int) -> float:
        """Upper edge of finite bucket ``i`` (0 is the underflow edge ``lo``)."""
        return self.lo * 10.0 ** (i / self.per_decade)

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        # the epsilon puts v == bound(k) in bucket k despite log rounding
        e = math.log10(v / self.lo) * self.per_decade
        return min(self.n + 1, max(1, math.ceil(e - 1e-9)))

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``n`` observations of ``value``; non-finite values are dropped."""
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
                    self._exact = None  # past the cap: the ladder alone

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile: exact while the raw list survives, else
        the geometric midpoint of the rank's bucket (the overflow bucket
        returns the ladder's top edge, an underestimate).  NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return float("nan")
            if self._exact is not None:
                s = sorted(self._exact)
                return s[max(1, math.ceil(q * len(s))) - 1]
            k = max(1, math.ceil(q * self._count))
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= k:
                    break
            if i == 0:
                return self.lo * 10.0 ** (-0.5 / self.per_decade)
            if i >= self.n + 1:
                return self.bound(self.n)
            return math.sqrt(self.bound(i - 1) * self.bound(i))

    def to_dict(self, compact: bool = False) -> dict:
        """JSON-able snapshot, sparse counts keyed by bucket index;
        ``compact`` drops the raw list (quantiles stay within the bound)."""
        with self._lock:
            out = {"schema": HIST_SCHEMA, "lo": self.lo, "per_decade": self.per_decade,
                   "n": self.n, "count": self._count, "sum": self._sum,
                   "counts": {str(i): c for i, c in enumerate(self._counts) if c}}
            if self._exact is not None and not compact:
                out["exact"] = list(self._exact)
            return out


    def _same_ladder(self, other: "Histogram") -> bool:
        return (self.lo, self.per_decade, self.n) == (other.lo, other.per_decade, other.n)

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into self (in place; returns self).  Raises on a
        ladder mismatch: bucket-wise addition across different edges would
        make a distribution up."""
        if not self._same_ladder(other):
            raise ValueError(
                f"ladder mismatch: (lo={self.lo}, per_decade={self.per_decade}, n={self.n}) "
                f"vs (lo={other.lo}, per_decade={other.per_decade}, n={other.n})")
        with other._lock:
            o_counts, o_count, o_sum = list(other._counts), other._count, other._sum
            o_exact = None if other._exact is None else list(other._exact)
        with self._lock:
            for i, c in enumerate(o_counts):
                self._counts[i] += c
            self._count += o_count
            self._sum += o_sum
            if self._exact is not None and o_exact is not None \
                    and self._count <= self.exact_cap:
                self._exact.extend(o_exact)
            else:
                self._exact = None
        return self

    @classmethod
    def from_dict(cls, data: dict) -> "Histogram":
        if data.get("schema") != HIST_SCHEMA:
            raise ValueError(f"unknown histogram schema {data.get('schema')!r}")
        per_decade, n = int(data["per_decade"]), int(data["n"])
        if n % per_decade:
            raise ValueError(f"n {n} not a multiple of per_decade {per_decade}")
        h = cls(lo=float(data["lo"]), decades=n // per_decade, per_decade=per_decade)
        for key, c in (data.get("counts") or {}).items():
            i = int(key)
            if not 0 <= i < len(h._counts):
                raise ValueError(f"bucket index {i} outside ladder")
            h._counts[i] = int(c)
        h._count = int(data.get("count", 0))
        h._sum = float(data.get("sum", 0.0))
        exact = data.get("exact")
        h._exact = [float(x) for x in exact] if isinstance(exact, list) else None
        return h


def merge_snapshots(total: dict | None, snaps: dict | None) -> dict:
    """Bucket-wise fold of ``snaps`` (name → ``to_dict``) into ``total``, as
    a new dict.  A ladder mismatch keeps the side with more observations:
    a fold across restarts degrades, it never raises."""
    out = {name: dict(snap) for name, snap in (total or {}).items()}
    for name, snap in (snaps or {}).items():
        if not isinstance(snap, dict):
            continue
        if name not in out:
            out[name] = dict(snap)
            continue
        try:
            out[name] = Histogram.from_dict(out[name]).merge(Histogram.from_dict(snap)).to_dict()
        except (ValueError, KeyError, TypeError):
            if int(snap.get("count", 0)) > int(out[name].get("count", 0)):
                out[name] = dict(snap)
    return out


class Histograms:
    """Name → :class:`Histogram` registry riding the hub; ``observe``
    creates a histogram at first use, with the ladder kwargs of that call."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: dict[str, Histogram] = {}

    def observe(self, name: str, value: float, n: int = 1, **ladder) -> None:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram(**ladder))
        h.observe(value, n)

    def get(self, name: str) -> Histogram | None:
        return self._hists.get(name)

    def quantile(self, name: str, q: float) -> float | None:
        """Quantile of one histogram, or None when it is absent or empty."""
        h = self._hists.get(name)
        if h is None or h.count == 0:
            return None
        return h.quantile(q)

    def snapshot(self, compact: bool = False) -> dict[str, dict]:
        """``{name: to_dict()}``: what the heartbeat carries."""
        with self._lock:
            hists = dict(self._hists)
        return {name: h.to_dict(compact=compact) for name, h in sorted(hists.items())}


class NullHistograms(Histograms):
    """Inert registry of a disabled hub (the ``NullCounters`` rule)."""

    def observe(self, name: str, value: float, n: int = 1, **ladder) -> None:
        pass
