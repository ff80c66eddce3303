"""``obs regress`` — a statistical perf gate over committed baselines.

Counterpart of ``estorch_tpu/obs/export/regress.py`` (stdlib only): the
same verdicts for the same inputs, and one more platform, ``gpu``.
Compare a current measurement (a run JSONL, a bench output line, or a
bench A/B JSONL) against a baseline (the ``BENCH_*.json`` schema, or
another run's JSONL) and emit a machine-readable verdict.

Single runs on a loaded host swing far more than any effect worth
gating on, so verdicts compare **robust medians**, and the pass/fail
threshold is a **noise band learned from the repeats themselves** — the
scaled median-absolute-deviation of whichever side carries repeats
(per-generation rates in a run JSONL, per-repeat rows in a bench
artifact), floored at ``min_band_pct`` so a suspiciously quiet sample
cannot manufacture false alarms.  A drop beyond the band is a
regression; a gain beyond it is reported as an improvement (still exit
0 — the gate is one-sided by design).

Accepted measurement files (auto-detected per line):

* ``BENCH_r*.json``     — ``{"parsed": {"metric", "value", ...}}``
* bench stdout line     — ``{"metric", "value", ...}``
* bench A/B JSONL rows  — ``{"label", "rate", ...}`` (``--label``
  filters; rows with null rate are skipped)
* run JSONL records     — ``{"generation", "env_steps_per_sec", ...}``
  (supervisor-replayed generations are deduped, keeping the last)

Two safeguards beyond the aggregate gate:

* **platform guard** — a measurement that records its platform (the
  ``device_probe`` extras BENCH artifacts carry, a ``platform`` key, or
  the platform noted in the unit string: ``cpu``, ``tpu`` or ``gpu``) is
  refused against a baseline from a DIFFERENT platform: a card run
  "regressing" against a TPU or CPU baseline is a platform mismatch, not
  a perf verdict, so it raises ``ValueError`` and gives none;
* **phase localization** (``obs regress --phases``, ``compare_phases``)
  — per-phase medians of the span seconds every record carries
  (``record["phases"]``), each gated by its own learned noise band, so
  the verdict names the phase that moved (``eval`` got 30% slower)
  instead of drowning a localized regression in aggregate host-load
  noise.
"""

from __future__ import annotations

import json
import math

DEFAULT_MIN_BAND_PCT = 5.0
REGRESS_SCHEMA = 1


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return float("nan")
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _noise_band_pct(xs: list[float]) -> float:
    """Relative noise of one sample set as a percentage of its median:
    1.4826·MAD/median (the robust sigma estimate) — 0 when there are
    fewer than 3 repeats to learn from."""
    if len(xs) < 3:
        return 0.0
    med = _median(xs)
    if not med or not math.isfinite(med):
        return 0.0
    mad = _median([abs(x - med) for x in xs])
    return 100.0 * 1.4826 * mad / abs(med)


def extract_samples(lines: list[dict], label: str | None = None
                    ) -> tuple[list[float], str]:
    """(samples, metric name) from parsed measurement lines (see module
    docstring for the accepted shapes).  Raises ValueError when nothing
    usable is found — a gate that silently passes on an empty file is
    worse than no gate."""
    samples: list[float] = []
    metric = "env_steps_per_sec"
    gen_last: dict[int, float] = {}  # replay dedup: last occurrence wins
    order: list[int] = []
    for row in lines:
        if not isinstance(row, dict):
            continue
        if label is not None and row.get("label") not in (None, label):
            continue
        parsed = row.get("parsed")
        if isinstance(parsed, dict) and isinstance(
                parsed.get("value"), (int, float)):
            samples.append(float(parsed["value"]))
            metric = str(parsed.get("metric", metric))
        elif isinstance(row.get("value"), (int, float)) and "metric" in row:
            samples.append(float(row["value"]))
            metric = str(row["metric"])
        elif isinstance(row.get("rate"), (int, float)):
            samples.append(float(row["rate"]))
            metric = "rate"
        elif isinstance(row.get("env_steps_per_sec"), (int, float)):
            g = row.get("generation")
            if isinstance(g, int):
                if g not in gen_last:
                    order.append(g)
                gen_last[g] = float(row["env_steps_per_sec"])
            else:
                samples.append(float(row["env_steps_per_sec"]))
    samples.extend(gen_last[g] for g in order)
    samples = [s for s in samples if math.isfinite(s)]
    if not samples:
        raise ValueError(
            "no usable samples (expected BENCH_*.json 'parsed.value', a "
            "bench {'metric','value'} line, {'rate'} rows, or run-JSONL "
            "'env_steps_per_sec' records)")
    return samples, metric


def load_rows(path: str) -> list[dict]:
    """The raw parsed rows of one measurement file: whole-file JSON
    first (BENCH_*.json is an indented object), then JSONL with a
    tolerated truncated FINAL line (crash artifact); garbage earlier in
    the file is an error, as is an empty file."""
    with open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty file")
    try:
        return [json.loads(text)]
    except ValueError:
        rows: list[dict] = []
        for i, ln in enumerate(lines):
            try:
                rows.append(json.loads(ln))
            except ValueError as e:
                if i == len(lines) - 1:
                    break  # truncated tail: a crash mid-append
                raise ValueError(f"{path} line {i + 1}: {e}") from e
        return rows


def load_measurement(path: str, label: str | None = None
                     ) -> tuple[list[float], str]:
    """Read one measurement file (JSON object or JSONL) into samples —
    :func:`load_rows`'s tolerance rules, then :func:`extract_samples`."""
    rows = load_rows(path)  # its errors already carry the path
    try:
        return extract_samples(rows, label=label)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e


def compare(current: list[float], baseline: list[float],
            metric: str = "rate",
            min_band_pct: float = DEFAULT_MIN_BAND_PCT) -> dict:
    """Median-vs-median verdict with a learned noise band.

    ``verdict``: ``"pass"`` | ``"regress"``; ``drop_pct`` is positive
    when the current measurement is slower than the baseline.
    """
    cur_med = _median(current)
    base_med = _median(baseline)
    band = max(float(min_band_pct),
               _noise_band_pct(current), _noise_band_pct(baseline))
    drop = ((base_med - cur_med) / base_med * 100.0) if base_med else 0.0
    verdict = "regress" if drop > band else "pass"
    return {
        "schema": REGRESS_SCHEMA,
        "verdict": verdict,
        "metric": metric,
        "current_median": round(cur_med, 3),
        "baseline_median": round(base_med, 3),
        "drop_pct": round(drop, 2),
        "band_pct": round(band, 2),
        "n_current": len(current),
        "n_baseline": len(baseline),
        "improved": drop < -band,
    }


def measurement_platform(rows: list[dict]) -> str | None:
    """The platform a measurement was taken on, when it says: the typed
    ``extras.device_probe.platform`` new BENCH artifacts carry, a bare
    ``platform`` key (stage rows), or — legacy artifacts — the platform
    noted in the unit string (``"..., cpu)"`` / ``"..., gpu)"`` / the old
    cpu-fallback prose).  None when nothing states it (run JSONLs
    don't)."""
    for row in rows:
        if not isinstance(row, dict):
            continue
        for holder in (row, row.get("extras") or {}):
            if not isinstance(holder, dict):
                continue
            probe = holder.get("device_probe")
            if isinstance(probe, dict) and probe.get("platform"):
                return str(probe["platform"])
            if isinstance(holder.get("platform"), str):
                return holder["platform"]
        parsed = row.get("parsed")
        unit = (parsed or {}).get("unit") if isinstance(parsed, dict) \
            else row.get("unit")
        if isinstance(unit, str):
            low = unit.lower()
            if "cpu fallback" in low or "cpu)" in low or ", cpu" in low:
                return "cpu"
            if "tpu)" in low or ", tpu" in low:
                return "tpu"
            if "gpu)" in low or ", gpu" in low:
                return "gpu"
    return None


def ensure_same_platform(cur_platform: str | None,
                         base_platform: str | None,
                         cur_what: str = "current",
                         base_what: str = "baseline") -> None:
    """Raise when both sides state a platform and they differ — a
    platform mismatch is an ERROR, not a verdict: a card measurement
    "regressing" against a TPU baseline says nothing about performance,
    and a bogus verdict would gate on it.  The ONE guard shared by
    ``compare_files`` and ``compare_tail_files``."""
    if cur_platform and base_platform and cur_platform != base_platform:
        raise ValueError(
            f"platform mismatch: {cur_what} was measured on "
            f"{cur_platform!r} but {base_what} on {base_platform!r} — "
            "perf verdicts only mean something within one platform "
            "(re-baseline, or pass a same-platform artifact)")


def compare_files(current_path: str, baseline_path: str,
                  label: str | None = None,
                  min_band_pct: float = DEFAULT_MIN_BAND_PCT) -> dict:
    cur_rows = load_rows(current_path)
    base_rows = load_rows(baseline_path)
    cur_platform = measurement_platform(cur_rows)
    base_platform = measurement_platform(base_rows)
    ensure_same_platform(cur_platform, base_platform,
                         cur_what=f"current {current_path}",
                         base_what=f"baseline {baseline_path}")
    try:
        cur, metric = extract_samples(cur_rows, label=label)
    except ValueError as e:
        raise ValueError(f"{current_path}: {e}") from e
    try:
        base, base_metric = extract_samples(base_rows, label=label)
    except ValueError as e:
        raise ValueError(f"{baseline_path}: {e}") from e
    out = compare(cur, base, metric=metric, min_band_pct=min_band_pct)
    if base_metric != metric:
        out["warning"] = (f"metric mismatch: current={metric!r} "
                          f"baseline={base_metric!r}")
    if cur_platform or base_platform:
        out["platform"] = cur_platform or base_platform
    return out


# ---------------------------------------------------------------------
# phase-localized gate: per-phase medians with per-phase noise bands
# ---------------------------------------------------------------------

def expand_embedded_rows(rows: list[dict]) -> list[dict]:
    """BENCH_r06+ artifacts carry their per-generation phase records and
    per-request latency rows EMBEDDED (``phase_rows`` / ``tail_rows``
    lists), so one committed JSON file is both the aggregate baseline
    and the phase/tail baseline.  This flattens them for the phase and
    tail extractors; the aggregate extractor deliberately does NOT
    expand (embedded per-generation rates are per-host, the headline
    ``parsed.value`` is per-chip — mixing units would corrupt the
    median)."""
    out: list[dict] = []
    for row in rows:
        if not isinstance(row, dict):
            continue
        out.append(row)
        for key in ("phase_rows", "tail_rows"):
            sub = row.get(key)
            if isinstance(sub, list):
                out.extend(r for r in sub if isinstance(r, dict))
    return out


def extract_phase_samples(records: list[dict]) -> dict[str, list[float]]:
    """Per-generation seconds for every TOP-LEVEL phase across a run's
    records (``record["phases"]``; nested ``parent/child`` spans are the
    parent's internal breakdown and are not separately gated).
    Supervisor-replayed generations are deduped keeping the last, the
    same rule the aggregate extractor applies."""
    gen_last: dict[tuple, dict] = {}
    order: list[tuple] = []
    anon: list[dict] = []
    for row in expand_embedded_rows(records):
        if not isinstance(row.get("phases"), dict):
            continue
        g = row.get("generation")
        if isinstance(g, int):
            # replay dedup is per measurement run: embedded baseline rows
            # carry a 'repeat' stamp (bench --capture-baseline), and
            # collapsing generation g across repeats would silently drop
            # all but the last repeat's samples
            key = (row.get("repeat"), g)
            if key not in gen_last:
                order.append(key)
            gen_last[key] = row["phases"]
        else:
            anon.append(row["phases"])
    out: dict[str, list[float]] = {}
    for phases in [gen_last[g] for g in order] + anon:
        for name, dur in phases.items():
            if (isinstance(dur, (int, float)) and not isinstance(dur, bool)
                    and math.isfinite(dur) and "/" not in name):
                out.setdefault(name, []).append(float(dur))
    return out


def compare_phases(current: list[dict], baseline: list[dict],
                   min_band_pct: float = DEFAULT_MIN_BAND_PCT) -> dict:
    """Phase-localized verdict over two runs' records: each shared
    top-level phase's median SECONDS gated by that phase's own learned
    noise band — the verdict names the phase(s) that slowed instead of
    drowning them in the aggregate.  Phases are durations, so here a
    regression is the current median coming out ABOVE the band (slower),
    the mirror of the rate gate's below."""
    cur_phases = extract_phase_samples(current)
    base_phases = extract_phase_samples(baseline)
    # mixed-schema degrade: a side with NO phase rows at all (a pre-r06
    # BENCH artifact, or a telemetry-off run) gets a one-line diagnosis
    # naming the side — not a traceback, and never a bogus verdict
    if not base_phases or not cur_phases:
        side = "baseline" if not base_phases else "current"
        raise ValueError(
            f"{side} measurement carries no per-phase rows — a pre-r06 "
            "BENCH artifact (no embedded 'phase_rows') or a "
            "telemetry-disabled run; pick a baseline captured with "
            "`bench.py --capture-baseline` (BENCH_r06+) or a run JSONL "
            "with 'phases' records")
    shared = sorted(set(cur_phases) & set(base_phases))
    if not shared:
        raise ValueError(
            "no shared top-level phases between the two runs (phase "
            "names disjoint — different engines or renamed spans?)")
    phases: dict[str, dict] = {}
    regressed: list[str] = []
    for name in shared:
        cur, base = cur_phases[name], base_phases[name]
        cur_med, base_med = _median(cur), _median(base)
        band = max(float(min_band_pct),
                   _noise_band_pct(cur), _noise_band_pct(base))
        slowdown = ((cur_med - base_med) / base_med * 100.0) if base_med \
            else 0.0
        verdict = "regress" if slowdown > band else "pass"
        if verdict == "regress":
            regressed.append(name)
        phases[name] = {
            "verdict": verdict,
            "current_median_s": round(cur_med, 6),
            "baseline_median_s": round(base_med, 6),
            "slowdown_pct": round(slowdown, 2),
            "band_pct": round(band, 2),
            "improved": slowdown < -band,
            "n_current": len(cur),
            "n_baseline": len(base),
        }
    return {
        "schema": REGRESS_SCHEMA,
        "verdict": "regress" if regressed else "pass",
        "metric": "phase_seconds",
        "phases": phases,
        "regressed_phases": regressed,
    }


def compare_phase_files(current_path: str, baseline_path: str,
                        min_band_pct: float = DEFAULT_MIN_BAND_PCT) -> dict:
    try:
        return compare_phases(load_rows(current_path),
                              load_rows(baseline_path),
                              min_band_pct=min_band_pct)
    except ValueError as e:
        raise ValueError(f"{current_path} vs {baseline_path}: {e}") from e


# ---------------------------------------------------------------------
# tail gate: p99-vs-p99 with its own learned MAD band
# ---------------------------------------------------------------------
#
# Medians can't see the 1% of requests a shed or a recompile ruins: a
# 5× slowdown on 1% of samples moves p50 by ~nothing and p99 by ~5×.
# ``obs regress --tail`` gates a chosen upper quantile per GROUP (phase
# of a run JSONL, endpoint of a latency JSONL) against the baseline's
# same quantile, with a noise band learned from the quantile estimator
# itself: each side is split into k deterministic interleaved
# subsamples, the quantile computed per subsample, and the band is the
# scaled MAD of those estimates — a tail quantile is far noisier than a
# median, and gating it against the MEDIAN's band would cry wolf.
# Verdicts NAME the quantile and the group ("p99 of 'eval'").

TAIL_QUANTILE = 0.99
TAIL_FOLDS = 5


def _quantile(xs: list[float], q: float) -> float:
    """Nearest-rank quantile (the loadgen/hist convention)."""
    s = sorted(xs)
    if not s:
        return float("nan")
    k = max(1, math.ceil(q * len(s)))
    return s[k - 1]


def _tail_band_pct(xs: list[float], q: float,
                   folds: int = TAIL_FOLDS) -> float:
    """Relative noise of the ``q``-quantile ESTIMATOR on this sample:
    scaled MAD of the quantile across ``folds`` deterministic
    interleaved subsamples, as a percentage of their median.  0 when
    there are too few samples to subsample (the floor then rules)."""
    if len(xs) < folds * 4:
        return 0.0
    qs = [_quantile(xs[i::folds], q) for i in range(folds)]
    med = _median(qs)
    if not med or not math.isfinite(med):
        return 0.0
    mad = _median([abs(x - med) for x in qs])
    return 100.0 * 1.4826 * mad / abs(med)


def extract_tail_groups(rows: list[dict]) -> dict[str, list[float]]:
    """Per-group duration samples for the tail gate.

    Two row shapes, combinable: latency rows (``{"latency_s": x,
    "endpoint": "/predict"}`` — the loadgen ``--latencies-out`` format)
    group by endpoint; run-JSONL generation records contribute their
    top-level phase seconds (replay-deduped, like the phase gate) plus a
    ``wall_time_s`` group."""
    groups: dict[str, list[float]] = {}
    # extract_phase_samples expands embedded rows ITSELF — it must see
    # the original rows, or the still-embedded copies inside the outer
    # row would be walked twice and double-count generation-less records
    for name, samples in extract_phase_samples(rows).items():
        groups.setdefault(name, []).extend(samples)
    expanded = expand_embedded_rows(rows)
    for row in expanded:
        v = row.get("latency_s")
        if (isinstance(v, (int, float)) and not isinstance(v, bool)
                and math.isfinite(v)):
            name = str(row.get("endpoint") or "latency")
            groups.setdefault(name, []).append(float(v))
    # wall_time_s follows the same replay-dedup rule as the phase
    # samples above: a supervisor-replayed generation appears twice in
    # the JSONL and must not be double-weighted in the quantile (but a
    # different 'repeat' is a different measurement run, not a replay)
    gen_last: dict[tuple, float] = {}
    order: list[tuple] = []
    anon: list[float] = []
    for r in expanded:
        w = r.get("wall_time_s")
        if (not isinstance(w, (int, float)) or isinstance(w, bool)
                or not math.isfinite(w)):
            continue
        g = r.get("generation")
        if isinstance(g, int):
            key = (r.get("repeat"), g)
            if key not in gen_last:
                order.append(key)
            gen_last[key] = float(w)
        else:
            anon.append(float(w))
    walls = [gen_last[g] for g in order] + anon
    if walls:
        groups.setdefault("wall_time_s", []).extend(walls)
    return groups


def compare_tail(current: list[dict], baseline: list[dict],
                 quantile: float = TAIL_QUANTILE,
                 min_band_pct: float = DEFAULT_MIN_BAND_PCT) -> dict:
    """Tail verdict over two measurements' rows: each shared group's
    ``quantile`` gated by that group's own learned quantile-estimator
    MAD band (durations: ABOVE the band = regress).  Each group also
    reports its p50 verdict under the median machinery, so "median
    passed, p99 regressed" is one artifact."""
    if not 0.5 <= quantile < 1.0:
        raise ValueError(f"tail quantile must be in [0.5, 1), got "
                         f"{quantile}")
    cur_groups = extract_tail_groups(current)
    base_groups = extract_tail_groups(baseline)
    # mixed-schema degrade (same contract as compare_phases): an empty
    # side is diagnosed on one line naming the side and the fix
    if not base_groups or not cur_groups:
        side = "baseline" if not base_groups else "current"
        raise ValueError(
            f"{side} measurement carries no tail rows — a pre-r06 BENCH "
            "artifact (no embedded 'phase_rows'/'tail_rows') or a "
            "measurement without {'latency_s','endpoint'} / "
            "'phases'/'wall_time_s' records; re-capture with `bench.py "
            "--capture-baseline` or `loadgen --latencies-out`")
    shared = sorted(set(cur_groups) & set(base_groups))
    if not shared:
        raise ValueError(
            "no shared tail groups between the two measurements (group "
            "names disjoint — different endpoints or renamed phases?)")
    qname = f"p{quantile * 100:g}"
    groups: dict[str, dict] = {}
    regressed: list[str] = []
    for name in shared:
        cur, base = cur_groups[name], base_groups[name]
        cur_q, base_q = _quantile(cur, quantile), _quantile(base, quantile)
        band = max(float(min_band_pct),
                   _tail_band_pct(cur, quantile),
                   _tail_band_pct(base, quantile))
        slowdown = ((cur_q - base_q) / base_q * 100.0) if base_q else 0.0
        verdict = "regress" if slowdown > band else "pass"
        if verdict == "regress":
            regressed.append(name)
        cur_med, base_med = _median(cur), _median(base)
        med_band = max(float(min_band_pct),
                       _noise_band_pct(cur), _noise_band_pct(base))
        med_slow = ((cur_med - base_med) / base_med * 100.0) if base_med \
            else 0.0
        groups[name] = {
            "verdict": verdict,
            "quantile": qname,
            "current_q_s": round(cur_q, 6),
            "baseline_q_s": round(base_q, 6),
            "slowdown_pct": round(slowdown, 2),
            "band_pct": round(band, 2),
            "improved": slowdown < -band,
            "median_verdict": ("regress" if med_slow > med_band
                               else "pass"),
            "current_median_s": round(cur_med, 6),
            "baseline_median_s": round(base_med, 6),
            "median_slowdown_pct": round(med_slow, 2),
            "n_current": len(cur),
            "n_baseline": len(base),
        }
    return {
        "schema": REGRESS_SCHEMA,
        "verdict": "regress" if regressed else "pass",
        "metric": "tail_seconds",
        "quantile": qname,
        "groups": groups,
        "regressed_groups": regressed,
    }


def compare_tail_files(current_path: str, baseline_path: str,
                       quantile: float = TAIL_QUANTILE,
                       min_band_pct: float = DEFAULT_MIN_BAND_PCT) -> dict:
    cur_rows = load_rows(current_path)
    base_rows = load_rows(baseline_path)
    # same platform guard as the aggregate gate: a cpu-fallback artifact
    # "tail-regressing" against a TPU baseline is a platform mismatch,
    # not a verdict
    ensure_same_platform(measurement_platform(cur_rows),
                         measurement_platform(base_rows),
                         cur_what=f"current {current_path}",
                         base_what=f"baseline {baseline_path}")
    try:
        return compare_tail(cur_rows, base_rows,
                            quantile=quantile, min_band_pct=min_band_pct)
    except ValueError as e:
        raise ValueError(f"{current_path} vs {baseline_path}: {e}") from e


def tail_selfcheck() -> list[str]:
    """The gate for the tail gate (``regress --tail --selfcheck``; [] =
    healthy): a
    median-clean / p99-regressed pair — 2% of requests slowed 5×, the
    chaos-shed signature — must PASS every group's median verdict but be
    FLAGGED by the tail verdict, naming the quantile and the group; an
    identical-distribution rerun must pass; the latency-row file round
    trip must agree with the in-memory path."""
    import os
    import random
    import tempfile

    problems: list[str] = []

    def lat_rows(seed: int, n: int = 2000, slow_every: int = 0
                 ) -> list[dict]:
        rng = random.Random(seed)
        rows = []
        for i in range(n):
            v = 0.010 * (1.0 + rng.uniform(-0.02, 0.02))
            if slow_every and i % slow_every == 0:
                v *= 5.0  # the 5x chaos slowdown on ~2% of requests
            rows.append({"endpoint": "/predict", "latency_s": v})
        return rows

    base = lat_rows(0)
    clean = compare_tail(lat_rows(1), base)
    if clean["verdict"] != "pass":
        problems.append(f"same-distribution rerun flagged: {clean}")
    tainted = compare_tail(lat_rows(2, slow_every=50), base)
    g = tainted["groups"].get("/predict", {})
    if tainted["verdict"] != "regress" or "/predict" not in \
            tainted["regressed_groups"]:
        problems.append(f"5x-on-2% tail regression not flagged: {tainted}")
    if tainted.get("quantile") != "p99" or g.get("quantile") != "p99":
        problems.append(f"verdict does not NAME the quantile: {tainted}")
    if g.get("median_verdict") != "pass":
        problems.append(
            f"median verdict should stay clean on a tail-only regression "
            f"(the whole point): {g}")

    # run-JSONL form: 1-in-50 generations' eval phase slowed 5x — the
    # median phase gate passes, the tail gate names 'eval'
    def gen_rows(seed: int, slow_every: int = 0) -> list[dict]:
        rng = random.Random(seed)
        rows = []
        for gdx in range(100):
            ev = 0.100 * (1.0 + rng.uniform(-0.02, 0.02))
            if slow_every and gdx % slow_every == 0:
                ev *= 5.0
            up = 0.020 * (1.0 + rng.uniform(-0.02, 0.02))
            rows.append({"generation": gdx, "wall_time_s": ev + up,
                         "env_steps_per_sec": 1000.0,
                         "phases": {"eval": ev, "update": up}})
        return rows

    base_g = gen_rows(3)
    cur_g = gen_rows(4, slow_every=50)
    med = compare_phases(cur_g, base_g)
    if med["verdict"] != "pass":
        problems.append(f"median phase gate flagged a tail-only "
                        f"regression: {med}")
    tail = compare_tail(cur_g, base_g)
    if "eval" not in tail["regressed_groups"]:
        problems.append(f"tail gate missed the eval-phase p99: {tail}")
    if "update" in tail["regressed_groups"]:
        problems.append(f"tail gate flagged the untouched update phase: "
                        f"{tail}")

    # supervisor-replayed generations must be deduped in EVERY group,
    # wall_time_s included (double-weighted duplicates skew the p99)
    replayed = base_g + [dict(base_g[0])]
    gg = extract_tail_groups(replayed)
    if len(gg["wall_time_s"]) != 100 or len(gg["eval"]) != 100:
        problems.append(
            f"replayed generation double-weighted in tail groups: "
            f"wall={len(gg['wall_time_s'])} eval={len(gg['eval'])}")

    # file round trip (the CLI path)
    with tempfile.TemporaryDirectory() as d:
        cur_path = os.path.join(d, "cur.jsonl")
        base_path = os.path.join(d, "base.jsonl")
        for path, rows in ((cur_path, lat_rows(2, slow_every=50)),
                           (base_path, base)):
            with open(path, "w") as f:
                for row in rows:
                    f.write(json.dumps(row) + "\n")
        v = compare_tail_files(cur_path, base_path)
        if (v["verdict"] != "regress"
                or v["regressed_groups"] != ["/predict"]):
            problems.append(f"file round trip disagreed: {v}")
        # cross-platform artifacts are an ERROR, never a tail verdict
        # (the same guard the aggregate gate applies)
        cpu_path = os.path.join(d, "cpu.jsonl")
        with open(cpu_path, "w") as f:
            f.write(json.dumps({"platform": "cpu"}) + "\n")
            for row in lat_rows(8):
                f.write(json.dumps(row) + "\n")
        tpu_path = os.path.join(d, "tpu.jsonl")
        with open(tpu_path, "w") as f:
            f.write(json.dumps({"platform": "tpu"}) + "\n")
            for row in base:
                f.write(json.dumps(row) + "\n")
        try:
            v = compare_tail_files(cpu_path, tpu_path)
            problems.append(f"cpu-vs-tpu tail comparison produced a "
                            f"verdict instead of a platform-mismatch "
                            f"error: {v}")
        except ValueError as e:
            if "platform mismatch" not in str(e):
                problems.append(f"cpu-vs-tpu tail error lacks the "
                                f"platform-mismatch diagnosis: {e}")
    return problems


# ---------------------------------------------------------------------
# selfcheck: the gate for the gate (`regress --selfcheck`)
# ---------------------------------------------------------------------

def selfcheck() -> list[str]:
    """Prove the gate can tell signal from noise ([] = healthy):

    * an identical-run comparison (same samples both sides) passes;
    * a same-distribution rerun (fresh ±2% noise) passes;
    * a 30% slowdown injected into a copied baseline is flagged;
    * the file round trip (BENCH-style baseline vs run-JSONL current)
      produces the same verdicts the in-memory path does.
    """
    import os
    import random
    import tempfile

    problems: list[str] = []

    def synth(seed: int, scale: float = 1.0, n: int = 12) -> list[float]:
        rng = random.Random(seed)
        return [1000.0 * scale * (1.0 + rng.uniform(-0.02, 0.02))
                for _ in range(n)]

    base = synth(0)
    same = compare(list(base), list(base))
    if same["verdict"] != "pass" or abs(same["drop_pct"]) > 1e-9:
        problems.append(f"identical-run comparison did not pass: {same}")
    rerun = compare(synth(1), base)
    if rerun["verdict"] != "pass":
        problems.append(f"same-distribution rerun flagged as regression: "
                        f"{rerun}")
    slow = compare(synth(2, scale=0.70), base)
    if slow["verdict"] != "regress" or slow["drop_pct"] < 20.0:
        problems.append(f"30% injected slowdown not flagged: {slow}")
    fast = compare(synth(3, scale=1.30), base)
    if fast["verdict"] != "pass" or not fast["improved"]:
        problems.append(f"30% speedup misreported: {fast}")

    with tempfile.TemporaryDirectory() as d:
        # committed-baseline schema (a copied BENCH_*.json with the
        # synthetic slowdown injected into the current side)
        base_path = os.path.join(d, "BENCH_base.json")
        with open(base_path, "w") as f:
            json.dump({"n": 1, "rc": 0, "parsed": {
                "metric": "env_steps_per_sec_per_chip",
                "value": 1000.0, "unit": "env-steps/s/chip"}}, f)

        def write_run(path: str, rates: list[float]) -> None:
            with open(path, "w") as f:
                for g, r in enumerate(rates):
                    f.write(json.dumps({
                        "generation": g, "env_steps_per_sec": r,
                        "env_steps": 1000, "wall_time_s": 1000 / r,
                        "reward_mean": 0.0, "reward_max": 0.0,
                        "best_reward": 0.0}) + "\n")

        clean_path = os.path.join(d, "clean.jsonl")
        write_run(clean_path, synth(4))
        v = compare_files(clean_path, base_path)
        if v["verdict"] != "pass":
            problems.append(f"clean run vs committed baseline failed: {v}")
        slow_path = os.path.join(d, "slow.jsonl")
        write_run(slow_path, synth(5, scale=0.70))
        v = compare_files(slow_path, base_path)
        if v["verdict"] != "regress":
            problems.append(f"slowed run vs committed baseline passed: {v}")
        # a replayed generation (supervisor restart) must be deduped, not
        # averaged in twice
        with open(clean_path, "a") as f:
            f.write(json.dumps({"generation": 0,
                                "env_steps_per_sec": 1.0}) + "\n")
        cur, _ = load_measurement(clean_path)
        if len(cur) != 12:
            problems.append(f"replay dedup kept {len(cur)} samples, not 12")
        if min(cur) != 1.0:
            problems.append("replay dedup did not keep the LAST occurrence")
        # truncated tail (crash artifact) tolerated; empty file is an error
        with open(clean_path, "a") as f:
            f.write('{"generation": 99, "env_ste')
        try:
            load_measurement(clean_path)
        except ValueError as e:
            problems.append(f"truncated tail not tolerated: {e}")
        empty = os.path.join(d, "empty.jsonl")
        open(empty, "w").close()
        empty_raised = False
        try:
            load_measurement(empty)
        except ValueError:
            empty_raised = True
        if not empty_raised:
            problems.append("empty measurement file did not raise")
        # platform guard: a cpu-fallback artifact against a TPU baseline
        # must be a platform-mismatch ERROR, never a verdict
        tpu_base = os.path.join(d, "BENCH_tpu.json")
        with open(tpu_base, "w") as f:
            json.dump({"parsed": {"metric": "env_steps_per_sec_per_chip",
                                  "value": 5e6,
                                  "unit": "env-steps/s/chip (pendulum, "
                                          "tpu)"}}, f)
        cpu_cur = os.path.join(d, "BENCH_cpu.json")
        with open(cpu_cur, "w") as f:
            json.dump({"parsed": {"metric": "env_steps_per_sec_per_chip",
                                  "value": 4e4, "unit": "env-steps/s/chip"},
                       "extras": {"device_probe": {"status": "failed",
                                                   "platform": "cpu"}}}, f)
        try:
            v = compare_files(cpu_cur, tpu_base)
            problems.append(f"cpu-vs-tpu comparison produced a verdict "
                            f"instead of a platform-mismatch error: {v}")
        except ValueError as e:
            if "platform mismatch" not in str(e):
                problems.append(f"cpu-vs-tpu error lacks the platform-"
                                f"mismatch diagnosis: {e}")
    return problems
