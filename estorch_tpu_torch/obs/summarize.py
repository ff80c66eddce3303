"""Run-JSONL summarizer: per-phase time share, throughput trend, stalls.

Counterpart of ``estorch_tpu/obs/summarize.py`` (stdlib only, the port's
own copy); ``python -m estorch_tpu_torch.obs summarize run.jsonl``
answers:

1. where the time goes: each phase's share of the spans the records
   carry (top-level phases; a nested ``parent/child`` span is listed under
   its parent);
2. whether the run slows down: env-steps/s of the first half against the
   second;
3. whether it stalled: generations whose wall time is a large multiple of
   the median, and (``--heartbeat``) the last phase and age of a run that
   never finished;
4. what it survived: the resilience counters, and the supervisor's
   restarts from the manifest's ``resilience`` section;
5. the barrier-free scheduler's accounting (records with an ``async``
   block, ``algo/scheduler.py``);
6. how each scenario variant fares (records with a ``scenarios`` block,
   ``scenarios/fitness.py``): count-weighted per-variant means, run-best
   bests, coverage, and a WORST-VARIANT callout for a variant whose mean
   lags the family median by more than ``SCENARIO_MAD_FACTOR`` times the
   cross-variant MAD.

For the same records it gives the JAX package's summary dict, but for the
JAX package's serving section (a policy server's request counters read
from its heartbeat), not ported yet (ROADMAP.md port item 9c).  ``--selfcheck`` holds the
golden record against the schema and the pipeline against synthetic runs.
"""

from __future__ import annotations

import json
import math

from .recorder import STALE_AFTER_S, read_heartbeat

# record schema: key -> (types, required).  Floats accept ints (JSON
# writes 1.0 back as 1); NaN and inf are legal values (failed generations).
# The keys are the JAX package's, so its records validate here too.
RECORD_SCHEMA: dict[str, tuple[tuple[type, ...], bool]] = {
    "generation": ((int,), True),
    "reward_max": ((float, int), True),
    "reward_mean": ((float, int), True),
    "reward_min": ((float, int), False),
    "n_failed": ((int,), False),
    "best_reward": ((float, int), True),
    "improved_best": ((bool,), False),
    "env_steps": ((int,), True),
    "env_steps_per_sec": ((float, int), True),
    "grad_norm": ((float, int), False),
    "sigma": ((float, int), False),
    "wall_time_s": ((float, int), True),
    "phases": ((dict,), False),
    "compile_events": ((list,), False),
    "cost_model": ((dict,), False),
    "async": ((dict,), False),
    "scenarios": ((dict,), False),
}

# the integer accounting an ``async`` block carries (consumed = fresh +
# folded, discards counted)
ASYNC_REQUIRED_KEYS = ("consumed", "fresh", "folded", "stale_discarded")

# a record shaped as the port's pooled engine emits it (ES._base_record
# and its spans): the selfcheck's fixture
GOLDEN_RECORD = {
    "generation": 0,
    "reward_max": -120.5,
    "reward_mean": -400.25,
    "reward_min": -800.0,
    "n_failed": 0,
    "best_reward": -120.5,
    "improved_best": True,
    "env_steps": 819200,
    "env_steps_per_sec": 512000.0,
    "grad_norm": 0.731,
    "sigma": 0.05,
    "wall_time_s": 1.6,
    "phases": {"sample": 0.01, "eval": 1.2, "update": 0.3, "update/obsnorm_merge": 0.05},
}

STALL_FACTOR = 5.0  # a generation this many times the median wall time stalls

# the async queue wait's tail callout: p99/p50 beyond this ratio and p99
# above this floor (the histogram clamps sub-10 µs waits, so a fast fold
# loop can show a large ratio of a sub-millisecond p99)
TAIL_RATIO_THRESHOLD = 10.0
TAIL_P99_FLOOR_S = 0.05

# the WORST-VARIANT callout: a variant whose run-level mean lags the
# family median by more than this many cross-variant MADs (one scenario
# systematically losing inside a healthy-looking family mean)
SCENARIO_MAD_FACTOR = 2.0

# counters surfaced when nonzero: the evidence that a run survived faults
RESILIENCE_COUNTERS = (
    "generations_rejected",
    "generations_skipped",
    "workers_respawned",
    "members_retried",
    "rollout_failures",
    "supervisor_resumes",
    "chaos_worker_kills",
)


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_record(rec: dict) -> list[str]:
    """Schema problems of one record ([] when clean)."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    problems = []
    for key, (types, required) in RECORD_SCHEMA.items():
        if key not in rec:
            if required:
                problems.append(f"missing required key {key!r}")
            continue
        v = rec[key]
        # bool is an int subclass: True must not satisfy an int field
        if (isinstance(v, bool) and bool not in types) or not isinstance(v, types):
            problems.append(f"{key!r} is {type(v).__name__}, expected "
                            f"{'/'.join(t.__name__ for t in types)}")
    phases = rec.get("phases")
    if isinstance(phases, dict):
        for name, dur in phases.items():
            if not isinstance(name, str):
                problems.append(f"phase key {name!r} is not a string")
            elif not _is_num(dur) or dur < 0:
                problems.append(f"phase {name!r} duration {dur!r} is not a "
                                "non-negative number")
    a = rec.get("async")
    if isinstance(a, dict):
        for key in ASYNC_REQUIRED_KEYS:
            v = a.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                problems.append(f"async.{key} {v!r} is not a non-negative int")
        if (all(isinstance(a.get(k), int) for k in ("consumed", "fresh", "folded"))
                and a["consumed"] != a["fresh"] + a["folded"]):
            problems.append(f"async accounting broken: consumed {a['consumed']} != "
                            f"fresh {a['fresh']} + folded {a['folded']}")
    sc = rec.get("scenarios")
    if isinstance(sc, dict):
        nv = sc.get("n_variants")
        if not isinstance(nv, int) or isinstance(nv, bool) or nv < 1:
            problems.append(f"scenarios.n_variants {nv!r} is not a positive int")
        else:
            for key in ("counts", "mean", "best"):
                v = sc.get(key)
                if not isinstance(v, list) or len(v) != nv:
                    problems.append(f"scenarios.{key} is not a length-{nv} list")
                elif key == "counts" and any(
                        not isinstance(c, int) or isinstance(c, bool) or c < 0 for c in v):
                    problems.append("scenarios.counts has a negative or non-int entry")
                elif key != "counts" and any(not (x is None or _is_num(x)) for x in v):
                    problems.append(f"scenarios.{key} has a non-numeric entry")
    for i, e in enumerate(rec.get("compile_events") or []):
        if not isinstance(e, dict) or not isinstance(e.get("program"), str):
            problems.append(f"compile_events[{i}] lacks a program name")
        elif not _is_num(e.get("compile_s")) or e["compile_s"] < 0:
            problems.append(f"compile_events[{i}] compile_s {e.get('compile_s')!r} "
                            "is not a non-negative number")
    return problems


def load_records(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def load_records_tolerant(path: str) -> tuple[list[dict], int]:
    """:func:`load_records`, but a malformed final line behind valid
    records is dropped, not raised: a killed writer leaves a torn tail.
    Returns ``(records, n_dropped)``; garbage earlier in the file raises."""
    with open(path) as f:
        lines = [(i, ln) for i, ln in enumerate(f.read().splitlines(), 1) if ln.strip()]
    records: list[dict] = []
    for pos, (lineno, ln) in enumerate(lines):
        try:
            records.append(json.loads(ln))
        except ValueError as e:
            if pos == len(lines) - 1 and records:
                return records, 1
            raise ValueError(f"line {lineno}: {e}") from e
    return records, 0


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return float("nan")
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _load_manifest_resilience(manifest_path: str | None) -> dict | None:
    """The manifest's ``resilience`` section (the supervisor's restarts and
    cross-restart counter totals), or None."""
    if not manifest_path:
        return None
    try:
        with open(manifest_path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    res = data.get("resilience")
    return res if isinstance(res, dict) else None


def _phase_share(records: list[dict]) -> tuple[dict, float]:
    top: dict[str, float] = {}
    children: dict[str, dict[str, float]] = {}
    for r in records:
        for name, dur in (r.get("phases") or {}).items():
            if "/" in name:
                parent, _, child = name.partition("/")
                kids = children.setdefault(parent, {})
                kids[child] = kids.get(child, 0.0) + float(dur)
            else:
                top[name] = top.get(name, 0.0) + float(dur)
    span_total = sum(top.values())
    share = {name: {"seconds": round(sec, 4),
                    "share": round(sec / span_total, 4) if span_total else 0.0}
             for name, sec in sorted(top.items(), key=lambda kv: -kv[1])}
    for parent, kids in children.items():
        if parent in share:
            share[parent]["children"] = {k: round(v, 4) for k, v in kids.items()}
    return share, span_total


def _async_section(records: list[dict]) -> dict | None:
    recs = [r["async"] for r in records if isinstance(r.get("async"), dict)]
    if not recs:
        return None
    consumed = sum(int(a.get("consumed", 0)) for a in recs)
    folded = sum(int(a.get("folded", 0)) for a in recs)
    oes = [a["overlap_efficiency"] for a in recs if _is_num(a.get("overlap_efficiency"))]
    block = {
        "updates": len(recs),
        "consumed": consumed,
        "folded": folded,
        "stale_discarded": sum(int(a.get("stale_discarded", 0)) for a in recs),
        "stale_reuse_ratio": round(folded / consumed, 4) if consumed else None,
        "overlap_efficiency": round(_median(oes), 4) if oes else None,
        "max_staleness": max((int(a.get("max_staleness", 0)) for a in recs), default=0),
    }
    # the last record's quantiles are the run's cumulative histograms
    for key in ("queue_wait_s", "staleness_q"):
        qs = recs[-1].get(key)
        if isinstance(qs, dict) and _is_num(qs.get("p50")) and _is_num(qs.get("p99")):
            block[key] = {"p50": float(qs["p50"]), "p99": float(qs["p99"])}
    qw = block.get("queue_wait_s")
    if qw and qw["p50"] > 0:
        block["queue_wait_tail_ratio"] = round(qw["p99"] / qw["p50"], 2)
    return block


def _scenarios_section(records: list[dict]) -> tuple[dict | None, str | None]:
    """(scenarios summary, diagnosis clause) over the run's per-generation
    blocks, or (None, None) for a run without scenarios.  Count-weighted
    per-variant means, run-best bests, summed counts: the stdlib twin of
    ``scenarios/fitness.py``'s NumPy merge (this module stays stdlib)."""
    blocks = [r["scenarios"] for r in records
              if isinstance(r.get("scenarios"), dict)
              and isinstance(r["scenarios"].get("n_variants"), int)]
    if not blocks:
        return None, None
    width = max(int(b["n_variants"]) for b in blocks)
    counts = [0] * width
    wsum = [0.0] * width
    wcnt = [0.0] * width
    best: list[float | None] = [None] * width

    def num(x):
        return float(x) if _is_num(x) and math.isfinite(x) else None

    for b in blocks:
        cs = b.get("counts") or []
        ms = b.get("mean") or []
        bs = b.get("best") or []
        for v in range(min(width, len(cs))):
            c = int(cs[v]) if isinstance(cs[v], int) else 0
            counts[v] += c
            m = num(ms[v]) if v < len(ms) else None
            if m is not None and c > 0:
                wsum[v] += m * c
                wcnt[v] += c
            bb = num(bs[v]) if v < len(bs) else None
            if bb is not None:
                best[v] = bb if best[v] is None else max(best[v], bb)
    means = [wsum[v] / wcnt[v] if wcnt[v] else None for v in range(width)]
    section = {
        "n_variants": width,
        "coverage": round(sum(1 for c in counts if c) / width, 4),
        "counts": counts,
        "mean": [round(m, 4) if m is not None else None for m in means],
        "best": [round(b, 4) if b is not None else None for b in best],
    }
    clause = None
    finite = [m for m in means if m is not None]
    if len(finite) >= 3:
        med = _median(finite)
        mad = _median([abs(m - med) for m in finite])
        worst_v = min((v for v in range(width) if means[v] is not None), key=lambda v: means[v])
        lag = med - means[worst_v]
        if mad > 0 and lag > SCENARIO_MAD_FACTOR * mad:
            section["worst_variant"] = {
                "variant": worst_v,
                "mean": round(means[worst_v], 4),
                "family_median": round(med, 4),
                "cross_variant_mad": round(mad, 4),
                "lag_in_mads": round(lag / mad, 2),
            }
            clause = (f"WORST-VARIANT: scenario variant {worst_v} mean {means[worst_v]:.4g} "
                      f"lags the family median {med:.4g} by {lag / mad:.1f}x the "
                      "cross-variant MAD — one scenario is systematically losing; inspect "
                      "its drawn constants (manifest config.scenarios)")
    return section, clause


def summarize(records: list[dict], heartbeat_path: str | None = None,
              manifest_path: str | None = None) -> dict:
    """Aggregate a run's records into the summary dict the CLI prints."""
    if not records:
        out: dict = {"generations": 0}
        hb = read_heartbeat(heartbeat_path) if heartbeat_path else None
        diagnosis = []
        if hb is not None:
            out["heartbeat"] = hb
            state = f"last phase={hb.get('phase')} beat {hb['age_s']:.0f}s ago"
            if hb["age_s"] > STALE_AFTER_S:
                diagnosis.append(f"STALE heartbeat: {state} — the process is wedged or dead")
            else:
                diagnosis.append(f"heartbeat fresh: {state}")
        out["diagnosis"] = "; ".join(diagnosis) or "no records"
        return out
    # a supervisor's replayed generations (between the last checkpoint and
    # a crash) appear twice in an append-only JSONL: keep the last of each
    gens = [r.get("generation") for r in records]
    n_replayed = 0
    if len({g for g in gens if g is not None}) < sum(g is not None for g in gens):
        last = {g: i for i, g in enumerate(gens) if g is not None}
        kept = [r for i, r in enumerate(records) if gens[i] is None or last[gens[i]] == i]
        n_replayed = len(records) - len(kept)
        records = kept
    walls = [float(r.get("wall_time_s", 0.0)) for r in records]
    steps = [int(r.get("env_steps", 0)) for r in records]
    wall_total = sum(walls)
    phase_share, span_total = _phase_share(records)

    half = len(records) // 2
    trend = None
    if half >= 1 and sum(walls[:half]) > 0 and sum(walls[half:]) > 0:
        first = sum(steps[:half]) / sum(walls[:half])
        second = sum(steps[half:]) / sum(walls[half:])
        trend = {"first_half_steps_per_s": round(first, 1),
                 "second_half_steps_per_s": round(second, 1),
                 "ratio": round(second / first, 4) if first > 0 else None}

    med = _median(walls)
    stalls = [{"generation": int(r.get("generation", i)), "wall_time_s": round(w, 3),
               "x_median": round(w / med, 1)}
              for i, (r, w) in enumerate(zip(records, walls))
              if med > 0 and w > STALL_FACTOR * med]
    async_block = _async_section(records)
    scenarios_section, scenario_clause = _scenarios_section(records)

    diagnosis = []
    if stalls:
        worst = max(stalls, key=lambda s: s["x_median"])
        diagnosis.append(f"gen {worst['generation']} took {worst['x_median']}x the median "
                         f"generation ({worst['wall_time_s']}s vs {med:.3f}s)")
    if trend and trend["ratio"] is not None and trend["ratio"] < 0.8:
        diagnosis.append(f"throughput decayed to {trend['ratio']:.0%} of the first half")
    manifest_res = _load_manifest_resilience(manifest_path)
    run_completed = bool(manifest_res and manifest_res.get("completed"))
    hb = None
    if heartbeat_path:
        hb = read_heartbeat(heartbeat_path)
        if hb is None:
            diagnosis.append(f"heartbeat unreadable at {heartbeat_path} — run never "
                             "started telemetry, or the path is wrong")
        else:
            state = (f"last phase={hb.get('phase')} gen={hb.get('generation')} "
                     f"beat {hb['age_s']:.0f}s ago")
            if hb["age_s"] > STALE_AFTER_S and run_completed:
                # a supervised run that completed: the old beat is its last child's
                diagnosis.append(f"run completed (supervised); {state}")
            elif hb["age_s"] > STALE_AFTER_S:
                diagnosis.append(f"STALE heartbeat: {state} — the run is wedged or dead, "
                                 "not slow")
            else:
                diagnosis.append(f"heartbeat fresh: {state}")

    # the manifest's counters are cross-restart totals; the heartbeat's
    # cover only the current child
    counter_src = None
    if manifest_res and isinstance(manifest_res.get("counters"), dict):
        counter_src = manifest_res["counters"]
    elif hb and isinstance(hb.get("counters"), dict):
        counter_src = hb["counters"]
    counters = None
    if counter_src is not None:
        counters = {k: counter_src[k] for k in RESILIENCE_COUNTERS if counter_src.get(k)}
        if counters:
            diagnosis.append("resilience: " + ", ".join(f"{int(v)} {k}"
                                                        for k, v in counters.items()))
    restarts = None
    if manifest_res is not None:
        n_restarts = int(manifest_res.get("restart_count", 0))
        restarts = {"count": n_restarts, "completed": manifest_res.get("completed"),
                    "reasons": [r.get("reason") for r in manifest_res.get("restarts", [])]}
        if n_restarts:
            last_reason = f" (last: {restarts['reasons'][-1]})" if restarts["reasons"] else ""
            diagnosis.append(f"supervisor restarted the run {n_restarts}x{last_reason}")
    if n_replayed:
        diagnosis.append(f"{n_replayed} replayed generation record"
                         f"{'s' if n_replayed != 1 else ''} deduped (re-run after a "
                         "restart resumed from an earlier checkpoint)")
    if async_block:
        clause = (f"async: {async_block['folded']}/{async_block['consumed']} results folded "
                  f"stale (ratio {async_block['stale_reuse_ratio']})")
        if async_block["stale_discarded"]:
            clause += (f", {async_block['stale_discarded']} DISCARDED past the staleness "
                       "horizon")
        diagnosis.append(clause)
        ratio = async_block.get("queue_wait_tail_ratio")
        qw = async_block.get("queue_wait_s")
        if ratio is not None and ratio > TAIL_RATIO_THRESHOLD and qw["p99"] >= TAIL_P99_FLOOR_S:
            diagnosis.append(
                f"TAIL-HEAVY async queue wait: p99 {qw['p99']}s is {ratio}x p50 "
                f"{qw['p50']}s — a few results wait far longer than typical (stragglers "
                "or a starved fold loop); check async/eval_s and stale discards")
    if scenarios_section is not None:
        diagnosis.append(f"scenarios: {scenarios_section['n_variants']} variants, "
                         f"{scenarios_section['coverage']:.0%} covered")
        if scenario_clause:
            diagnosis.append(scenario_clause)
    if not diagnosis:
        diagnosis.append("steady: no stalls, no throughput decay")

    out = {
        "generations": len(records),
        "wall_time_s": round(wall_total, 3),
        "env_steps": sum(steps),
        "env_steps_per_sec": round(sum(steps) / wall_total, 1) if wall_total > 0 else None,
        "span_coverage": (round(span_total / wall_total, 4)
                          if wall_total > 0 and span_total else 0.0),
        "phase_share": phase_share,
        "throughput": trend,
        "stalls": stalls,
        "diagnosis": "; ".join(diagnosis),
    }
    if hb is not None:
        out["heartbeat"] = hb
    if counters:
        out["counters"] = counters
    if restarts is not None:
        out["restarts"] = restarts
    if async_block is not None:
        out["async"] = async_block
    if scenarios_section is not None:
        out["scenarios"] = scenarios_section
    return out


def format_summary(s: dict) -> str:
    """Human rendering of :func:`summarize`'s dict."""
    if not s.get("generations"):
        return f"diagnosis        {s['diagnosis']}" if s.get("heartbeat") else "no records"
    lines = [
        f"generations      {s['generations']}",
        f"wall time        {s['wall_time_s']:.3f}s",
        f"env steps        {s['env_steps']:,}",
        f"env steps/s      {s['env_steps_per_sec']:,}"
        if s["env_steps_per_sec"] is not None else "env steps/s      n/a",
    ]
    if s["phase_share"]:
        lines.append(f"phase share      (covers {s['span_coverage']:.0%} of wall)")
        for name, row in s["phase_share"].items():
            bar = "#" * max(1, int(40 * row["share"]))
            lines.append(f"  {name:<14} {row['share']:7.1%}  {row['seconds']:9.3f}s  {bar}")
            for child, sec in row.get("children", {}).items():
                lines.append(f"    └ {child:<12} {'':7}  {sec:9.3f}s")
    else:
        lines.append("phase share      none recorded (telemetry disabled?)")
    t = s.get("throughput")
    if t:
        lines.append(f"throughput       {t['first_half_steps_per_s']:,} → "
                     f"{t['second_half_steps_per_s']:,} steps/s (x{t['ratio']})")
    if s.get("counters"):
        lines.append("resilience       " + "  ".join(f"{k}={int(v)}"
                                                    for k, v in s["counters"].items()))
    a = s.get("async")
    if a:
        line = f"async            {a['updates']} updates  {a['folded']}/{a['consumed']} folded stale"
        if a.get("stale_reuse_ratio") is not None:
            line += f" (ratio {a['stale_reuse_ratio']})"
        if a.get("overlap_efficiency") is not None:
            line += f"  overlap {a['overlap_efficiency']}"
        lines.append(line + f"  discarded={a['stale_discarded']}")
        qw, st = a.get("queue_wait_s"), a.get("staleness_q")
        if qw or st:
            tail = "async tails      "
            if qw:
                tail += f"queue-wait p50={qw['p50']}s p99={qw['p99']}s"
                if a.get("queue_wait_tail_ratio") is not None:
                    tail += f" (p99/p50 {a['queue_wait_tail_ratio']}x)"
            if st:
                tail += f"  staleness p50={st['p50']} p99={st['p99']}"
            lines.append(tail)
    sc = s.get("scenarios")
    if sc:
        means = [m for m in sc["mean"] if m is not None]
        line = f"scenarios        {sc['n_variants']} variants  coverage {sc['coverage']:.0%}"
        if means:
            line += f"  mean {min(means):.4g}..{max(means):.4g}"
        lines.append(line)
        wv = sc.get("worst_variant")
        if wv:
            lines.append(f"  └ worst v{wv['variant']:<3} mean {wv['mean']:.4g}  "
                         f"({wv['lag_in_mads']}x MAD below median {wv['family_median']:.4g})")
    if s.get("restarts") and s["restarts"]["count"]:
        lines.append(f"restarts         {s['restarts']['count']} "
                     f"(completed={s['restarts']['completed']})")
    lines.append(f"diagnosis        {s['diagnosis']}")
    return "\n".join(lines)


def selfcheck() -> list[str]:
    """The schema and pipeline's self-validation ([] when healthy): the
    golden record validates and a broken one does not, a synthetic run
    summarizes with every promised key and its stall found, the async
    accounting and tails surface, the scenarios section aggregates and calls
    out a laggard, and the resilience counters and restarts come through
    from a heartbeat and a manifest."""
    import os
    import tempfile
    import time

    def via_json(r: dict) -> dict:  # what the CLI reads
        return json.loads(json.dumps(r))

    problems = list(validate_record(GOLDEN_RECORD))
    broken = dict(GOLDEN_RECORD, env_steps="many")
    broken.pop("reward_mean")
    if not validate_record(broken):
        problems.append("validator accepted a broken record")
    recs = [via_json(dict(GOLDEN_RECORD, generation=g, wall_time_s=30.0 if g == 4 else 1.0))
            for g in range(6)]
    s = summarize(recs)
    for key in ("generations", "wall_time_s", "env_steps", "env_steps_per_sec",
                "phase_share", "throughput", "stalls", "diagnosis"):
        if key not in s:
            problems.append(f"summary missing {key!r}")
    if not s.get("stalls"):
        problems.append("stall detector missed a 30x-median generation")
    share = s.get("phase_share", {})
    for phase in ("sample", "eval", "update"):
        if phase not in share:
            problems.append(f"phase_share missing {phase!r}")
    if "update" in share and "obsnorm_merge" not in share["update"].get("children", {}):
        problems.append("nested span update/obsnorm_merge not aggregated")
    if share and not math.isclose(sum(r["share"] for r in share.values()), 1.0, abs_tol=1e-3):
        problems.append("top-level shares do not sum to 1")
    if format_summary(s) == "no records":
        problems.append("format_summary rendered nothing")

    async_rec = via_json(dict(GOLDEN_RECORD, generation=6, **{"async": {
        "consumed": 16, "fresh": 10, "folded": 6, "stale_discarded": 1, "max_staleness": 2,
        "overlap_efficiency": 0.8, "queue_wait_s": {"p50": 0.004, "p99": 0.09},
        "staleness_q": {"p50": 0.0, "p99": 2.0}}}))
    problems += [f"async golden: {p}" for p in validate_record(async_rec)]
    if not validate_record(dict(GOLDEN_RECORD, **{"async": {
            "consumed": 16, "fresh": 10, "folded": 3, "stale_discarded": 0}})):
        problems.append("validator accepted consumed != fresh + folded")
    sa = summarize(recs + [async_rec])
    ab = sa.get("async") or {}
    if ab.get("folded") != 6 or ab.get("consumed") != 16:
        problems.append("summary missed the async accounting block")
    if ab.get("stale_reuse_ratio") != round(6 / 16, 4):
        problems.append("stale_reuse_ratio mis-derived")
    if "DISCARDED" not in sa["diagnosis"]:
        problems.append("diagnosis missed the stale-discard callout")
    if ab.get("queue_wait_tail_ratio") != round(0.09 / 0.004, 2):
        problems.append("queue-wait p99/p50 ratio mis-derived")
    if "TAIL-HEAVY" not in sa["diagnosis"]:
        problems.append("diagnosis missed the tail-heavy queue-wait callout")
    if "queue-wait" not in format_summary(sa):
        problems.append("format_summary dropped the async tails line")
    fast = via_json(dict(async_rec, **{"async": dict(
        async_rec["async"], queue_wait_s={"p50": 9.1e-06, "p99": 0.0005})}))
    if "TAIL-HEAVY" in summarize(recs + [fast])["diagnosis"]:
        problems.append("tail-heavy callout fired on a sub-millisecond p99")
    if summarize(recs).get("async"):
        problems.append("sync run grew an async section")

    # scenarios: per-variant blocks validate, fold count-weighted into the
    # section, and a 2x-MAD laggard is called out while a balanced family
    # stays quiet
    def scen_rec(gen, means):
        return dict(GOLDEN_RECORD, generation=gen, scenarios={
            "n_variants": len(means), "counts": [4] * len(means),
            "mean": means, "best": [m + 5.0 for m in means]})

    lag = [-100.0, -102.0, -98.0, -101.0, -99.0, -400.0]
    sr = [via_json(scen_rec(g, lag)) for g in range(3)]
    problems += [f"scenario golden: {p}" for p in validate_record(sr[0])]
    broken_sc = dict(GOLDEN_RECORD, scenarios={
        "n_variants": 4, "counts": [1, 2], "mean": [0.0], "best": "big"})
    if not validate_record(broken_sc):
        problems.append("validator accepted a malformed scenarios block")
    ssc = summarize(recs + sr)
    blk = ssc.get("scenarios")
    if not blk or blk.get("n_variants") != 6:
        problems.append("summary missed the scenarios section")
    if blk and blk.get("coverage") != 1.0:
        problems.append("scenario coverage mis-derived")
    if blk and blk.get("mean", [None])[0] != -100.0:
        problems.append("per-variant mean not count-weighted across generations")
    if blk and blk.get("best", [None])[0] != -95.0:
        problems.append("per-variant best not aggregated as run max")
    if not blk or blk.get("worst_variant", {}).get("variant") != 5:
        problems.append("worst-variant callout missed a 2x-MAD laggard")
    if "WORST-VARIANT" not in ssc.get("diagnosis", ""):
        problems.append("diagnosis missed the worst-variant callout")
    if "scenarios" not in format_summary(ssc):
        problems.append("format_summary dropped the scenarios block")
    balanced = [via_json(scen_rec(g, [-100.0, -102.0, -98.0, -101.0, -99.0, -103.0]))
                for g in range(3)]
    if "WORST-VARIANT" in summarize(recs + balanced).get("diagnosis", ""):
        problems.append("worst-variant callout fired on a balanced family")
    if summarize(recs).get("scenarios"):
        problems.append("un-randomized run grew a scenarios section")

    with tempfile.TemporaryDirectory() as d:
        hb_path = os.path.join(d, "heartbeat.json")
        with open(hb_path, "w") as f:
            json.dump({"ts": time.time(), "pid": 1, "phase": "eval", "generation": 3,
                       "counters": {"generations_rejected": 2, "workers_respawned": 1}}, f)
        mf_path = os.path.join(d, "manifest.json")
        with open(mf_path, "w") as f:
            json.dump({"resilience": {
                "restart_count": 1, "completed": True,
                "restarts": [{"reason": "child died with exit code -9"}],
                "counters": {"generations_rejected": 2, "generations_skipped": 1}}}, f)
        sr = summarize(recs, heartbeat_path=hb_path, manifest_path=mf_path)
        if sr.get("counters", {}).get("generations_rejected") != 2:
            problems.append("summary missed generations_rejected counter")
        if sr.get("restarts", {}).get("count") != 1:
            problems.append("summary missed supervisor restart count")
        if "restarted" not in sr["diagnosis"]:
            problems.append("diagnosis missed the supervisor restart")
        if "resilience" not in format_summary(sr):
            problems.append("format_summary dropped resilience counters")
        sh = summarize(recs, heartbeat_path=hb_path)
        if sh.get("counters", {}).get("workers_respawned") != 1:
            problems.append("heartbeat counters not surfaced sans manifest")
    return problems
