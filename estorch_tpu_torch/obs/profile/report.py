"""``obs profile`` — per-phase performance attribution over a run JSONL.

Counterpart of ``estorch_tpu/obs/profile/report.py`` (stdlib only): for
the same records and roofline its dict and its text equal the JAX
package's.  ``obs summarize`` says where the time went; this module says
what that time *bought*: each top-level phase's seconds are joined with
the analytic cost model the run recorded (``record["cost_model"]``,
written by ``ES`` into its first record) to produce achieved FLOP/s,
bytes/s and arithmetic intensity, each stated against a platform
roofline (:mod:`roofline` — the H100 SXM data sheet on that card, a
measured-GEMM calibration on CPU).  The compile ledger
(``record["compile_events"]``) rides along: per-program compile seconds
and, for a JAX run, XLA's own cost estimates and the model/XLA FLOPs
ratio (the port's native builds carry no such estimates).

Tolerance contract (matches summarize/trace): phase-less records, a
truncated tail, or a run with zero compile events degrade to a noted,
partial report — never a crash; post-mortem inputs are exactly the runs
that died mid-write.
"""

from __future__ import annotations

import math

from . import costmodel
from .ledger import collect_compile_events

PROFILE_SCHEMA = 1

# phases that are pure host-side bookkeeping: no modeled cost, and their
# absence from the modeled set is by design, not a gap
UNMODELED_PHASES = ("dispatch", "host_sync", "record")


def _dedup_replays(records: list[dict]) -> list[dict]:
    """Keep the LAST occurrence per generation (supervisor replays), the
    same rule summarize/regress apply."""
    gens = [r.get("generation") for r in records if isinstance(r, dict)]
    records = [r for r in records if isinstance(r, dict)]
    if len(set(g for g in gens if g is not None)) == sum(
            1 for g in gens if g is not None):
        return records
    last = {g: i for i, g in enumerate(gens) if g is not None}
    return [r for i, r in enumerate(records)
            if gens[i] is None or last[gens[i]] == i]


def find_cost_model(records: list[dict]) -> dict | None:
    """The run's recorded analytic cost model (first record carrying
    one — ES writes it at generation 0)."""
    for r in records:
        if isinstance(r, dict) and isinstance(r.get("cost_model"), dict):
            return r["cost_model"]
    return None


def profile_records(records: list[dict], roofline: dict,
                    cost_model: dict | None = None) -> dict:
    """Build the profile dict the CLI renders (see module docstring).

    ``roofline``: a :func:`roofline.platform_roofline` dict; its peaks
    may be None (un-calibrated), in which case utilizations are omitted
    and the report is rates-only.
    """
    notes: list[str] = []
    records = _dedup_replays(records)
    if not records:
        return {"schema": PROFILE_SCHEMA, "generations": 0,
                "notes": ["no records"]}
    model = cost_model or find_cost_model(records)
    if model is None:
        notes.append("no cost_model in the run records — time shares "
                     "only (runs from before the profile layer, or a "
                     "hand-built JSONL)")

    n_gens = len(records)
    env_steps = sum(int(r.get("env_steps", 0) or 0) for r in records)
    wall = sum(float(r.get("wall_time_s", 0.0) or 0.0) for r in records)

    top: dict[str, float] = {}
    for r in records:
        for name, dur in (r.get("phases") or {}).items():
            if isinstance(dur, (int, float)) and "/" not in name:
                top[name] = top.get(name, 0.0) + float(dur)
    if not top:
        notes.append("no phase spans recorded (telemetry disabled?) — "
                     "nothing to attribute")
    span_total = sum(top.values())

    peak_f = roofline.get("peak_flops_per_s")
    peak_b = roofline.get("peak_bytes_per_s")
    ridge = (peak_f / peak_b) if peak_f and peak_b else None

    phases: dict[str, dict] = {}
    modeled_flops_total = 0.0
    for name, sec in sorted(top.items(), key=lambda kv: -kv[1]):
        row: dict = {
            "seconds": round(sec, 4),
            "share": round(sec / span_total, 4) if span_total else 0.0,
        }
        cost = costmodel.phase_cost_for(
            model, name, env_steps=env_steps, n_generations=n_gens
        ) if model else None
        if cost is not None and sec > 0:
            flops, nbytes = float(cost["flops"]), float(cost["bytes"])
            modeled_flops_total += flops
            row["modeled_flops"] = flops
            row["flops_per_s"] = round(flops / sec, 1)
            row["bytes_per_s"] = round(nbytes / sec, 1)
            row["arith_intensity"] = (round(flops / nbytes, 3)
                                      if nbytes else None)
            # mfu/bw_util stay unrounded: the selfcheck's known-FLOPs
            # gate compares them exactly (format_profile rounds for
            # display)
            if peak_f:
                row["mfu"] = flops / sec / peak_f
            if peak_b:
                row["bw_util"] = nbytes / sec / peak_b
            if ridge is not None and row["arith_intensity"] is not None:
                row["bound"] = ("compute"
                                if row["arith_intensity"] >= ridge
                                else "memory")
        phases[name] = row

    run: dict = {}
    if model and wall > 0 and modeled_flops_total > 0:
        run = {"modeled_flops": modeled_flops_total,
               "flops_per_s": round(modeled_flops_total / wall, 1)}
        if peak_f:
            run["mfu"] = modeled_flops_total / wall / peak_f

    # ---- compile ledger -------------------------------------------------
    entries = collect_compile_events(records)
    compile_block: dict = {"n_events": len(entries)}
    if entries:
        compile_block["total_compile_s"] = round(
            sum(float(e.get("compile_s", 0.0) or 0.0) for e in entries), 4)
        compile_block["programs"] = [
            {k: e[k] for k in ("program", "compile_s", "generation",
                               "xla_flops", "xla_bytes_accessed",
                               "peak_bytes", "first_call") if k in e}
            for e in entries
        ]
        peaks = [e["peak_bytes"] for e in entries
                 if isinstance(e.get("peak_bytes"), (int, float))]
        if peaks:
            compile_block["peak_device_bytes"] = max(peaks)
        # model/XLA cross-check: the fused generation program's XLA FLOPs
        # estimate vs the analytic model's per-generation total
        if model:
            xla = next((e.get("xla_flops") for e in entries
                        if e.get("program") == "generation_step"
                        and isinstance(e.get("xla_flops"), (int, float))),
                       None)
            per_gen = costmodel.phase_cost_for(
                model, "device", env_steps=env_steps // max(1, n_gens),
                n_generations=1)
            if xla and per_gen and per_gen["flops"] > 0:
                compile_block["model_vs_xla_flops_ratio"] = round(
                    per_gen["flops"] / float(xla), 3)
    else:
        notes.append("no compile events in the run (host backend, "
                     "telemetry disabled, or a pre-ledger run)")

    out = {
        "schema": PROFILE_SCHEMA,
        "generations": n_gens,
        "wall_time_s": round(wall, 3),
        "env_steps": env_steps,
        "platform": roofline.get("platform"),
        "basis": roofline.get("basis"),
        "roofline": {
            "peak_flops_per_s": peak_f,
            "peak_bytes_per_s": peak_b,
            **({"ridge_flops_per_byte": round(ridge, 3)} if ridge else {}),
        },
        "has_cost_model": model is not None,
        "phases": phases,
        "compile": compile_block,
        "notes": notes,
    }
    if run:
        out["run"] = run
    return out


def _rate(v: float | None, unit: str) -> str:
    if v is None or not math.isfinite(v):
        return "n/a"
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= scale:
            return f"{v / scale:.2f} {suffix}{unit}"
    return f"{v:.1f} {unit}"


def format_profile(p: dict) -> str:
    """Human rendering of :func:`profile_records`'s dict."""
    if not p.get("generations"):
        return "\n".join(["no records"] + [f"note: {n}"
                                           for n in p.get("notes", [])])
    lines = [
        f"generations      {p['generations']}",
        f"wall time        {p['wall_time_s']:.3f}s",
        f"env steps        {p['env_steps']:,}",
        f"platform         {p.get('platform')} (basis: {p.get('basis')})",
    ]
    roof = p.get("roofline") or {}
    if roof.get("peak_flops_per_s"):
        lines.append(
            f"roofline         {_rate(roof['peak_flops_per_s'], 'FLOP/s')}"
            f" / {_rate(roof.get('peak_bytes_per_s'), 'B/s')}"
            + (f"  (ridge {roof['ridge_flops_per_byte']} FLOP/B)"
               if roof.get("ridge_flops_per_byte") else ""))
    if p.get("run", {}).get("mfu") is not None:
        lines.append(f"run MFU          {p['run']['mfu']:.4%}  "
                     f"({_rate(p['run']['flops_per_s'], 'FLOP/s')})")
    if p.get("phases"):
        lines.append("phase            share     seconds   achieved")
        for name, row in p["phases"].items():
            ach = ""
            if "flops_per_s" in row:
                ach = _rate(row["flops_per_s"], "FLOP/s")
                if row.get("mfu") is not None:
                    ach += f"  mfu {row['mfu']:.4%}"
                if row.get("bound"):
                    ach += f"  [{row['bound']}-bound"
                    if row.get("arith_intensity") is not None:
                        ach += f", {row['arith_intensity']} FLOP/B"
                    ach += "]"
            lines.append(f"  {name:<14} {row['share']:7.1%}  "
                         f"{row['seconds']:9.3f}s  {ach}")
    c = p.get("compile") or {}
    if c.get("n_events"):
        lines.append(f"compiles         {c['n_events']} program(s), "
                     f"{c.get('total_compile_s', 0)}s total"
                     + (f", peak device bytes "
                        f"{_rate(c['peak_device_bytes'], 'B')}"
                        if c.get("peak_device_bytes") else ""))
        if c.get("model_vs_xla_flops_ratio") is not None:
            lines.append(f"model vs XLA     analytic/XLA FLOPs ratio "
                         f"{c['model_vs_xla_flops_ratio']} "
                         "(the cost model's honesty check)")
    for n in p.get("notes", []):
        lines.append(f"note: {n}")
    return "\n".join(lines)


# ---------------------------------------------------------------------
# selfcheck: the gate for the attribution layer (`obs profile --selfcheck`)
# ---------------------------------------------------------------------

def _synth_records(model: dict, n: int = 8, eval_s: float = 1.0,
                   sample_s: float = 0.02, update_s: float = 0.1) -> list:
    import json as _json

    steps = int(model["env_steps_per_generation"])
    recs = []
    for g in range(n):
        wall = sample_s + eval_s + update_s
        rec = {
            "generation": g, "env_steps": steps,
            "env_steps_per_sec": steps / wall, "wall_time_s": wall,
            "reward_mean": 0.0, "reward_max": 0.0, "best_reward": 0.0,
            "phases": {"sample": sample_s, "eval": eval_s,
                       "update": update_s},
        }
        if g == 0:
            rec["cost_model"] = model
            rec["compile_events"] = [
                {"program": "generation_step", "compile_s": 12.5,
                 "generation": 0,
                 "xla_flops": float(model["env_steps_per_generation"]
                                    * model["flops_per_env_step"]),
                 "peak_bytes": 2.5e9},
            ]
        recs.append(_json.loads(_json.dumps(rec)))  # via-JSON: CLI-equal
    return recs


def selfcheck() -> list[str]:
    """Prove the attribution layer computes what it claims ([] = healthy):

    * a synthetic run with known per-step FLOPs and a synthetic roofline
      produces exactly the expected eval-phase MFU;
    * the compile ledger rides the records and round-trips through the
      Prometheus exposition parser;
    * degenerate inputs (phase-less records, no cost model) degrade to a
      noted report, never a crash;
    * a 30% eval-phase slowdown is flagged by the phase-localized
      regress gate naming the ``eval`` phase — and only it;
    * the CPU roofline calibration measures positive peaks.
    """
    from ..export import regress
    from ..export.prometheus import (parse_exposition, render_exposition,
                                     samples_by_name)
    from .ledger import ledger_counters
    from .roofline import measure_cpu_roofline

    problems: list[str] = []
    shapes = [(3, 64), (64, 64), (64, 1)]
    kernels = sum(m * n for m, n in shapes)
    param_dim = kernels + 64 + 64 + 1
    model = costmodel.generation_cost(
        population=4096, matmul_shapes=shapes, param_dim=param_dim,
        horizon=200)
    recs = _synth_records(model)
    roof = {"platform": "synthetic", "basis": "selfcheck",
            "peak_flops_per_s": 1e12, "peak_bytes_per_s": 1e11}
    p = profile_records(recs, roof)
    fwd = 2 * kernels
    want_mfu = (model["env_steps_per_generation"] * fwd) / 1.0 / 1e12
    got = p.get("phases", {}).get("eval", {}).get("mfu")
    if got is None or abs(got - want_mfu) > 1e-12:
        problems.append(f"known-FLOPs eval MFU wrong: got {got}, "
                        f"want {want_mfu}")
    # the model says ES eval is GEMV-regime (intensity ~0.5 FLOP/B):
    # below this roofline's ridge of 10 it must read memory-bound, and
    # against a bandwidth-rich roofline (ridge 0.01) compute-bound —
    # both branches of the classification, not just one
    if p.get("phases", {}).get("eval", {}).get("bound") != "memory":
        problems.append("eval phase (intensity << ridge) not marked "
                        "memory-bound")
    roof_bw = dict(roof, peak_bytes_per_s=1e14)
    p_bw = profile_records(recs, roof_bw)
    if p_bw.get("phases", {}).get("eval", {}).get("bound") != "compute":
        problems.append("eval phase (intensity >> ridge) not marked "
                        "compute-bound")
    if p.get("compile", {}).get("n_events") != 1:
        problems.append("compile ledger entry did not ride the records")
    ratio = p.get("compile", {}).get("model_vs_xla_flops_ratio")
    if ratio is None or not (0.9 <= ratio <= 1.1):
        problems.append(f"model-vs-XLA cross-check ratio off: {ratio}")
    if format_profile(p) == "no records":
        problems.append("format_profile rendered nothing")

    # ledger -> flat registry -> exposition -> parser round trip
    entries = recs[0]["compile_events"]
    folded = ledger_counters(entries)
    body = render_exposition(folded, up=True)
    try:
        vals = samples_by_name(parse_exposition(body))
    except ValueError as e:
        problems.append(f"ledger exposition did not parse: {e}")
        vals = {}
    if vals.get("estorch_compile_s_generation_step") != 12.5:
        problems.append("compile_s did not round-trip the exposition "
                        f"parser: {vals}")

    # degenerate inputs: never a crash, always a note
    bare = [{"generation": g, "env_steps": 10, "env_steps_per_sec": 1.0,
             "wall_time_s": 10.0, "reward_mean": 0, "reward_max": 0,
             "best_reward": 0} for g in range(3)]
    pb = profile_records(bare, roof)
    if not any("no phase spans" in n for n in pb.get("notes", [])):
        problems.append("phase-less records not noted")
    if not any("no cost_model" in n for n in pb.get("notes", [])):
        problems.append("missing cost model not noted")
    if not any("no compile events" in n for n in pb.get("notes", [])):
        problems.append("zero compile events not noted")
    if profile_records([], roof).get("generations") != 0:
        problems.append("empty record list mishandled")

    # phase-localized regression: 30% slower eval must be flagged as
    # eval — and only eval
    slow = _synth_records(model, eval_s=1.3)
    v = regress.compare_phases(slow, recs)
    if v["verdict"] != "regress" or v.get("regressed_phases") != ["eval"]:
        problems.append(f"30% eval slowdown not localized to eval: {v}")
    same = regress.compare_phases(_synth_records(model), recs)
    if same["verdict"] != "pass":
        problems.append(f"identical run flagged by phase gate: {same}")

    cal = measure_cpu_roofline(budget_s=0.05, gemm_n=128, copy_mb=4)
    if not (cal["peak_flops_per_s"] > 0 and cal["peak_bytes_per_s"] > 0):
        problems.append(f"cpu roofline calibration not positive: {cal}")
    if cal["basis"] != "cpu_calibrated":
        problems.append("cpu roofline not tagged cpu_calibrated")
    return problems
