"""obs CLI: ``python -m estorch_tpu_torch.obs`` (counterpart of
``estorch_tpu/obs/__main__.py``, with the JAX package's flags and exit
codes).

  summarize <run.jsonl> [--heartbeat PATH] [--manifest PATH] [--json]
      Per-phase time share, throughput trend, stall diagnosis, resilience
      counters and supervisor restarts of a training run's JSONL (the
      ``train(log_fn=JsonlSink(...))`` output).  A ``heartbeat.json`` and
      a ``manifest.json`` beside the JSONL are picked up when no path is
      given; a torn final line (a killed writer) is dropped with a note.

  summarize --heartbeat PATH
      The liveness of a process that writes no records.

  summarize --selfcheck
      Hold the golden record against the schema and the pipeline against
      synthetic runs.

  trace <run.jsonl> [-o trace.json] [--events ring.jsonl]
      Export the run as Perfetto/Chrome trace-event JSON: phase lanes
      per generation, supervisor-restart boundaries marked, a compiles
      lane, process lanes keyed by manifest provenance.  ``manifest.json``
      / ``heartbeat.json`` beside the JSONL are auto-discovered.

  profile <run.jsonl> [--platform auto|cpu|tpu|gpu] [--json]
      Per-phase performance attribution: time share, achieved FLOP/s and
      bytes/s against the platform roofline (the H100 SXM data sheet on
      that card, a measured-GEMM calibration on cpu, the v5e data sheet
      for a JAX run on a TPU; rates only on any other card), arithmetic
      intensity, MFU, and the compile ledger.  ``auto`` reads the
      manifest beside the JSONL: any GPU device picks ``gpu`` with its
      kind.  ``profile --selfcheck``: a synthetic run with known FLOPs
      must give exactly the expected MFU, and an injected 30% eval
      slowdown must be flagged naming ``eval``.

  regress <current> --baseline <PATH> [--label L] [--json]
      Statistical perf gate: robust medians + a noise band learned from
      repeats.  Exit 0 pass, 1 regression.  ``--phases`` gates per-phase
      medians (two run JSONLs) so the verdict names the phase that
      moved; ``--tail [--quantile Q]`` gates an upper quantile (default
      p99) per phase/endpoint with its own learned MAD band; mismatched
      platforms (a card run against a TPU or CPU baseline) are an error,
      not a verdict.  ``regress --selfcheck`` / ``regress --tail
      --selfcheck`` are the gates for the gates.

  hist --selfcheck
      Streaming-histogram math gate (obs/hist.py): exact small-N
      quantiles, known-distribution bucket error bound, merge
      associativity, cross-restart composition + exposition round trips.

  serve-metrics --run-dir DIR [--port N] [--port-file PATH]
      Prometheus /metrics sidecar over a run directory (heartbeat +
      supervisor-published counter totals).  Without the package, run it
      as a file: ``python estorch_tpu_torch/obs/export/sidecar.py``.

The JAX package's fleet subcommands (``collect``, ``dash``, ``slow``,
``autoscale`` and the distributed ``trace --fleet/--store``) wait for
ROADMAP.md port item 9.

Exit codes: 0 ok; 1 selfcheck problems / unreadable input / regression;
2 bad run dir; 3 bad usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .summarize import format_summary, load_records_tolerant, selfcheck, summarize

# the JAX package's other subcommands, and the port's queue item each waits for
NOT_PORTED = {"collect": "9", "dash": "9", "slow": "9", "autoscale": "9"}
# the flags of the JAX package's distributed ``trace`` form (item 9 too)
_FLEET_TRACE_FLAGS = ("--fleet", "--store", "--selfcheck")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m estorch_tpu_torch.obs",
                                description="observability tooling of the port")
    sub = p.add_subparsers(dest="cmd")
    s = sub.add_parser("summarize", help="per-phase share and stall diagnosis of a run")
    s.add_argument("jsonl", nargs="?", default=None,
                   help="run JSONL (one generation record per line)")
    s.add_argument("--heartbeat", default=None, metavar="PATH",
                   help="heartbeat file (default: heartbeat.json beside the JSONL)")
    s.add_argument("--manifest", default=None, metavar="PATH",
                   help="run manifest with the supervisor's restarts and counters "
                        "(default: manifest.json beside the JSONL)")
    s.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable summary on stdout")
    s.add_argument("--selfcheck", action="store_true",
                   help="validate the golden record and the pipeline, then exit")

    t = sub.add_parser("trace", help="export a run JSONL as Perfetto/Chrome trace-event JSON")
    t.add_argument("jsonl", help="run JSONL (one generation per line)")
    t.add_argument("-o", "--out", default=None, metavar="PATH",
                   help="output path (default: trace.json beside the JSONL)")
    t.add_argument("--manifest", default=None, metavar="PATH",
                   help="run manifest for restart provenance (default: manifest.json "
                        "beside the JSONL)")
    t.add_argument("--heartbeat", default=None, metavar="PATH",
                   help="heartbeat file (default: heartbeat.json beside the JSONL)")
    t.add_argument("--events", default=None, metavar="PATH",
                   help="flight-recorder dump_jsonl file: rendered as a wall-clock "
                        "marker lane")

    pr = sub.add_parser("profile", help="per-phase MFU/roofline attribution of a run JSONL")
    pr.add_argument("jsonl", nargs="?", default=None,
                    help="run JSONL (one generation record per line)")
    pr.add_argument("--platform", default="auto", choices=("auto", "cpu", "tpu", "gpu"),
                    help="roofline platform (auto: manifest.json beside the JSONL, "
                         "else cpu)")
    pr.add_argument("--manifest", default=None, metavar="PATH",
                    help="run manifest for platform and card detection (default: "
                         "manifest.json beside the JSONL)")
    pr.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable profile on stdout")
    pr.add_argument("--selfcheck", action="store_true",
                    help="prove the attribution math (known FLOPs -> known MFU; 30%% "
                         "eval slowdown localized) and exit")

    r = sub.add_parser("regress", help="perf gate: current measurement vs a baseline")
    r.add_argument("current", nargs="?", default=None,
                   help="run JSONL / bench output to gate")
    r.add_argument("--baseline", default=None, metavar="PATH",
                   help="baseline (BENCH_*.json schema, bench line, or run JSONL)")
    r.add_argument("--label", default=None,
                   help="filter bench A/B rows by label on both sides")
    r.add_argument("--min-band-pct", type=float, default=None,
                   help="noise-band floor in percent (default 5)")
    r.add_argument("--phases", action="store_true",
                   help="gate per-phase span medians (two run JSONLs) — the verdict "
                        "names the phase that moved")
    r.add_argument("--tail", action="store_true",
                   help="gate an upper quantile (default p99) per phase/endpoint with "
                        "its own learned MAD band, naming the quantile and the group")
    r.add_argument("--quantile", type=float, default=None, metavar="Q",
                   help="tail quantile in [0.5, 1) (default 0.99; requires --tail)")
    r.add_argument("--json", action="store_true", dest="as_json",
                   help="verdict as one JSON line (default: human line + JSON)")
    r.add_argument("--selfcheck", action="store_true",
                   help="prove the gate flags an injected 30%% slowdown and passes an "
                        "identical run, then exit")

    h = sub.add_parser("hist", help="streaming-histogram tooling (obs/hist.py)")
    h.add_argument("--selfcheck", action="store_true",
                   help="prove the histogram math: known-distribution quantile error "
                        "bound, exact small-N path, merge associativity, cross-restart "
                        "composition round trip, exposition round trip")

    m = sub.add_parser("serve-metrics", help="Prometheus /metrics sidecar over a run dir")
    m.add_argument("--run-dir", required=True, metavar="DIR")
    m.add_argument("--host", default="127.0.0.1")
    m.add_argument("--port", type=int, default=9321)
    m.add_argument("--port-file", default=None, metavar="PATH")
    m.add_argument("--stale-after-s", type=float, default=None)
    return p


def _beside(jsonl: str, explicit: str | None, name: str) -> str | None:
    if explicit is not None:
        return explicit
    cand = os.path.join(os.path.dirname(os.path.abspath(jsonl)), name)
    return cand if os.path.exists(cand) else None


def _load_tolerant(jsonl: str) -> list[dict] | None:
    try:
        records, dropped = load_records_tolerant(jsonl)
    except (OSError, ValueError) as e:
        print(f"cannot read {jsonl}: {e}", file=sys.stderr)
        return None
    if dropped:
        print(f"note: dropped a truncated final line in {jsonl} "
              "(crash artifact)", file=sys.stderr)
    return records


def _cmd_summarize(args) -> int:
    if args.selfcheck:
        problems = selfcheck()
        if problems:
            for pr in problems:
                print(f"selfcheck: {pr}", file=sys.stderr)
            return 1
        print("obs selfcheck: OK (record schema + summarize pipeline)")
        return 0

    if not args.jsonl:
        if args.heartbeat:
            # serving processes have no generation JSONL — liveness +
            # serving counters come from the heartbeat alone
            s = summarize([], heartbeat_path=args.heartbeat)
            print(json.dumps(s, default=float) if args.as_json
                  else format_summary(s))
            return 0
        print("summarize needs a run JSONL (or --heartbeat PATH, or "
              "--selfcheck)", file=sys.stderr)
        return 3
    records = _load_tolerant(args.jsonl)
    if records is None:
        return 1
    s = summarize(records,
                  heartbeat_path=_beside(args.jsonl, args.heartbeat,
                                         "heartbeat.json"),
                  manifest_path=_beside(args.jsonl, args.manifest,
                                        "manifest.json"))
    if args.as_json:
        print(json.dumps(s, default=float))
    else:
        print(format_summary(s))
    return 0


def _cmd_trace(args) -> int:
    from .recorder import read_heartbeat
    from .export.traceevent import export_trace, validate_trace, write_trace

    records = _load_tolerant(args.jsonl)
    if records is None:
        return 1
    manifest = None
    mf = _beside(args.jsonl, args.manifest, "manifest.json")
    if mf:
        try:
            with open(mf) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            print(f"note: ignoring unreadable manifest {mf}: {e}",
                  file=sys.stderr)
    hb_path = _beside(args.jsonl, args.heartbeat, "heartbeat.json")
    heartbeat = read_heartbeat(hb_path) if hb_path else None
    events = None
    if args.events:
        try:
            events, dropped = load_records_tolerant(args.events)
            if dropped:
                print(f"note: dropped a truncated final line in "
                      f"{args.events}", file=sys.stderr)
        except (OSError, ValueError) as e:
            print(f"cannot read {args.events}: {e}", file=sys.stderr)
            return 1
    trace = export_trace(records, manifest=manifest, events=events,
                         heartbeat=heartbeat)
    problems = validate_trace(trace)
    if problems:  # exporter bug, not user error — still fail loudly
        for pr in problems:
            print(f"trace: invalid output: {pr}", file=sys.stderr)
        return 1
    out = args.out or os.path.join(
        os.path.dirname(os.path.abspath(args.jsonl)), "trace.json")
    write_trace(trace, out)
    meta = trace["otherData"]
    print(f"trace: {len(trace['traceEvents'])} events, "
          f"{meta['generations']} generations, "
          f"{meta['segments']} segment(s), "
          f"{meta['restart_markers']} restart marker(s) -> {out}")
    return 0


def _cmd_profile(args) -> int:
    from .profile import (find_cost_model, format_profile, platform_roofline,
                          profile_records)
    from .profile.report import selfcheck as profile_selfcheck

    if args.selfcheck:
        problems = profile_selfcheck()
        if problems:
            for pr in problems:
                print(f"profile selfcheck: {pr}", file=sys.stderr)
            return 1
        print("obs profile selfcheck: OK (known-FLOPs MFU exact, ledger "
              "round-trips the exposition parser, 30% eval slowdown "
              "localized to eval)")
        return 0
    if not args.jsonl:
        print("profile needs a run JSONL (or --selfcheck)", file=sys.stderr)
        return 3
    records = _load_tolerant(args.jsonl)
    if records is None:
        return 1
    platform, kind = args.platform, None
    mf = _beside(args.jsonl, args.manifest, "manifest.json")
    devs = []
    if mf:
        try:
            with open(mf) as f:
                devs = json.load(f).get("devices") or []
            # the manifest schema (obs/manifest.py) is a LIST of
            # per-device dicts; tolerate a bare dict too
            if isinstance(devs, dict):
                devs = [devs]
            devs = [d for d in devs if isinstance(d, dict)]
        except (OSError, ValueError) as e:
            print(f"note: ignoring unreadable manifest {mf}: {e}",
                  file=sys.stderr)
    # a card's kind picks its roofline (obs/profile/roofline.py)
    gpus = [d for d in devs if str(d.get("platform", "")).lower() == "gpu"]
    if platform == "auto":
        platform = "cpu"
        if gpus:
            platform = "gpu"
        elif any(str(d.get("platform", "")).lower() == "tpu" for d in devs):
            platform = "tpu"
    if platform == "gpu" and gpus:
        kind = gpus[0].get("kind")
    roofline = platform_roofline(platform, kind=kind)
    p = profile_records(records, roofline,
                        cost_model=find_cost_model(records))
    if args.as_json:
        print(json.dumps(p, default=float))
    else:
        print(format_profile(p))
    return 0


def _cmd_regress(args) -> int:
    from .export import regress as _regress

    if args.selfcheck:
        if args.tail:
            problems = _regress.tail_selfcheck()
            if problems:
                for pr in problems:
                    print(f"regress --tail selfcheck: {pr}",
                          file=sys.stderr)
                return 1
            print("obs regress --tail selfcheck: OK (a median-clean "
                  "~2%-of-requests-5x-slower pair passes the median gate "
                  "but is flagged at p99, naming the quantile and the "
                  "endpoint/phase)")
            return 0
        problems = _regress.selfcheck()
        if problems:
            for pr in problems:
                print(f"regress selfcheck: {pr}", file=sys.stderr)
            return 1
        print("obs regress selfcheck: OK (flags a 30% injected slowdown, "
              "passes an identical run)")
        return 0
    if args.quantile is not None and not args.tail:
        print("regress: --quantile only applies to the --tail gate",
              file=sys.stderr)
        return 3
    if not args.current or not args.baseline:
        print("regress needs <current> --baseline PATH (or --selfcheck)",
              file=sys.stderr)
        return 3
    kw = {}
    if args.min_band_pct is not None:
        kw["min_band_pct"] = args.min_band_pct
    if args.tail:
        if args.phases or args.label is not None:
            print("regress: --tail is its own gate — it cannot combine "
                  "with --phases or --label", file=sys.stderr)
            return 3
        if args.quantile is not None:
            kw["quantile"] = args.quantile
        try:
            verdict = _regress.compare_tail_files(args.current,
                                                  args.baseline, **kw)
        except (OSError, ValueError) as e:
            print(f"regress: {e}", file=sys.stderr)
            return 1
        if not args.as_json:
            qn = verdict["quantile"]
            if verdict["regressed_groups"]:
                for name in verdict["regressed_groups"]:
                    row = verdict["groups"][name]
                    print(f"regress: TAIL REGRESSION — {qn} of {name!r} "
                          f"{row['current_q_s']}s vs baseline "
                          f"{row['baseline_q_s']}s (slowdown "
                          f"{row['slowdown_pct']}%, band "
                          f"{row['band_pct']}%, median "
                          f"{row['median_verdict']})")
            else:
                print(f"regress: pass — {qn} of "
                      f"{len(verdict['groups'])} group(s) within their "
                      "learned tail bands")
        print(json.dumps(verdict, default=float))
        return 0 if verdict["verdict"] == "pass" else 1
    if args.phases:
        if args.label is not None:
            # phase records carry no labels — silently ignoring the
            # filter would attribute a verdict to rows the user excluded
            print("regress: --label filters bench A/B rows; --phases "
                  "gates run-JSONL span records, which carry no labels "
                  "— the two cannot combine", file=sys.stderr)
            return 3
        try:
            verdict = _regress.compare_phase_files(args.current,
                                                   args.baseline, **kw)
        except (OSError, ValueError) as e:
            print(f"regress: {e}", file=sys.stderr)
            return 1
        if not args.as_json:
            if verdict["regressed_phases"]:
                for name in verdict["regressed_phases"]:
                    row = verdict["phases"][name]
                    print(f"regress: REGRESSION in phase {name!r} — "
                          f"{row['current_median_s']}s vs baseline "
                          f"{row['baseline_median_s']}s (slowdown "
                          f"{row['slowdown_pct']}%, band "
                          f"{row['band_pct']}%)")
            else:
                print(f"regress: pass — {len(verdict['phases'])} phase(s) "
                      "within their noise bands")
        print(json.dumps(verdict, default=float))
        return 0 if verdict["verdict"] == "pass" else 1
    try:
        verdict = _regress.compare_files(args.current, args.baseline,
                                         label=args.label, **kw)
    except (OSError, ValueError) as e:
        print(f"regress: {e}", file=sys.stderr)
        return 1
    if not args.as_json:
        word = ("REGRESSION" if verdict["verdict"] == "regress"
                else ("pass (improved)" if verdict.get("improved")
                      else "pass"))
        print(f"regress: {word} — {verdict['metric']} "
              f"{verdict['current_median']} vs baseline "
              f"{verdict['baseline_median']} "
              f"(drop {verdict['drop_pct']}%, band {verdict['band_pct']}%)")
    print(json.dumps(verdict, default=float))
    return 0 if verdict["verdict"] == "pass" else 1


def _cmd_hist(args) -> int:
    from . import hist as _hist
    from .export.prometheus import parse_exposition, render_exposition

    if not args.selfcheck:
        print("hist currently has only --selfcheck", file=sys.stderr)
        return 3
    problems = _hist.selfcheck(render=render_exposition,
                               parse=parse_exposition)
    if problems:
        for pr in problems:
            print(f"hist selfcheck: {pr}", file=sys.stderr)
        return 1
    print("obs hist selfcheck: OK (exact small-N quantiles, "
          "known-distribution error bound, merge associativity, "
          "cross-restart composition + exposition round trips)")
    return 0


def _cmd_serve_metrics(args) -> int:
    from .export import sidecar as _sidecar

    argv = ["--run-dir", args.run_dir, "--host", args.host,
            "--port", str(args.port)]
    if args.port_file:
        argv += ["--port-file", args.port_file]
    if args.stale_after_s is not None:
        argv += ["--stale-after-s", str(args.stale_after_s)]
    return _sidecar.main(argv)


def _not_ported(what: str, item: str) -> int:
    print(f"obs {what} is not ported yet (ROADMAP.md, port queue item {item}); the port "
          "has: summarize, trace, profile, regress, hist, serve-metrics", file=sys.stderr)
    return 3


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] and argv[0] in NOT_PORTED:
        return _not_ported(argv[0], NOT_PORTED[argv[0]])
    if argv[:1] == ["trace"] and any(f in argv for f in _FLEET_TRACE_FLAGS):
        return _not_ported("trace --fleet/--store/--selfcheck (distributed traces)", "9")
    args = build_parser().parse_args(argv)
    if args.cmd == "summarize":
        return _cmd_summarize(args)
    if args.cmd == "trace":
        return _cmd_trace(args)
    if args.cmd == "profile":
        return _cmd_profile(args)
    if args.cmd == "regress":
        return _cmd_regress(args)
    if args.cmd == "hist":
        return _cmd_hist(args)
    if args.cmd == "serve-metrics":
        return _cmd_serve_metrics(args)
    build_parser().print_help()
    return 3


if __name__ == "__main__":
    sys.exit(main())
