"""Cross-process trace assembly: fleet segments → one Perfetto timeline.

``python -m estorch_tpu_torch.obs trace --fleet DIR...`` (or, on a
wedged-CUDA host, ``python estorch_tpu_torch/obs/agg/traces.py``) is the
assembly half of distributed tracing (``obs/tracing.py`` is the
per-process half): every hop of a sampled
request — the router's ``route`` span and per-attempt ``upstream`` legs
(retries and BOTH hedge legs, the loser marked cancelled), the replica's
``request`` span with its ``queue_wait``/``coalesce``/``compute``/
``write`` children, the batcher's per-dispatch ``batch`` span — lands in
that process's ``traces.jsonl``, and this module joins them by trace id
into one timeline:

* per-process LANES (Perfetto process rows), one thread row per
  assembled trace, every segment an ``X`` duration event placed on the
  wall-clock axis (``ts`` is the cross-process alignment key — the
  per-process monotonic marks share no epoch);
* cross-process parent→child hand-offs drawn as FLOW ARROWS (``s``/``f``
  pairs): router leg → replica request, so a hedged request reads as one
  picture — two arrows leaving the router, the loser's lane ending in a
  cancelled leg;
* the output passes ``validate_trace`` (obs/export/traceevent.py), the
  same schema gate every other exporter answers to.

Inputs: ``--fleet`` takes run dirs (each holding a ``traces.jsonl``),
parent dirs of such dirs (a fleet workdir — every child dir is
scanned), or segment files directly; ``--store`` reads the
``traces-<target>.jsonl`` files the collector scraped off the fleet's
``/traces?since=`` endpoints — assembly from the store alone, no access
to the replicas' disks.  Foreign lines, torn tails, and trace ids that
never cross a process boundary degrade to smaller output, never a
crash.

``obs slow --store DIR [--quantile Q]`` is the exemplar join: the
stored request histograms carry per-bucket trace-id exemplars
(obs/hist.py), so the worst in-window traces are NAMED, assembled from
the store's scraped segments, and printed with a per-hop breakdown —
"p99 breached, and here is exactly where trace X spent it".

``--selfcheck`` proves the join on a synthetic three-process segment
set: hedged trace assembled across router + two
replicas with the win attributed and the loser cancelled, flow arrows
present, torn tail tolerated, foreign trace ids isolated, exported
JSON schema-clean.

Stdlib-only, torch-free, file-runnable — the sidecar discipline.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zlib

if __package__:
    from ..export.traceevent import validate_trace, write_trace
    from ..tracing import TRACES_FILENAME, valid_segment
    from .store import SeriesStore
else:  # file-run (wedged-CUDA host): load siblings without package init
    import importlib.util

    def _load(name: str, *rel: str):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            *rel)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    _traceevent = _load("_estorch_torch_obs_traceevent", os.pardir, "export",
                        "traceevent.py")
    _tracing = _load("_estorch_torch_obs_tracing", os.pardir, "tracing.py")
    _store_mod = _load("_estorch_torch_obs_agg_store", "store.py")
    validate_trace = _traceevent.validate_trace
    write_trace = _traceevent.write_trace
    TRACES_FILENAME = _tracing.TRACES_FILENAME
    valid_segment = _tracing.valid_segment
    SeriesStore = _store_mod.SeriesStore

# collector-scraped per-target segment files in a store root
TRACE_FILE_PREFIX = "traces-"
# metric names the exemplar join tries, in preference order: the
# router's end-to-end route histogram sees the whole hop chain; a
# router-less fleet still has the replicas' request histogram
SLOW_HIST_NAMES = ("estorch_router_route_s", "estorch_serve_request_s")
DEFAULT_SLOW_WINDOW_S = 900.0


def _us(seconds: float) -> float:
    return round(float(seconds) * 1e6, 3)


# ----------------------------------------------------------------- inputs

def trace_files(paths: list[str]) -> list[str]:
    """Segment files named by ``--fleet`` operands: a file is taken as
    is; a dir contributes its own ``traces.jsonl``, every child dir's
    ``traces.jsonl`` (the fleet-workdir case: ``router/``, ``r0/``, …),
    and any collector-scraped ``traces-*.jsonl`` at its top level."""
    out: list[str] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            out.append(p)
            continue
        if not os.path.isdir(p):
            continue
        own = os.path.join(p, TRACES_FILENAME)
        if os.path.isfile(own):
            out.append(own)
        try:
            children = sorted(os.listdir(p))
        except OSError:
            children = []
        for name in children:
            child = os.path.join(p, name)
            if (os.path.isfile(child) and name.startswith(TRACE_FILE_PREFIX)
                    and name.endswith(".jsonl")):
                out.append(child)
            elif os.path.isdir(child):
                sub = os.path.join(child, TRACES_FILENAME)
                if os.path.isfile(sub):
                    out.append(sub)
    # stable + deduped: the same file named twice must not double spans
    seen: set[str] = set()
    uniq = []
    for f in out:
        if f not in seen:
            seen.add(f)
            uniq.append(f)
    return uniq


def store_trace_files(store_dir: str) -> list[str]:
    """The collector's scraped segment files in a store root."""
    root = os.path.abspath(store_dir)
    try:
        names = sorted(n for n in os.listdir(root)
                       if n.startswith(TRACE_FILE_PREFIX)
                       and n.endswith(".jsonl"))
    except OSError:
        return []
    return [os.path.join(root, n) for n in names]


def load_segments(files: list[str]) -> list[dict]:
    """Valid segments across files, torn-tail / foreign-line tolerant,
    deduped on (trace_id, proc, span_id) — the same span scraped into
    two files (fleet dir AND store) must not render twice."""
    out: list[dict] = []
    seen: set[tuple] = set()
    for path in files:
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            continue
        for ln in text.splitlines():
            if not ln.strip():
                continue
            try:
                row = json.loads(ln)
            except ValueError:
                continue  # torn tail / foreign line
            if not valid_segment(row):
                continue
            key = (row["trace_id"], row["proc"], row["span_id"])
            if key in seen:
                continue
            seen.add(key)
            out.append(row)
    return out


# --------------------------------------------------------------- assembly

def assemble(segments: list[dict]) -> dict[str, dict]:
    """Join segments by trace id → ``{trace_id: trace}`` where a trace
    is ``{"trace_id", "segments" (ts order), "procs" (first-seen order),
    "t0", "dur_s", "sampled"}``.  ``dur_s`` spans the earliest start to
    the latest end across ALL processes (the wall-clock union — what the
    client experienced, retries and hedges included)."""
    by_id: dict[str, list[dict]] = {}
    for s in segments:
        by_id.setdefault(s["trace_id"], []).append(s)
    out: dict[str, dict] = {}
    for tid, segs in by_id.items():
        segs.sort(key=lambda s: (s["ts"], s.get("seq", 0)))
        procs: list[str] = []
        for s in segs:
            if s["proc"] not in procs:
                procs.append(s["proc"])
        t0 = min(s["ts"] for s in segs)
        t1 = max(s["ts"] + s["dur_s"] for s in segs)
        sampled = None
        for s in segs:
            r = (s.get("attrs") or {}).get("sampled")
            if isinstance(r, str):
                sampled = r
                break
        out[tid] = {"trace_id": tid, "segments": segs, "procs": procs,
                    "t0": t0, "dur_s": max(0.0, t1 - t0),
                    "sampled": sampled}
    return out


def _span_index(trace: dict) -> dict[str, dict]:
    return {s["span_id"]: s for s in trace["segments"]}


def cross_process_edges(trace: dict) -> list[tuple[dict, dict]]:
    """(parent, child) segment pairs whose hand-off crosses a process
    boundary — the edges rendered as flow arrows."""
    idx = _span_index(trace)
    edges = []
    for s in trace["segments"]:
        parent = idx.get(s.get("parent_span_id") or "")
        if parent is not None and parent["proc"] != s["proc"]:
            edges.append((parent, s))
    return edges


def export_fleet_trace(traces: list[dict], files: int = 0) -> dict:
    """Assembled traces → one Perfetto trace-event dict: per-process
    lanes (pid per proc), one thread row per trace, cross-process
    hand-offs as flow arrows (see module docstring)."""
    procs: list[str] = []
    for t in traces:
        for p in t["procs"]:
            if p not in procs:
                procs.append(p)
    pid_of = {p: 1000 + i for i, p in enumerate(procs)}
    events: list[dict] = []
    for p in procs:
        events.append({"ph": "M", "name": "process_name",
                       "pid": pid_of[p], "tid": 0, "args": {"name": p}})
    t_base = min((t["t0"] for t in traces), default=0.0)
    for k, t in enumerate(traces):
        tid = k + 1
        for p in t["procs"]:
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid_of[p], "tid": tid,
                           "args": {"name": f"trace {t['trace_id']}"}})
        for s in t["segments"]:
            args = {"trace_id": s["trace_id"], "span_id": s["span_id"],
                    **(s.get("attrs") or {})}
            if s.get("parent_span_id"):
                args["parent_span_id"] = s["parent_span_id"]
            events.append({
                "ph": "X", "name": s["name"], "cat": "trace",
                "ts": _us(max(0.0, s["ts"] - t_base)),
                "dur": _us(s["dur_s"]),
                "pid": pid_of[s["proc"]], "tid": tid, "args": args,
            })
        for parent, child in cross_process_edges(t):
            # one arrow per hand-off; Chrome binds flows on identical
            # (cat, id, name), and the id must be an int — derive it
            # from the child span (unique per edge by construction)
            fid = zlib.crc32(
                f"{t['trace_id']}/{child['span_id']}".encode()) & 0x7FFFFFFF
            for ph, seg in (("s", parent), ("f", child)):
                ev = {"ph": ph, "id": fid, "name": t["trace_id"],
                      "cat": "hop", "ts": _us(max(0.0, seg["ts"] - t_base)),
                      "pid": pid_of[seg["proc"]], "tid": tid}
                if ph == "f":
                    ev["bp"] = "e"
                events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "exporter": "estorch_tpu_torch.obs trace --fleet",
            "traces": len(traces),
            "procs": procs,
            "files": files,
        },
    }


# ------------------------------------------------------------- formatting

_NOTE_KEYS = ("status", "replica", "attempt", "attempts", "hedge",
              "cancelled", "error", "bucket", "n", "sampled")


def _notes(attrs: dict) -> str:
    parts = []
    for k in _NOTE_KEYS:
        if k in (attrs or {}):
            v = attrs[k]
            if isinstance(v, bool):
                if v:
                    parts.append(k)
            else:
                parts.append(f"{k}={v}")
    return " ".join(parts)


def format_trace(trace: dict) -> str:
    """Human per-hop breakdown of one assembled trace: offset from the
    trace start, duration, process, span name, and the attrs that
    explain the hop (status, replica, hedge/cancelled, sampling
    reason)."""
    head = (f"trace {trace['trace_id']}  "
            f"{trace['dur_s'] * 1e3:.1f}ms  "
            f"procs={','.join(trace['procs'])}"
            + (f"  sampled={trace['sampled']}" if trace["sampled"]
               else ""))
    lines = [head]
    for s in trace["segments"]:
        off = (s["ts"] - trace["t0"]) * 1e3
        note = _notes(s.get("attrs") or {})
        lines.append(f"  +{off:8.1f}ms {s['dur_s'] * 1e3:9.1f}ms  "
                     f"{s['proc']:<16} {s['name']:<12}"
                     + (f"  {note}" if note else ""))
    return "\n".join(lines)


# ------------------------------------------------------------- slow join

def slowest_traces(store_dir: str, quantile: float = 0.99,
                   window_s: float = DEFAULT_SLOW_WINDOW_S,
                   limit: int = 5) -> dict:
    """The ``obs slow`` body: exemplar trace ids above the quantile from
    the STORED request histograms, joined against the store's scraped
    segments.  Returns ``{"metric", "quantile", "q_s", "ids",
    "traces" (assembled, worst first), "missing" (exemplar ids with no
    scraped segments)}`` — everything from the store alone."""
    store = SeriesStore(store_dir)
    # the store is written by another process: derive "now" from the
    # data, not the wall clock (a post-mortem store must still answer)
    now = 0.0
    for row in store._iter_rows(0.0):
        now = max(now, float(row["ts"]))
    metric, hist = None, None
    for name in SLOW_HIST_NAMES:
        h = store.hist_window(name, window_s=window_s, now=now)
        if h is not None and h.count > 0:
            metric, hist = name, h
            break
    if hist is None:
        return {"metric": None, "quantile": quantile, "q_s": None,
                "ids": [], "traces": [], "missing": []}
    ids = hist.slow_exemplars(q=quantile)
    assembled = assemble(load_segments(store_trace_files(store_dir)))
    traces, missing = [], []
    for tid in ids:
        t = assembled.get(tid)
        if t is not None:
            traces.append(t)
        else:
            missing.append(tid)
    traces.sort(key=lambda t: -t["dur_s"])
    return {"metric": metric, "quantile": quantile,
            "q_s": hist.quantile(quantile), "ids": ids[:limit],
            "traces": traces[:limit], "missing": missing}


# -------------------------------------------------------------- selfcheck

def _synth_segment(tid, span, parent, proc, name, ts, dur, **attrs):
    return {"trace_id": tid, "span_id": span, "parent_span_id": parent,
            "proc": proc, "name": name, "t0_mono": ts, "dur_s": dur,
            "ts": ts, "seq": 1, "attrs": attrs}


def selfcheck() -> list[str]:
    """Prove the assembly on a synthetic three-process fleet ([] =
    healthy): a hedged trace whose segments span
    router + two replicas must join into one trace with both upstream
    legs (loser cancelled, win attributed), export with cross-process
    flow arrows and a schema-clean validate, tolerate a torn tail, and
    keep a foreign trace id isolated in its own assembly."""
    import tempfile

    problems: list[str] = []
    base = 1_700_000_000.0
    hedge = [
        _synth_segment("t-hedge", "router.1", None, "router", "route",
                       base, 0.080, status=200, replica="r0", attempts=1,
                       sampled="hedge"),
        _synth_segment("t-hedge", "router.2", "router.1", "router",
                       "upstream", base + 0.001, 0.060, replica="r0",
                       attempt=0, hedge=False, status=200),
        _synth_segment("t-hedge", "router.3", "router.1", "router",
                       "upstream", base + 0.030, 0.045, replica="r1",
                       attempt=0, hedge=True, cancelled=True,
                       error="cancelled"),
        _synth_segment("t-hedge", "server-a.1", "router.2", "server-a",
                       "request", base + 0.004, 0.050, status=200),
        _synth_segment("t-hedge", "server-a.2", "server-a.1", "server-a",
                       "compute", base + 0.010, 0.030, bucket=2, n=1),
        _synth_segment("t-hedge", "server-b.1", "router.3", "server-b",
                       "request", base + 0.033, 0.020, status=200),
    ]
    baseline = [
        _synth_segment("t-base", "router.4", None, "router", "route",
                       base + 1.0, 0.010, status=200, sampled="head"),
        _synth_segment("t-base", "router.5", "router.4", "router",
                       "upstream", base + 1.001, 0.008, replica="r0",
                       attempt=0, status=200),
        _synth_segment("t-base", "server-a.3", "router.5", "server-a",
                       "request", base + 1.002, 0.006, status=200),
    ]
    foreign = [
        _synth_segment("t-foreign", "server-b.9", None, "server-b",
                       "request", base + 2.0, 0.004, status=200),
    ]
    with tempfile.TemporaryDirectory() as d:
        by_proc = {"router": [], "r0": [], "r1": []}
        for s in hedge + baseline:
            by_proc[{"router": "router", "server-a": "r0",
                     "server-b": "r1"}[s["proc"]]].append(s)
        by_proc["r1"].extend(foreign)
        for name, segs in by_proc.items():
            os.makedirs(os.path.join(d, name))
            with open(os.path.join(d, name, TRACES_FILENAME), "w") as f:
                for s in segs:
                    f.write(json.dumps(s) + "\n")
        # torn tail + foreign line on one file: a crash artifact and a
        # stray log line must degrade, never crash the join
        with open(os.path.join(d, "r0", TRACES_FILENAME), "a") as f:
            f.write("not json at all\n")
            f.write('{"trace_id": "t-torn", "span_id": "x", "pr')

        files = trace_files([d])
        if len(files) != 3:
            problems.append(f"expected 3 segment files under the fleet "
                            f"dir, found {len(files)}: {files}")
        assembled = assemble(load_segments(files))
        th = assembled.get("t-hedge")
        if th is None:
            return problems + ["hedged trace did not assemble"]
        if th["procs"] != ["router", "server-a", "server-b"]:
            problems.append(f"hedged trace procs wrong: {th['procs']}")
        legs = [s for s in th["segments"] if s["name"] == "upstream"]
        if len(legs) != 2:
            problems.append(f"expected both hedge legs, got {len(legs)}")
        else:
            cancelled = [s for s in legs
                         if (s["attrs"] or {}).get("cancelled")]
            winners = [s for s in legs
                       if (s["attrs"] or {}).get("status") == 200]
            if len(cancelled) != 1 or len(winners) != 1:
                problems.append(
                    f"win attribution wrong: {len(winners)} winner(s), "
                    f"{len(cancelled)} cancelled")
        if th["sampled"] != "hedge":
            problems.append(f"sampling reason lost: {th['sampled']!r}")
        if "t-foreign" not in assembled:
            problems.append("foreign trace id vanished entirely")
        elif assembled["t-foreign"]["procs"] != ["server-b"]:
            problems.append("foreign trace leaked across processes")
        if "t-torn" in assembled:
            problems.append("torn tail line assembled as a segment")

        ordered = sorted(assembled.values(), key=lambda t: t["t0"])
        trace = export_fleet_trace(ordered, files=len(files))
        schema = validate_trace(trace)
        if schema:
            problems.append(f"exported trace fails validate_trace: "
                            f"{schema[:3]}")
        flows = [e for e in trace["traceEvents"] if e["ph"] in ("s", "f")]
        pids = {e["pid"] for e in flows}
        # hedge: router→server-a and router→server-b; baseline:
        # router→server-a — three edges = six flow events, across ≥2 pids
        if len(flows) != 6:
            problems.append(f"expected 6 flow events (3 cross-process "
                            f"edges), got {len(flows)}")
        if len(pids) < 2:
            problems.append("flow arrows do not cross process lanes")
        out = os.path.join(d, "fleet_trace.json")
        write_trace(trace, out)
        try:
            with open(out) as f:
                json.load(f)
        except ValueError as e:
            problems.append(f"written trace is not valid JSON: {e}")
        text = format_trace(th)
        if "cancelled" not in text or "server-b" not in text:
            problems.append("per-hop breakdown loses the cancelled "
                            "hedge leg")
    return problems


# ------------------------------------------------------------------- CLI

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m estorch_tpu_torch.obs trace",
        description="assemble fleet trace segments into one Perfetto "
                    "timeline")
    p.add_argument("--fleet", nargs="*", metavar="DIR",
                   help="run dirs / fleet workdirs / segment files "
                        "holding traces.jsonl")
    p.add_argument("--store", metavar="DIR",
                   help="collector store root: assemble from the scraped "
                        "traces-<target>.jsonl files instead")
    p.add_argument("--trace-id", action="append", default=None,
                   metavar="ID", help="assemble only these trace ids "
                                      "(repeatable; default: all)")
    p.add_argument("-o", "--out", default=None, metavar="PATH",
                   help="output path (default: fleet_trace.json beside "
                        "the first input)")
    p.add_argument("--print", action="store_true", dest="do_print",
                   help="also print each assembled trace's per-hop "
                        "breakdown")
    p.add_argument("--selfcheck", action="store_true",
                   help="prove the assembly on a synthetic 3-process "
                        "segment set and exit")
    return p


def build_slow_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m estorch_tpu_torch.obs slow",
        description="worst stored traces via histogram exemplars")
    p.add_argument("--store", required=True, metavar="DIR",
                   help="collector store root")
    p.add_argument("--quantile", type=float, default=0.99, metavar="Q",
                   help="exemplars at/above this stored quantile "
                        "(default 0.99)")
    p.add_argument("--window", type=float, default=DEFAULT_SLOW_WINDOW_S,
                   metavar="S", help="stored-history window in seconds")
    p.add_argument("--limit", type=int, default=5, metavar="N",
                   help="show at most N traces (default 5)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable result on stdout")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.selfcheck:
        problems = selfcheck()
        if problems:
            for pr in problems:
                print(f"trace selfcheck: {pr}", file=sys.stderr)
            return 1
        print("obs trace selfcheck: OK (3-process hedged trace assembled "
              "with both legs and the win attributed, cross-process flow "
              "arrows validate, torn tail tolerated, foreign trace ids "
              "isolated)")
        return 0
    if bool(args.fleet) == bool(args.store):
        print("trace assembly needs exactly one of --fleet DIR... / "
              "--store DIR (or --selfcheck)", file=sys.stderr)
        return 3
    files = (trace_files(args.fleet) if args.fleet
             else store_trace_files(args.store))
    if not files:
        print("trace: no segment files found (nothing sampled yet, or "
              "wrong dir?)", file=sys.stderr)
        return 2
    assembled = assemble(load_segments(files))
    if args.trace_id:
        missing = [t for t in args.trace_id if t not in assembled]
        for t in missing:
            print(f"note: trace id {t!r} not in the segment files",
                  file=sys.stderr)
        assembled = {k: v for k, v in assembled.items()
                     if k in set(args.trace_id)}
    if not assembled:
        print("trace: no assembled traces", file=sys.stderr)
        return 1
    ordered = sorted(assembled.values(), key=lambda t: t["t0"])
    trace = export_fleet_trace(ordered, files=len(files))
    problems = validate_trace(trace)
    if problems:  # exporter bug, not user error — still fail loudly
        for pr in problems:
            print(f"trace: invalid output: {pr}", file=sys.stderr)
        return 1
    first = args.fleet[0] if args.fleet else args.store
    out = args.out or os.path.join(
        first if os.path.isdir(first)
        else os.path.dirname(os.path.abspath(first)), "fleet_trace.json")
    write_trace(trace, out)
    cross = sum(len(cross_process_edges(t)) for t in ordered)
    print(f"trace: {len(ordered)} trace(s) across "
          f"{len(trace['otherData']['procs'])} process(es), "
          f"{cross} cross-process hop(s), {len(files)} file(s) -> {out}")
    if args.do_print:
        for t in ordered:
            print(format_trace(t))
    return 0


def main_slow(argv: list[str] | None = None) -> int:
    args = build_slow_parser().parse_args(argv)
    if not 0.5 <= args.quantile < 1.0:
        print("slow: --quantile must be in [0.5, 1)", file=sys.stderr)
        return 3
    result = slowest_traces(args.store, quantile=args.quantile,
                            window_s=args.window, limit=args.limit)
    if args.as_json:
        print(json.dumps({**result,
                          "traces": [{k: v for k, v in t.items()}
                                     for t in result["traces"]]},
                         default=float))
        return 0 if result["traces"] else 1
    if result["metric"] is None:
        print("slow: no stored request histogram in the window (is the "
              "collector running against this store?)", file=sys.stderr)
        return 1
    q_ms = (result["q_s"] or 0.0) * 1e3
    print(f"slow: {result['metric']} p{args.quantile * 100:g} = "
          f"{q_ms:.1f}ms, {len(result['ids'])} exemplar(s) above it")
    for t in result["traces"]:
        print(format_trace(t))
    for tid in result["missing"]:
        print(f"  {tid}: exemplar known, but no scraped segments in the "
              "store (dropped by the source sampler, or scrape lag)")
    if not result["traces"] and not result["missing"]:
        print("  (no exemplars recorded yet)")
    return 0 if result["traces"] else 1


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv[:1] == ["slow"]:
        sys.exit(main_slow(argv[1:]))
    sys.exit(main(argv))
