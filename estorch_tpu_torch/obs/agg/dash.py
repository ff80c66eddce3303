"""``obs dash`` — the fleet on one terminal screen.

Renders the collector's STORED history (never a live endpoint — the
whole point of the store is that the dash works while a replica is dead)
as a per-target table:

    target     up   gen    req p50/p99 ms   disp p99 ms   queue   recomp   alerts
    serve-a    UP    -        1.2 / 4.8          -            0        2    -
    serve-b    DOWN  -          -  /  -          -            -        -    replica-down
    run-1      UP    41         -  /  -         3.1           -        0    -

Columns come from the stored metric names every surface already exports:
``estorch_up`` (liveness), ``estorch_heartbeat_generation`` (training
progress), ``estorch_serve_request_s`` (request-latency histogram →
p50/p99), ``estorch_async_fold_latency_s`` (dispatch-to-fold p99 for
training runs), ``estorch_queue_depth``, ``estorch_recompiles``
(windowed increase, reset-aware), plus the active alerts from the
ledger.  Missing metrics render as ``-`` — a training run has no
request latencies and a serve replica has no generations, and the dash
must say so rather than fabricate.  The ``slowest`` column names the
worst in-window trace id from the latency histogram's bucket exemplars
— paste it into ``obs slow --store`` for the per-hop breakdown;
targets exporting no
exemplars render ``-``.

Autoscaled router targets (obs/agg/autoscale.py) get two more columns,
derived from the store + the append-only decision log alone: ``scale``
is desired-vs-actual replicas (``3→5`` while the fleet converges, a
bare count once it has), ``scale age`` is seconds since the last
decision event in ``autoscale_decisions.jsonl``.  Non-autoscaled
targets render ``-`` in both.

``--once`` prints one frame (scriptable, CI-friendly); ``--watch N``
redraws every N seconds until interrupted.

Stdlib-only, file-runnable (``python estorch_tpu_torch/obs/agg/dash.py``) —
the wedged-host discipline shared with the sidecar and collector.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__:
    from .autoscale import DECISIONS_FILENAME, read_decisions
    from .rules import (LEDGER_FILENAME, LEDGER_MAX_TRANSITIONS,
                        read_ledger)
    from .store import SeriesStore
else:  # file-run: load siblings without any package init
    import importlib.util

    def _load(name: str, fname: str):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            fname)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    _store = _load("_estorch_torch_obs_agg_store", "store.py")
    _rules = _load("_estorch_torch_obs_agg_rules", "rules.py")
    _autoscale = _load("_estorch_torch_obs_agg_autoscale", "autoscale.py")
    SeriesStore = _store.SeriesStore
    read_ledger = _rules.read_ledger
    LEDGER_FILENAME = _rules.LEDGER_FILENAME
    LEDGER_MAX_TRANSITIONS = _rules.LEDGER_MAX_TRANSITIONS
    DECISIONS_FILENAME = _autoscale.DECISIONS_FILENAME
    read_decisions = _autoscale.read_decisions

REQUEST_HIST = "estorch_serve_request_s"
DISPATCH_HIST = "estorch_async_fold_latency_s"
ROUTE_HIST = "estorch_router_route_s"


def _fmt_ms(v: float | None) -> str:
    return f"{v * 1e3:.1f}" if v is not None else "-"


def _slowest_trace(store, metric: str, labels: dict, window_s: float,
                   now: float) -> str | None:
    """Worst exemplar trace id at/above the stored p99 bucket, or None
    when the window's histogram carries no exemplars."""
    h = store.hist_window(metric, labels, window_s, now)
    if h is None or h.count == 0:
        return None
    ids = h.slow_exemplars(q=0.99)
    return ids[0] if ids else None


def _fmt_num(v: float | None) -> str:
    if v is None:
        return "-"
    return f"{int(v)}" if float(v) == int(v) else f"{v:g}"


def fleet_snapshot(store_root: str, *, window_s: float = 60.0,
                   now: float | None = None,
                   store: "SeriesStore | None" = None) -> dict:
    """The dash's data model: per-target rows + active alerts, all from
    the store + ledger (machine-readable half of :func:`render`).

    Pass ``store`` to reuse one :class:`SeriesStore` across frames —
    watch mode does, so sealed segments stay memoized instead of being
    re-parsed on every redraw."""
    now = time.time() if now is None else float(now)
    store = SeriesStore(store_root) if store is None else store
    targets = store.label_values("estorch_up", "target", window_s, now)
    # active = fired and not since resolved, reconstructed from the
    # ledger so the dash needs no live collector to agree with /alerts;
    # the tail matches the ledger's own compaction bound — a shorter
    # read could drop an old still-firing transition and show resolved
    active: dict[tuple[str, str], dict] = {}
    for t in read_ledger(os.path.join(store_root, LEDGER_FILENAME),
                         tail=LEDGER_MAX_TRANSITIONS):
        key = (str(t.get("rule")), str(t.get("target")))
        if t.get("event") == "firing":
            active[key] = t
        elif t.get("event") == "resolved":
            active.pop(key, None)
    # autoscaler state: last decision event per target from the
    # append-only log — the dash needs no live autoscaler, the log +
    # store ARE the source of truth (obs/agg/autoscale.py)
    last_decision: dict[str, dict] = {}
    for ev in read_decisions(os.path.join(store_root,
                                          DECISIONS_FILENAME)):
        last_decision[str(ev.get("target"))] = ev
    rows = []
    for name in targets:
        labels = {"target": name}

        def latest(metric: str) -> float | None:
            got = store.latest(metric, labels, window_s, now)
            if not got:
                return None
            return max(got.values(), key=lambda x: x[0])[2]

        up = latest("estorch_up")
        # front-router targets (serve/router.py) export per-replica
        # labeled gauges; their presence IS the router detection, and
        # the columns come from the store alone like everything else
        replica_up = store.latest("estorch_router_replica_up", labels,
                                  window_s, now)
        router = None
        if replica_up:
            breaker = store.latest("estorch_router_breaker_state",
                                   labels, window_s, now)
            p99 = store.latest("estorch_router_upstream_p99_s", labels,
                               window_s, now)
            replicas = {}
            for _ts, lab, v in replica_up.values():
                replicas[str(lab.get("replica"))] = {"up": v == 1.0}
            for _ts, lab, v in (breaker or {}).values():
                replicas.setdefault(str(lab.get("replica")), {})[
                    "breaker"] = int(v)
            for _ts, lab, v in (p99 or {}).values():
                name_r = str(lab.get("replica"))
                if v == v:  # NaN = no samples yet
                    replicas.setdefault(name_r, {})["p99_s"] = v
            router = {
                "replicas": replicas,
                # only OPEN (2) alarms: half-open (1) is the normal
                # readmission probe, not a down replica
                "breakers_open": sum(
                    1 for r in replicas.values()
                    if r.get("breaker", 0) == 2),
                "retries": store.increase("estorch_router_retries_total",
                                          labels, window_s, now),
                "hedge_wins": store.increase(
                    "estorch_router_hedge_wins_total", labels, window_s,
                    now),
                "worst_p99_s": max(
                    (r["p99_s"] for r in replicas.values()
                     if "p99_s" in r), default=None),
            }
        # autoscale columns: desired from the router's exported gauge
        # (falls back to the last decision's verdict), actual from the
        # replica_up gauges, age from the decision log — None for
        # non-autoscaled targets so render shows '-'
        autoscale = None
        dec = last_decision.get(name)
        desired_g = latest("estorch_router_desired_replicas")
        if router is not None and (dec is not None
                                   or desired_g is not None):
            desired = (int(desired_g) if desired_g is not None
                       else (dec.get("verdict") or {}).get("desired"))
            autoscale = {
                "desired": desired,
                "actual": sum(1 for _ts, _lab, v in replica_up.values()
                              if v == 1.0),
                "last_decision_ts": dec["ts"] if dec else None,
                "decision_age_s": (round(now - float(dec["ts"]), 3)
                                   if dec else None),
                "last_action": ((dec.get("verdict") or {}).get("action")
                                if dec else None),
            }
        rows.append({
            "target": name,
            "up": bool(up == 1.0),
            "generation": latest("estorch_heartbeat_generation"),
            # cold-start health (serve replicas publish startup_s /
            # compiles_at_load gauges; a training run honestly has none)
            "startup_s": latest("estorch_startup_s"),
            "compiles_at_load": latest("estorch_compiles_at_load"),
            # a router target's client-facing latency is its route_s
            # histogram; a replica's is serve_request_s — same column
            "req_p50_s": store.quantile(
                ROUTE_HIST if router else REQUEST_HIST, 0.50, labels,
                window_s, now),
            "req_p99_s": store.quantile(
                ROUTE_HIST if router else REQUEST_HIST, 0.99, labels,
                window_s, now),
            "dispatch_p99_s": store.quantile(DISPATCH_HIST, 0.99, labels,
                                             window_s, now),
            # the worst in-window trace id from the latency histogram's
            # bucket exemplars (obs/hist.py) — `obs slow --store` turns
            # it into a per-hop breakdown; None when the target exports
            # no exemplars (old process, tracing off)
            "slowest_trace": _slowest_trace(
                store, ROUTE_HIST if router else REQUEST_HIST, labels,
                window_s, now),
            "queue_depth": latest("estorch_queue_depth"),
            "recompiles": store.increase("estorch_recompiles", labels,
                                         window_s, now),
            # elastic multi-host coordinators (JAX package) export
            # membership + per-host fold-latency gauges; training runs
            # without a fleet — and every serve target — honestly lack
            # them and render '-'
            "elastic_hosts": latest("estorch_elastic_hosts"),
            "host_fold_p99_s": latest("estorch_elastic_fold_p99_worst_s"),
            "hosts_lost": store.increase("estorch_hosts_lost", labels,
                                         window_s, now),
            "router": router,
            "autoscale": autoscale,
            "alerts": sorted(rule for (rule, tgt) in active
                             if tgt == name),
        })
    return {"ts": now, "window_s": float(window_s), "targets": rows,
            "active_alerts": [
                {"rule": rule, "target": tgt,
                 "detail": ev.get("detail", "")}
                for (rule, tgt), ev in sorted(active.items())]}


def render(store_root: str, *, window_s: float = 60.0,
           now: float | None = None,
           store: "SeriesStore | None" = None) -> str:
    """One human frame of the fleet (see module docstring)."""
    snap = fleet_snapshot(store_root, window_s=window_s, now=now,
                          store=store)
    header = ("target", "up", "gen", "cold", "req p50/p99 ms",
              "disp p99 ms", "hosts", "host p99 ms", "queue", "recomp",
              "brk", "retry", "hedge", "repl p99", "scale", "scale age",
              "slowest", "alerts")
    table = [header]
    for row in snap["targets"]:
        # cold: startup seconds, suffixed ! when the replica built or
        # loaded native libraries at load (compiles_at_load > 0); -1 is
        # the server's "no monitoring stream, warmth unproven" sentinel —
        # rendered ? so unproven never reads as proven-clean
        cold = "-"
        if row.get("startup_s") is not None:
            cold = f"{row['startup_s']:.1f}s"
            compiles = row.get("compiles_at_load")
            if compiles is not None and compiles > 0:
                cold += f"!{int(compiles)}"
            elif compiles is not None and compiles < 0:
                cold += "?"
        # router columns (serve/router.py targets): open-breaker count
        # over replica total (suffixed ! when any is open), windowed
        # retry / hedge-win increases, and the worst per-replica p99 —
        # non-router targets honestly render '-'
        ro = row.get("router")
        if ro:
            n_open = ro["breakers_open"]
            brk = f"{n_open}/{len(ro['replicas'])}"
            if n_open:
                brk += "!"
            retry = _fmt_num(ro["retries"])
            hedge = _fmt_num(ro["hedge_wins"])
            repl_p99 = _fmt_ms(ro["worst_p99_s"])
        else:
            brk = retry = hedge = repl_p99 = "-"
        # scale: desired vs actual replicas — `3→5` while converging, a
        # bare count once converged; scale age: seconds since the last
        # autoscaler decision — non-autoscaled targets honestly show '-'
        az = row.get("autoscale")
        scale = scale_age = "-"
        if az and az.get("desired") is not None:
            scale = (f"{az['actual']}" if az["actual"] == az["desired"]
                     else f"{az['actual']}→{az['desired']}")
        if az and az.get("decision_age_s") is not None:
            scale_age = f"{az['decision_age_s']:.0f}s"
        # hosts: elastic membership count, suffixed !N when N host
        # deaths landed inside the window (a shrinking fleet should
        # jump out of the table the way open breakers do)
        hosts = "-"
        if row.get("elastic_hosts") is not None:
            hosts = _fmt_num(row["elastic_hosts"])
            lost = row.get("hosts_lost")
            if lost:
                hosts += f"!{int(lost)}"
        table.append((
            row["target"],
            "UP" if row["up"] else "DOWN",
            _fmt_num(row["generation"]),
            cold,
            f"{_fmt_ms(row['req_p50_s'])} / {_fmt_ms(row['req_p99_s'])}",
            _fmt_ms(row["dispatch_p99_s"]),
            hosts,
            _fmt_ms(row["host_fold_p99_s"]),
            _fmt_num(row["queue_depth"]),
            _fmt_num(row["recompiles"]),
            brk, retry, hedge, repl_p99, scale, scale_age,
            # worst in-window trace id — feed it to `obs slow --store`
            # / `obs trace --store --trace-id` for the per-hop story;
            # '-' for targets exporting no exemplars
            row.get("slowest_trace") or "-",
            ",".join(row["alerts"]) or "-",
        ))
    widths = [max(len(str(r[i])) for r in table)
              for i in range(len(header))]
    lines = [f"fleet @ {time.strftime('%H:%M:%S', time.localtime(snap['ts']))}"
             f" (window {snap['window_s']:g}s, {len(snap['targets'])} "
             f"target(s), {len(snap['active_alerts'])} active alert(s))"]
    for j, r in enumerate(table):
        lines.append("  ".join(str(c).ljust(w)
                               for c, w in zip(r, widths)).rstrip())
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    for a in snap["active_alerts"]:
        lines.append(f"ALERT {a['rule']} [{a['target']}]: {a['detail']}")
    if not snap["targets"]:
        lines.append("(no targets in window — is the collector running "
                     "against this store?)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m estorch_tpu_torch.obs dash",
        description="terminal fleet console over a collector store")
    p.add_argument("--store", required=True, metavar="DIR",
                   help="the collector's --store directory")
    p.add_argument("--window", type=float, default=60.0,
                   help="history window in seconds (default 60)")
    p.add_argument("--once", action="store_true",
                   help="print one frame and exit (default)")
    p.add_argument("--watch", type=float, default=None, metavar="SECS",
                   help="redraw every SECS seconds until interrupted")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable snapshot instead of the table")
    args = p.parse_args(argv)
    if not os.path.isdir(args.store):
        print(f"dash: no such store dir {args.store!r}", file=sys.stderr)
        return 2

    # ONE store across frames: watch mode redraws every few seconds and
    # the store's sealed-segment memo cache only pays off if it survives
    # the frame loop
    store = SeriesStore(args.store)

    def frame() -> str:
        if args.as_json:
            return json.dumps(fleet_snapshot(args.store,
                                             window_s=args.window,
                                             store=store),
                              default=float)
        return render(args.store, window_s=args.window, store=store)

    if args.watch is None or args.once:
        print(frame())
        return 0
    try:
        while True:
            # ANSI home+clear keeps the frame in place without pulling in
            # curses; harmless when redirected to a file
            sys.stdout.write("\x1b[H\x1b[2J" + frame() + "\n")
            sys.stdout.flush()
            time.sleep(max(0.2, args.watch))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
