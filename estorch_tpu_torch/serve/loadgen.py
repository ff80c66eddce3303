"""Load generator for the policy server: open/closed-loop traffic with
throughput and latency percentiles.

Counterpart of ``estorch_tpu/serve/loadgen.py``, copied with its code
unchanged (stdlib only).

Engine design: ONE thread drives N persistent connections through a
``selectors`` loop, each connection holding at most one request in
flight.  On a GIL'd host this measures the server honestly — a
thread-per-connection client spends more time context-switching than
talking, and (measured) *lowers* observed server throughput as
concurrency rises.  Closed loop: every connection fires its next request
the moment its response lands — offered load tracks capacity, the right
mode for "how fast CAN it go" A/Bs.  Open loop: requests fire on a fixed
schedule (``target_rps``) regardless of completions — queueing delay
shows up in the latencies, the right mode for "what happens at X rps".

Importable without the package, and runnable as a file
(``python estorch_tpu_torch/serve/loadgen.py --address HOST:PORT``, or
``--selfcheck`` against an in-process echo server), so a host whose torch
install is broken can still drive and load-test a server.
"""

from __future__ import annotations

import argparse
import json
import selectors
import socket
import sys
import time


def _percentile(sorted_xs: list[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted sample (q in [0, 1])."""
    if not sorted_xs:
        return float("nan")
    i = min(len(sorted_xs) - 1, max(0, int(q * len(sorted_xs))))
    return sorted_xs[i]


class _Conn:
    __slots__ = ("sock", "buf", "sent_at", "req_index", "busy")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""
        self.sent_at = 0.0
        self.req_index = -1
        self.busy = False


def _parse_responses(conn: _Conn):
    """Yield (status, body bytes, trace id) for each complete HTTP
    response in the buffer; leaves partial data buffered.  The trace id
    is the server's ``X-Trace-Id`` response header ("" when absent) —
    the join key between a latency row and the assembled distributed
    trace (``obs trace --fleet`` / ``obs slow``)."""
    while True:
        head_end = conn.buf.find(b"\r\n\r\n")
        if head_end < 0:
            return
        head = conn.buf[:head_end]
        status = int(head.split(b" ", 2)[1])
        clen = 0
        trace = ""
        for line in head.split(b"\r\n")[1:]:
            if line[:15].lower() == b"content-length:":
                clen = int(line[15:])
            elif line[:11].lower() == b"x-trace-id:":
                trace = line[11:].strip().decode("ascii", "replace")
        total = head_end + 4 + clen
        if len(conn.buf) < total:
            return
        body = conn.buf[head_end + 4:total]
        conn.buf = conn.buf[total:]
        yield status, body, trace


def run_load(
    address: str,
    *,
    mode: str = "closed",
    conns: int = 8,
    duration_s: float = 3.0,
    total: int | None = None,
    target_rps: float | None = None,
    obs: list | None = None,
    obs_list: list | None = None,
    collect_responses: bool = False,
    collect_latencies: bool = False,
    timeout_s: float = 60.0,
) -> dict:
    """Drive ``/predict`` traffic; returns the measurement dict.

    ``obs_list`` assigns observation i to request i (requests are issued
    in index order; with ``collect_responses`` the returned
    ``responses[i]`` is request i's parsed body — the bit-exactness
    check's plumbing).  ``total`` stops after exactly that many requests
    (default: run for ``duration_s``).  ``mode="open"`` needs
    ``target_rps``.  ``collect_latencies`` returns the raw per-request
    latency list (``latencies_s``, completion order) — the offline
    samples the ``obs regress --tail`` gate and the quantile-honesty
    test consume.
    """
    if mode not in ("closed", "open"):
        raise ValueError(f"mode must be closed|open, got {mode!r}")
    if mode == "open" and not target_rps:
        raise ValueError("open-loop load needs target_rps")
    if obs_list is None:
        obs_list = [obs if obs is not None else [0.0]]
    bodies = [json.dumps({"obs": o}).encode() for o in obs_list]
    reqs = [
        b"POST /predict HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
        b"\r\nContent-Length: " + str(len(b)).encode() + b"\r\n\r\n" + b
        for b in bodies
    ]

    if "://" in address:
        address = address.split("://", 1)[1]
    host, _, port = address.rstrip("/").partition(":")
    addr = (host, int(port))

    sel = selectors.DefaultSelector()
    pool: list[_Conn] = []
    for _ in range(int(conns)):
        s = socket.create_connection(addr, timeout=timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        c = _Conn(s)
        sel.register(s, selectors.EVENT_READ, c)
        pool.append(c)

    import collections

    latencies: list[float] = []
    trace_ids: list[str] = []
    responses: list | None = [None] * len(obs_list) if collect_responses else None
    issued = completed = errors = shed = scheduled = 0
    t0 = time.perf_counter()
    deadline = t0 + float(duration_s)
    interval = 1.0 / target_rps if target_rps else 0.0
    next_send = t0
    # open loop: the SCHEDULE is authoritative — ticks accumulate here
    # even while every connection is busy, and a request's latency is
    # measured from its scheduled time, so queueing delay above capacity
    # shows up in the percentiles instead of being coordinated away
    backlog: collections.deque[float] = collections.deque()

    def want_more(now: float) -> bool:
        if total is not None:
            return scheduled < total if mode == "open" else issued < total
        return now < deadline

    def tick_schedule(now: float) -> None:
        nonlocal next_send, scheduled
        if mode != "open":
            return
        while next_send <= now and want_more(now):
            backlog.append(next_send)
            scheduled += 1
            next_send += interval

    def retire(c: _Conn) -> None:
        nonlocal completed, errors
        if c.busy:
            errors += 1
            completed += 1
            c.busy = False
        sel.unregister(c.sock)
        c.sock.close()
        pool.remove(c)

    def send_on(c: _Conn, sent_at: float) -> bool:
        """Issue the next request on ``c`` (``sent_at``: the wall time
        latency is measured from — the actual send for closed loop, the
        SCHEDULED time for open loop).  A send failure (server closed
        the connection mid-measurement) retires the connection and
        counts the request as an error instead of blowing up the whole
        measurement."""
        nonlocal issued, errors, completed
        c.req_index = issued
        c.sent_at = sent_at
        c.busy = True
        issued += 1
        try:
            c.sock.sendall(reqs[c.req_index % len(reqs)])
        except OSError:
            retire(c)
            return False
        return True

    def feed_idle(now: float) -> None:
        tick_schedule(now)
        for c in [c for c in pool if not c.busy]:
            if mode == "open":
                if not backlog:
                    break
                send_on(c, backlog.popleft())
            else:
                if not want_more(time.perf_counter()):
                    break
                send_on(c, time.perf_counter())

    feed_idle(t0)

    hard_stop = t0 + float(duration_s) + timeout_s
    while (completed < issued or backlog
           or want_more(time.perf_counter())):
        now = time.perf_counter()
        if now > hard_stop:
            errors += issued - completed
            break
        feed_idle(now)
        wait = 0.05
        if mode == "open" and want_more(now) and not backlog:
            wait = min(wait, max(0.0, next_send - now))
        for key, _ in sel.select(timeout=wait):
            c: _Conn = key.data
            try:
                chunk = c.sock.recv(1 << 16)
            except BlockingIOError:
                continue
            except OSError:
                chunk = b""
            if not chunk:
                # server closed the connection (drain) — count any
                # outstanding request on it as an error and retire it
                retire(c)
                if not pool:
                    break
                continue
            c.buf += chunk
            for status, body, trace in _parse_responses(c):
                completed += 1
                latencies.append(time.perf_counter() - c.sent_at)
                trace_ids.append(trace)
                if status == 503:
                    shed += 1
                elif status != 200:
                    errors += 1
                if responses is not None and 0 <= c.req_index < len(responses):
                    try:
                        responses[c.req_index] = json.loads(body)
                    except ValueError:
                        responses[c.req_index] = None
                c.busy = False
                now = time.perf_counter()
                if mode == "open":
                    tick_schedule(now)
                    if backlog:
                        send_on(c, backlog.popleft())
                elif want_more(now):
                    send_on(c, now)
        if not pool:
            errors += issued - completed
            break

    wall = time.perf_counter() - t0
    for c in pool:
        sel.unregister(c.sock)
        c.sock.close()
    sel.close()
    lat_sorted = sorted(latencies)
    out = {
        "mode": mode,
        "conns": int(conns),
        "requests": completed,
        "errors": errors,
        "shed": shed,
        "duration_s": round(wall, 4),
        "throughput_rps": round(completed / wall, 2) if wall > 0 else 0.0,
        "latency_ms": {
            "p50": round(_percentile(lat_sorted, 0.50) * 1e3, 3),
            "p95": round(_percentile(lat_sorted, 0.95) * 1e3, 3),
            "p99": round(_percentile(lat_sorted, 0.99) * 1e3, 3),
            "mean": round(sum(lat_sorted) / len(lat_sorted) * 1e3, 3)
            if lat_sorted else float("nan"),
            "max": round(lat_sorted[-1] * 1e3, 3) if lat_sorted else
            float("nan"),
        },
    }
    if target_rps:
        out["target_rps"] = float(target_rps)
    if responses is not None:
        out["responses"] = responses
    if collect_latencies:
        out["latencies_s"] = latencies
        # same completion order as latencies_s: trace_ids[i] is the
        # server's X-Trace-Id for the request latencies_s[i] measured
        out["trace_ids"] = trace_ids
    return out


def coldstart_probe(
    address: str,
    *,
    total: int = 100,
    conns: int = 4,
    obs: list | None = None,
    timeout_s: float = 180.0,
) -> dict:
    """Cold-start measurement against a just-started server: the FIRST
    request is fired alone on one connection (so any JIT pause lands on
    exactly one measured sample — ``ttfr_s``), then the remainder of the
    first ``total`` requests run concurrently for the early-tail
    percentiles (``first_p99_ms``) — the two facts
    ``bench.py --coldstart`` gates (docs/serving.md "Cold start &
    quantized serving").  The caller measures process spawn → ready
    separately; this probe owns ready → first answers."""
    first = run_load(address, conns=1, total=1, duration_s=timeout_s,
                     obs=obs, collect_latencies=True, timeout_s=timeout_s)
    rest = {"errors": 0, "shed": 0, "latencies_s": []}
    if total > 1:
        rest = run_load(address, conns=conns, total=int(total) - 1,
                        duration_s=timeout_s, obs=obs,
                        collect_latencies=True, timeout_s=timeout_s)
    lats = list(first.get("latencies_s", [])) + list(
        rest.get("latencies_s", []))
    lat_sorted = sorted(lats)
    return {
        "ttfr_s": round(first["latencies_s"][0], 4)
        if first.get("latencies_s") else None,
        "first_requests": len(lats),
        "first_p50_ms": round(_percentile(lat_sorted, 0.50) * 1e3, 3),
        "first_p99_ms": round(_percentile(lat_sorted, 0.99) * 1e3, 3),
        "errors": first["errors"] + rest["errors"],
        "shed": first.get("shed", 0) + rest.get("shed", 0),
        "latencies_s": lats,
        "trace_ids": list(first.get("trace_ids", [])) + list(
            rest.get("trace_ids", [])),
    }


def capacity_sweep(
    address: str,
    *,
    slo_ms: float = 50.0,
    rps_ladder: list[float] | None = None,
    start_rps: float = 25.0,
    growth: float = 2.0,
    max_rungs: int = 8,
    rung_duration_s: float = 2.0,
    conns: int = 16,
    obs: list | None = None,
    quantile: float = 0.99,
    max_error_frac: float = 0.0,
    timeout_s: float = 60.0,
) -> dict:
    """The ROADMAP capacity model: an OPEN-LOOP offered-load ladder —
    each rung fires requests on a fixed schedule regardless of
    completions, with latency measured from the SCHEDULED send time
    (``run_load``'s schedule-authoritative rule), so queueing delay past
    saturation lands in the percentiles instead of being coordinated
    away.  Reports per-rung rows and ``max_rps_at_slo``: the highest
    offered rate whose ``quantile`` latency stayed <= ``slo_ms`` with
    error+shed fraction <= ``max_error_frac``.

    ``rps_ladder`` pins the rungs explicitly; otherwise a geometric
    ladder (``start_rps`` × ``growth``^k) runs until the SLO breaks or
    ``max_rungs`` is exhausted (the early stop keeps a saturated server
    from being hammered through rungs that can only fail).
    """
    ladder = ([float(r) for r in rps_ladder] if rps_ladder
              else [start_rps * (growth ** k) for k in range(max_rungs)])
    qkey = f"p{quantile * 100:g}"
    rungs: list[dict] = []
    max_ok: float | None = None
    for rps in ladder:
        res = run_load(address, mode="open", target_rps=rps, conns=conns,
                       duration_s=rung_duration_s, obs=obs,
                       collect_latencies=True, timeout_s=timeout_s)
        lat_sorted = sorted(res.pop("latencies_s", []))
        q_ms = _percentile(lat_sorted, quantile) * 1e3
        bad = res["errors"] + res["shed"]
        bad_frac = bad / res["requests"] if res["requests"] else 1.0
        ok = (bool(lat_sorted) and q_ms <= slo_ms
              and bad_frac <= max_error_frac)
        rungs.append({
            "offered_rps": rps,
            "achieved_rps": res["throughput_rps"],
            qkey + "_ms": round(q_ms, 3),
            "errors": res["errors"],
            "shed": res["shed"],
            "requests": res["requests"],
            "ok": ok,
        })
        if ok:
            max_ok = rps
        elif rps_ladder is None:
            break  # saturated: further geometric rungs can only fail
    return {
        "slo_ms": float(slo_ms),
        "quantile": qkey,
        "rungs": rungs,
        "max_rps_at_slo": max_ok,
        "saturated": any(not r["ok"] for r in rungs),
    }


CAPACITY_SCHEMA = 1


def write_capacity_artifact(sweep: dict, path: str, *,
                            bundle: str | None = None,
                            platform: str | None = None) -> dict:
    """Persist a :func:`capacity_sweep` result as the VERSIONED capacity
    model the autoscaler consumes (obs/agg/autoscale.py owns the
    validator — the two keep ``schema`` in lockstep).

    ``bundle`` stamps identity from the bundle's MANIFEST.json (arrays
    sha256, version, warm platform — read jax-free): the autoscaler
    refuses a model whose bundle/platform mismatches the fleet it is
    about to scale, naming both sides.  ``platform`` overrides the
    manifest's warm platform (a cold-exported bundle has none)."""
    import os

    art = {
        "schema": CAPACITY_SCHEMA,
        "kind": "capacity",
        "created_ts": time.time(),
        "slo_ms": sweep["slo_ms"],
        "quantile": sweep["quantile"],
        "max_rps_at_slo": sweep["max_rps_at_slo"],
        "saturated": sweep["saturated"],
        "rungs": sweep["rungs"],
        "bundle_sha": None,
        "bundle_version": None,
        "platform": platform,
    }
    if bundle:
        try:
            with open(os.path.join(bundle, "MANIFEST.json")) as f:
                man = json.load(f)
        except (OSError, ValueError) as e:
            raise ValueError(
                f"{bundle}: unreadable bundle MANIFEST.json: {e}") from e
        art["bundle_version"] = man.get("version")
        art["bundle_sha"] = (man.get("sha256") or {}).get("arrays.npz")
        if platform is None:
            art["platform"] = (man.get("warm") or {}).get("platform")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(art, f, indent=1)
    os.replace(tmp, path)
    return art


def write_latency_rows(latencies_s: list, path: str,
                       endpoint: str = "/predict",
                       trace_ids: list | None = None) -> str:
    """Per-request latency rows as JSONL (``{"endpoint", "latency_s"}``)
    — the measurement file shape ``obs regress --tail`` groups by
    endpoint.  When ``trace_ids`` is given (same completion order as
    ``latencies_s``), each row that has one gains a ``trace_id`` column:
    the server's ``X-Trace-Id``, so a tail outlier in the measurement
    file can be looked up as an assembled distributed trace
    (``obs trace --fleet`` / ``obs slow --store``).  Atomic (tmp +
    rename), like every other artifact."""
    import os

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for i, v in enumerate(latencies_s):
            row = {"endpoint": endpoint, "latency_s": float(v)}
            if trace_ids is not None and i < len(trace_ids) and trace_ids[i]:
                row["trace_id"] = str(trace_ids[i])
            f.write(json.dumps(row) + "\n")
    os.replace(tmp, path)
    return path


# ------------------------------------------------------------------ smoke

def _selfcheck() -> int:
    """Self-contained plumbing gate for run_lint.sh: spin a trivial
    stdlib echo server in-process, drive both loop modes against it,
    and validate the measurement schema.  No jax, no numpy, ~1s."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Echo(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        served = 0  # class-level: stamps each response's X-Trace-Id

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(n))
            body = json.dumps({"action": data["obs"]}).encode()
            Echo.served += 1
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Trace-Id", f"t-{Echo.served:06d}")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Echo)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    addr = f"127.0.0.1:{srv.server_address[1]}"
    problems = []
    try:
        obs_list = [[float(i), 1.0] for i in range(16)]
        closed = run_load(addr, conns=4, total=16, duration_s=5.0,
                          obs_list=obs_list, collect_responses=True,
                          collect_latencies=True)
        if closed["requests"] != 16 or closed["errors"]:
            problems.append(f"closed loop lost requests: {closed}")
        if len(closed.get("latencies_s", [])) != 16:
            problems.append("per-request latencies not collected")
        tids = closed.get("trace_ids", [])
        if len(tids) != 16 or len(set(tids)) != 16 or not all(tids):
            problems.append(f"X-Trace-Id response headers not captured "
                            f"per request: {tids}")
        import os
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            rows_path = write_latency_rows(
                closed["latencies_s"], os.path.join(td, "lat.jsonl"),
                trace_ids=tids)
            with open(rows_path) as f:
                rows = [json.loads(line) for line in f]
            if ([r.get("trace_id") for r in rows] != tids
                    or any("latency_s" not in r for r in rows)):
                problems.append("latency rows lost the trace_id column")
        got = [r and r["action"] for r in closed["responses"]]
        if got != obs_list:
            problems.append("responses not matched to request indices")
        lat = closed["latency_ms"]
        if not (lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]):
            problems.append(f"percentiles not monotone: {lat}")
        open_ = run_load(addr, mode="open", target_rps=200, conns=4,
                         duration_s=0.5)
        if open_["requests"] == 0 or open_["errors"]:
            problems.append(f"open loop failed: {open_}")
        if not (0.3 * 200 * 0.5 < open_["requests"] <= 1.7 * 200 * 0.5):
            problems.append(
                f"open loop missed its schedule: {open_['requests']} "
                "requests for target 200 rps x 0.5s")
        # capacity ladder: the echo server answers in microseconds, so a
        # generous SLO must pass every rung and report the top one
        sweep = capacity_sweep(addr, slo_ms=1000.0,
                               rps_ladder=[50, 100], conns=4,
                               rung_duration_s=0.4)
        if sweep["max_rps_at_slo"] != 100.0 or sweep["saturated"]:
            problems.append(f"capacity sweep missed the trivially-"
                            f"passing ladder: {sweep}")
        if [r["offered_rps"] for r in sweep["rungs"]] != [50.0, 100.0]:
            problems.append(f"capacity rungs wrong: {sweep['rungs']}")
        # an impossible SLO must read as saturation, not success
        tight = capacity_sweep(addr, slo_ms=1e-6, rps_ladder=[50],
                               conns=4, rung_duration_s=0.3)
        if tight["max_rps_at_slo"] is not None or not tight["saturated"]:
            problems.append(f"impossible SLO not flagged: {tight}")
    finally:
        srv.shutdown()
        srv.server_close()
    for p in problems:
        print(f"loadgen selfcheck: {p}", file=sys.stderr)
    if not problems:
        print("loadgen selfcheck: OK (closed+open loop, percentiles, "
              "response indexing, trace-id capture, capacity sweep)")
    return 1 if problems else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="drive /predict load against a policy server")
    p.add_argument("--address", help="host:port of a running server")
    p.add_argument("--mode", choices=("closed", "open"), default="closed")
    p.add_argument("--conns", type=int, default=8)
    p.add_argument("--duration", type=float, default=3.0)
    p.add_argument("--target-rps", type=float, default=None)
    p.add_argument("--obs", default=None,
                   help="JSON observation, e.g. '[0.1, 0.2, 0.3]'")
    p.add_argument("--coldstart", type=int, default=None, metavar="N",
                   help="cold-start probe instead of a load run: first "
                        "request alone (time-to-first-response), then the "
                        "first N requests' p50/p99")
    p.add_argument("--capacity-sweep", action="store_true",
                   help="open-loop offered-load ladder: max sustainable "
                        "RPS at the --slo-ms p99 SLO (schedule-"
                        "authoritative latencies, so saturation is "
                        "honest)")
    p.add_argument("--slo-ms", type=float, default=50.0,
                   help="p99 latency SLO for --capacity-sweep")
    p.add_argument("--rps-ladder", default=None, metavar="R1,R2,...",
                   help="explicit offered-load rungs (default: geometric "
                        "from --start-rps)")
    p.add_argument("--start-rps", type=float, default=25.0)
    p.add_argument("--rung-duration", type=float, default=2.0)
    p.add_argument("--out", default=None, metavar="PATH",
                   help="persist the --capacity-sweep result as the "
                        "versioned capacity.json artifact the "
                        "autoscaler consumes")
    p.add_argument("--bundle", default=None, metavar="DIR",
                   help="stamp --out with this bundle's identity "
                        "(MANIFEST.json sha256/version/warm platform)")
    p.add_argument("--platform", default=None,
                   help="platform stamp for --out (overrides the "
                        "bundle manifest's warm platform)")
    p.add_argument("--latencies-out", default=None, metavar="PATH",
                   help="also write per-request latency rows as JSONL "
                        "({'endpoint', 'latency_s', 'trace_id'}) — the "
                        "obs regress --tail measurement format; trace_id "
                        "joins a row to its assembled distributed trace")
    p.add_argument("--selfcheck", action="store_true",
                   help="validate the loadgen itself against an "
                        "in-process echo server (CI gate)")
    args = p.parse_args(argv)
    if args.selfcheck:
        return _selfcheck()
    if not args.address:
        p.error("--address is required (or --selfcheck)")
    if args.capacity_sweep:
        ladder = ([float(x) for x in args.rps_ladder.split(",")]
                  if args.rps_ladder else None)
        res = capacity_sweep(
            args.address, slo_ms=args.slo_ms, rps_ladder=ladder,
            start_rps=args.start_rps, rung_duration_s=args.rung_duration,
            conns=args.conns,
            obs=json.loads(args.obs) if args.obs else None)
        if args.out:
            try:
                write_capacity_artifact(res, args.out,
                                        bundle=args.bundle,
                                        platform=args.platform)
            except ValueError as e:
                print(f"loadgen: {e}", file=sys.stderr)
                return 2
            res["artifact"] = args.out
        print(json.dumps(res))
        return 0
    if args.coldstart:
        res = coldstart_probe(
            args.address, total=args.coldstart, conns=args.conns,
            obs=json.loads(args.obs) if args.obs else None)
        lats = res.pop("latencies_s")
        traces = res.pop("trace_ids", None)
        if args.latencies_out:
            write_latency_rows(lats, args.latencies_out, trace_ids=traces)
            res["latencies_out"] = args.latencies_out
        print(json.dumps(res))
        return 0
    res = run_load(
        args.address, mode=args.mode, conns=args.conns,
        duration_s=args.duration, target_rps=args.target_rps,
        obs=json.loads(args.obs) if args.obs else None,
        collect_latencies=bool(args.latencies_out),
    )
    if args.latencies_out:
        write_latency_rows(res.pop("latencies_s"), args.latencies_out,
                           trace_ids=res.pop("trace_ids", None))
        res["latencies_out"] = args.latencies_out
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
