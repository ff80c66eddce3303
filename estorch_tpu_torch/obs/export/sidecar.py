"""Metrics sidecar: scrape a training run FROM OUTSIDE its process.

Counterpart of ``estorch_tpu/obs/export/sidecar.py``.  ``python -m
estorch_tpu_torch.obs serve-metrics --run-dir D`` (or, without importing
the package or torch, ``python estorch_tpu_torch/obs/export/sidecar.py
--run-dir D``) serves Prometheus text exposition at ``/metrics`` built
entirely from files in the run directory:

* ``heartbeat.json`` — the live child's last beat (phase, generation,
  counter and histogram snapshots), written atomically by the obs hub;
* ``counters.json`` — the supervisor's atomically-published
  cross-restart counter TOTALS (``resilience/supervisor.py`` writes it
  each time a child exits, folding that child's final heartbeat in).

The composition rule makes scraped totals monotone across restarts
without double counting: ``total = published + live`` where the live
heartbeat's counters only count when the beat is NEWER than the
published snapshot's ``through_ts`` (an exited child's final beat is
already folded into the published totals).

A wedged or restarting trainer cannot answer HTTP itself, but its
heartbeat file keeps telling the story: the sidecar is a separate
stdlib-only process whose answers survive every child death.  Run as a
file it loads the port's own sibling modules (``obs/recorder.py``,
``obs/hist.py``, ``export/prometheus.py``) by path, so it starts in
milliseconds and never imports torch.

``/healthz`` answers liveness OF THE WATCHED RUN as JSON (heartbeat age
+ staleness verdict); the sidecar itself answering at all is its own
liveness.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

if __package__:
    from ..hist import export_snapshots, merge_snapshots
    from ..recorder import STALE_AFTER_S, read_heartbeat
    from .prometheus import render_exposition
else:  # file-run: load the port's siblings by path, without any package init
    import importlib.util

    def _load(name: str, *rel: str):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            *rel)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    _recorder = _load("_estorch_torch_obs_recorder", os.pardir, "recorder.py")
    _prom = _load("_estorch_torch_obs_prometheus", "prometheus.py")
    _hist = _load("_estorch_torch_obs_hist", os.pardir, "hist.py")
    STALE_AFTER_S = _recorder.STALE_AFTER_S
    read_heartbeat = _recorder.read_heartbeat
    render_exposition = _prom.render_exposition
    merge_snapshots = _hist.merge_snapshots
    export_snapshots = _hist.export_snapshots

COUNTERS_FILENAME = "counters.json"
COUNTERS_SCHEMA = 1


def publish_counters(run_dir: str, counters: dict, through_ts: float,
                     extra: dict | None = None,
                     hists: dict | None = None) -> str:
    """Atomically publish cross-restart counter totals into ``run_dir``.

    ``through_ts``: the heartbeat timestamp these totals already include
    — the sidecar only adds a live heartbeat's counters on top when the
    beat is newer than this.  Same tmp+rename contract as the heartbeat,
    so a scrape can never read a half-written snapshot.  ``hists``:
    cross-restart histogram totals (``Histogram.to_dict`` snapshots per
    name, bucket-wise summed by the supervisor) riding the same file so
    a dead child's latency DISTRIBUTION survives it, not just its sums.
    """
    path = os.path.join(os.path.abspath(run_dir), COUNTERS_FILENAME)
    payload = {
        "schema": COUNTERS_SCHEMA,
        "through_ts": float(through_ts),
        "counters": {k: v for k, v in (counters or {}).items()
                     if isinstance(v, (int, float))
                     and not isinstance(v, bool)},
    }
    if hists:
        payload["hists"] = {k: v for k, v in hists.items()
                            if isinstance(v, dict)}
    if extra:
        payload.update(extra)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, default=float)
    os.replace(tmp, path)
    return path


def read_published_counters(run_dir: str) -> dict | None:
    """The published snapshot, or None when absent/corrupt/unknown-schema
    (an unsupervised run never publishes one — the heartbeat alone then
    carries the counters)."""
    path = os.path.join(run_dir, COUNTERS_FILENAME)
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if (data.get("schema") != COUNTERS_SCHEMA
            or not isinstance(data.get("counters"), dict)):
        return None
    return data


def compose_totals(published: dict | None, heartbeat: dict | None) -> dict:
    """published totals + live child's counters (see module docstring)."""
    totals: dict = {}
    through_ts = 0.0
    if published is not None:
        through_ts = float(published.get("through_ts", 0.0))
        for k, v in published["counters"].items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                totals[k] = totals.get(k, 0) + v
    if heartbeat is not None and float(heartbeat.get("ts", 0.0)) > through_ts:
        for k, v in (heartbeat.get("counters") or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                totals[k] = totals.get(k, 0) + v
    return totals


def compose_hists(published: dict | None, heartbeat: dict | None) -> dict:
    """Published histogram totals + the live child's snapshots, under
    the same newer-than-``through_ts`` rule as :func:`compose_totals` —
    bucket ladders add exactly, so scraped tail quantiles stay truthful
    across restarts without double counting a buried child's beat."""
    total: dict = {}
    through_ts = 0.0
    if published is not None:
        through_ts = float(published.get("through_ts", 0.0))
        if isinstance(published.get("hists"), dict):
            total = published["hists"]
    live = None
    if (heartbeat is not None
            and float(heartbeat.get("ts", 0.0)) > through_ts
            and isinstance(heartbeat.get("hists"), dict)):
        live = heartbeat["hists"]
    return merge_snapshots(total, live)


class MetricsSidecar:
    """Loopback HTTP server exposing one run directory as /metrics."""

    def __init__(self, run_dir: str, *, host: str = "127.0.0.1",
                 port: int = 0, stale_after_s: float = STALE_AFTER_S):
        self.run_dir = os.path.abspath(run_dir)
        self.stale_after_s = float(stale_after_s)
        self._httpd = _SidecarHttpd((host, int(port)), _make_handler(self))
        self.host, self.port = self._httpd.server_address[:2]

    # ----------------------------------------------------------- scrape

    @property
    def heartbeat_path(self) -> str:
        return os.path.join(self.run_dir, "heartbeat.json")

    def scrape(self) -> str:
        """One /metrics body — re-reads the run-dir files every call, so
        the sidecar holds no state a child restart could invalidate."""
        hb = read_heartbeat(self.heartbeat_path)
        published = read_published_counters(self.run_dir)
        totals = compose_totals(published, hb)
        hists = compose_hists(published, hb)
        extra = {}
        if published is not None and "restart_count" in published:
            extra["supervisor_restarts"] = published["restart_count"]
        if published is not None and "completed" in published:
            # lets an alert tell "done" from "dead": after the run ends
            # the heartbeat goes stale and estorch_up drops either way,
            # but a completed run publishes its verdict first
            extra["run_completed"] = 1.0 if published["completed"] else 0.0
        return render_exposition(totals, hb,
                                 stale_after_s=self.stale_after_s,
                                 extra_gauges=extra,
                                 histograms=export_snapshots(hists) or None)

    def health(self) -> tuple[int, dict]:
        hb = read_heartbeat(self.heartbeat_path)
        if hb is None:
            return 503, {"ok": False, "run_dir": self.run_dir,
                         "error": "no readable heartbeat — run never "
                                  "started telemetry, or wrong dir"}
        stale = hb["age_s"] > self.stale_after_s
        return (503 if stale else 200), {
            "ok": not stale,
            "run_dir": self.run_dir,
            "age_s": round(hb["age_s"], 3),
            "stale": stale,
            "phase": hb.get("phase"),
            "generation": hb.get("generation"),
        }

    # -------------------------------------------------------- lifecycle

    def serve_forever(self) -> None:
        self._serving = True
        self._httpd.serve_forever(poll_interval=0.1)

    def start_background(self) -> threading.Thread:
        self._serving = True
        t = threading.Thread(target=self.serve_forever,
                             name="obs-metrics-sidecar", daemon=True)
        t.start()
        return t

    def close(self) -> None:
        # shutdown() blocks on the serve loop's acknowledgement — if the
        # loop never ran (scrape()-only use), it would wait forever
        if getattr(self, "_serving", False):
            self._httpd.shutdown()
        self._httpd.server_close()


class _SidecarHttpd(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


def _make_handler(sidecar: MetricsSidecar):
    class SidecarHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # scrapes every few seconds: quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                self._reply(200, sidecar.scrape().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/healthz":
                code, payload = sidecar.health()
                self._reply(code, json.dumps(payload).encode(),
                            "application/json")
            else:
                self._reply(404, json.dumps(
                    {"error": f"no route {self.path!r}"}).encode(),
                    "application/json")

    return SidecarHandler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m estorch_tpu_torch.obs serve-metrics",
        description="Prometheus /metrics sidecar over a run directory")
    p.add_argument("--run-dir", required=True, metavar="DIR",
                   help="run directory holding heartbeat.json (and, for "
                        "supervised runs, counters.json)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9321,
                   help="0 picks an ephemeral port (see --port-file)")
    p.add_argument("--port-file", default=None, metavar="PATH",
                   help="atomically write {host,port,pid} JSON once bound")
    p.add_argument("--stale-after-s", type=float, default=STALE_AFTER_S,
                   help="heartbeat age beyond which estorch_up reads 0")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.isdir(args.run_dir):
        print(f"serve-metrics: no such run dir {args.run_dir!r}",
              file=sys.stderr)
        return 2
    sidecar = MetricsSidecar(args.run_dir, host=args.host, port=args.port,
                             stale_after_s=args.stale_after_s)
    # ready-to-paste targets.json entry for the fleet collector
    # (obs/agg/) — same stanza (and same wildcard-bind substitution) as
    # the serve server's /stats: 0.0.0.0 is not routable FROM the
    # collector's host, so pasting it would scrape the wrong machine
    stanza_host = sidecar.host
    if stanza_host in ("0.0.0.0", "::", ""):
        import socket as _socket

        stanza_host = _socket.getfqdn() or _socket.gethostname()
    print(json.dumps({"ready": True,
                      "url": f"http://{sidecar.host}:{sidecar.port}",
                      "run_dir": sidecar.run_dir, "pid": os.getpid(),
                      "collector_target": {
                          "name": os.path.basename(sidecar.run_dir)
                                  or "run",
                          "url": f"http://{stanza_host}:{sidecar.port}"
                                 "/metrics",
                      }}),
          flush=True)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": sidecar.host, "port": sidecar.port,
                       "pid": os.getpid()}, f)
        os.replace(tmp, args.port_file)
    import signal

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    sidecar.start_background()
    stop.wait()
    sidecar.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
