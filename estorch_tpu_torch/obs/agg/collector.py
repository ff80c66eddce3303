"""Fleet metrics collector: scrape N targets, store history, evaluate SLOs.

``python -m estorch_tpu_torch.obs collect --targets targets.json --store D``
(or, on a wedged-CUDA host, ``python estorch_tpu_torch/obs/agg/collector.py``)
runs the loop every per-process telemetry surface presupposed but nobody
owned: each tick it scrapes every configured target — serve servers'
``/metrics``, run-dir sidecars, bare run directories — through the SAME
validating parser the doctor uses (``obs/export/prometheus.py``), lands
every sample in the local time-series store (``store.py``) tagged with a
``target`` label, and evaluates the declarative SLO rules
(``rules.py``), appending firing/resolved transitions to the alerts
ledger.

Targets file (``targets.json``)::

    {"schema": 1, "interval_s": 2.0, "targets": [
      {"name": "serve-a", "url": "http://127.0.0.1:8321/metrics",
       "timeout_s": 2.0},
      {"name": "run-1", "run_dir": "runs/r1"}
    ]}

``url`` targets are Prometheus text-exposition endpoints; ``run_dir``
targets are scraped in-process through the sidecar's composition rules
(heartbeat + supervisor-published ``counters.json``), so a training run
is a first-class fleet member without running a sidecar at all.

Fault containment (the reason this is a daemon, not a cron of curls):

* every scrape runs in its own thread with a PER-TARGET timeout — a
  dead, slow, or garbage-spewing target costs its own slot, never the
  tick (a target whose scrape is still in flight at the next tick is
  skipped, not doubled);
* a failed scrape bumps the target's consecutive-failure count and
  synthesizes ``estorch_up{target=...} 0`` into the store, so the
  absence rule and the dash see the SAME down verdict the scrape saw —
  no separate bookkeeping to drift;
* a garbage body is a parse ERROR (the validating parser refuses it),
  counted like a refused connection — blessing garbage would be the
  false health check the parser exists to prevent.

The collector is itself a fleet citizen: its own ``/metrics`` exposes
tick/sample/error counters plus per-target up/failure/latency gauges,
``/alerts`` serves the active alert set + recent ledger transitions as
JSON, and ``/healthz`` answers collector liveness.

Stdlib-only; importable and runnable WITHOUT the package (file-run mode
loads the port's siblings by path, the sidecar discipline) — the fleet
plane must keep answering while a replica's CUDA context is wedged.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

if __package__:
    from ..export.prometheus import (histogram_series, metric_name,
                                     parse_exposition, render_exposition)
    from ..export.sidecar import (compose_hists, compose_totals,
                                  read_published_counters)
    from ..hist import export_snapshots, snapshot_from_export
    from ..recorder import STALE_AFTER_S, read_heartbeat
    from ..tracing import valid_segment
    from .rules import (LEDGER_FILENAME, RulesEngine, load_rules,
                        read_ledger)
    from .store import SeriesStore
else:  # file-run (wedged-CUDA host): load siblings without any package init
    import importlib.util

    def _load(name: str, *rel: str):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            *rel)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    _prom = _load("_estorch_torch_obs_prometheus", os.pardir, "export",
                  "prometheus.py")
    _sidecar = _load("_estorch_torch_obs_sidecar", os.pardir, "export",
                     "sidecar.py")
    _hist = _load("_estorch_torch_obs_hist", os.pardir, "hist.py")
    _recorder = _load("_estorch_torch_obs_recorder", os.pardir, "recorder.py")
    _tracing = _load("_estorch_torch_obs_tracing", os.pardir, "tracing.py")
    _store = _load("_estorch_torch_obs_agg_store", "store.py")
    _rules = _load("_estorch_torch_obs_agg_rules", "rules.py")
    histogram_series = _prom.histogram_series
    metric_name = _prom.metric_name
    parse_exposition = _prom.parse_exposition
    render_exposition = _prom.render_exposition
    compose_hists = _sidecar.compose_hists
    compose_totals = _sidecar.compose_totals
    read_published_counters = _sidecar.read_published_counters
    export_snapshots = _hist.export_snapshots
    snapshot_from_export = _hist.snapshot_from_export
    STALE_AFTER_S = _recorder.STALE_AFTER_S
    read_heartbeat = _recorder.read_heartbeat
    valid_segment = _tracing.valid_segment
    SeriesStore = _store.SeriesStore
    RulesEngine = _rules.RulesEngine
    load_rules = _rules.load_rules
    read_ledger = _rules.read_ledger
    LEDGER_FILENAME = _rules.LEDGER_FILENAME

TARGETS_SCHEMA = 1
DEFAULT_INTERVAL_S = 2.0
DEFAULT_TIMEOUT_S = 2.0
# collector-side per-target trace segment files (store root):
# traces-<target>.jsonl, joined by `obs trace --store` / `obs slow`
TRACE_FILE_PREFIX = "traces-"
TRACE_FILE_MAX_LINES = 20_000


def trace_file_path(store_root: str, target: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", target)
    return os.path.join(store_root, f"{TRACE_FILE_PREFIX}{safe}.jsonl")


def append_segments(path: str, segments: list[dict],
                    max_lines: int = TRACE_FILE_MAX_LINES) -> int:
    """Append valid segments to a per-target trace file, atomically
    (tmp + replace), capped to the newest ``max_lines`` — a reader mid-
    scrape sees the old file or the new one, never a torn middle.
    Returns how many segments were kept."""
    rows = [json.dumps(s, sort_keys=True) for s in segments
            if valid_segment(s)]
    if not rows:
        return 0
    try:
        with open(path) as f:
            old = f.read().splitlines()
    except OSError:
        old = []
    keep = (old + rows)[-max_lines:]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(keep) + "\n")
    os.replace(tmp, path)
    return len(rows)


def traces_url(metrics_url: str) -> str:
    """The fleet convention: a target exposing ``/metrics`` exposes its
    sampled trace segments at ``/traces`` on the same listener."""
    parts = urllib.parse.urlsplit(metrics_url)
    return urllib.parse.urlunsplit(
        (parts.scheme, parts.netloc, "/traces", "", ""))


def scrape_traces(metrics_url: str, since: int,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """One ``/traces?since=<cursor>`` scrape → the payload dict
    (``obs/tracing.py`` :func:`traces_payload` shape).  Raises on any
    failure — the CALLER decides that traces are best-effort."""
    url = f"{traces_url(metrics_url)}?since={int(since)}"
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        payload = json.loads(resp.read().decode(errors="replace"))
    if not isinstance(payload, dict) \
            or not isinstance(payload.get("segments"), list):
        raise ValueError("malformed /traces payload")
    return payload


class Target:
    """One scrape target (see module docstring for the JSON shape)."""

    __slots__ = ("name", "kind", "url", "run_dir", "timeout_s",
                 "stale_after_s")

    def __init__(self, name: str, *, url: str | None = None,
                 run_dir: str | None = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 stale_after_s: float = STALE_AFTER_S):
        if bool(url) == bool(run_dir):
            raise ValueError(
                f"target {name!r} needs exactly one of url / run_dir")
        self.name = str(name)
        self.kind = "prometheus" if url else "run_dir"
        self.url = url
        self.run_dir = run_dir
        self.timeout_s = float(timeout_s)
        self.stale_after_s = float(stale_after_s)


def validate_targets(obj) -> list[str]:
    """Structural problems of a parsed targets file ([] when clean)."""
    problems: list[str] = []
    if not isinstance(obj, dict) or obj.get("schema") != TARGETS_SCHEMA:
        return [f"targets file must be an object with "
                f"schema={TARGETS_SCHEMA}"]
    targets = obj.get("targets")
    if not isinstance(targets, list) or not targets:
        return ["targets must be a non-empty list"]
    seen: set[str] = set()
    for i, t in enumerate(targets):
        where = f"targets[{i}]"
        if not isinstance(t, dict):
            problems.append(f"{where}: not an object")
            continue
        name = t.get("name")
        if not name or not isinstance(name, str):
            problems.append(f"{where}: missing name")
        elif name in seen:
            problems.append(f"{where}: duplicate name {name!r}")
        else:
            seen.add(name)
        if bool(t.get("url")) == bool(t.get("run_dir")):
            problems.append(f"{where}: exactly one of url / run_dir")
    return problems


def load_targets(path: str) -> tuple[list[Target], float]:
    """Parse + validate a targets file → (targets, interval_s)."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(f"{path}: unreadable targets file: {e}") from e
    problems = validate_targets(obj)
    if problems:
        raise ValueError(f"{path}: " + "; ".join(problems))
    base = os.path.dirname(os.path.abspath(path))
    targets = []
    for t in obj["targets"]:
        run_dir = t.get("run_dir")
        if run_dir and not os.path.isabs(run_dir):
            run_dir = os.path.join(base, run_dir)
        targets.append(Target(
            t["name"], url=t.get("url"), run_dir=run_dir,
            timeout_s=float(t.get("timeout_s", DEFAULT_TIMEOUT_S)),
            stale_after_s=float(t.get("stale_after_s", STALE_AFTER_S))))
    return targets, float(obj.get("interval_s", DEFAULT_INTERVAL_S))


# ---------------------------------------------------------------- scrape

def samples_from_exposition(text: str, target: str) -> list[dict]:
    """Parsed exposition → store samples tagged ``target``.

    Scalar samples store as values; histogram series (``_bucket`` /
    ``_sum`` / ``_count``) collapse into ONE snapshot sample per base
    (``obs/hist.py`` to_dict shape via :func:`snapshot_from_export`) so
    stored windows merge bucket-wise instead of being resampled.  A
    histogram on a foreign bucket ladder degrades to nothing (its
    ``_count`` survives as a scalar) rather than fabricating a
    distribution.  Raises ValueError on a malformed body — garbage is a
    scrape FAILURE, not data."""
    samples = parse_exposition(text)  # ValueError on malformed lines
    hist_bases = set(histogram_series(samples))
    out: list[dict] = []
    for name, labels, value in samples:
        base = None
        for suffix in ("_bucket", "_sum"):
            if name.endswith(suffix) and name[: -len(suffix)] in hist_bases:
                base = name[: -len(suffix)]
        if base is not None:
            continue  # folded into the snapshot below (counts kept)
        out.append({"name": name,
                    "labels": {"target": target, **labels},
                    "value": value})
    for base, series in histogram_series(samples).items():
        snap = snapshot_from_export(series)
        if snap is not None:
            out.append({"name": base, "labels": {"target": target},
                        "hist": snap})
    return out


def scrape_prometheus(url: str, target: str,
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> list[dict]:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        body = resp.read().decode(errors="replace")
    return samples_from_exposition(body, target)


def scrape_run_dir(run_dir: str, target: str,
                   stale_after_s: float = STALE_AFTER_S) -> list[dict]:
    """Scrape a run directory in-process through the sidecar composition
    rules, rendered + re-parsed so BOTH target kinds flow through the
    one validating parser (a composition bug fails the scrape here, not
    silently downstream)."""
    hb = read_heartbeat(os.path.join(run_dir, "heartbeat.json"))
    published = read_published_counters(run_dir)
    if hb is None and published is None:
        raise ValueError(f"no heartbeat.json or counters.json in "
                         f"{run_dir!r}")
    totals = compose_totals(published, hb)
    hists = compose_hists(published, hb)
    body = render_exposition(totals, hb, stale_after_s=stale_after_s,
                             histograms=export_snapshots(hists) or None)
    return samples_from_exposition(body, target)


class _TargetState:
    __slots__ = ("consecutive_failures", "last_error", "last_scrape_s",
                 "last_ok_ts", "inflight", "trace_cursor")

    def __init__(self):
        self.consecutive_failures = 0
        self.last_error: str | None = None
        self.last_scrape_s: float | None = None
        self.last_ok_ts: float | None = None
        self.inflight = False
        # /traces?since= high-water mark; reset to 0 when the target's
        # cursor goes BACKWARD (process restart — seq starts over)
        self.trace_cursor = 0


class Collector:
    """The scrape/store/evaluate loop plus its own HTTP plane."""

    def __init__(self, targets: list[Target], store: SeriesStore,
                 rules: RulesEngine | None = None, *,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 host: str = "127.0.0.1", port: int = 0,
                 serve_http: bool = True, scrape_traces: bool = True):
        self.targets = list(targets)
        self.store = store
        self.rules = rules
        self.interval_s = float(interval_s)
        self.scrape_traces = bool(scrape_traces)
        self.counters: dict[str, float] = {
            "agg_ticks_total": 0, "agg_samples_stored_total": 0,
            "agg_scrape_errors_total": 0, "agg_alert_transitions_total": 0,
            "agg_trace_segments_total": 0,
            "agg_trace_scrape_errors_total": 0,
        }
        self._states = {t.name: _TargetState() for t in self.targets}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._httpd = None
        if serve_http:
            self._httpd = _AggHttpd((host, int(port)), _make_handler(self))
            self.host, self.port = self._httpd.server_address[:2]

    # ------------------------------------------------------------- tick

    def _scrape_one(self, t: Target) -> list[dict]:
        if t.kind == "prometheus":
            return scrape_prometheus(t.url, t.name, timeout_s=t.timeout_s)
        return scrape_run_dir(t.run_dir, t.name,
                              stale_after_s=t.stale_after_s)

    def _land_traces(self, t: Target, state: _TargetState,
                     r: dict) -> int:
        """Land one successful scrape's /traces payload: segments append
        to the store root's ``traces-<target>.jsonl`` (what ``obs trace
        --store`` / ``obs slow`` assemble), bucket exemplars are grafted
        onto this tick's stored histogram snapshots (Prometheus text
        cannot carry them), and the cursor advances — backward movement
        means the target restarted, so restart from 0.  Returns how many
        segments landed."""
        if r.get("trace_error"):
            self.counters["agg_trace_scrape_errors_total"] += 1
            return 0
        payload = r.get("traces")
        if not payload:
            return 0
        kept = 0
        segs = payload.get("segments") or []
        if segs:
            kept = append_segments(
                trace_file_path(self.store.root, t.name), segs)
            self.counters["agg_trace_segments_total"] += kept
        cursor = int(payload.get("cursor") or 0)
        state.trace_cursor = cursor if cursor >= state.trace_cursor else 0
        exemplars = payload.get("exemplars") or {}
        if isinstance(exemplars, dict):
            by_metric = {metric_name(name): ex
                         for name, ex in exemplars.items()
                         if isinstance(ex, dict)}
            for sample in r["samples"]:
                ex = by_metric.get(sample["name"])
                if ex is not None and isinstance(sample.get("hist"), dict):
                    sample["hist"]["exemplars"] = ex
        return kept

    def tick(self, now: float | None = None) -> dict:
        """One collection round: scrape every target (bounded, parallel),
        store the samples, evaluate the rules.  Returns a summary dict
        (per-target ok/error + transitions) for callers that drive ticks
        themselves (tests, the doctor probe)."""
        now = time.time() if now is None else float(now)
        results: dict[str, dict] = {}
        res_lock = threading.Lock()

        def scrape(t: Target, state: _TargetState) -> None:
            t0 = time.perf_counter()
            try:
                samples = self._scrape_one(t)
                err = None
            except Exception as e:  # noqa: BLE001 — any failure mode
                # (refused, timeout, garbage, missing files) is the same
                # verdict: this target did not produce a scrape
                samples, err = None, f"{type(e).__name__}: {e}"
            traces, terr = None, None
            if (err is None and self.scrape_traces
                    and t.kind == "prometheus"):
                # best-effort second fetch on the same listener: trace
                # segments + histogram exemplars ride /traces?since= —
                # a missing endpoint degrades tracing, never the scrape
                try:
                    traces = scrape_traces(t.url, state.trace_cursor,
                                           timeout_s=t.timeout_s)
                except Exception as e:  # noqa: BLE001 — same envelope
                    terr = f"{type(e).__name__}: {e}"
            dt = time.perf_counter() - t0
            with res_lock:
                results[t.name] = {"samples": samples, "error": err,
                                   "traces": traces, "trace_error": terr,
                                   "elapsed_s": dt}
            # handshake with the next tick's skip-if-stuck check — the
            # collector lock orders this against tick's read+set
            with self._lock:
                state.inflight = False

        threads = []
        budget = max((t.timeout_s for t in self.targets),
                     default=DEFAULT_TIMEOUT_S) + 1.0
        for t in self.targets:
            state = self._states[t.name]
            # test-and-set under the collector lock: a zombie scrape
            # clearing the flag concurrently must not double-spawn
            with self._lock:
                stuck, state.inflight = state.inflight, True
            if stuck:
                # previous scrape still stuck past its own timeout: skip
                # this round rather than stacking threads on a zombie
                with res_lock:
                    results[t.name] = {"samples": None, "elapsed_s": 0.0,
                                       "error": "previous scrape still "
                                                "in flight"}
                continue
            th = threading.Thread(target=scrape, args=(t, state),
                                  name=f"agg-scrape-{t.name}", daemon=True)
            th.start()
            threads.append(th)
        deadline = time.perf_counter() + budget
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.perf_counter()))

        batch: list[dict] = []
        for t in self.targets:
            state = self._states[t.name]
            r = results.get(t.name)
            if r is None or r.get("samples") is None:
                err = (r or {}).get("error") or "scrape timed out"
                state.consecutive_failures += 1
                state.last_error = err
                self.counters["agg_scrape_errors_total"] += 1
                # the down verdict lands in the SAME store the rules and
                # dash read — one source of truth for "this replica died"
                batch.append({"name": "estorch_up",
                              "labels": {"target": t.name}, "value": 0.0})
                results[t.name] = {"ok": False, "error": err}
            else:
                state.consecutive_failures = 0
                state.last_error = None
                state.last_ok_ts = now
                state.last_scrape_s = r["elapsed_s"]
                segs = self._land_traces(t, state, r)
                batch.extend(r["samples"])
                results[t.name] = {"ok": True,
                                   "samples": len(r["samples"]),
                                   "segments": segs,
                                   "elapsed_s": round(r["elapsed_s"], 4)}
        with self._lock:
            self.store.append(batch, ts=now)
        self.counters["agg_ticks_total"] += 1
        self.counters["agg_samples_stored_total"] += len(batch)
        transitions: list[dict] = []
        if self.rules is not None:
            transitions = self.rules.evaluate(
                self.store, [t.name for t in self.targets], now)
            self.counters["agg_alert_transitions_total"] += len(transitions)
        return {"ts": now, "targets": results, "stored": len(batch),
                "transitions": transitions}

    def run(self, max_ticks: int | None = None) -> int:
        """The daemon loop: tick, then sleep the interval remainder.
        Stops after ``max_ticks`` (None = until :meth:`stop`)."""
        done = 0
        while not self._stop.is_set():
            t0 = time.perf_counter()
            self.tick()
            done += 1
            if max_ticks is not None and done >= max_ticks:
                break
            remaining = self.interval_s - (time.perf_counter() - t0)
            if remaining > 0 and self._stop.wait(remaining):
                break
        return done

    def stop(self) -> None:
        self._stop.set()

    # -------------------------------------------------------- HTTP plane

    def metrics(self) -> str:
        """The collector's own exposition: flat counters via the shared
        encoder, then per-target labeled gauges (one TYPE block each)."""
        body = render_exposition(dict(self.counters), None, up=True)
        lines = [body.rstrip("\n")]

        def esc(v: str) -> str:
            return (str(v).replace("\\", r"\\").replace("\n", r"\n")
                    .replace('"', r'\"'))

        gauges = (
            ("agg_target_up", "1 while the last scrape of the target "
                              "succeeded",
             lambda st: 0.0 if st.consecutive_failures else 1.0),
            ("agg_target_consecutive_failures", "scrapes failed in a row",
             lambda st: float(st.consecutive_failures)),
            ("agg_target_scrape_seconds", "duration of the last "
                                          "successful scrape",
             lambda st: float(st.last_scrape_s or 0.0)),
        )
        for name, help_, get in gauges:
            metric = metric_name(name)
            lines.append(f"# HELP {metric} {help_}")
            lines.append(f"# TYPE {metric} gauge")
            for t in self.targets:
                st = self._states[t.name]
                lines.append(f'{metric}{{target="{esc(t.name)}"}} '
                             f"{get(st):g}")
        return "\n".join(lines) + "\n"

    def alerts(self) -> dict:
        ledger_path = (self.rules.ledger_path
                       if self.rules is not None else None)
        return {
            "active": self.rules.active() if self.rules is not None else [],
            "transitions": (read_ledger(ledger_path, tail=50)
                            if ledger_path else []),
        }

    def health(self) -> dict:
        return {
            "ok": True,
            "targets": {
                t.name: {
                    "kind": t.kind,
                    "up": self._states[t.name].consecutive_failures == 0
                          and self._states[t.name].last_ok_ts is not None,
                    "consecutive_failures":
                        self._states[t.name].consecutive_failures,
                    **({"error": self._states[t.name].last_error}
                       if self._states[t.name].last_error else {}),
                } for t in self.targets
            },
            "ticks": int(self.counters["agg_ticks_total"]),
        }

    def start_background(self) -> threading.Thread | None:
        if self._httpd is None:
            return None
        self._serving = True
        th = threading.Thread(target=self._httpd.serve_forever,
                              kwargs={"poll_interval": 0.1},
                              name="agg-http", daemon=True)
        th.start()
        return th

    def close(self) -> None:
        self.stop()
        if self._httpd is not None:
            if getattr(self, "_serving", False):
                self._httpd.shutdown()
            self._httpd.server_close()


class _AggHttpd(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


def _make_handler(collector: Collector):
    class AggHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                self._reply(200, collector.metrics().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/alerts":
                self._reply(200, json.dumps(collector.alerts(),
                                            default=float).encode(),
                            "application/json")
            elif self.path == "/healthz":
                self._reply(200, json.dumps(collector.health()).encode(),
                            "application/json")
            else:
                self._reply(404, json.dumps(
                    {"error": f"no route {self.path!r}"}).encode(),
                    "application/json")

    return AggHandler


# ------------------------------------------------------------- selfcheck

def selfcheck() -> list[str]:
    """End-to-end proof on synthetic targets ([] = healthy): a healthy
    exposition target, a garbage target, and a dead port under one
    collector — every tick survives the dead/garbage targets, samples
    land in the store, the absence rule fires for the dead pair, an
    injected latency spike breaches the burn-rate rule NAMING the
    target, stored quantiles match the source histogram within the
    documented ladder bound, and the collector's own /metrics and
    /alerts parse.  Stdlib only, ~seconds."""
    import socket
    import tempfile

    if __package__:
        from ..hist import Histogram
    else:
        Histogram = _hist.Histogram

    problems: list[str] = []
    hist = Histogram()
    counters = {"requests_total": 0}

    class Fake(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            body = render_exposition(
                dict(counters), None, up=True,
                extra_gauges={"queue_depth": 1.0},
                histograms={"serve/request_s": hist.to_export()}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    class Garbage(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            body = b"<html>definitely not an exposition</html>"
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    fake = ThreadingHTTPServer(("127.0.0.1", 0), Fake)
    junk = ThreadingHTTPServer(("127.0.0.1", 0), Garbage)
    for srv in (fake, junk):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    # bound-but-not-listening: connects get RST for the whole selfcheck
    # (closing it would let the allocator hand the port to the collector
    # itself, and the "dead" target would scrape something alive)
    dead_sock = socket.socket()
    dead_sock.bind(("127.0.0.1", 0))
    dead_port = dead_sock.getsockname()[1]

    with tempfile.TemporaryDirectory() as d:
        col = None
        try:
            store = SeriesStore(os.path.join(d, "store"), max_segments=4)
            rules = RulesEngine([
                {"name": "replica-down", "kind": "absence",
                 "metric": "estorch_up", "for_s": 0, "window_s": 30},
                {"name": "queue-deep", "kind": "threshold",
                 "metric": "estorch_queue_depth", "op": ">", "value": 100,
                 "for_s": 0, "window_s": 30},
                {"name": "p99-slo", "kind": "burn_rate",
                 "metric": "estorch_serve_request_s", "quantile": 0.99,
                 "slo_s": 0.05,
                 "windows": [{"window_s": 60}, {"window_s": 10}]},
            ], ledger_path=os.path.join(d, LEDGER_FILENAME))
            targets = [
                Target("good",
                       url=f"http://127.0.0.1:{fake.server_address[1]}"
                           "/metrics", timeout_s=2.0),
                Target("garbage",
                       url=f"http://127.0.0.1:{junk.server_address[1]}"
                           "/metrics", timeout_s=2.0),
                Target("dead", url=f"http://127.0.0.1:{dead_port}/metrics",
                       timeout_s=0.5),
            ]
            col = Collector(targets, store, rules, interval_s=0.1, port=0)
            col.start_background()

            for v in (0.010, 0.012, 0.011, 0.013):
                hist.observe(v)
            counters["requests_total"] = 4
            t0 = time.perf_counter()
            now = time.time()
            r1 = col.tick(now)
            tick_s = time.perf_counter() - t0
            if tick_s > 5.0:
                problems.append(f"tick stalled on dead/garbage targets: "
                                f"{tick_s:.1f}s")
            if not r1["targets"]["good"]["ok"]:
                problems.append(f"healthy target failed: {r1}")
            for bad in ("garbage", "dead"):
                if r1["targets"][bad].get("ok"):
                    problems.append(f"{bad} target scraped OK?!")
            fired = {(t["rule"], t["target"])
                     for t in r1["transitions"] if t["event"] == "firing"}
            for bad in ("garbage", "dead"):
                if ("replica-down", bad) not in fired:
                    problems.append(
                        f"absence rule did not fire for {bad!r}: {fired}")
            if ("replica-down", "good") in fired:
                problems.append("absence rule fired for the healthy "
                                "target")
            if ("p99-slo", "good") in fired:
                problems.append("burn-rate fired on healthy latency")

            # inject the latency spike, scrape again: burn-rate must fire
            # naming the target, and the stored quantile must match the
            # source histogram within the documented ladder bound
            for _ in range(400):
                hist.observe(0.250)
            counters["requests_total"] = 404
            r2 = col.tick(now + 1.0)
            burn = [t for t in r2["transitions"]
                    if t["rule"] == "p99-slo" and t["event"] == "firing"]
            if not burn or burn[0]["target"] != "good":
                problems.append(f"burn-rate did not fire naming the "
                                f"target: {r2['transitions']}")
            elif "estorch_serve_request_s" not in burn[0]["detail"]:
                problems.append(f"burn-rate detail does not name the "
                                f"metric: {burn[0]}")
            got = store.quantile("estorch_serve_request_s", 0.99,
                                 {"target": "good"}, window_s=60,
                                 now=now + 1.0)
            want = hist.quantile(0.99)
            bound = hist.quantile_error_bound()
            if got is None or abs(got - want) > want * bound + 1e-12:
                problems.append(f"stored p99 {got} vs source {want} "
                                f"outside ladder bound {bound:.1%}")
            up = store.latest("estorch_up", {"target": "dead"},
                              window_s=60, now=now + 1.0)
            if not up or list(up.values())[-1][2] != 0.0:
                problems.append(f"dead target's estorch_up not stored "
                                f"as 0: {up}")

            # the collector's own plane must parse/serve
            with urllib.request.urlopen(
                    f"http://{col.host}:{col.port}/metrics",
                    timeout=10) as resp:
                own = resp.read().decode()
            try:
                parse_exposition(own)
            except ValueError as e:
                problems.append(f"collector /metrics does not parse: {e}")
            if 'estorch_agg_target_up{target="dead"} 0' not in own:
                problems.append("per-target up gauge missing from "
                                "collector /metrics")
            with urllib.request.urlopen(
                    f"http://{col.host}:{col.port}/alerts",
                    timeout=10) as resp:
                alerts = json.loads(resp.read().decode())
            active = {(a["rule"], a["target"]) for a in alerts["active"]}
            if ("p99-slo", "good") not in active \
                    or ("replica-down", "dead") not in active:
                problems.append(f"/alerts active set wrong: {active}")
            if not any(t["event"] == "firing"
                       for t in alerts["transitions"]):
                problems.append("/alerts carries no ledger transitions")

            # junk rules/targets files must be refused with a diagnosis
            bad = os.path.join(d, "bad.json")
            with open(bad, "w") as f:
                json.dump({"schema": 1, "rules": [{"kind": "nope"}]}, f)
            refused = False
            try:
                load_rules(bad)
            except ValueError:
                refused = True
            if not refused:
                problems.append("junk rules file accepted")
            with open(bad, "w") as f:
                json.dump({"schema": 1, "targets": [{"name": "x"}]}, f)
            refused = False
            try:
                load_targets(bad)
            except ValueError:
                refused = True
            if not refused:
                problems.append("junk targets file accepted")
        except Exception as e:  # noqa: BLE001 — the lint gate's
            # contract is one problem line + exit 1, never a traceback
            problems.append(f"unexpected selfcheck failure: {e!r}")
        finally:
            if col is not None:
                col.close()
            dead_sock.close()
            fake.shutdown(), fake.server_close()
            junk.shutdown(), junk.server_close()
    return problems


# ------------------------------------------------------------------ CLI

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m estorch_tpu_torch.obs collect",
        description="fleet metrics collector")
    p.add_argument("--targets", metavar="PATH",
                   help="targets.json (required unless --selfcheck)")
    p.add_argument("--store", metavar="DIR",
                   help="time-series store root (required unless "
                        "--selfcheck)")
    p.add_argument("--rules", default=None, metavar="PATH",
                   help="rules.json — SLO/alert rules evaluated each tick")
    p.add_argument("--interval", type=float, default=None,
                   help="collection interval seconds (default: the "
                        "targets file's interval_s, else "
                        f"{DEFAULT_INTERVAL_S})")
    p.add_argument("--ticks", type=int, default=None, metavar="N",
                   help="stop after N ticks (default: run until SIGTERM)")
    p.add_argument("--once", action="store_true",
                   help="one tick, then exit (alias for --ticks 1)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="collector's own /metrics //alerts port "
                        "(0 = ephemeral)")
    p.add_argument("--port-file", default=None, metavar="PATH",
                   help="atomically write {host,port,pid} JSON once bound")
    p.add_argument("--selfcheck", action="store_true",
                   help="prove the scrape/store/rules loop on synthetic "
                        "targets and exit")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.selfcheck:
        problems = selfcheck()
        if problems:
            for pr in problems:
                print(f"collect selfcheck: {pr}", file=sys.stderr)
            return 1
        print("obs collect selfcheck: OK (dead/garbage targets tolerated "
              "per tick, absence + burn-rate rules fire naming the "
              "target, stored quantiles within the ladder bound, "
              "/metrics and /alerts parse)")
        return 0
    if not args.targets or not args.store:
        print("collect needs --targets and --store (or --selfcheck)",
              file=sys.stderr)
        return 3
    try:
        targets, file_interval = load_targets(args.targets)
    except ValueError as e:
        print(f"collect: {e}", file=sys.stderr)
        return 2
    store = SeriesStore(args.store)
    rules = None
    if args.rules:
        try:
            rules = load_rules(args.rules)
        except ValueError as e:
            print(f"collect: {e}", file=sys.stderr)
            return 2
        rules.ledger_path = os.path.join(os.path.abspath(args.store),
                                         LEDGER_FILENAME)
        os.makedirs(args.store, exist_ok=True)
        # adopt still-firing alerts from a previous collector's ledger so
        # a restart emits the missing resolved (or keeps firing) instead
        # of forgetting — /alerts and the dash must agree after restarts
        rules.seed_from_ledger()
    interval = args.interval if args.interval is not None else file_interval
    col = Collector(targets, store, rules, interval_s=interval,
                    host=args.host, port=args.port)
    col.start_background()
    print(json.dumps({"ready": True,
                      "url": f"http://{col.host}:{col.port}",
                      "targets": [t.name for t in col.targets],
                      "store": store.root, "pid": os.getpid()}),
          flush=True)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": col.host, "port": col.port,
                       "pid": os.getpid()}, f)
        os.replace(tmp, args.port_file)
    import signal

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: col.stop())
    ticks = 1 if args.once else args.ticks
    done = col.run(max_ticks=ticks)
    col.close()
    print(json.dumps({"done": True, "ticks": done}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
