"""Threaded inference server over a policy bundle (stdlib HTTP only).

Counterpart of ``estorch_tpu/serve/server.py``.
``python -m estorch_tpu_torch.serve --bundle <dir>`` serves, on ``cuda``
unless ``--device cpu``:

* ``POST /predict``  — ``{"obs": [...]}`` → ``{"action": [...]}``; the
  request rides the dynamic micro-batcher (serve/batcher.py); a full
  queue answers 503 + ``Retry-After`` instead of growing without bound;
* ``GET /healthz``   — liveness + the heartbeat facts (last phase, beat
  age) + queue/counter snapshot; 503 while draining;
* ``GET /stats``     — full serving counters, bucket ladder, bundle
  provenance, the device;
* ``GET /metrics``   — Prometheus text exposition of the same counters
  (obs/export/prometheus.py) + heartbeat freshness, for scrapers;
* ``GET /traces?since=N`` — sampled trace segments (obs/tracing.py);
* ``POST /reload``   — ``{"path": "<bundle dir>"}`` hot-swaps the bundle
  atomically: the new bundle loads and verifies its ladder OFF the
  serving path, the swap is one reference assignment, and the old
  batcher drains its in-flight requests against the old params — no
  request ever sees a half-loaded policy.

Operational contract: heartbeat beats ride the ``ESTORCH_OBS_HEARTBEAT``
protocol (obs/recorder.py) so the watchdog can babysit a serving process
exactly like a training run — ``serve --supervised`` runs the server as a
spawned child of :class:`estorch_tpu_torch.resilience.Supervisor` with
heartbeat-staleness restarts.  SIGTERM drains: stop accepting, answer
everything in flight, write the final counter line, exit 0.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..obs.spans import Telemetry, resolve_telemetry
from ..obs.tracing import (PARENT_SPAN_HEADER, SAMPLED_HEADER,
                           TRACES_FILENAME, ProcessTracer, make_segment,
                           traces_payload)
from .batcher import BatcherClosed, BatcherSaturated, DynamicBatcher
from .bundle import BundleError, load_bundle

DRAIN_GRACE_S = 15.0


class _Engine:
    """One immutable (bundle, batcher) pair — THE hot-reload swap unit."""

    def __init__(self, bundle, batcher: DynamicBatcher):
        self.bundle = bundle
        self.batcher = batcher


class PolicyServer:
    """Bundle + dynamic batcher behind a ThreadingHTTPServer."""

    def __init__(
        self,
        bundle_path: str,
        *,
        host: str = "127.0.0.1",
        port: int = 8321,
        max_batch: int = 32,
        max_wait_ms: float = 4.0,
        max_queue: int = 256,
        request_timeout_s: float = 30.0,
        telemetry=None,
        warm: bool = False,
        dtype: str = "f32",
        quant_bound: float | None = None,
        t0_monotonic: float | None = None,
        run_dir: str | None = None,
        trace_head_every: int = 16,
        device=None,
    ):
        from ..utils.backend import resolve_device

        self.device = resolve_device(device)
        self.obs = resolve_telemetry(telemetry)
        self.max_batch = int(max_batch)
        # validate the CONFIG here so a bad --max-batch fails fast as a
        # config error — inside _build_engine it would be misattributed
        # to the bundle (the try there is for slot-dependence only)
        from .batcher import bucket_sizes

        bucket_sizes(self.max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.request_timeout_s = float(request_timeout_s)
        self.warm = bool(warm)
        from .predictor import SERVE_DTYPES

        if dtype not in SERVE_DTYPES:
            raise BundleError(
                f"serving dtype must be one of {SERVE_DTYPES}, got "
                f"{dtype!r}")
        self.dtype = dtype
        self.quant_bound = quant_bound
        # monotonic: uptime is an elapsed measure (esguard R09 — an NTP
        # step must not make a healthy server report negative uptime)
        # t0_monotonic: the CLI stamps it at main() entry so startup_s
        # covers the torch import, not just this constructor
        self._started_mono = (time.monotonic() if t0_monotonic is None
                              else float(t0_monotonic))
        self._first_request_recorded = False
        self._first_request_lock = threading.Lock()
        self.draining = False
        # per-request trace ids (docs/observability.md "Tails & traces"):
        # minted at HTTP entry, threaded through the batcher's recorder
        # events, echoed back as the X-Trace-Id response header
        self._req_seq = itertools.count(1)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._inflight_zero = threading.Event()
        self._inflight_zero.set()
        self._drained = threading.Event()
        self.obs.note("load_bundle")
        # serializes reload-vs-reload and reload-vs-shutdown: concurrent
        # swaps would double-close one old engine and leak the other
        self._engine_lock = threading.Lock()
        self._engine = self._build_engine(bundle_path)
        # cold-start facts (docs/serving.md "Cold start & quantized
        # serving"): gauges so /metrics, the heartbeat, and the fleet
        # dash all see how this replica came up
        self.obs.counters.gauge(
            "startup_s", round(time.monotonic() - self._started_mono, 3))
        self._httpd = _Httpd((host, int(port)), _make_handler(self))
        self.host, self.port = self._httpd.server_address[:2]
        # per-hop trace segments + tail sampler (obs/tracing.py,
        # docs/observability.md "Distributed tracing"): proc is
        # port-qualified so fleet replicas land in distinct lanes of the
        # assembled trace.  The batcher shares this tracer — its
        # lifecycle child segments must ride the SAME tail verdict the
        # handler applies at response time.
        self.tracer = ProcessTracer(
            f"server-{self.port}", counters=self.obs.counters,
            hists=self.obs.hists, hist_name="serve/request_s",
            head_every=trace_head_every,
            path=(os.path.join(run_dir, TRACES_FILENAME) if run_dir
                  else None))
        self._engine.batcher.tracer = self.tracer

    # ----------------------------------------------------------- engine

    def _build_engine(self, bundle_path: str) -> _Engine:
        # the port's compiles are its native libraries' first loads
        # (ops/_build.py): the ones made during this load are claimed here
        # and published as compiles_at_load (expected 0 — the serving path
        # loads none).  warm_cache_hits stays 0 (torch caches no programs);
        # it is published only to keep the JAX package's /stats and
        # Prometheus schema
        from ..ops._build import claim_library_loads
        from .warm import build_serving_batcher

        t_load = time.monotonic()
        t0 = time.perf_counter()
        bundle = load_bundle(bundle_path, device=self.device)
        # the batcher's construction-time bucket verification runs every
        # ladder shape once (serve/batcher.py); --warm additionally runs
        # the single-bucket case the verification skips (max_batch=1, the
        # A/B baseline), so its first request does not set up cuBLAS
        batcher = build_serving_batcher(
            bundle, max_batch=self.max_batch, max_wait_ms=self.max_wait_ms,
            max_queue=self.max_queue, dtype=self.dtype,
            quant_bound=self.quant_bound, telemetry=self.obs,
        )
        if self.warm and len(batcher.buckets) == 1:
            b = batcher.buckets[0]
            batcher.batch_fn(np.zeros((b,) + bundle.obs_shape, np.float32))
        # hot reload swaps in a fresh batcher mid-flight: it must keep
        # feeding the same per-process tracer (None during the FIRST
        # build — __init__ assigns once the bound port names the proc)
        batcher.tracer = getattr(self, "tracer", None)
        dt = time.perf_counter() - t0
        loads = claim_library_loads(t_load)
        for e in loads:
            self.obs.compile_event(e["program"], e["compile_s"],
                                   count_recompiles=0, cached=e["cached"],
                                   library=e["library"])
        self.obs.counters.gauge("warm_cache_hits", 0)
        self.obs.counters.gauge("compiles_at_load", len(loads))
        warm = bundle.warm_status
        self.obs.compile_event(
            "bundle_load", dt, count_recompiles=0, first_call=True,
            cache_hits=0, fresh_builds=len(loads),
            warm_installed=warm["installed"],
            **({"warm_skip_reason": warm["reason"]} if warm.get("reason") else {}))
        return _Engine(bundle, batcher)

    def reload(self, bundle_path: str) -> dict:
        """Hot bundle reload: load+warm off-path, swap atomically, drain
        the old batcher.  On any load error the old bundle keeps serving.
        Serialized: concurrent reloads would double-close one old engine
        and leak the other's worker thread + loaded params."""
        with self._engine_lock:
            if self.draining:
                raise BundleError("server is draining — reload refused")
            old = self._engine
            new = self._build_engine(bundle_path)  # BundleError on junk
            self._engine = new  # atomic reference swap
        self.obs.counters.inc("reloads_total")
        self.obs.event("bundle_reloaded", path=bundle_path,
                       version=new.bundle.version)
        old.batcher.close(drain=True)
        return {"ok": True, "version": new.bundle.version,
                "previous": old.bundle.version}

    # ---------------------------------------------------------- serving

    def predict(self, obs, trace: str | None = None,
                span: str | None = None) -> np.ndarray:
        # one engine read per attempt; a request racing a hot reload can
        # catch the OLD batcher mid-close (BatcherClosed) on a perfectly
        # healthy server — retry against the freshly-swapped engine
        # instead of answering a spurious "draining" 503
        while True:
            eng = self._engine
            try:
                out = eng.batcher.predict(obs,
                                          timeout=self.request_timeout_s,
                                          trace=trace, span=span)
            except BatcherClosed:
                if self.draining or eng is self._engine:
                    raise
                continue
            if not self._first_request_recorded:
                # time-to-first-response from process start — THE
                # cold-start product metric; set once, raced safely
                with self._first_request_lock:
                    if not self._first_request_recorded:
                        self._first_request_recorded = True
                        self.obs.counters.gauge(
                            "first_request_s",
                            round(time.monotonic() - self._started_mono,
                                  3))
            return out

    def track_request(self):
        with self._inflight_lock:
            self._inflight += 1
            self._inflight_zero.clear()

    def untrack_request(self):
        with self._inflight_lock:
            self._inflight -= 1
            if self._inflight <= 0:
                self._inflight_zero.set()

    def health(self) -> dict:
        eng = self._engine
        c = self.obs.counters
        out = {
            "ok": not self.draining,
            "draining": self.draining,
            "version": eng.bundle.version,
            "bundle": eng.bundle.path,
            "uptime_s": round(time.monotonic() - self._started_mono, 3),
            "pid": os.getpid(),
            "queue_depth": eng.batcher._q.qsize(),
            "requests_total": int(c.get("requests_total")),
            "shed_total": int(c.get("shed_total")),
        }
        hb = self.obs.heartbeat
        if hb is not None:
            from ..obs.recorder import read_heartbeat

            beat = read_heartbeat(hb.path)
            if beat is not None:
                out["heartbeat"] = {"path": hb.path,
                                    "age_s": round(beat["age_s"], 3),
                                    "phase": beat.get("phase")}
        return out

    def metrics(self) -> str:
        """Prometheus text exposition of the serving counters (the
        `/metrics` body; obs/export/prometheus.py).  `estorch_up` is 1
        while not draining — this process answering IS the liveness; the
        heartbeat facts ride along when a heartbeat path is configured
        so scrapes and the watchdog agree on staleness."""
        from ..obs.export.prometheus import render_exposition
        from ..obs.recorder import read_heartbeat

        eng = self._engine
        hb = (read_heartbeat(self.obs.heartbeat.path)
              if self.obs.heartbeat is not None else None)
        return render_exposition(
            self.obs.counters.snapshot(), hb,
            extra_gauges={
                "queue_depth": eng.batcher._q.qsize(),
                "uptime_seconds": round(
                    time.monotonic() - self._started_mono, 3),
                "draining": 1.0 if self.draining else 0.0,
            },
            up=not self.draining,
            # per-request lifecycle distributions (serve/batcher.py:
            # queue-wait, coalesce-wait, compute, request; the handler's
            # write) as true histogram types — the tail a scraper can
            # actually alert on
            histograms=self.obs.hists.export() or None,
        )

    def _collector_target(self) -> dict:
        """Ready-to-paste targets.json entry.  A wildcard bind address
        (0.0.0.0 / ::) is not routable FROM the collector's host — an
        operator pasting it would scrape the collector's own loopback —
        so substitute this machine's name, which is what a remote
        collector must dial anyway."""
        host = self.host
        if host in ("0.0.0.0", "::", ""):
            import socket as _socket

            host = _socket.getfqdn() or _socket.gethostname()
        return {
            "name": f"serve-{host}-{self.port}",
            "url": f"http://{host}:{self.port}/metrics",
        }

    def device_facts(self) -> dict:
        """The serving device as a manifest entry (``obs/manifest.py``):
        platform ``gpu``/``cpu`` and the card's name."""
        from ..obs.manifest import describe_device

        return describe_device(self.device)

    def memory_facts(self) -> dict | None:
        """The card's memory as this process sees it (None on the CPU):
        what torch's allocator holds for this process, and the whole
        card's free and total bytes (``torch.cuda.mem_get_info``, which
        counts every process's CUDA context)."""
        if self.device.type != "cuda":
            return None
        import torch

        free, total = torch.cuda.mem_get_info(self.device)
        mib = 1 << 20
        return {"allocated_mib": round(torch.cuda.memory_allocated(self.device) / mib, 3),
                "reserved_mib": round(torch.cuda.memory_reserved(self.device) / mib, 3),
                "card_free_mib": round(free / mib, 3),
                "card_total_mib": round(total / mib, 3)}

    def cold_start(self) -> dict:
        """The replica's cold-start facts (docs/serving.md): how long to
        come up, how long to first answer, and the warm-bundle proof —
        native library loads at load (the port's compiles) and cache hits
        (always 0: torch caches no programs)."""
        c = self.obs.counters
        fresh = c.get("compiles_at_load", -1)
        eng = self._engine
        out = {
            "startup_s": c.get("startup_s") or None,
            "first_request_s": (c.get("first_request_s")
                                if self._first_request_recorded else None),
            "compiles_at_load": None if fresh < 0 else int(fresh),
            "warm_cache_hits": int(c.get("warm_cache_hits")),
            "warm": eng.bundle.warm_status,
        }
        return out

    def stats(self) -> dict:
        eng = self._engine
        return {
            "version": eng.bundle.version,
            "bundle": eng.bundle.path,
            "source": eng.bundle.manifest.get("source"),
            "obs_shape": list(eng.bundle.obs_shape),
            "dtype": self.dtype,
            "device": self.device_facts(),
            "cold_start": self.cold_start(),
            "max_wait_ms": self.max_wait_ms,
            "counters": self.obs.counters.snapshot(),
            # collector-discovery stanza (obs/agg/, docs/observability.md
            # "Fleet aggregation"): a ready-to-paste targets.json entry,
            # so enrolling this replica in the fleet collector is a copy,
            # not a transcription
            "collector_target": self._collector_target(),
            **eng.batcher.stats(),
        }

    # -------------------------------------------------------- lifecycle

    def serve_forever(self) -> None:
        self.obs.note("serving")
        self._httpd.serve_forever(poll_interval=0.1)

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, name="serve-http",
                             daemon=True)
        t.start()
        return t

    def shutdown(self, drain: bool = True) -> dict:
        """Graceful stop: no new connections, answer everything already
        in flight, drain the batcher queue, then close.  Returns the
        final counter snapshot (the CLI prints it as the last line)."""
        with self._engine_lock:
            # after this flag no reload can swap in a fresh engine that
            # shutdown would never close
            self.draining = True
        self.obs.note("draining")
        self._httpd.shutdown()  # stop accepting; serve_forever returns
        # requests already parsed (tracked) finish against the batcher
        self._inflight_zero.wait(DRAIN_GRACE_S)
        self._engine.batcher.close(drain=drain)
        self._httpd.server_close()
        self.tracer.flush()  # sampled segments outlive the process
        self.obs.note("drained")
        final = {
            "drained": True,
            "clean": self._inflight_zero.is_set(),
            "counters": self.obs.counters.snapshot(),
        }
        self._drained.set()
        return final


class _Httpd(ThreadingHTTPServer):
    # handler threads die with the process; drain correctness comes from
    # the in-flight tracking in PolicyServer.shutdown, not thread joins
    daemon_threads = True
    allow_reuse_address = True
    # the listen backlog: a fleet's router opens a new connection for every
    # request, so a batch's answers return a burst of connects at once.
    # socketserver's default of 5 overflowed under it, and Linux drops an
    # overflowing SYN, which the client resends a second later: 1 s stalls,
    # and a health poll timing out on one took a live replica out of
    # rotation (the JAX package's server keeps the default)
    request_queue_size = 1024


def _make_handler(server: PolicyServer):
    class ServeHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive: persistent clients
        # TCP_NODELAY: a reply is two writes (headers, then body), and with
        # Nagle's algorithm the body waits for the client's delayed ACK of
        # the headers — about 40 ms a request on one keep-alive connection
        # (the JAX package's server keeps that stall)
        disable_nagle_algorithm = True

        def log_message(self, *args):  # quiet: obs counters tell the story
            pass

        def _reply(self, code: int, payload: dict,
                   extra_headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            if server.draining:
                # finish this response, then let the connection close so
                # keep-alive clients re-resolve elsewhere
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        # ------------------------------------------------------- routes

        def do_GET(self):
            if self.path == "/healthz":
                h = server.health()
                self._reply(200 if h["ok"] else 503, h)
            elif self.path == "/stats":
                self._reply(200, server.stats())
            elif self.path.split("?", 1)[0] == "/traces":
                # sampled segments since a cursor + histogram exemplars
                # (obs/tracing.py traces_payload) — the collector's
                # scrape leg of cross-process trace assembly
                q = self.path.split("since=", 1)
                try:
                    since = int(q[1].split("&", 1)[0]) if len(q) == 2 else 0
                except ValueError:
                    since = 0
                self._reply(200, traces_payload(server.tracer, since,
                                                hists=server.obs.hists))
            elif self.path == "/metrics":
                body = server.metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; "
                                 "charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                if server.draining:
                    self.send_header("Connection", "close")
                    self.close_connection = True
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": f"no route {self.path!r}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                data = json.loads(self.rfile.read(n)) if n else {}
            except (ValueError, TypeError) as e:
                self._reply(400, {"error": f"bad request body: {e}"})
                return
            if not isinstance(data, dict):
                self._reply(400, {"error": "request body must be a JSON "
                                           "object"})
                return
            if self.path == "/predict":
                self._predict(data)
            elif self.path == "/reload":
                self._reload(data)
            else:
                self._reply(404, {"error": f"no route {self.path!r}"})

        def _predict(self, data: dict) -> None:
            if "obs" not in data:
                self._reply(400, {"error": "predict needs {'obs': [...]}"})
                return
            # a request counts as in flight until its RESPONSE is written:
            # untracking before the reply would let a SIGTERM drain declare
            # victory (inflight==0) while this thread still holds an
            # unwritten answer — and the process exit would drop it.
            # An incoming X-Trace-Id (the fleet router forwards the id it
            # minted) is honored so one slow answer traces end to end;
            # direct clients still get a locally-minted r<N>
            trace = (self.headers.get("X-Trace-Id")
                     or f"r{next(server._req_seq)}")
            # span parenting crosses the process boundary here: the
            # router's upstream LEG span arrives as X-Parent-Span, and an
            # upstream hop that already judged the trace interesting
            # (retry/hedge legs) forces this process's tail sampler
            parent_span = self.headers.get(PARENT_SPAN_HEADER) or None
            forced = self.headers.get(SAMPLED_HEADER) == "1"
            req_span = server.tracer.span_id()
            t0 = time.perf_counter()
            status, shed = 500, False
            headers = {"X-Trace-Id": trace}
            server.track_request()
            try:
                try:
                    out = server.predict(data["obs"], trace=trace,
                                         span=req_span)
                except BatcherSaturated:
                    status, shed = 503, True
                    self._reply(503,
                                {"error": "saturated — retry with backoff",
                                 "trace": trace},
                                {"Retry-After": "1", **headers})
                    return
                except BatcherClosed:
                    status = 503
                    self._reply(503, {"error": "draining"}, headers)
                    return
                except (ValueError, TypeError) as e:
                    # malformed obs AT SUBMIT (wrong shape → ValueError,
                    # nulls/non-numerics → TypeError from np.asarray) —
                    # genuinely the client's fault; batch-side faults
                    # arrive as BatchError below, never these types
                    status = 400
                    self._reply(400, {"error": str(e)}, headers)
                    return
                except TimeoutError as e:
                    status = 504
                    self._reply(504, {"error": str(e)}, headers)
                    return
                except Exception as e:  # noqa: BLE001 — a server fault
                    # (BatchError from the jitted forward, device runtime
                    # death) must answer 500, not drop the connection
                    server.obs.counters.inc("http_500_total")
                    server.obs.event("predict_error", error=repr(e)[:200],
                                     trace=trace)
                    self._reply(500, {"error": f"server fault: {e}"},
                                headers)
                    return
                t_write = time.perf_counter()
                self._reply(200, {"action": out.tolist()}, headers)
                status = 200
                # the write leg of the lifecycle (serialize + socket):
                # the only piece the batcher's request_s cannot see
                dt_write = time.perf_counter() - t_write
                server.obs.hists.observe("serve/write_s", dt_write)
                server.tracer.add(make_segment(
                    trace, server.tracer.span_id(), req_span,
                    server.tracer.proc, "write", t_write, dt_write))
            finally:
                # the request ROOT span + the tail verdict — recorded
                # last so every child (batcher lifecycle, write) is
                # already buffered under this trace id
                dur = time.perf_counter() - t0
                server.tracer.add(make_segment(
                    trace, req_span, parent_span, server.tracer.proc,
                    "request", t0, dur, attrs={"status": status}))
                server.tracer.finish(trace, dur, error=status >= 400,
                                     shed=shed, forced=forced)
                server.untrack_request()

        def _reload(self, data: dict) -> None:
            path = data.get("path")
            if not path:
                self._reply(400, {"error": "reload needs {'path': ...}"})
                return
            try:
                self._reply(200, server.reload(path))
            except (BundleError, OSError) as e:
                # the old bundle keeps serving — a bad reload is a 409,
                # not an outage
                self._reply(409, {"error": str(e)})

    return ServeHandler


# ---------------------------------------------------------------- CLI body

def write_port_file(path: str, host: str, port: int) -> None:
    """Atomically publish ``{host, port, pid}`` — the bind announcement a
    launcher passing ``--port-file`` polls for (the JAX package's schema)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"host": host, "port": int(port), "pid": os.getpid()}, f)
    os.replace(tmp, path)


def run_server(args) -> int:
    """The ``python -m estorch_tpu_torch.serve`` body (args from
    __main__.py).  Returns the process exit code: 0 after a clean drain."""
    telemetry = Telemetry.from_env()
    telemetry.note("init")
    server = PolicyServer(
        args.bundle, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue, telemetry=telemetry, warm=args.warm,
        dtype=args.dtype,
        t0_monotonic=getattr(args, "_t0_monotonic", None),
        run_dir=getattr(args, "run_dir", None), device=args.device,
    )

    stop = threading.Event()

    def _on_signal(signum, frame):
        del frame
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    url = f"http://{server.host}:{server.port}"
    ready = {
        "ready": True, "url": url, "pid": os.getpid(),
        "version": server._engine.bundle.version,
        "max_batch": server.max_batch,
        "buckets": list(server._engine.batcher.buckets),
        "buckets_excluded": list(server._engine.batcher.buckets_excluded),
        "dtype": server.dtype,
        "device": server.device_facts(),
        "memory": server.memory_facts(),
        "cold_start": server.cold_start(),
    }
    print(json.dumps(ready), flush=True)
    if args.port_file:
        write_port_file(args.port_file, server.host, server.port)

    server.start_background()
    beat_s = max(0.2, float(args.beat_interval))
    # a fleet replica (serve/fleet.py names its pid in the environment)
    # drains and exits once its supervisor is gone, as a reparented
    # process: nothing else would ever stop it.  Only the supervisor's
    # own child watches (a server under ``--supervised`` inside a fleet
    # has another parent)
    supervisor = os.environ.get("ESTORCH_FLEET_SUPERVISOR")
    supervisor = int(supervisor) if supervisor == str(os.getppid()) else None
    while not stop.wait(beat_s):
        if supervisor is not None and os.getppid() != supervisor:
            print(json.dumps({"orphaned": True, "supervisor": supervisor}), flush=True)
            break
        # periodic heartbeat so the staleness watchdog sees an IDLE
        # server as alive, not wedged (batcher phases beat under load)
        telemetry.note("serving")
    final = server.shutdown(drain=True)
    print(json.dumps(final, default=float), flush=True)
    return 0 if final["clean"] else 1


# ------------------------------------------------------------- supervision

def supervised_child(root: str, argv: list) -> None:
    """Child body for ``serve --supervised`` — runs in a spawned (fresh)
    interpreter with ``ESTORCH_OBS_HEARTBEAT`` already pointed into
    ``root`` by the Supervisor plumbing (resilience/supervisor.py)."""
    del root
    t0 = time.monotonic()
    from .__main__ import build_parser

    args = build_parser().parse_args(argv)
    args._t0_monotonic = t0
    raise SystemExit(run_server(args))


def run_supervised(args, argv: list) -> int:
    """Babysit the server with the watchdog: exit-status + heartbeat
    staleness restarts, exponential backoff.  SIGTERM to the supervisor
    forwards to the child, which drains and exits 0 — the supervisor then
    reports clean completion."""
    from ..resilience.supervisor import Supervisor

    child_argv = [a for a in argv if a != "--supervised"]
    sup = Supervisor(
        ckpt_root=args.supervise_root,
        target_generation=0,
        child_target="estorch_tpu_torch.serve.server:supervised_child",
        child_args=(child_argv,),
        max_restarts=args.max_restarts,
        stale_after_s=args.stale_after_s,
        startup_grace_s=args.startup_grace_s,
    )

    def _forward(signum, frame):
        del frame
        sup.request_stop(signum)

    signal.signal(signal.SIGTERM, _forward)
    signal.signal(signal.SIGINT, _forward)
    result = sup.run()
    print(json.dumps({"supervised": True, "ok": result["ok"],
                      "restarts": len(result["restarts"]),
                      "reason": result["reason"]}), flush=True)
    return 0 if result["ok"] else 1


def find_free_port(host: str = "127.0.0.1") -> int:
    """An ephemeral port for tests/tools (bind(0), read, release)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]
