"""Front router for a serving fleet: health-gated failover over N replicas.

Counterpart of ``estorch_tpu/serve/router.py`` (the port's own copy; code
equal but for the listen backlog of its HTTP server).  ``python -m estorch_tpu_torch.serve route --fleet fleet.json``
(serve/fleet.py spawns the replicas and runs this router in-process) or
``... route --replicas r0=127.0.0.1:8321,r1=127.0.0.1:8322`` over
replicas managed elsewhere.  Stdlib-only, torch-free, and runnable as a
plain file (``python estorch_tpu_torch/serve/router.py``), which loads
the port's own ``obs`` siblings by path and never the package: the layer
that answers "is the fleet up?" must not depend on the runtime (a CUDA
context in a replica) whose death it exists to survive.

Routes:

* ``POST /predict`` — forwarded to one healthy replica, chosen by
  capacity (``/stats`` queue depth × ``request_ms`` p99 ≈ expected
  wait); connect/timeout/5xx failures retry on a DIFFERENT replica
  under a bounded budget with exponential backoff + jitter.
  Idempotent-safe: a request is never replayed after response bytes
  were written to the client, and ``/reload`` (non-idempotent) is never
  retried at all;
* ``GET /healthz`` / ``GET /stats`` / ``GET /metrics`` — router
  liveness, per-replica breaker/health detail (+ the collector-
  discovery stanza), Prometheus exposition with per-replica labeled
  gauges and true ``route_s``/``upstream_s`` histograms;
* ``POST /rollout {"path": bundle}`` / ``GET /rollout`` — canary
  rollout, delegated to the fleet supervisor when one is attached
  (serve/fleet.py owns the state machine; a bare router answers 409);
* ``POST /scale {"replicas": N}`` / ``GET /scale`` — the fleet's
  autoscaler admin surface (obs/agg/autoscale.py actuates here),
  delegated to the fleet like /rollout; a bare router answers 409.

Per-replica circuit breakers: consecutive
failures open the breaker (no traffic), a timed half-open probe admits
one trial, success closes it.  The health poll doubles as the probe, so
a respawned replica re-enters rotation within one poll interval without
sacrificing a client request.  Optional tail hedging duplicates a
request that outlives the observed upstream p99 onto a second replica —
first answer wins, the loser's connection is torn down (``hedged`` /
``hedge_wins`` counters).

Trace ids: the router mints ``r<N>`` (or honors an incoming
``X-Trace-Id``), forwards it upstream — where the replica's batcher
records it against the batch dispatch — and echoes it plus
``X-Upstream`` back, so one slow answer is attributable to one replica
in ``obs trace``.

SIGTERM drains: stop accepting, answer everything in flight, exit 0.
"""

from __future__ import annotations

import argparse
import http.client
import itertools
import json
import os
import random
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

if __package__:
    from ..obs.counters import Counters
    from ..obs.hist import Histogram, Histograms
    from ..obs.export.prometheus import (metric_name, render_exposition,
                                         _escape_label)
    from ..obs.tracing import (PARENT_SPAN_HEADER, SAMPLED_HEADER,
                               TRACES_FILENAME, ProcessTracer,
                               make_segment, traces_payload)
else:  # file-run (wedged-CUDA host): load siblings without any package init
    import importlib.util

    def _load(name: str, *rel: str):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            *rel)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    _counters = _load("_estorch_torch_obs_counters", os.pardir, "obs",
                      "counters.py")
    _hist = _load("_estorch_torch_obs_hist", os.pardir, "obs", "hist.py")
    _prom = _load("_estorch_torch_obs_prometheus", os.pardir, "obs", "export",
                  "prometheus.py")
    _tracing = _load("_estorch_torch_obs_tracing", os.pardir, "obs",
                     "tracing.py")
    Counters = _counters.Counters
    Histogram = _hist.Histogram
    Histograms = _hist.Histograms
    metric_name = _prom.metric_name
    render_exposition = _prom.render_exposition
    _escape_label = _prom._escape_label
    PARENT_SPAN_HEADER = _tracing.PARENT_SPAN_HEADER
    SAMPLED_HEADER = _tracing.SAMPLED_HEADER
    TRACES_FILENAME = _tracing.TRACES_FILENAME
    ProcessTracer = _tracing.ProcessTracer
    make_segment = _tracing.make_segment
    traces_payload = _tracing.traces_payload

DRAIN_GRACE_S = 15.0

BREAKER_CLOSED = "closed"
BREAKER_HALF_OPEN = "half_open"
BREAKER_OPEN = "open"
# numeric encoding for the exported gauge
BREAKER_STATE_CODE = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1,
                      BREAKER_OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure breaker: closed → open (after
    ``fail_threshold`` failures in a row) → half-open (one probe after
    ``open_s``) → closed on success / open on failure.  A success from
    ANY state closes — the health poll is the probe, and a replica that
    answers it is back (its respawn may sit on a new port, so the probe
    result is fresher than any stale failure streak)."""

    def __init__(self, fail_threshold: int = 3, open_s: float = 1.0):
        self.fail_threshold = int(fail_threshold)
        self.open_s = float(open_s)
        self.state = BREAKER_CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.opens_total = 0
        self._probe_inflight = False
        self._lock = threading.Lock()

    def allow(self) -> bool:
        """May a request be sent now?  Half-open admits exactly one
        in-flight probe; its outcome decides the next state."""
        with self._lock:
            if self.state == BREAKER_CLOSED:
                return True
            if self.state == BREAKER_OPEN:
                if time.monotonic() - self.opened_at < self.open_s:
                    return False
                self.state = BREAKER_HALF_OPEN
                self._probe_inflight = False
            # half-open: one probe at a time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self.state = BREAKER_CLOSED
            self.failures = 0
            self._probe_inflight = False

    def record_failure(self) -> bool:
        """Returns True when this failure OPENED the breaker."""
        with self._lock:
            self.failures += 1
            opened = False
            if (self.state == BREAKER_HALF_OPEN
                    or (self.state == BREAKER_CLOSED
                        and self.failures >= self.fail_threshold)):
                self.state = BREAKER_OPEN
                self.opened_at = time.monotonic()
                self.opens_total += 1
                opened = True
            self._probe_inflight = False
            return opened


class Replica:
    """One upstream: address + breaker + the last health-poll facts."""

    def __init__(self, name: str, address: str, *,
                 fail_threshold: int = 3, open_s: float = 1.0):
        self.name = str(name)
        self.address = _strip_scheme(address)
        self.breaker = CircuitBreaker(fail_threshold, open_s)
        self.hist = Histogram()  # per-replica upstream latency
        self.lock = threading.Lock()
        # health facts, overwritten whole by the poll thread
        self.health: dict = {"polled": False}
        self.inflight = 0
        self.requests = 0
        self.failures = 0
        # set by retire_replica: out of selection immediately (the
        # fleet notifies the router BEFORE killing a retiring replica)
        self.retiring = False

    def snapshot(self) -> dict:
        h = dict(self.health)
        return {
            "name": self.name,
            "address": self.address,
            "breaker": self.breaker.state,
            "breaker_opens": self.breaker.opens_total,
            "retiring": self.retiring,
            "inflight": self.inflight,
            "requests": self.requests,
            "failures": self.failures,
            "upstream_p99_ms": (round(self.hist.quantile(0.99) * 1e3, 3)
                                if self.hist.count else None),
            **{k: h.get(k) for k in ("polled", "ok", "draining",
                                     "queue_depth", "p99_ms", "age_s",
                                     "error", "version")},
        }


def _strip_scheme(address: str) -> str:
    if "://" in address:
        address = address.split("://", 1)[1]
    return address.rstrip("/")


def write_port_file(path: str, host: str, port: int) -> None:
    """Atomically publish ``{host, port, pid}`` — the bind announcement
    the fleet's ``_check_starting`` (and any launcher passing
    ``--port-file``) polls for.  One definition: server, router, and
    fleet entry points all write the same schema."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"host": host, "port": int(port),
                   "pid": os.getpid()}, f)
    os.replace(tmp, path)


class UpstreamError(Exception):
    """One failed upstream attempt — always safe to retry on a
    DIFFERENT replica (/predict is pure and nothing reached the
    client); ``breaker`` says whether it counts as a death (transport
    failures and 5xx do, 503 backpressure does not)."""

    def __init__(self, msg: str, *, breaker: bool):
        super().__init__(msg)
        self.breaker = breaker


class Router:
    """Health-gated load balancer + the fleet's one client-facing port."""

    def __init__(
        self,
        replicas: list[tuple[str, str]],
        *,
        host: str = "127.0.0.1",
        port: int = 8400,
        retry_budget: int = 2,
        backoff_base_s: float = 0.025,
        backoff_max_s: float = 0.5,
        upstream_timeout_s: float = 10.0,
        poll_interval_s: float = 0.25,
        poll_timeout_s: float = 1.0,
        breaker_failures: int = 3,
        breaker_open_s: float = 1.0,
        hedge: bool = False,
        hedge_min_ms: float = 25.0,
        hedge_quantile: float = 0.99,
        shadow_queue: int = 64,
        rollout_cb=None,
        scale_cb=None,
        serve_http: bool = True,
        run_dir: str | None = None,
        trace_head_every: int = 16,
    ):
        self.counters = Counters()
        self.hists = Histograms()
        # distributed tracing (obs/tracing.py): per-hop segments,
        # tail-sampled when the route span ends; ``run_dir`` enables the
        # traces.jsonl flush beside the heartbeat/port files
        self.tracer = ProcessTracer(
            "router", counters=self.counters, hists=self.hists,
            hist_name="router/route_s", head_every=trace_head_every,
            path=(os.path.join(run_dir, TRACES_FILENAME)
                  if run_dir else None))
        self.retry_budget = int(retry_budget)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.upstream_timeout_s = float(upstream_timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self.poll_timeout_s = float(poll_timeout_s)
        self.breaker_failures = int(breaker_failures)
        self.breaker_open_s = float(breaker_open_s)
        self.hedge = bool(hedge)
        self.hedge_min_ms = float(hedge_min_ms)
        self.hedge_quantile = float(hedge_quantile)
        self._rollout_cb = rollout_cb
        self._scale_cb = scale_cb
        # desired fleet size, set by the supervisor on every scale
        # decision — exported as a gauge so the dash can show
        # desired-vs-actual from the store alone
        self.desired_replicas: int | None = None
        self._replicas: dict[str, Replica] = {}
        self._replicas_lock = threading.Lock()
        for name, addr in replicas:
            self.add_replica(name, addr)
        self._rr = itertools.count()
        self._req_seq = itertools.count(1)
        self._rng = random.Random(0xE57)  # backoff jitter only
        self._started_mono = time.monotonic()
        self.draining = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._inflight_zero = threading.Event()
        self._inflight_zero.set()
        # canary shadow state (armed by the fleet during a rollout)
        self._canary_lock = threading.Lock()
        self._canary: dict | None = None
        self._shadow_q: "list" = []  # bounded, guarded by _canary_lock
        self._shadow_q_max = int(shadow_queue)
        self._shadow_wake = threading.Event()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._httpd = None
        if serve_http:
            self._httpd = _RouterHttpd((host, int(port)),
                                       _make_handler(self))
            self.host, self.port = self._httpd.server_address[:2]

    # ------------------------------------------------------------ replicas

    def add_replica(self, name: str, address: str) -> None:
        with self._replicas_lock:
            self._replicas[name] = Replica(
                name, address, fail_threshold=self.breaker_failures,
                open_s=self.breaker_open_s)

    def update_replica(self, name: str, address: str) -> None:
        """A respawned replica comes back on a fresh port: swap the
        address, reset health (the poll re-learns it), KEEP the breaker
        — the probe closing it is the readmission protocol."""
        with self._replicas_lock:
            rep = self._replicas.get(name)
            if rep is None:
                self._replicas[name] = Replica(
                    name, address, fail_threshold=self.breaker_failures,
                    open_s=self.breaker_open_s)
                return
            rep.address = _strip_scheme(address)
            rep.health = {"polled": False}
            rep.retiring = False

    def retire_replica(self, name: str) -> bool:
        """Take ``name`` out of selection IMMEDIATELY (scale-down step
        one): no new request reaches it, in-flight answers complete, the
        health poll keeps watching it drain.  The fleet calls this
        BEFORE sending SIGTERM — the ordering that makes a retirement
        cost zero client errors."""
        with self._replicas_lock:
            rep = self._replicas.get(name)
            if rep is None:
                return False
            rep.retiring = True
        self.counters.inc("router_replicas_retired_total")
        return True

    def remove_replica(self, name: str) -> bool:
        """Forget ``name`` entirely (the retired process is dead): its
        breaker, histogram and health facts go with it — a future slot
        reusing the name starts clean."""
        with self._replicas_lock:
            return self._replicas.pop(name, None) is not None

    def replicas(self) -> list[Replica]:
        with self._replicas_lock:
            return list(self._replicas.values())

    # ------------------------------------------------------------ lifecycle

    def start_background(self) -> None:
        for target, name in ((self._poll_loop, "router-poll"),
                             (self._shadow_loop, "router-shadow")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        if self._httpd is not None:
            t = threading.Thread(target=self._httpd.serve_forever,
                                 kwargs={"poll_interval": 0.1},
                                 name="router-http", daemon=True)
            t.start()
            self._threads.append(t)

    def shutdown(self, drain: bool = True) -> dict:
        self.draining = True
        self._stop.set()
        self._shadow_wake.set()
        if self._httpd is not None:
            self._httpd.shutdown()
        if drain:
            self._inflight_zero.wait(DRAIN_GRACE_S)
        if self._httpd is not None:
            self._httpd.server_close()
        self.tracer.flush()  # sampled segments outlive the process
        return {"drained": True, "clean": self._inflight_zero.is_set(),
                "counters": self.counters.snapshot()}

    def track_request(self):
        with self._inflight_lock:
            self._inflight += 1
            self._inflight_zero.clear()

    def untrack_request(self):
        with self._inflight_lock:
            self._inflight -= 1
            if self._inflight <= 0:
                self._inflight_zero.set()

    # ------------------------------------------------------------- health

    def _poll_one(self, rep: Replica) -> None:
        conn = http.client.HTTPConnection(
            *_split(rep.address), timeout=self.poll_timeout_s)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            body = json.loads(resp.read().decode() or "{}")
            facts = {
                "polled": True,
                "ok": bool(body.get("ok")),
                "draining": bool(body.get("draining")),
                "queue_depth": body.get("queue_depth"),
                "version": body.get("version"),
                "age_s": (body.get("heartbeat") or {}).get("age_s"),
                "error": None,
            }
            # capacity detail rides /stats (request_ms p99 from the
            # replica's own histograms) — best-effort: a replica whose
            # /stats is momentarily slow is still healthy
            try:
                conn.request("GET", "/stats")
                stats = json.loads(conn.getresponse().read().decode())
                lat = stats.get("request_ms") or {}
                facts["p99_ms"] = lat.get("p99")
                facts["queue_depth"] = stats.get(
                    "queue_depth", facts["queue_depth"])
            except (OSError, ValueError, http.client.HTTPException):
                facts["p99_ms"] = rep.health.get("p99_ms")
            with rep.lock:
                rep.health = facts
            if facts["ok"]:
                # the poll IS the half-open probe: an answering replica
                # re-enters rotation without risking a client request
                if rep.breaker.state != BREAKER_CLOSED:
                    self.counters.inc("router_breaker_closes_total")
                rep.breaker.record_success()
            elif facts["draining"]:
                # draining answers politely but must leave rotation;
                # not a death — no breaker-open storm for a clean drain
                pass
        except (OSError, ValueError, http.client.HTTPException) as e:
            with rep.lock:
                rep.health = {"polled": True, "ok": False,
                              "error": f"{type(e).__name__}: {e}",
                              "draining": rep.health.get("draining"),
                              "queue_depth": None,
                              "p99_ms": rep.health.get("p99_ms"),
                              "age_s": None,
                              "version": rep.health.get("version")}
            if rep.breaker.record_failure():
                self.counters.inc("router_breaker_opens_total")
        finally:
            conn.close()

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            for rep in self.replicas():
                self._poll_one(rep)
            self._stop.wait(self.poll_interval_s)

    # ------------------------------------------------------------- routing

    def _eligible(self, exclude: set[str]
                  ) -> tuple[list[Replica], list[Replica]]:
        """(healthy closed-breaker replicas, breaker-gated candidates).
        ``allow()`` is NOT called here — it claims the single half-open
        probe slot, so only :meth:`pick`'s chosen candidate may call it
        (claiming it for a candidate that loses the pick would lock a
        recovering replica out until the next health poll)."""
        c = self._canary  # one read: end_canary can null it mid-pick
        canary = c["name"] if c else None
        healthy, probes = [], []
        for rep in self.replicas():
            if rep.name in exclude or rep.name == canary or rep.retiring:
                continue
            h = rep.health
            down = h.get("polled") and (not h.get("ok")
                                        or h.get("draining"))
            if rep.breaker.state == BREAKER_CLOSED:
                if not down:
                    healthy.append(rep)
            else:
                probes.append(rep)
        return healthy, probes

    def pick(self, exclude: set[str] = frozenset()) -> Replica | None:
        """Least-expected-wait among eligible replicas: queue depth (its
        own + our in-flight) × observed p99 service time, round-robin on
        ties so equal replicas share load.  Half-open probes get client
        traffic only when no healthy replica exists, best-scored first,
        claiming the probe slot only for the one actually returned."""
        healthy, probes = self._eligible(set(exclude))
        rr = next(self._rr)

        def ranked(cands):
            def score(item):
                i, rep = item
                h = rep.health
                q = h.get("queue_depth")
                depth = (0 if q is None else float(q)) + rep.inflight
                p99 = h.get("p99_ms")
                service = max(float(p99) if p99 else 0.0, 1.0) / 1e3
                return (depth * service, (i + rr) % len(cands))

            return [rep for _i, rep in
                    sorted(enumerate(cands), key=score)]

        if healthy:
            return ranked(healthy)[0]
        for rep in ranked(probes):
            if rep.breaker.allow():
                return rep
        return None

    # one upstream try; raises UpstreamError on any failed attempt
    def _upstream_predict(self, rep: Replica, body: bytes, trace: str,
                          cancel_box: dict | None = None,
                          parent_span: str | None = None,
                          sampled: bool = False) -> tuple[int, bytes]:
        conn = http.client.HTTPConnection(
            *_split(rep.address), timeout=self.upstream_timeout_s)
        if cancel_box is not None:
            cancel_box["conn"] = conn
        try:
            try:
                headers = {
                    "Content-Type": "application/json",
                    "X-Trace-Id": trace,
                }
                if parent_span:
                    # the replica's request span parents to THIS leg, so
                    # assembly can tell retry/hedge legs apart
                    headers[PARENT_SPAN_HEADER] = parent_span
                if sampled:
                    # this hop already knows the trace is interesting
                    # (retry/hedge leg): force the downstream sampler
                    headers[SAMPLED_HEADER] = "1"
                conn.request("POST", "/predict", body, headers)
                resp = conn.getresponse()
                data = resp.read()
            except (TimeoutError, OSError,
                    http.client.HTTPException) as e:
                # connect refused / reset / read timeout: the CLIENT saw
                # no bytes, and /predict is pure — safe on another
                # replica.  Counts toward the breaker.
                raise UpstreamError(f"{type(e).__name__}: {e}",
                                    breaker=True) from e
            except Exception as e:
                # a hedge cancel races this read: the winner's thread
                # calls conn.close() under us, and http.client's
                # internals can surface that as errors outside the
                # tuple above (e.g. AttributeError from a half-torn
                # response object mid-read).  Only when WE cancelled is
                # that expected — map it to the failed-attempt path so
                # the loser records its cancelled leg instead of dying
                # as an unhandled thread exception.
                if cancel_box is not None and cancel_box.get("cancelled"):
                    raise UpstreamError(
                        f"cancelled mid-read ({type(e).__name__}: {e})",
                        breaker=False) from e
                raise
            if resp.status == 503:
                # shed or draining: alive but refusing — try another
                # replica, but don't open the breaker for backpressure
                raise UpstreamError(f"503 from {rep.name}",
                                    breaker=False)
            if resp.status >= 500:
                raise UpstreamError(
                    f"{resp.status} from {rep.name}: "
                    f"{data[:200].decode(errors='replace')}",
                    breaker=True)
            return resp.status, data
        finally:
            conn.close()

    def _attempt(self, rep: Replica, body: bytes, trace: str,
                 cancel_box: dict | None = None, *,
                 parent_span: str | None = None, attempt: int = 0,
                 hedge: bool = False,
                 sampled: bool = False) -> tuple[int, bytes]:
        """One accounted attempt: breaker + latency + counters + one
        ``upstream`` trace leg (retry legs carry their attempt index,
        hedge legs their flag, a cancelled loser its ``cancelled``)."""
        with rep.lock:
            rep.inflight += 1
            rep.requests += 1
        t0 = time.perf_counter()
        leg_span = self.tracer.span_id()
        try:
            status, data = self._upstream_predict(
                rep, body, trace, cancel_box, parent_span=leg_span,
                sampled=sampled or hedge)
        except UpstreamError as e:
            with rep.lock:
                rep.inflight -= 1
            cancelled = bool(cancel_box is not None
                             and cancel_box.get("cancelled"))
            self.tracer.add(make_segment(
                trace, leg_span, parent_span, "router", "upstream",
                t0, time.perf_counter() - t0,
                attrs={"replica": rep.name, "attempt": attempt,
                       "hedge": hedge, "cancelled": cancelled,
                       "error": str(e)}))
            if cancelled:
                # WE closed this connection (hedge loser): the replica
                # is healthy-but-slow, not dead — charging its breaker
                # would flap a slow replica out of rotation, the exact
                # 'overload is not death' mistake the 503 rule avoids
                raise
            with rep.lock:
                rep.failures += 1
            self.counters.inc("router_upstream_failures_total")
            if e.breaker and rep.breaker.record_failure():
                self.counters.inc("router_breaker_opens_total")
            raise
        dt = time.perf_counter() - t0
        with rep.lock:
            rep.inflight -= 1
        rep.breaker.record_success()
        rep.hist.observe(dt)
        self.hists.observe("router/upstream_s", dt, exemplar=trace)
        self.tracer.add(make_segment(
            trace, leg_span, parent_span, "router", "upstream", t0, dt,
            attrs={"replica": rep.name, "attempt": attempt,
                   "hedge": hedge, "status": status}))
        return status, data

    def _hedge_deadline_s(self) -> float | None:
        """Hedge after the observed upstream tail (p-``hedge_quantile``),
        floored at ``hedge_min_ms`` — hedging below the floor would
        double most traffic, not just the tail."""
        if not self.hedge:
            return None
        q = self.hists.quantile("router/upstream_s", self.hedge_quantile)
        if q is None:
            return self.hedge_min_ms / 1e3
        return max(q, self.hedge_min_ms / 1e3)

    def route_predict(self, body: bytes, trace: str,
                      parent_span: str | None = None,
                      forced: bool = False
                      ) -> tuple[int, bytes, str | None]:
        """Forward one /predict; returns (status, body, replica name).
        Exhausted budget / no eligible replica answers 503 here — the
        handler writes it; nothing is ever retried after that write.
        The whole routing decision is one ``route`` trace span; its end
        is where the tail sampler judges the trace."""
        t0 = time.perf_counter()
        route_span = self.tracer.span_id()
        flags = {"retried": False, "hedged": False, "breaker": False}
        tried: set[str] = set()
        last_err = "no eligible replica"
        for attempt in range(1 + self.retry_budget):
            rep = self.pick(exclude=tried)
            if rep is None:
                break
            tried.add(rep.name)
            if rep.breaker.state != BREAKER_CLOSED:
                flags["breaker"] = True
            if attempt:
                flags["retried"] = True
                self.counters.inc("router_retries_total")
                # exponential backoff + jitter: a mass failover must not
                # stampede the survivors in lockstep
                base = min(self.backoff_base_s * (2 ** (attempt - 1)),
                           self.backoff_max_s)
                time.sleep(base * (0.5 + self._rng.random()))
            try:
                status, data, winner = self._attempt_maybe_hedged(
                    rep, body, trace, first=(attempt == 0), tried=tried,
                    route_span=route_span, attempt=attempt, flags=flags,
                    sampled=forced)
            except UpstreamError as e:
                flags["breaker"] = flags["breaker"] or e.breaker
                last_err = str(e)
                continue
            self.counters.inc("router_requests_total")
            dt = time.perf_counter() - t0
            self._observe_live(winner, body, data, status, dt)
            self.hists.observe("router/route_s", dt, exemplar=trace)
            self.tracer.add(make_segment(
                trace, route_span, parent_span, "router", "route", t0,
                dt, attrs={"status": status, "replica": winner.name,
                           "attempts": attempt + 1}))
            self.tracer.finish(trace, dt, error=status >= 400,
                               forced=forced, **flags)
            return status, data, winner.name
        self.counters.inc("router_no_upstream_total")
        dt = time.perf_counter() - t0
        self.hists.observe("router/route_s", dt, exemplar=trace)
        self.tracer.add(make_segment(
            trace, route_span, parent_span, "router", "route", t0, dt,
            attrs={"status": 503, "attempts": len(tried),
                   "error": last_err}))
        self.tracer.finish(trace, dt, error=True, forced=forced, **flags)
        body_out = json.dumps({
            "error": f"no healthy upstream after {len(tried)} attempt(s)"
                     f" — last: {last_err}",
            "trace": trace,
        }).encode()
        return 503, body_out, None

    def _attempt_maybe_hedged(self, rep: Replica, body: bytes, trace: str,
                              *, first: bool, tried: set[str],
                              route_span: str | None = None,
                              attempt: int = 0, flags: dict | None = None,
                              sampled: bool = False
                              ) -> tuple[int, bytes, Replica]:
        """First attempt with optional tail hedging: when the primary
        outlives the hedge deadline, duplicate onto a second replica and
        take whichever answers first (the loser's connection is torn
        down).  Returns (status, body, WINNING replica) — the client's
        X-Upstream must name the replica that actually answered, not
        the stalled primary.  Retries (non-first attempts) never hedge —
        the budget is already paying for them."""
        deadline = self._hedge_deadline_s() if first else None
        if deadline is None:
            status, data = self._attempt(rep, body, trace,
                                         parent_span=route_span,
                                         attempt=attempt, sampled=sampled)
            return status, data, rep

        results: list = []
        done = threading.Event()
        lock = threading.Lock()

        def run(target: Replica, box: dict, hedge_leg: bool) -> None:
            try:
                out = self._attempt(target, body, trace, cancel_box=box,
                                    parent_span=route_span,
                                    attempt=attempt, hedge=hedge_leg,
                                    sampled=sampled)
                with lock:
                    results.append((target, out, None))
            except UpstreamError as e:
                with lock:
                    results.append((target, None, e))
            done.set()

        primary_box: dict = {}
        t_p = threading.Thread(target=run, args=(rep, primary_box, False),
                               name="router-primary", daemon=True)
        t_p.start()
        hedged = False
        hedge_rep = None
        hedge_box: dict = {}
        t_h = None
        if not done.wait(deadline):
            hedge_rep = self.pick(exclude=tried | {rep.name})
            if hedge_rep is not None:
                tried.add(hedge_rep.name)
                hedged = True
                if flags is not None:
                    flags["hedged"] = True
                self.counters.inc("router_hedged_total")
                t_h = threading.Thread(target=run,
                                       args=(hedge_rep, hedge_box, True),
                                       name="router-hedge", daemon=True)
                t_h.start()
        # wait until SOME attempt succeeds or all in flight have failed
        outstanding = 1 + (1 if hedged else 0)
        while True:
            done.wait(self.upstream_timeout_s + 1.0)
            with lock:
                done.clear()
                wins = [r for r in results if r[1] is not None]
                fails = [r for r in results if r[1] is None]
                if wins:
                    winner, out, _ = wins[0]
                    break
                if len(fails) >= outstanding:
                    raise fails[-1][2]
        if hedged:
            if winner is hedge_rep:
                self.counters.inc("router_hedge_wins_total")
                loser_box, loser_t = primary_box, t_p
            else:
                loser_box, loser_t = hedge_box, t_h
            # cancel the loser: mark FIRST (so its _attempt knows the
            # failure is ours, not the replica's — no breaker charge),
            # then close the socket to abandon the duplicate answer; an
            # already-broken socket is the same outcome
            loser_box["cancelled"] = True
            conn = loser_box.get("conn")
            if conn is not None:
                import contextlib

                with contextlib.suppress(OSError):
                    conn.close()
            # give the aborted loser a beat to record its cancelled leg
            # BEFORE the route span ends and the tail sampler judges the
            # trace — a closed socket raises immediately, so this join
            # costs microseconds on the happy path and is best-effort
            # (a straggler leg still lands via the decided-trace cache)
            if loser_t is not None:
                loser_t.join(0.25)
        return out[0], out[1], winner

    # ------------------------------------------------------------- canary

    def start_canary(self, name: str, fraction: float,
                     parity_max: int = 32) -> None:
        """Quarantine ``name``: it leaves live rotation IMMEDIATELY (a
        client must never see an unpromoted canary's answers — the fleet
        calls this BEFORE reloading it), but shadow sampling stays off
        until :meth:`arm_canary` — a sample taken mid-reload would
        compare the canary's OLD engine against itself and wave a bad
        bundle through the parity gate."""
        with self._canary_lock:
            self._canary = {
                "name": name, "fraction": float(fraction),
                "parity_max": int(parity_max), "started": time.time(),
                "armed": False,
                "canary_lat": [], "incumbent_lat": [], "parity": [],
                "shadow_sent": 0, "shadow_errors": 0, "shadow_dropped": 0,
            }
            self._shadow_q.clear()

    def arm_canary(self) -> None:
        """Begin shadow sampling (the canary now serves the NEW bundle);
        buffers reset so nothing from the reload window leaks in."""
        with self._canary_lock:
            c = self._canary
            if c is None:
                return
            c["armed"] = True
            c["canary_lat"].clear()
            c["incumbent_lat"].clear()
            c["parity"].clear()
            c["shadow_sent"] = c["shadow_errors"] = 0
            c["shadow_dropped"] = 0
            self._shadow_q.clear()

    def end_canary(self) -> dict | None:
        with self._canary_lock:
            snap, self._canary = self._canary, None
            self._shadow_q.clear()
        return snap

    def canary_snapshot(self) -> dict | None:
        with self._canary_lock:
            if self._canary is None:
                return None
            c = self._canary
            return {
                "name": c["name"], "fraction": c["fraction"],
                "started": c["started"],
                "canary_lat": list(c["canary_lat"]),
                "incumbent_lat": list(c["incumbent_lat"]),
                "parity": list(c["parity"]),
                "shadow_sent": c["shadow_sent"],
                "shadow_errors": c["shadow_errors"],
                "shadow_dropped": c["shadow_dropped"],
            }

    def _observe_live(self, rep: Replica, body: bytes, data: bytes,
                      status: int, latency_s: float) -> None:
        """Sample live traffic into the rollout comparison while a
        canary is armed: the sampled request is enqueued for the shadow
        worker, which probes canary AND a live incumbent through the
        IDENTICAL path (bounded queue — shadowing must never add latency
        to, or block, the live path)."""
        del rep, latency_s
        with self._canary_lock:
            c = self._canary
            if c is None or not c["armed"] or status != 200:
                return
            if self._rng.random() >= c["fraction"]:
                return
            if len(self._shadow_q) >= self._shadow_q_max:
                c["shadow_dropped"] += 1
                return
            self._shadow_q.append((body, data))
        self._shadow_wake.set()

    def _shadow_probe(self, name: str, body: bytes
                      ) -> tuple[bool, bytes, float]:
        with self._replicas_lock:
            rep = self._replicas.get(name)
        if rep is None:
            return False, b"", 0.0
        t0 = time.perf_counter()
        try:
            status, data = self._upstream_predict(
                rep, body, f"shadow-{next(self._req_seq)}")
            return status == 200, data, time.perf_counter() - t0
        except UpstreamError:
            return False, b"", 0.0

    def _shadow_loop(self) -> None:
        """Paired probes: each sampled request is sent to the canary AND
        to a live incumbent through the SAME code path (fresh
        connection, lone arrival — so a sparse shadow's batching-window
        cost hits both sides equally; comparing shadow probes against
        the live path's coalesced latencies systematically biased
        against the canary).  The parity row compares the canary's
        answer against the LIVE answer the client actually got."""
        while not self._stop.is_set():
            self._shadow_wake.wait(0.2)
            while True:
                with self._canary_lock:
                    c = self._canary
                    if c is None or not self._shadow_q:
                        self._shadow_wake.clear()
                        break
                    body, live_data = self._shadow_q.pop(0)
                    canary_name = c["name"]
                ok, data, dt = self._shadow_probe(canary_name, body)
                inc = self.pick()  # excludes the canary by definition
                inc_ok = inc_dt = None
                if inc is not None:
                    inc_ok, _, inc_dt = self._shadow_probe(inc.name,
                                                           body)
                with self._canary_lock:
                    c = self._canary
                    if c is None or c["name"] != canary_name:
                        continue  # rollout ended while we were in flight
                    c["shadow_sent"] += 1
                    if not ok:
                        c["shadow_errors"] += 1
                        continue
                    if len(c["canary_lat"]) < 10000:
                        c["canary_lat"].append(dt)
                    if inc_ok and len(c["incumbent_lat"]) < 10000:
                        c["incumbent_lat"].append(inc_dt)
                    if len(c["parity"]) < c["parity_max"]:
                        c["parity"].append((
                            body.decode(errors="replace"),
                            _action_of(live_data),
                            _action_of(data)))

    # ------------------------------------------------------------ surfaces

    def health(self) -> dict:
        reps = [r.snapshot() for r in self.replicas()]
        healthy = sum(1 for r in reps
                      if r["breaker"] == BREAKER_CLOSED and r.get("ok"))
        return {
            "ok": not self.draining and healthy > 0,
            "draining": self.draining,
            "role": "router",
            "replicas_total": len(reps),
            "replicas_healthy": healthy,
            "uptime_s": round(time.monotonic() - self._started_mono, 3),
            "pid": os.getpid(),
        }

    def rollout_status(self) -> dict:
        if self._rollout_cb is None:
            return {"supported": False}
        return {"supported": True, **self._rollout_cb("status", None)}

    def scale_status(self) -> dict:
        if self._scale_cb is None:
            return {"supported": False}
        return {"supported": True, **self._scale_cb("status", None)}

    def stats(self) -> dict:
        lat = {}
        h = self.hists.get("router/route_s")
        if h is not None and h.count:
            lat = {"p50": round(h.quantile(0.5) * 1e3, 3),
                   "p99": round(h.quantile(0.99) * 1e3, 3)}
        snap = self.canary_snapshot()
        return {
            "role": "router",
            "replicas": [r.snapshot() for r in self.replicas()],
            "counters": self.counters.snapshot(),
            "route_ms": lat,
            "canary": ({k: v for k, v in snap.items()
                        if k not in ("canary_lat", "incumbent_lat",
                                     "parity")}
                       if snap else None),
            "rollout": self.rollout_status(),
            "scale": self.scale_status(),
            "collector_target": self._collector_target(),
        }

    def _collector_target(self) -> dict:
        host = getattr(self, "host", "127.0.0.1")
        if host in ("0.0.0.0", "::", ""):
            import socket as _socket

            host = _socket.getfqdn() or _socket.gethostname()
        port = getattr(self, "port", 0)
        return {"name": f"router-{host}-{port}",
                "url": f"http://{host}:{port}/metrics"}

    def metrics(self) -> str:
        """Prometheus exposition: flat counters + route/upstream
        histograms through the shared encoder, then per-replica labeled
        gauges (the collector-idiom blocks the fleet dash reads)."""
        extra = {
            "uptime_seconds": round(
                time.monotonic() - self._started_mono, 3),
            "draining": 1.0 if self.draining else 0.0,
        }
        if self.desired_replicas is not None:
            extra["router_desired_replicas"] = float(self.desired_replicas)
        body = render_exposition(
            self.counters.snapshot(), None, up=not self.draining,
            extra_gauges=extra,
            histograms=self.hists.export() or None)
        lines = [body.rstrip("\n")]
        gauges = (
            ("router_replica_up", "1 while the replica answers health "
                                  "polls",
             lambda r: 1.0 if (r.health.get("ok")
                               and not r.health.get("draining")) else 0.0),
            ("router_breaker_state", "0 closed / 1 half-open / 2 open",
             lambda r: float(BREAKER_STATE_CODE[r.breaker.state])),
            ("router_replica_queue_depth", "replica queue depth at last "
                                           "poll",
             lambda r: float(r.health.get("queue_depth") or 0.0)),
            ("router_upstream_p99_s", "observed p99 of this replica's "
                                      "answers through the router",
             lambda r: (r.hist.quantile(0.99)
                        if r.hist.count else float("nan"))),
            ("router_replica_retries_total",
             "failed attempts charged to this replica",
             lambda r: float(r.failures)),
        )
        for name, help_, get in gauges:
            metric = metric_name(name)
            kind = "counter" if name.endswith("_total") else "gauge"
            lines.append(f"# HELP {metric} {help_}")
            lines.append(f"# TYPE {metric} {kind}")
            for rep in self.replicas():
                lines.append(
                    f'{metric}{{replica="{_escape_label(rep.name)}"}} '
                    f"{_fmt_val(get(rep))}")
        return "\n".join(lines) + "\n"


def _fmt_val(v: float) -> str:
    import math

    if math.isnan(v):
        return "NaN"
    return f"{v:g}"


def _split(address: str) -> tuple[str, int]:
    host, _, port = address.partition(":")
    return host, int(port or 80)


def _since_of(path: str) -> int:
    """``since`` cursor of a ``/traces?since=N`` request path (0 when
    absent/garbage — a bad cursor degrades to a full recent-window
    answer, never a 400 on a scrape path)."""
    query = path.partition("?")[2]
    for part in query.split("&"):
        key, _, value = part.partition("=")
        if key == "since":
            try:
                return int(value)
            except ValueError:
                return 0
    return 0


def _action_of(data: bytes):
    try:
        return json.loads(data.decode()).get("action")
    except (ValueError, AttributeError):
        return None


class _RouterHttpd(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # socketserver's listen backlog of 5 overflows when dozens of clients
    # connect at once, and Linux drops the SYN for a resend a second
    # later (the port's change from the JAX package's code)
    request_queue_size = 1024


def _make_handler(router: Router):
    class RouterHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def _reply(self, code: int, body: bytes, ctype: str,
                   extra: dict | None = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            if router.draining:
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, payload: dict,
                        extra: dict | None = None) -> None:
            self._reply(code, json.dumps(payload, default=float).encode(),
                        "application/json", extra)

        def do_GET(self):
            if self.path == "/healthz":
                h = router.health()
                self._reply_json(200 if h["ok"] else 503, h)
            elif self.path == "/stats":
                self._reply_json(200, router.stats())
            elif self.path == "/metrics":
                self._reply(200, router.metrics().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
            elif self.path == "/rollout":
                self._reply_json(200, router.rollout_status())
            elif self.path == "/scale":
                self._reply_json(200, router.scale_status())
            elif self.path.split("?", 1)[0] == "/traces":
                self._reply_json(200, traces_payload(
                    router.tracer, _since_of(self.path),
                    hists=router.hists))
            else:
                self._reply_json(404, {"error": f"no route {self.path!r}"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b""
            if self.path == "/predict":
                self._predict(raw)
                return
            try:
                data = json.loads(raw) if raw else {}
            except ValueError as e:
                self._reply_json(400, {"error": f"bad request body: {e}"})
                return
            if self.path == "/rollout":
                self._rollout(data)
            elif self.path == "/scale":
                self._scale(data)
            else:
                self._reply_json(404, {"error": f"no route {self.path!r}"})

        def _predict(self, raw: bytes) -> None:
            if router.draining:
                self._reply_json(503, {"error": "draining"})
                return
            trace = (self.headers.get("X-Trace-Id")
                     or f"r{next(router._req_seq)}")
            parent_span = self.headers.get(PARENT_SPAN_HEADER) or None
            forced = self.headers.get(SAMPLED_HEADER) == "1"
            router.track_request()
            try:
                status, body, upstream = router.route_predict(
                    raw, trace, parent_span=parent_span, forced=forced)
                extra = {"X-Trace-Id": trace}
                if upstream:
                    extra["X-Upstream"] = upstream
                elif status == 503:
                    extra["Retry-After"] = "1"
                self._reply(status, body, "application/json", extra)
            finally:
                router.untrack_request()

        def _rollout(self, data: dict) -> None:
            if router._rollout_cb is None:
                self._reply_json(409, {
                    "error": "no fleet attached — rollout needs the fleet "
                             "supervisor (serve/fleet.py)"})
                return
            path = data.get("path")
            if not path:
                self._reply_json(400,
                                 {"error": "rollout needs {'path': ...}"})
                return
            res = router._rollout_cb("start", data)
            self._reply_json(200 if res.get("ok") else 409, res)

        def _scale(self, data: dict) -> None:
            if router._scale_cb is None:
                self._reply_json(409, {
                    "error": "no fleet attached — scaling needs the fleet "
                             "supervisor (serve/fleet.py)"})
                return
            n = data.get("replicas")
            if not isinstance(n, int) or isinstance(n, bool) or n < 1:
                self._reply_json(400, {
                    "error": "scale needs {'replicas': <int >= 1>}"})
                return
            res = router._scale_cb("set", data)
            self._reply_json(200 if res.get("ok") else 409, res)

    return RouterHandler


# ------------------------------------------------------------------ CLI

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m estorch_tpu_torch.serve route",
        description="front router for a serving fleet")
    p.add_argument("--fleet", metavar="PATH",
                   help="fleet.json — spawn + supervise replicas AND "
                        "route (serve/fleet.py)")
    p.add_argument("--workdir", default=None, metavar="DIR",
                   help="fleet workdir (port files / replica logs; "
                        "--fleet only)")
    p.add_argument("--replicas", metavar="SPEC",
                   help="route over replicas managed elsewhere: "
                        "name=host:port[,name=host:port...]")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8400,
                   help="0 picks an ephemeral port (see --port-file)")
    p.add_argument("--retry-budget", type=int, default=2,
                   help="extra attempts per request, each on a replica "
                        "not yet tried")
    p.add_argument("--hedge", action="store_true",
                   help="duplicate requests that outlive the observed "
                        "upstream p99 onto a second replica; first "
                        "answer wins")
    p.add_argument("--upstream-timeout", type=float, default=10.0)
    p.add_argument("--poll-interval", type=float, default=0.25)
    p.add_argument("--breaker-failures", type=int, default=3)
    p.add_argument("--breaker-open-s", type=float, default=1.0)
    p.add_argument("--autoscale", action="store_true",
                   help="with --fleet: embed the autoscaler loop "
                        "(obs/agg/autoscale.py) in the supervisor; "
                        "needs fleet.json's autoscale block with "
                        "'store' and 'capacity'")
    p.add_argument("--port-file", default=None, metavar="PATH",
                   help="atomically write {host,port,pid} JSON once bound")
    p.add_argument("--run-dir", default=None, metavar="DIR",
                   help="flush tail-sampled trace segments to "
                        "DIR/traces.jsonl")
    return p


def parse_replica_spec(spec: str) -> list[tuple[str, str]]:
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, addr = part.partition("=")
        if not eq or not addr:
            raise ValueError(
                f"bad replica spec {part!r} (want name=host:port)")
        out.append((name, addr))
    if not out:
        raise ValueError("empty --replicas spec")
    return out


def run_router(args, replicas: list[tuple[str, str]],
               rollout_cb=None) -> Router:
    router = Router(
        replicas, host=args.host, port=args.port,
        retry_budget=args.retry_budget, hedge=args.hedge,
        upstream_timeout_s=args.upstream_timeout,
        poll_interval_s=args.poll_interval,
        breaker_failures=args.breaker_failures,
        breaker_open_s=args.breaker_open_s,
        rollout_cb=rollout_cb,
        run_dir=getattr(args, "run_dir", None),
    )
    router.start_background()
    return router


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if bool(args.fleet) == bool(args.replicas):
        print("route: pass exactly one of --fleet / --replicas",
              file=sys.stderr)
        return 2
    if args.fleet:
        # the fleet supervisor owns the full lifecycle (spawn replicas,
        # run this router in-process, drive rollouts)
        if __package__:
            from .fleet import main as fleet_main
        else:
            fleet = _load("_estorch_torch_serve_fleet", "fleet.py")
            fleet_main = fleet.main
        fleet_argv = ["--fleet", args.fleet, "--host", args.host]
        if args.port != 8400:
            fleet_argv += ["--port", str(args.port)]
        if args.port_file:
            fleet_argv += ["--port-file", args.port_file]
        if args.workdir:
            fleet_argv += ["--workdir", args.workdir]
        if args.autoscale:
            fleet_argv += ["--autoscale"]
        return fleet_main(fleet_argv)
    if args.autoscale:
        # replicas managed elsewhere: nothing to spawn or retire
        print("route: --autoscale needs --fleet (a supervisor that "
              "owns the replica lifecycle)", file=sys.stderr)
        return 2
    try:
        replicas = parse_replica_spec(args.replicas)
    except ValueError as e:
        print(f"route: {e}", file=sys.stderr)
        return 2
    router = run_router(args, replicas)
    stop = threading.Event()

    def _on_signal(signum, frame):
        del frame
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(json.dumps({
        "ready": True, "role": "router",
        "url": f"http://{router.host}:{router.port}",
        "pid": os.getpid(),
        "replicas": [r.name for r in router.replicas()],
    }), flush=True)
    if args.port_file:
        write_port_file(args.port_file, router.host, router.port)
    while not stop.wait(0.5):
        pass
    final = router.shutdown(drain=True)
    print(json.dumps(final, default=float), flush=True)
    return 0 if final["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
