"""Dynamic micro-batcher: coalesce concurrent predict requests into
power-of-two buckets, one batched forward a dispatch.

Counterpart of ``estorch_tpu/serve/batcher.py``, with its code unchanged
(it never touches torch).  The training insight applied to serving
(PAPERS.md 2206.08888): the batched inference that evaluates a population
evaluates concurrent user requests too — one weight-streaming GEMM
amortizes the memory traffic that dominates per-request GEMV.

Mechanics:

* a bounded queue feeds ONE worker thread; the worker takes the oldest
  request, then coalesces more until ``max_batch`` or ``max_wait_ms``
  from the first request, whichever comes first;
* the batch is padded to the next power-of-two bucket, so the forward
  only ever sees the ladder's shapes; ``recompiles`` keeps the JAX
  package's name and here counts each bucket shape's first run, which
  stays ≤ the number of ladder shapes no matter how request sizes mix;
* buckets start at 2 (when ``max_batch`` ≥ 2): batch 1 is a
  matrix-vector product whose final bits may differ from the
  matrix-matrix family, and a response's bits must not depend on how many
  neighbors a request was coalesced with.  cuBLAS (and the CPU's BLAS)
  picks its kernel by batch size, so cross-shape row stability is
  MEASURED per loaded policy, not assumed — buckets whose rows deviate
  from the anchor (largest) bucket are excluded from the ladder at
  construction (:func:`verify_stable_buckets`);
* admission control: a full queue SHEDS (``BatcherSaturated`` →
  HTTP 503 + ``shed_total``) instead of growing without bound — graceful
  backpressure, not OOM;
* optional quantized fast path (``quant_fn``/``quant_bound``): per-bucket
  divergence vs the f32 anchor is MEASURED at construction
  (:func:`measure_quant_divergence`); out-of-bound buckets dispatch the
  exact f32 program instead, and a policy past the bound at the anchor
  is refused;
* ``close(drain=True)`` stops intake, finishes every queued request, and
  joins the worker — the SIGTERM drain path.

``batch_fn`` is any ``(B, *obs_shape) ndarray → (B, ...) ndarray``
callable (``Bundle.batched_predict_fn()`` in production, plain numpy in
the tests).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Sequence

import numpy as np

from ..obs.spans import NULL_TELEMETRY
from ..obs.tracing import make_segment


class BatcherClosed(RuntimeError):
    """submit() after close() — the server is draining."""


class BatcherSaturated(RuntimeError):
    """Queue full: request shed for backpressure (serve as HTTP 503)."""


class BatchError(RuntimeError):
    """The batched predict callable itself failed — a SERVER-side fault
    (device runtime error, poisoned params), distinct from the
    ValueError a caller's malformed observation raises at submit time.
    The server maps this to HTTP 500, never 400."""


class _Pending:
    """One in-flight request: the caller blocks on ``event``.

    Carries its own lifecycle clock marks (submit → taken off the queue
    → dispatched) and an optional caller-assigned trace id, so the
    per-request histograms (``serve/queue_wait_s``,
    ``serve/coalesce_wait_s``, ``serve/request_s``) and the flight
    recorder can tell WHICH request a tail sample belongs to."""

    __slots__ = ("obs", "event", "result", "error", "trace", "span",
                 "t_submit", "t_taken")

    def __init__(self, obs: np.ndarray, trace: str | None = None,
                 span: str | None = None):
        self.obs = obs
        self.event = threading.Event()
        self.result = None
        self.error: BaseException | None = None
        self.trace = trace
        # the server's `request` span id: the parent the batcher's
        # queue_wait/coalesce/compute child segments hang under
        self.span = span
        self.t_submit = time.perf_counter()
        self.t_taken = 0.0


def bucket_sizes(max_batch: int) -> tuple[int, ...]:
    """The power-of-two bucket ladder for ``max_batch``.

    ``max_batch=1`` → ``(1,)`` (the batch-size-1 baseline); otherwise
    buckets start at 2 (matrix-matrix family, see module docstring) and double up
    to ``max_batch`` (which must then itself be a power of two ≥ 2).
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if max_batch == 1:
        return (1,)
    if max_batch & (max_batch - 1):
        raise ValueError(
            f"max_batch must be a power of two (bucket ladder), got "
            f"{max_batch}"
        )
    out = []
    b = 2
    while b <= max_batch:
        out.append(b)
        b *= 2
    return tuple(out)


def verify_stable_buckets(
    batch_fn: Callable[[np.ndarray], np.ndarray],
    obs_shape: Sequence[int],
    buckets: Sequence[int],
    *,
    trials: int = 3,
    seed: int = 0,
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Partition the bucket ladder into (stable, excluded) by MEASUREMENT.

    The serving bit-determinism contract — a request's bits must not
    depend on which bucket/neighbors it was coalesced with — rests on
    the forward producing row-identical results across batch shapes.
    That is NOT guaranteed: BLAS libraries pick their kernel (tile, split
    of the reduction) by batch size, so a row at B=2 can differ from the
    same row at B≥4 in the last ulp.  So the contract is VERIFIED per
    loaded bundle
    instead of assumed: every bucket's rows are checked (random obs,
    random slot arrangements, real pad rows) against the largest bucket
    — the anchor — and buckets that fail are excluded from the ladder
    (their requests pad up to the next stable size).  The anchor itself
    is checked for slot-independence; if even that fails, serving cannot
    be made deterministic under coalescing and this raises.
    """
    buckets = sorted(set(int(b) for b in buckets))
    anchor = buckets[-1]
    rng = np.random.default_rng(seed)
    shape = tuple(int(d) for d in obs_shape)
    obs = rng.standard_normal((anchor,) + shape).astype(np.float32)
    ref = np.asarray(batch_fn(obs), np.float32)
    # anchor slot-independence: the same rows, shuffled, must yield the
    # same per-row bits
    for _ in range(trials):
        perm = rng.permutation(anchor)
        out = np.asarray(batch_fn(obs[perm]), np.float32)
        if out.tobytes() != ref[perm].tobytes():
            raise ValueError(
                f"batched predict is slot-dependent at anchor batch "
                f"{anchor}: the same observation yields different bits in "
                "different slots — deterministic coalesced serving is "
                "impossible with this program"
            )
    stable, excluded = [], []
    for b in buckets[:-1]:
        ok = True
        for _ in range(trials):
            idx = rng.choice(anchor, size=b, replace=False)
            out = np.asarray(batch_fn(obs[idx]), np.float32)
            if out.tobytes() != ref[idx].tobytes():
                ok = False
                break
            # half-full composition: real rows + zero padding
            n = max(1, b // 2)
            idx2 = rng.choice(anchor, size=n, replace=False)
            pad = np.zeros((b,) + shape, np.float32)
            pad[:n] = obs[idx2]
            out2 = np.asarray(batch_fn(pad), np.float32)[:n]
            if out2.tobytes() != ref[idx2].tobytes():
                ok = False
                break
        (stable if ok else excluded).append(b)
    stable.append(anchor)
    return tuple(stable), tuple(excluded)


def measure_quant_divergence(
    quant_fn: Callable[[np.ndarray], np.ndarray],
    batch_fn: Callable[[np.ndarray], np.ndarray],
    obs_shape: Sequence[int],
    buckets: Sequence[int],
    *,
    trials: int = 2,
    seed: int = 0,
) -> dict[int, float]:
    """Per-bucket divergence of the quantized program vs the f32 anchor —
    the :func:`verify_stable_buckets` discipline applied to accuracy.

    The f32 anchor rows are THE reference (they are what the f32 ladder's
    own bit-determinism contract chains to), and the quantized path's
    error is MEASURED against them per bucket: random obs drawn once at
    the anchor shape, each bucket fed row subsets, and the divergence
    reported as  ``max |quant - f32| / max(|f32 anchor rows|)``  — a
    relative-to-output-scale worst-row error.  Measuring per bucket (not
    once) matters because it captures BOTH quantization error and the
    quantized program's cross-shape variation, which (unlike f32's
    occasional 1 ulp) can be orders of magnitude above the rounding
    floor.  Non-finite quantized outputs count as infinite divergence.
    """
    buckets = sorted(set(int(b) for b in buckets))
    anchor = buckets[-1]
    rng = np.random.default_rng(seed)
    shape = tuple(int(d) for d in obs_shape)
    obs = rng.standard_normal((anchor,) + shape).astype(np.float32)
    ref = np.asarray(batch_fn(obs), np.float32)
    scale = float(max(np.max(np.abs(ref)), 1e-6))
    out: dict[int, float] = {}
    for b in buckets:
        worst = 0.0
        for _ in range(max(1, int(trials))):
            idx = rng.choice(anchor, size=b, replace=False)
            got = np.asarray(quant_fn(obs[idx]), np.float32)
            err = np.max(np.abs(got - ref[idx]))
            if not np.isfinite(err):
                worst = float("inf")
                break
            worst = max(worst, float(err) / scale)
        out[b] = worst
    return out


class DynamicBatcher:
    """Bounded-queue request coalescer over a batched predict callable."""

    def __init__(
        self,
        batch_fn: Callable[[np.ndarray], np.ndarray],
        obs_shape: Sequence[int],
        *,
        max_batch: int = 32,
        max_wait_ms: float = 4.0,
        max_queue: int = 256,
        telemetry=None,
        tracer=None,
        verify: bool = True,
        quant_fn: Callable[[np.ndarray], np.ndarray] | None = None,
        quant_bound: float | None = None,
        quant_label: str = "bf16",
    ):
        self.batch_fn = batch_fn
        self.obs_shape = tuple(int(d) for d in obs_shape)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.obs = telemetry if telemetry is not None else NULL_TELEMETRY
        # optional per-process segment tracer (obs/tracing.py): the
        # server assigns its own after construction so batcher child
        # segments land in the SAME sampler deciding the request's fate
        self.tracer = tracer
        ladder = bucket_sizes(self.max_batch)
        if quant_fn is not None:
            if quant_bound is None:
                raise ValueError("quant_fn needs quant_bound (the documented "
                                 "per-bucket divergence bound)")
            if not verify and ladder[-1] >= 2:
                raise ValueError(
                    "quantized serving requires bucket verification — the "
                    "divergence contract chains to the VERIFIED f32 anchor")
        self.buckets_excluded: tuple[int, ...] = ()
        # verification applies to every coalescing ladder (anchor ≥ 2):
        # even a single-bucket ladder of 2 must prove slot-independence —
        # only the batch-1 baseline has nothing to coalesce
        if verify and ladder[-1] >= 2:
            # measured bit-consistency gate (see verify_stable_buckets);
            # the verification forwards also pre-compile every kept bucket,
            # so they count toward `recompiles` exactly once here
            t0 = time.perf_counter()
            stable, excluded = verify_stable_buckets(
                batch_fn, self.obs_shape, ladder)
            # one ledger entry for the verification pass (it IS the
            # ladder's compile cost); recompiles are counted per bucket
            # below, so count_recompiles=0 here
            self.obs.compile_event(
                "bucket_verify", time.perf_counter() - t0,
                count_recompiles=0, buckets=len(ladder), first_call=True)
            self.buckets = stable
            self.buckets_excluded = excluded
            for b in excluded:
                self.obs.counters.inc("buckets_excluded")
                self.obs.event("bucket_excluded", bucket=b)
        else:
            self.buckets = ladder
        self._q: queue.Queue[_Pending | None] = queue.Queue(
            maxsize=int(max_queue))
        self._closing = False
        # serializes the closing-flag check against close(): without it a
        # submit() preempted between check and enqueue could land in the
        # queue after close()'s final sweep and block its caller for the
        # whole request timeout (reachable via hot reload)
        self._close_lock = threading.Lock()
        self._buckets_seen: set[int] = set()
        if verify and ladder[-1] >= 2:
            # verification dispatched every ladder shape once — those ARE
            # the compiles; honest accounting means recompiles == ladder
            # length already, and dispatch never adds more
            for b in ladder:
                self._buckets_seen.add(b)
                self.obs.counters.inc("recompiles")
        # ------------------------------------------------ quantized path
        # opt-in accuracy-bounded fast path (docs/serving.md "Cold start &
        # quantized serving"): per-bucket divergence vs the f32 anchor is
        # MEASURED here; drifting buckets fall back to the f32 program at
        # the same shape (exact answers, evidence in the counters), and a
        # policy whose divergence exceeds the bound AT THE ANCHOR — pure
        # quantization error, no shape effects — is refused outright.
        self.quant_fn = quant_fn
        self.quant_bound = float(quant_bound) if quant_bound is not None \
            else None
        self.quant_label = str(quant_label)
        self.quant_divergence: dict[int, float] = {}
        self.quant_buckets: tuple[int, ...] = ()
        self.quant_buckets_excluded: tuple[int, ...] = ()
        self._quant_buckets: set[int] = set()
        if quant_fn is not None:
            t0 = time.perf_counter()
            div = measure_quant_divergence(
                quant_fn, batch_fn, self.obs_shape, self.buckets)
            self.quant_divergence = div
            anchor = self.buckets[-1]
            if not div[anchor] <= self.quant_bound:
                raise ValueError(
                    f"{self.quant_label} path exceeds the divergence bound "
                    f"at the anchor bucket {anchor}: measured "
                    f"{div[anchor]:.3g} > {self.quant_bound:g} — this "
                    "policy cannot serve quantized within the documented "
                    "accuracy bound; serve it f32"
                )
            keep = [b for b in self.buckets if div[b] <= self.quant_bound]
            dropped = [b for b in self.buckets if b not in keep]
            self.quant_buckets = tuple(keep)
            self.quant_buckets_excluded = tuple(dropped)
            self._quant_buckets = set(keep)
            for b in dropped:
                self.obs.counters.inc("quant_buckets_excluded")
                self.obs.event("quant_bucket_excluded", bucket=b,
                               dtype=self.quant_label,
                               divergence=round(div[b], 6),
                               bound=self.quant_bound)
            # the measurement compiled one quantized program per stable
            # bucket (and, when f32 verification did not run — the (1,)
            # ladder — the f32 anchor program too); count them so the
            # recompile budget stays honest and dispatch never adds more
            for b in self.buckets:
                self.obs.counters.inc("recompiles")
            if not self._buckets_seen:
                for b in self.buckets:
                    self._buckets_seen.add(b)
                    self.obs.counters.inc("recompiles")
            self.obs.compile_event(
                "quant_verify", time.perf_counter() - t0,
                count_recompiles=0, buckets=len(self.buckets),
                dtype=self.quant_label, first_call=True)
        self._worker = threading.Thread(
            target=self._run, name="batcher", daemon=True)
        self._worker.start()

    # ---------------------------------------------------------- intake

    def submit(self, obs, trace: str | None = None,
               span: str | None = None) -> _Pending:
        """Enqueue one observation; returns the pending slot to wait on.
        Sheds (:class:`BatcherSaturated`) when the queue is full.
        ``trace``: caller-assigned request id threaded through the
        recorder's shed/batch events (the server mints one per HTTP
        request); ``span``: the caller's request span id, parent of the
        lifecycle child segments."""
        if self._closing:
            raise BatcherClosed("batcher is draining — no new requests")
        arr = np.asarray(obs, np.float32)
        if arr.shape != self.obs_shape:
            raise ValueError(
                f"observation shape {arr.shape} != bundle obs_shape "
                f"{self.obs_shape}"
            )
        item = _Pending(arr, trace=trace, span=span)
        self.obs.counters.inc("requests_total")
        with self._close_lock:
            if self._closing:
                raise BatcherClosed("batcher is draining — no new requests")
            try:
                self._q.put_nowait(item)
            except queue.Full:
                self.obs.counters.inc("shed_total")
                self.obs.event("request_shed", queue_depth=self._q.qsize(),
                               **({"trace": trace} if trace else {}))
                raise BatcherSaturated(
                    f"request queue full ({self._q.maxsize}) — shedding "
                    "for backpressure"
                ) from None
        return item

    def predict(self, obs, timeout: float | None = 30.0,
                trace: str | None = None,
                span: str | None = None) -> np.ndarray:
        """submit + wait; raises the batch's error or TimeoutError."""
        item = self.submit(obs, trace=trace, span=span)
        if not item.event.wait(timeout):
            raise TimeoutError(f"no batch result within {timeout}s")
        if item.error is not None:
            raise item.error
        return item.result

    # ---------------------------------------------------------- worker

    def _bucket(self, n: int) -> int:
        # walk the STABLE ladder, not powers of two: an excluded interior
        # shape (e.g. B=4 failed verification) must be padded PAST, never
        # dispatched to — n ≤ max_batch = buckets[-1], so this always hits
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _run(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closing:
                    return
                continue
            if item is None:
                self._drain_remaining()
                return
            item.t_taken = time.perf_counter()
            batch = [item]
            deadline = item.t_taken + self.max_wait_s
            stop = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                nxt.t_taken = time.perf_counter()
                batch.append(nxt)
            self._dispatch(batch)
            if stop:
                self._drain_remaining()
                return

    def _drain_remaining(self) -> None:
        """Service requests that slipped in BEHIND the close sentinel: a
        submit() racing close() can pass the ``_closing`` check and land
        after the None in the FIFO — returning at the sentinel would
        leave that caller blocked for its whole request timeout (the hot
        reload path closes a batcher that is still taking traffic)."""
        batch: list[_Pending] = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            item.t_taken = time.perf_counter()
            batch.append(item)
            if len(batch) >= self.max_batch:
                self._dispatch(batch)
                batch = []
        if batch:
            self._dispatch(batch)

    def _dispatch(self, batch: list[_Pending]) -> None:
        obs = self.obs
        n = len(batch)
        bucket = self._bucket(n)
        new_bucket = bucket not in self._buckets_seen
        if new_bucket:
            # one first run per bucket shape — this counter staying
            # ≤ len(self.buckets) under mixed load is the test contract
            self._buckets_seen.add(bucket)
            obs.counters.inc("recompiles")
            obs.event("bucket_compile", bucket=bucket)
        arr = np.zeros((bucket,) + self.obs_shape, np.float32)
        t_dispatch = time.perf_counter()
        for i, item in enumerate(batch):
            arr[i] = item.obs
            # per-request lifecycle distributions (docs/observability.md
            # "Tails & traces"): time on the queue before a worker took
            # it, then time spent waiting for neighbors to coalesce
            if item.t_taken:
                obs.hists.observe("serve/queue_wait_s",
                                  item.t_taken - item.t_submit)
                obs.hists.observe("serve/coalesce_wait_s",
                                  t_dispatch - item.t_taken)
        obs.counters.gauge("queue_depth", self._q.qsize())
        obs.counters.gauge("batch_size_last", n)
        obs.counters.gauge("bucket_last", bucket)
        # thread-safe primitives only (note/counters): during a hot
        # reload the OLD batcher drains while the NEW one serves, and two
        # workers sharing the Telemetry would corrupt its span stack —
        # obs.phase is single-writer machinery.  The heartbeat still
        # shows "predict" as the last phase under load, and the timing
        # lands in counters (which is all the serving summary reads).
        obs.note("predict")
        # quantized fast path for buckets measured within the divergence
        # bound; excluded buckets dispatch the f32 program at the SAME
        # shape — a drifting bucket degrades to exact, never to wrong
        use_quant = self.quant_fn is not None and bucket in self._quant_buckets
        fn = self.quant_fn if use_quant else self.batch_fn
        t_predict = time.perf_counter()
        try:
            out = fn(arr)
            err = None
        except Exception as e:  # noqa: BLE001 — propagated to every waiter
            # typed so the server can answer 500 (server fault), never
            # mistake it for a caller's 400-grade ValueError
            err = BatchError(f"batched predict failed: {e!r}")
            err.__cause__ = e
            obs.counters.inc("batch_errors_total")
            obs.event("batch_error", error=repr(e)[:200])
        dt = time.perf_counter() - t_predict
        if new_bucket and err is None:
            # a lazily-compiled bucket's first call is compile-dominated:
            # its wall seconds are the closest thing to a compile time
            # the dispatch path can observe (count_recompiles=0 — the
            # seen-check above already counted it).  compile_event uses
            # thread-safe primitives only, per the worker-thread contract
            obs.compile_event(f"bucket_{bucket}", dt, count_recompiles=0,
                              bucket=bucket, first_call=True)
        obs.counters.inc("predict_time_s_total", dt)
        if use_quant:
            obs.counters.inc("quant_batches_total")
            obs.counters.inc("quant_requests_total", n)
        # the compute cost every coalesced request shared, as a
        # DISTRIBUTION (n-weighted: per request, not per batch) — a
        # last-write gauge here would keep exactly the sample the tail
        # is not in (esguard R12 gauge-shaped-latency)
        obs.hists.observe("serve/compute_s", dt, n=n)
        obs.counters.inc("batches_total")
        obs.counters.inc("batched_requests_total", n)
        traces = [item.trace for item in batch if item.trace]
        if traces:
            # causal record: which requests rode this dispatch (the
            # ring is bounded, so high-RPS churn evicts, not grows)
            obs.event("batch_dispatch", bucket=bucket, n=n,
                      dur_ms=round(dt * 1e3, 3), traces=traces)
        tracer = self.tracer
        # one wall/mono pair: every segment of this dispatch rebases its
        # perf_counter mark onto the same wall epoch (cross-process
        # assembly aligns on wall `ts`; see obs/tracing.py)
        wall = time.time() if tracer is not None else 0.0
        mono = time.perf_counter()
        if tracer is not None and traces:
            # per-dispatch `batch` span linking the member request ids —
            # bypasses the tail sampler (record): dispatch volume is
            # already bounded by construction, and the span must survive
            # for WHICHEVER member the sampler ends up keeping
            tracer.record(make_segment(
                traces[0], tracer.span_id(), None, tracer.proc, "batch",
                t_dispatch, dt, attrs={"bucket": bucket, "n": n,
                                       "traces": traces},
                ts=wall - (mono - t_dispatch)))
        if err is None:
            # own the results before crossing threads: a batch_fn may
            # return a ZERO-COPY view of a buffer it reuses (a CPU
            # tensor's .numpy() is one), and waiter threads read it
            # milliseconds later — after the worker has dispatched more
            # batches.  The copy is (bucket, action_dim) floats, noise
            # next to the forward pass.
            out = np.array(out, np.float32, copy=True)
        t_done = time.perf_counter()
        for i, item in enumerate(batch):
            if err is None:
                item.result = out[i]
            else:
                item.error = err
            if tracer is not None and item.trace and item.span:
                # lifecycle children under the server's request span,
                # recorded BEFORE event.set() so they are buffered by the
                # time the handler thread applies the tail verdict
                for nm, t0s, ds in (
                        ("queue_wait", item.t_submit,
                         item.t_taken - item.t_submit),
                        ("coalesce", item.t_taken,
                         t_dispatch - item.t_taken),
                        ("compute", t_predict, dt)):
                    tracer.add(make_segment(
                        item.trace, tracer.span_id(), item.span,
                        tracer.proc, nm, t0s, ds,
                        ts=wall - (mono - t0s)))
            # full in-batcher request latency (submit → result ready):
            # the quantity the server's tail SLO is about, and the one
            # the quantile-honesty test reconciles against loadgen;
            # the exemplar ties the bucket back to an assemblable trace
            obs.hists.observe("serve/request_s", t_done - item.t_submit,
                              exemplar=item.trace)
            item.event.set()

    # ----------------------------------------------------------- drain

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop intake; with ``drain`` finish every queued request, then
        join the worker.  Without ``drain`` pending requests get
        :class:`BatcherClosed` set as their error."""
        with self._close_lock:
            if self._closing:
                already = True
            else:
                already = False
                self._closing = True
        if already:
            self._worker.join(timeout)
            return
        if not drain:
            # fail queued waiters fast instead of leaving them blocked
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item.error = BatcherClosed("batcher closed without drain")
                    item.event.set()
        try:
            self._q.put_nowait(None)  # wake + stop the worker
        except queue.Full:
            pass  # worker is draining a full queue; the _closing flag stops it
        self._worker.join(timeout)
        # a submit() that raced close() may have enqueued after the worker
        # exited — fail those waiters loudly instead of leaving them to
        # time out against a dead queue
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item.error = BatcherClosed("batcher closed mid-submit")
                item.event.set()

    # ----------------------------------------------------------- stats

    def stats(self) -> dict:
        c = self.obs.counters
        batches = c.get("batches_total")
        served = c.get("batched_requests_total")
        out = {
            "queue_depth": self._q.qsize(),
            "max_batch": self.max_batch,
            "buckets": list(self.buckets),
            "buckets_excluded": list(self.buckets_excluded),
            "buckets_compiled": sorted(self._buckets_seen),
            "requests_total": int(c.get("requests_total")),
            "batches_total": int(batches),
            "shed_total": int(c.get("shed_total")),
            "recompiles": int(c.get("recompiles")),
            "mean_batch": round(served / batches, 3) if batches else None,
        }
        if self.quant_fn is not None:
            out["quant"] = {
                "dtype": self.quant_label,
                "bound": self.quant_bound,
                "buckets": list(self.quant_buckets),
                "excluded": list(self.quant_buckets_excluded),
                "divergence": {str(b): round(v, 6)
                               for b, v in self.quant_divergence.items()},
                "batches_total": int(c.get("quant_batches_total")),
            }
        hists = self.obs.hists
        lat = {}
        for q, key in ((0.5, "p50"), (0.99, "p99")):
            v = hists.quantile("serve/request_s", q)
            if v is not None:
                lat[key] = round(v * 1e3, 3)
        if lat:
            out["request_ms"] = lat
        return out
