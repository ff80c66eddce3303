"""Elastic multi-host ES: hosts that come and go, folded asynchronously.

Counterpart of ``estorch_tpu/parallel/elastic.py``.  ``multihost.py``
scales by synchronous data parallelism: every rank steps every generation
and the update's sum is a barrier, so one slow rank stalls all and a dead
rank ends the job.  Here hosts are independent processes (each its own
torch, its own CUDA context, no process group) joined to a COORDINATOR
over stdlib TCP.  The coordinator (the process calling
``es.train_elastic(n, fleet=coord)``) hands out whole-population
dispatches; a host evaluates one under the center it was last sent and
answers with the (population,) fitness; the scheduler
(``algo/scheduler.py`` ``ElasticScheduler``) folds arrivals with clipped
importance weights, so a slow host's results fold late with λ < 1, and a
dead host's dispatches are counted lost and replaced.  Per update only
the ``dim``-float center crosses the wire: never the optimizer state, the
noise or the population.

Membership is elastic: a host may join mid-run (it is synced to the
current center and version first; dispatch ids come from the
coordinator's one counter, so no noise coordinate is reused) and may leave
at any time (EOF on its socket is the death signal: a SIGKILLed host takes
its CUDA context with it, and the coordinator sees only the EOF).  Joins
and leaves land on the event log (``membership``) and the hub
(``hosts_joined``/``hosts_lost``, ``elastic_hosts``, per-host
``elastic/h<i>/fold_s``); ``replay=log`` is pure math over the recorded
dispatches and updates, bit-identical to the live run.

Wire protocol, every socket operation timed (esguard R17 in the JAX
package): a frame is a 4-byte big-endian length, a JSON header listing the
arrays as ``[name, dtype, shape]``, then the arrays' raw bytes; message
types ``join``/``sync``/``center``/``dispatch``/``result``/``close``.  The
frames are byte-compatible with the JAX package's, so each package's
hosts and coordinators read the other's frames; arrays cross as NumPy from
an explicit ``.cpu()``.  Chaos (``resilience/chaos.py``): ``straggle_host``
sleeps in the host's loop keyed on (dispatch, host); ``kill_host``
SIGKILLs a host process (a host thread drops its connection, the same
observable death).

Launch recipe (one command a host):

    # the coordinator, in the process that trains
    coord = ElasticCoordinator()                 # coord.address: host, port
    es = es_from_spec(spec)                      # device backend
    es.train_elastic(n, fleet=coord)

    # each host, before or DURING the run (its device is the spec's
    # "device", default cuda; several hosts may share one card):
    python -m estorch_tpu_torch.parallel.elastic --join HOST:PORT \\
        --spec spec.json --host 1

A host process prints one JSON line when it has joined and warmed (one
evaluation before its first dispatch, so the first timed dispatch is not
its setup) and one when it leaves: its dispatches and its kernel launches.
The coordinator, the protocol and the CLI's parsing import no torch.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import socket
import struct
import threading
import time
from typing import Callable

import numpy as np

# the bounded slice of every blocking point (accept, recv, inbox): loops
# wake to notice shutdown and dead peers, never sleep unbounded
POLL_SLICE_S = 0.05
# sends get their own deadline, far above the recv slice: a peer busy
# evaluating may take longer than one slice to drain a center
SEND_DEADLINE_S = 60.0
PROTO_VERSION = 1
_HDR = struct.Struct(">I")
_MAX_HEADER = 1 << 20


def _socket_close(sock) -> None:
    """Close, quiet on teardown."""
    try:
        sock.close()
    except OSError:
        pass


class ElasticError(RuntimeError):
    """A protocol violation or a dead coordinator or host connection."""


class _Killed(Exception):
    """A chaos ``kill_host`` in a host thread (a host process SIGKILLs
    itself instead)."""


# ---------------------------------------------------------------------
# framed messages
# ---------------------------------------------------------------------


def send_msg(sock: socket.socket, header: dict, arrays: dict[str, np.ndarray] | None = None,
             deadline_s: float = SEND_DEADLINE_S) -> None:
    """One frame: length, JSON header (``_arrays``: ``[name, dtype,
    shape]``), raw buffers.  Sent in timed slices; raises ``TimeoutError``
    when the peer accepts nothing for ``deadline_s``."""
    arrays = arrays or {}
    specs = []
    bufs = []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        specs.append([name, str(arr.dtype), list(arr.shape)])
        bufs.append(arr.tobytes())
    head = json.dumps({**header, "_arrays": specs}).encode()
    view = memoryview(_HDR.pack(len(head)) + head + b"".join(bufs))
    deadline = time.monotonic() + deadline_s
    while view:
        if time.monotonic() > deadline:
            raise TimeoutError(f"peer not draining ({len(view)} bytes unsent)")
        try:
            sent = sock.send(view)
        except socket.timeout:
            continue  # no buffer space this slice; the deadline bounds the wait
        view = view[sent:]


def _recv_exact(sock: socket.socket, n: int, deadline: float) -> bytes:
    """Exactly n bytes in timed slices; raises on EOF or the deadline (the
    socket carries its timeout from connect/accept)."""
    chunks = []
    got = 0
    while got < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"peer silent mid-message ({got}/{n} bytes)")
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except socket.timeout:
            continue
        if not chunk:
            raise ElasticError("connection closed mid-message")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket, timeout_s: float
             ) -> tuple[dict, dict[str, np.ndarray]] | None:
    """One frame, or None when nothing arrived within ``timeout_s``.  A
    frame once started must finish within 60 s, so a half-written frame
    cannot wedge the reader."""
    deadline = time.monotonic() + timeout_s
    head_len = None
    while head_len is None:
        if time.monotonic() > deadline:
            return None
        try:
            first = sock.recv(_HDR.size)
        except socket.timeout:
            continue
        if not first:
            raise ElasticError("connection closed")
        if len(first) < _HDR.size:
            first += _recv_exact(sock, _HDR.size - len(first), time.monotonic() + 30.0)
        head_len = _HDR.unpack(first)[0]
    if head_len > _MAX_HEADER:
        raise ElasticError(f"oversized header ({head_len} bytes)")
    msg_deadline = time.monotonic() + 60.0
    header = json.loads(_recv_exact(sock, head_len, msg_deadline).decode())
    arrays: dict[str, np.ndarray] = {}
    for name, dtype, shape in header.pop("_arrays", []):
        n_bytes = int(np.dtype(dtype).itemsize * int(np.prod(shape or [1])))
        buf = _recv_exact(sock, n_bytes, msg_deadline)
        arrays[name] = np.frombuffer(buf, dtype=dtype).reshape(shape)
    return header, arrays


# ---------------------------------------------------------------------
# coordinator
# ---------------------------------------------------------------------


class _HostConn:
    def __init__(self, hid: int, conn: socket.socket):
        self.hid = hid
        self.conn = conn
        self.send_lock = threading.Lock()
        self.inflight: set[int] = set()
        self.alive = True
        self.synced = False  # sync sent: only then routable and broadcast to
        self.last_dispatch_t = 0.0


class ElasticCoordinator:
    """Membership, dispatch routing and the center's broadcast for an
    elastic fleet.  One instance serves the one process that trains; the scheduler
    talks to it through ``algo/scheduler.py``'s ``_HostSource``.

    Threads: one acceptor (a timed ``accept`` loop) and one reader a
    joined host (a timed ``recv`` loop into the inbox).  Every transition
    goes through the inbox, so the scheduler's one ``poll`` sees joins,
    results and leaves in one ordered stream."""

    def __init__(self, listen_host: str = "127.0.0.1", port: int = 0,
                 join_grace_s: float = 120.0):
        self.join_grace_s = float(join_grace_s)
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((listen_host, port))
        self._srv.listen(16)
        self._srv.settimeout(POLL_SLICE_S)
        self.address = self._srv.getsockname()
        self._inbox: queue.Queue = queue.Queue()
        self._hosts: dict[int, _HostConn] = {}
        self._lock = threading.Lock()
        self._next_hid = 0
        self._center: np.ndarray | None = None
        self._sigma: float | None = None
        self._version = 0
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._acceptor, daemon=True)]
        self._threads[0].start()

    # ---------------------------------------------------------- center

    def push_center(self, version: int, center: np.ndarray, sigma: float) -> None:
        """Record an update and send the center to every live host (TCP's
        order means a later dispatch naming ``version`` finds it there)."""
        center = np.asarray(center, np.float32)
        with self._lock:
            self._version = int(version)
            self._center = center.copy()
            self._sigma = float(sigma)
            targets = [h for h in self._hosts.values() if h.alive and h.synced]
        for h in targets:
            self._send(h, {"t": "center", "version": int(version), "sigma": float(sigma)},
                       {"center": center})

    # -------------------------------------------------------- dispatch

    def n_live(self) -> int:
        with self._lock:
            return sum(1 for h in self._hosts.values() if h.alive and h.synced)

    def dispatch(self, dispatch: int, version: int) -> int | None:
        """Route one dispatch to the least-loaded live host (ties to the
        one idle longest, so every host gets work); waits in poll slices
        up to ``join_grace_s`` for a host to exist.  Returns the host id,
        or None when the grace passed with no live host."""
        deadline = time.monotonic() + self.join_grace_s
        while not self._stop.is_set():
            with self._lock:
                live = sorted((len(h.inflight), h.last_dispatch_t, h.hid)
                              for h in self._hosts.values() if h.alive and h.synced)
            if live:
                hid = live[0][2]
                with self._lock:
                    h = self._hosts.get(hid)
                    if h is not None and h.alive:
                        h.inflight.add(int(dispatch))
                        h.last_dispatch_t = time.monotonic()
                ok = h is not None and self._send(
                    h, {"t": "dispatch", "dispatch": int(dispatch), "version": int(version)})
                if ok:
                    return hid
                # the send failed: dead now (the reader's leave owns the
                # accounting); the dispatch was never delivered, try another
                with self._lock:
                    if h is not None:
                        h.inflight.discard(int(dispatch))
                        h.alive = False
                continue
            if time.monotonic() > deadline:
                return None
            time.sleep(POLL_SLICE_S)
        return None

    def poll(self, timeout_s: float) -> tuple[list[dict], list[tuple[int, int]], list[dict]]:
        """Drain the inbox: (results, lost (dispatch, host) pairs,
        membership transitions).  One bounded wait, then what is buffered."""
        results: list[dict] = []
        lost: list[tuple[int, int]] = []
        membership: list[dict] = []
        wait = timeout_s
        while True:
            try:
                kind, hid, payload = self._inbox.get(timeout=wait)
            except queue.Empty:
                break
            wait = 0.0
            if kind == "result":
                h = payload.pop("_conn")
                with self._lock:
                    h.inflight.discard(int(payload["dispatch"]))
                results.append(payload)
            elif kind == "join":
                membership.append({"event": "join", "host": hid})
            elif kind == "leave":
                h = payload  # the dying connection itself
                with self._lock:
                    pending = sorted(h.inflight)
                    h.alive = False
                    h.inflight.clear()
                lost.extend((d, hid) for d in pending)
                membership.append({"event": "leave", "host": hid})
        return results, lost, membership

    # ------------------------------------------------------- internals

    def _send(self, h: _HostConn, header: dict,
              arrays: dict[str, np.ndarray] | None = None) -> bool:
        try:
            with h.send_lock:
                send_msg(h.conn, header, arrays)
            return True
        except OSError:
            # a failed send may have left half a frame: the stream is
            # unusable, so the failure is the connection's death (the
            # reader's EOF posts the leave that does the accounting)
            with h.send_lock:
                h.alive = False
            _socket_close(h.conn)
            return False

    def _acceptor(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(POLL_SLICE_S)
            threading.Thread(target=self._handshake, args=(conn,), daemon=True).start()

    def _handshake(self, conn: socket.socket) -> None:
        try:
            got = None
            deadline = time.monotonic() + 30.0
            while got is None:
                if time.monotonic() > deadline or self._stop.is_set():
                    conn.close()
                    return
                got = recv_msg(conn, POLL_SLICE_S)
            header, _ = got
            if header.get("t") != "join":
                conn.close()
                return
        except (ElasticError, OSError, ValueError):
            conn.close()
            return
        with self._lock:
            want = header.get("host")
            hid = int(want) if want is not None else self._next_hid
            while hid in self._hosts and self._hosts[hid].alive:
                hid += 1  # a duplicate index takes the next free one
            self._next_hid = max(self._next_hid, hid + 1)
            h = _HostConn(hid, conn)
            # the id is reserved now; the host stays unroutable until synced
            self._hosts[hid] = h
            center = self._center
            sync_version = self._version
            sync = {"t": "sync", "host": hid, "proto": PROTO_VERSION, "version": sync_version,
                    "sigma": self._sigma if self._sigma is not None else 0.0}
        # the sync goes before the host is routable: a dispatch never
        # overtakes the center it names (one writer a connection)
        if not self._send(h, sync, {"center": center} if center is not None else None):
            with self._lock:
                if self._hosts.get(hid) is h:
                    del self._hosts[hid]
            _socket_close(conn)
            return
        # catch the host up to any center pushed during the handshake, until
        # the version is stable across a send; `synced` flips under the lock
        # that reads the version, so a concurrent push either included this
        # host or left a bump this loop re-sends
        sent_version = sync_version if center is not None else None
        while True:
            with self._lock:
                cur_version = self._version
                cur_center = self._center
                cur_sigma = self._sigma
                if cur_center is None or sent_version == cur_version:
                    h.synced = True
                    break
            if not self._send(h, {"t": "center", "version": int(cur_version),
                                  "sigma": float(cur_sigma)}, {"center": cur_center}):
                with self._lock:
                    if self._hosts.get(hid) is h:
                        del self._hosts[hid]
                _socket_close(conn)
                return
            sent_version = cur_version
        self._inbox.put(("join", hid, None))
        t = threading.Thread(target=self._reader, args=(h,), daemon=True)
        self._threads.append(t)
        t.start()

    def _reader(self, h: _HostConn) -> None:
        try:
            while not self._stop.is_set():
                try:
                    got = recv_msg(h.conn, POLL_SLICE_S)
                except (ElasticError, OSError, TimeoutError, ValueError):
                    break
                if got is None:
                    continue
                header, arrays = got
                if header.get("t") == "result":
                    # settled on THIS connection: a same-id rejoin may have
                    # replaced the table's entry
                    self._inbox.put(("result", h.hid, {
                        "dispatch": int(header["dispatch"]), "host": h.hid,
                        "fitness": arrays["fitness"], "steps": int(header.get("steps", 0)),
                        "eval_s": float(header.get("eval_s", 0.0)), "_conn": h}))
                elif header.get("t") == "bye":
                    break
        finally:
            # the leave carries the dying connection, so a host that rejoined
            # under the same id keeps its fresh one
            self._inbox.put(("leave", h.hid, h))
            _socket_close(h.conn)

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            hosts = list(self._hosts.values())
        for h in hosts:
            self._send(h, {"t": "close"})
            _socket_close(h.conn)
        _socket_close(self._srv)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------
# host worker
# ---------------------------------------------------------------------


class HostWorker:
    """One elastic host: joins a coordinator, evaluates dispatched
    populations with its own device engine and streams back the
    (population,) fitness.  Its whole world is the (center, σ, version) it
    was last sent and the dispatch ids; the noise comes from the shared
    table by ``(seed, dispatch)``, as on the coordinator.  ``on_ready`` is
    called once the host has joined and warmed."""

    def __init__(self, address: tuple[str, int], es, host_index: int,
                 simulate_kill: bool = False,
                 on_ready: Callable[["HostWorker"], None] | None = None):
        self.address = (str(address[0]), int(address[1]))
        self.es = es
        self.host_index = int(host_index)
        self.simulate_kill = bool(simulate_kill)
        self.on_ready = on_ready
        self._stop = threading.Event()
        self._center: np.ndarray | None = None
        self._sigma: float | None = None
        self._version = -1
        self.dispatches_done = 0
        self.warm_s: float | None = None

    def stop(self) -> None:
        self._stop.set()

    def run(self, connect_timeout_s: float = 30.0, sync_timeout_s: float = 120.0) -> None:
        from ..resilience.chaos import host_fault

        sock = socket.create_connection(self.address, timeout=connect_timeout_s)
        sock.settimeout(POLL_SLICE_S)
        self._sock = sock
        try:
            send_msg(sock, {"t": "join", "host": self.host_index, "proto": PROTO_VERSION})
            deadline = time.monotonic() + sync_timeout_s
            got = None
            while got is None:
                if time.monotonic() > deadline:
                    raise ElasticError("coordinator never answered JOIN")
                got = recv_msg(sock, POLL_SLICE_S)
            header, arrays = got
            if header.get("t") != "sync":
                raise ElasticError(f"expected sync, got {header.get('t')!r}")
            self.host_index = int(header["host"])
            self._version = int(header["version"])
            if "center" in arrays:
                self._center = np.asarray(arrays["center"], np.float32)
                self._sigma = float(header["sigma"])
            self._warm()
            if self.on_ready is not None:
                self.on_ready(self)
            while not self._stop.is_set():
                try:
                    got = recv_msg(sock, POLL_SLICE_S)
                except (ElasticError, OSError):
                    return  # the coordinator is gone: the run is over for us
                if got is None:
                    continue
                header, arrays = got
                t = header.get("t")
                if t == "center":
                    self._center = np.asarray(arrays["center"], np.float32)
                    self._sigma = float(header["sigma"])
                    self._version = int(header["version"])
                elif t == "dispatch":
                    d = int(header["dispatch"])
                    if host_fault(d, self.host_index):
                        self._die()
                    fitness, steps, eval_s = self._evaluate(d)
                    try:
                        send_msg(sock, {"t": "result", "dispatch": d, "steps": int(steps),
                                        "eval_s": float(eval_s)}, {"fitness": fitness})
                    except OSError:
                        return  # the coordinator went away mid-result
                    self.dispatches_done += 1
                elif t == "close":
                    return
        except _Killed:
            return  # a simulated SIGKILL: the socket is closed below
        finally:
            _socket_close(sock)

    def _die(self):
        """``kill_host``: a host process dies for real (SIGKILL closes the
        socket, the coordinator's leave signal); a host thread reproduces
        the observable part, an abrupt close."""
        if self.simulate_kill:
            _socket_close(self._sock)
            raise _Killed()
        os.kill(os.getpid(), signal.SIGKILL)

    def _state_for(self, dispatch: int):
        """The ES state a dispatch is evaluated from: the synced center and
        σ, the dispatch id as the generation (the noise stream's key)."""
        import torch

        es = self.es
        if self._center is None:
            raise ElasticError("dispatch before any center sync")
        center = torch.from_numpy(self._center.copy()).to(es.device)
        sigma = torch.tensor(self._sigma, dtype=torch.float32, device=es.device)
        if es._shard_params:
            # the sharded state is this rank's shards: rebuilt from the
            # synced center each dispatch, as the JAX package rebuilds it
            return es.engine.init_state(center, es.state.seed)._replace(
                sigma=sigma, generation=int(dispatch))
        return es.state._replace(params_flat=center, sigma=sigma, generation=int(dispatch))

    def _evaluate(self, dispatch: int):
        t0 = time.perf_counter()
        es = self.es
        st = self._state_for(dispatch)
        if es._shard_params:
            # the sharded generation as the source: its fitness is kept, the
            # update it computed is the coordinator's job
            _, metrics = es.engine.generation_step(st)
            fitness, steps = metrics["fitness"], metrics["steps"]
        else:
            ev = es.engine.evaluate(st)
            fitness, steps = ev.fitness, ev.steps
        return (fitness.cpu().numpy().astype(np.float32), int(steps.cpu()),
                time.perf_counter() - t0)

    def _warm(self) -> None:
        """One evaluation before the first dispatch (cuBLAS set up, the
        kernels' library loaded), so that dispatch is not the host's setup
        in the coordinator's latency.  Before any center exists, the host's
        own initial center stands in: it is the same one, built from the
        same spec."""
        t0 = time.perf_counter()
        center, sigma = self._center, self._sigma
        if center is None:
            self._center = self.es.state.params_flat.cpu().numpy()
            self._sigma = float(self.es.state.sigma)
        try:
            self._evaluate(0)
        except Exception:  # noqa: BLE001 — warmth is best-effort
            self.es.obs.event("elastic_warm_failed", host=self.host_index)
        finally:
            if center is None:
                self._center, self._sigma = None, None
        self.warm_s = time.perf_counter() - t0


def run_host_thread(address: tuple[str, int], es, host_index: int
                    ) -> tuple[HostWorker, threading.Thread]:
    """A host in a thread of this process (tests, one-machine demos): its
    own ES joined through a real loopback socket; everything but the
    separate interpreter."""
    worker = HostWorker(address, es, host_index, simulate_kill=True)
    t = threading.Thread(target=worker.run, daemon=True, name=f"elastic-host-{host_index}")
    t.start()
    return worker, t


# ---------------------------------------------------------------------
# spec → ES (the host processes' and the coordinator's shared recipe)
# ---------------------------------------------------------------------


def es_from_spec(spec: dict, mesh=None):
    """The ES a spec names: the shared recipe of the coordinator and every
    host (same seed, same table, same noise coordinates).  The JAX
    package's keys (``env``, ``population_size``, ``sigma``,
    ``policy_kwargs``, ``horizon``, ``lr``, ``seed``, ``table_size``,
    ``telemetry``, ``eval_chunk``) mean the same; the port adds
    ``device`` (default ``cuda``; the JAX package's ``cpu_devices`` asks
    for the CPU), ``streamed`` and ``noise_kernel``.  ``shard`` asks for
    the param-sharded engine in table mode (``model_shards`` its mesh's
    model axis), as the JAX package's spec does."""
    from .. import envs as envs_mod
    from ..algo.es import ES
    from ..envs.agent import DeviceAgent
    from ..models.policies import MLPPolicy
    from ..optim import adam

    env = getattr(envs_mod, spec.get("env", "CartPole"))()
    policy_kwargs = dict(spec.get("policy_kwargs")
                         or {"action_dim": env.action_dim, "hidden": (8,), "discrete": True})
    if "hidden" in policy_kwargs:
        policy_kwargs["hidden"] = tuple(policy_kwargs["hidden"])
    device = spec.get("device") or ("cpu" if spec.get("cpu_devices") else None)
    kw = dict(
        policy=MLPPolicy,
        agent=DeviceAgent,
        optimizer=adam,
        population_size=int(spec.get("population_size", 16)),
        sigma=float(spec.get("sigma", 0.1)),
        policy_kwargs=policy_kwargs,
        agent_kwargs={"env": env, "horizon": int(spec.get("horizon", 64))},
        optimizer_kwargs={"learning_rate": float(spec.get("lr", 1e-2))},
        seed=int(spec.get("seed", 7)),
        table_size=int(spec.get("table_size", 1 << 18)),
        telemetry=bool(spec.get("telemetry", True)),
        device=device,
        streamed=bool(spec.get("streamed", False)),
        noise_kernel=bool(spec.get("noise_kernel", False)),
    )
    if spec.get("eval_chunk"):
        kw["eval_chunk"] = int(spec["eval_chunk"])
    if spec.get("shard"):
        kw.update(shard_params=True, noise_mode="table")
        if spec.get("model_shards"):
            kw["model_shards"] = int(spec["model_shards"])
    if mesh is not None:
        kw["mesh"] = mesh
        kw.pop("device")
    return ES(**kw)


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m estorch_tpu_torch.parallel.elastic",
        description="join an elastic ES coordinator as one host")
    p.add_argument("--join", required=True, metavar="HOST:PORT")
    p.add_argument("--spec", required=True,
                   help="JSON file (or inline JSON) naming the ES config; it must match the "
                        "coordinator's (same seed)")
    p.add_argument("--host", type=int, default=None,
                   help="host index (chaos plans key on it); default: coordinator-assigned")
    args = p.parse_args(argv)
    text = args.spec
    if os.path.exists(text):
        with open(text) as f:
            text = f.read()
    spec = json.loads(text)
    t0 = time.perf_counter()
    es = es_from_spec(spec)
    built_s = time.perf_counter() - t0
    host, port = args.join.rsplit(":", 1)
    idx = args.host if args.host is not None else 10_000 + (os.getpid() % 10_000)

    def ready(w: HostWorker) -> None:
        print(json.dumps({"event": "ready", "host": w.host_index, "pid": os.getpid(),
                          "device": str(es.device), "build_s": round(built_s, 4),
                          "warm_s": round(w.warm_s or 0.0, 4)}), flush=True)

    worker = HostWorker((host, int(port)), es, idx, on_ready=ready)
    worker.run()
    from ..ops.noise_kernels import launch_counts

    print(json.dumps({"host": worker.host_index, "dispatches_done": worker.dispatches_done,
                      "launches": dict(launch_counts)}), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
