"""Fleet supervisor: N serving replicas + the front router + canary
rollout.

Counterpart of ``estorch_tpu/serve/fleet.py`` (the port's own copy).
``python -m estorch_tpu_torch.serve route --fleet fleet.json`` spawns N
replica processes from one bundle (each a full ``python -m
estorch_tpu_torch.serve`` server on the card: heartbeat, bundle load,
SIGTERM drain — the child ``serve --supervised`` watches), runs the front router
(serve/router.py) in-process over them, respawns dead replicas with
exponential backoff, escalates wedged ones (alive process, silent
socket) to SIGKILL + respawn, and drives canary rollout:

``POST /rollout {"path": <bundle>}`` on the router →

1. **canary** — ONE replica is quarantined out of live rotation FIRST
   (a client must never see an unpromoted bundle's answers), then
   hot-reloads the new bundle (the atomic ``/reload`` swap; a bundle
   that fails to load aborts here, the fleet never left the incumbent);
2. **shadow** — the router duplicates a configured fraction of live
   traffic off-path as PAIRED probes (canary + a live incumbent
   through the identical path), collecting latency samples and
   (request, live answer, canary answer) parity triples;
3. **gate** — promote ONLY if (a) the canary's ``/predict`` latency
   quantile stays inside the ``obs regress --tail`` learned band vs the
   incumbent samples from the same window, and (b) the bit-parity spot
   check passes: the same observation rows answered through canary and
   incumbent compare EXACTLY (rollouts ship re-exports / serving-config
   changes of the same parameters; a perturbed or corrupted bundle
   fails here — pass ``"check_parity": false`` for an intentional
   policy change);
4. **promote** — the remaining replicas ``/reload`` to the new bundle;
   **abort** — the canary reloads back to the incumbent (or, if even
   that fails, is killed and respawned on the incumbent — the respawn
   path IS the rollback of last resort), and the structured
   ``rollout_aborted`` result carries the tail-band or parity evidence.

Serving chaos is declared like training chaos: ``ESTORCH_CHAOS``
``kill_replica``/``wedge_replica`` events (wall-clock ``at_s``, same
once-semantics ledger — resilience/chaos.py) are fired by the monitor
loop, so a fleet test schedules its SIGKILL instead of ad-hoc
``os.kill``.  ``at_s`` counts from the moment every replica of the
initial spawn first answered (or from :meth:`Fleet.arm_chaos`), where
the JAX package's fleet counts from its start: a replica takes seconds
to import torch and create its CUDA context, so seconds since the start
would land a declared kill in that window, on a replica the router
never met.

Scaling: ``POST /scale {"replicas": N}``
on the router is the fleet's admin surface — the autoscaler daemon
(obs/agg/autoscale.py) actuates here.  Slot ADD is a warm spawn from
the incumbent bundle, gated on ``compiles_at_load == 0`` (no native
library built or loaded during the bundle load, serve/server.py;
recorded per slot).  Slot REMOVE is drain-then-retire:
the router deselects the least-loaded replica FIRST, in-flight answers
complete, THEN the replica gets SIGTERM (its own drain path) — a
retirement costs zero client errors.  ``--autoscale`` embeds the
autoscaler loop in this supervisor (fleet.json ``autoscale`` block:
``store``, ``capacity``, policy knobs).

Where the JAX package's fleet passes ``--cpu-devices`` (XLA's CPU
layout), this one passes ``--device`` from fleet.json's ``serve.device``
(default ``cuda``; ``"cpu"`` serves on the CPU).  A replica that exits 2
while starting (a bad bundle, no card for ``cuda``) refused its
configuration: the slot is marked ``failed`` and never respawned (no
crash loop, and never a fallback to the CPU), and ``main`` exits 2.

Stdlib-only, torch-free, file-runnable (``python
estorch_tpu_torch/serve/fleet.py``): replicas are subprocesses that
import torch and hold a CUDA context each; the supervisor that must
outlive them never does.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time

if __package__:
    from ..obs.export.regress import compare_tail
    from ..resilience import chaos as _chaos
    from .router import Router, write_port_file
else:  # file-run (wedged-CUDA host): load siblings without any package init
    import importlib.util

    def _load(name: str, *rel: str):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            *rel)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    _regress = _load("_estorch_torch_obs_regress", os.pardir, "obs", "export",
                     "regress.py")
    _chaos = _load("_estorch_torch_resilience_chaos", os.pardir, "resilience",
                   "chaos.py")
    _router_mod = _load("_estorch_torch_serve_router", "router.py")
    compare_tail = _regress.compare_tail
    Router = _router_mod.Router
    write_port_file = _router_mod.write_port_file

FLEET_SCHEMA = 1
# the supervisor's pid, in each replica's environment (serve/server.py)
SUPERVISOR_ENV = "ESTORCH_FLEET_SUPERVISOR"
START_TIMEOUT_S = 180.0
# scale-down: bound on waiting for router-side in-flight to a retiring
# replica to reach zero, and on the SIGTERMed replica's own drain
# (server.py DRAIN_GRACE_S=15 + margin)
RETIRE_INFLIGHT_WAIT_S = 20.0
RETIRE_REAP_S = 25.0

ROLLOUT_DEFAULTS = {
    "shadow_fraction": 0.5,
    "min_shadow": 24,
    "parity_samples": 8,
    "window_s": 30.0,
    "tail_quantile": 0.99,
    "min_band_pct": 5.0,
    "check_parity": True,
}


class FleetError(RuntimeError):
    """Bad fleet.json or an unrecoverable supervision failure."""


def validate_fleet_config(obj) -> list[str]:
    """Structural problems of a parsed fleet file ([] when clean)."""
    if not isinstance(obj, dict) or obj.get("schema") != FLEET_SCHEMA:
        return [f"fleet file must be an object with schema={FLEET_SCHEMA}"]
    problems = []
    if not obj.get("bundle") or not isinstance(obj["bundle"], str):
        problems.append("bundle: required (path to an exported bundle)")
    n = obj.get("replicas")
    if not isinstance(n, int) or isinstance(n, bool) or n < 1:
        problems.append("replicas: required, integer >= 1")
    for section in ("serve", "router", "respawn", "rollout", "autoscale"):
        if section in obj and not isinstance(obj[section], dict):
            problems.append(f"{section}: must be an object")
    sv = obj.get("serve")
    if isinstance(sv, dict):
        if "cpu_devices" in sv:
            problems.append("serve.cpu_devices: not a key of this fleet "
                            "(it pins XLA's CPU layout); set serve.device "
                            "to 'cuda' (the default) or 'cpu'")
        if "no_warm" in sv:
            problems.append("serve.no_warm: not a key of this fleet "
                            "(a bundle load builds nothing to skip)")
        if "device" in sv and (not isinstance(sv["device"], str)
                               or not sv["device"]):
            problems.append("serve.device: must be a device name "
                            "('cuda' or 'cpu')")
    az = obj.get("autoscale")
    if isinstance(az, dict):
        mn, mx = az.get("min_replicas", 1), az.get("max_replicas", 64)
        for key, v in (("min_replicas", mn), ("max_replicas", mx)):
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                problems.append(
                    f"autoscale.{key}: must be an integer >= 1")
        if (isinstance(mn, int) and isinstance(mx, int)
                and not isinstance(mn, bool) and not isinstance(mx, bool)
                and mn > mx):
            problems.append(
                "autoscale.min_replicas: must be <= max_replicas")
    ro = obj.get("rollout") or {}
    frac = ro.get("shadow_fraction",
                  ROLLOUT_DEFAULTS["shadow_fraction"])
    if not isinstance(frac, (int, float)) or not 0.0 < float(frac) <= 1.0:
        problems.append("rollout.shadow_fraction: must be in (0, 1]")
    return problems


def load_fleet_config(path: str) -> dict:
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        raise FleetError(f"{path}: unreadable fleet file: {e}") from e
    problems = validate_fleet_config(obj)
    if problems:
        raise FleetError(f"{path}: " + "; ".join(problems))
    base = os.path.dirname(os.path.abspath(path))
    if not os.path.isabs(obj["bundle"]):
        obj["bundle"] = os.path.join(base, obj["bundle"])
    az = obj.get("autoscale")
    if isinstance(az, dict):
        for key in ("store", "capacity"):
            if isinstance(az.get(key), str) and not os.path.isabs(az[key]):
                az[key] = os.path.join(base, az[key])
    return obj


class _Slot:
    """One replica slot: the process currently (or about to be) filling
    it, plus its respawn bookkeeping.  Names are stable (``r<i>``) so
    breaker state and traces survive a respawn."""

    __slots__ = ("index", "name", "proc", "port_file", "log_path",
                 "address", "state", "started_at", "restarts",
                 "next_spawn_at", "down_since", "wedged", "cold_start")

    def __init__(self, index: int, workdir: str):
        self.index = index
        self.name = f"r{index}"
        self.proc: subprocess.Popen | None = None
        self.port_file = os.path.join(workdir, f"{self.name}_port.json")
        self.log_path = os.path.join(workdir, f"{self.name}.log")
        self.address: str | None = None
        self.state = "down"  # down | starting | up | retiring | failed
        self.started_at = 0.0
        self.restarts = 0
        self.next_spawn_at = 0.0
        self.down_since: float | None = None
        self.wedged = False
        # last recorded /stats cold_start facts (warmth proof for the
        # INITIAL spawn and every scale-up: compiles_at_load == 0)
        self.cold_start: dict | None = None


class Fleet:
    """Supervisor-of-supervisors: replica processes + in-process router
    + the rollout state machine."""

    def __init__(self, config: dict, workdir: str, *,
                 host: str = "127.0.0.1", port: int = 0,
                 backoff_s: float = 0.5, backoff_max_s: float = 10.0,
                 start_timeout_s: float = START_TIMEOUT_S):
        self.config = dict(config)
        self.workdir = os.path.abspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.bundle = os.path.abspath(config["bundle"])
        respawn = config.get("respawn") or {}
        self.backoff_s = float(respawn.get("backoff_s", backoff_s))
        self.backoff_max_s = float(respawn.get("backoff_max_s",
                                               backoff_max_s))
        self.max_restarts = int(respawn.get("max_restarts", 20))
        self.wedge_kill_s = float(respawn.get("wedge_kill_s", 5.0))
        self.start_timeout_s = float(respawn.get("start_timeout_s",
                                                 start_timeout_s))
        self.rollout_cfg = {**ROLLOUT_DEFAULTS,
                            **(config.get("rollout") or {})}
        self.autoscale_cfg = (dict(config["autoscale"])
                              if isinstance(config.get("autoscale"), dict)
                              else None)
        rc = config.get("router") or {}
        self.router = Router(
            [], host=host, port=port,
            retry_budget=int(rc.get("retry_budget", 2)),
            hedge=bool(rc.get("hedge", False)),
            hedge_min_ms=float(rc.get("hedge_min_ms", 25.0)),
            upstream_timeout_s=float(rc.get("upstream_timeout_s", 10.0)),
            poll_interval_s=float(rc.get("poll_interval_s", 0.25)),
            poll_timeout_s=float(rc.get("poll_timeout_s", 1.0)),
            breaker_failures=int(rc.get("breaker_failures", 3)),
            breaker_open_s=float(rc.get("breaker_open_s", 1.0)),
            rollout_cb=self._rollout_cb,
            scale_cb=self._scale_cb,
            # per-process trace dir (obs/tracing.py): the router's
            # sampled segments land beside the replicas' so `obs trace
            # --fleet <workdir>` assembles the whole hop chain
            run_dir=os.path.join(self.workdir, "router"),
        )
        self.slots = [_Slot(i, self.workdir)
                      for i in range(int(config["replicas"]))]
        # scaling state: slot indices only grow (a retired r2 never
        # comes back — a fresh slot gets a fresh name, so breaker and
        # log history never alias across lives)
        self._next_index = int(config["replicas"])
        self.desired = int(config["replicas"])
        self.router.desired_replicas = self.desired
        self._scale_lock = threading.Lock()  # one scale op in flight
        self._last_scale: dict | None = None
        # slot state machine fields (state/proc/timers) are written by
        # BOTH the monitor thread (_tick) and the rollout thread
        # (rollback kills) — every mutation holds this lock; process
        # kill/wait stays outside it so a slow reap can't wedge a tick
        self._slots_lock = threading.Lock()
        self.events: list[dict] = []
        self._events_lock = threading.Lock()
        self._stop = threading.Event()
        self._monitor_thread: threading.Thread | None = None
        self._armed_mono: float | None = None
        # rollout state machine (one in flight; guarded by _ro_lock)
        self._ro_lock = threading.Lock()
        self._ro_state = "idle"
        self._ro_thread: threading.Thread | None = None
        self._ro_result: dict | None = None
        # set when a replica refused its configuration at start (exit 2)
        self.start_error: str | None = None

    # -------------------------------------------------------------- events

    def _event(self, kind: str, **extra) -> None:
        with self._events_lock:
            self.events.append({"ts": time.time(), "event": kind, **extra})
            del self.events[:-500]

    def _slots_snapshot(self) -> list[_Slot]:
        """Point-in-time copy: the slot LIST is mutated by the scale
        thread (add/retire), so every iterator takes a snapshot."""
        with self._slots_lock:
            return list(self.slots)

    # -------------------------------------------------------------- spawn

    def _serve_argv(self, slot: _Slot) -> list[str]:
        sv = self.config.get("serve") or {}
        argv = [sys.executable, "-m", "estorch_tpu_torch.serve",
                "--bundle", self.bundle, "--port", "0",
                "--port-file", slot.port_file,
                # per-slot trace dir: slot names are stable across
                # respawns, so a replica's segments survive its restarts
                "--run-dir", os.path.join(self.workdir, slot.name),
                "--beat-interval", "0.5",
                "--device", str(sv.get("device", "cuda"))]
        for flag, key in (("--max-batch", "max_batch"),
                          ("--max-wait-ms", "max_wait_ms"),
                          ("--max-queue", "max_queue"),
                          ("--dtype", "dtype")):
            if key in sv:
                argv += [flag, str(sv[key])]
        argv += [str(a) for a in sv.get("extra_args", [])]
        return argv

    def _spawn(self, slot: _Slot) -> None:
        import contextlib

        with contextlib.suppress(OSError):  # stale file from a prior life
            os.unlink(slot.port_file)
        env = {**os.environ, "ESTORCH_OBS_HEARTBEAT": os.path.join(
            self.workdir, f"{slot.name}_heartbeat.json"),
            # the replica drains and exits if this process dies
            # (serve/server.py): a killed supervisor must not leave
            # replicas holding their CUDA contexts and ports
            SUPERVISOR_ENV: str(os.getpid())}
        # the child runs `-m estorch_tpu_torch.serve`: make the package root
        # this file lives under importable regardless of the fleet's cwd
        # (a file-run fleet on an uninstalled checkout must still spawn)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        log = open(slot.log_path, "a")
        try:
            proc = subprocess.Popen(
                self._serve_argv(slot), stdout=log, stderr=log, env=env)
        finally:
            log.close()
        with self._slots_lock:
            slot.proc = proc
            slot.state = "starting"
            slot.started_at = time.monotonic()
            slot.down_since = None
            slot.wedged = False
        self._event("replica_spawned", replica=slot.name,
                    pid=proc.pid)

    def _check_starting(self, slot: _Slot) -> None:
        if os.path.exists(slot.port_file):
            try:
                with open(slot.port_file) as f:
                    pf = json.load(f)
            except (OSError, ValueError):
                return  # racing the atomic rename; next tick
            with self._slots_lock:
                slot.address = f"{pf['host']}:{pf['port']}"
                slot.state = "up"
            self.router.update_replica(slot.name, slot.address)
            self._event("replica_up", replica=slot.name,
                        address=slot.address)
            return
        if time.monotonic() - slot.started_at > self.start_timeout_s:
            self._event("replica_start_timeout", replica=slot.name)
            self._kill_slot(slot, reason="start_timeout")
            self._schedule_respawn(slot)

    def _kill_slot(self, slot: _Slot, reason: str) -> None:
        proc = slot.proc
        if proc is not None and proc.poll() is None:
            proc.kill()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._event("replica_unreapable", replica=slot.name)
        with self._slots_lock:
            slot.state = "down"
            slot.down_since = None
        self._event("replica_killed", replica=slot.name, reason=reason)

    def _refuse_start(self, slot: _Slot) -> None:
        """A replica exited 2 while starting: it refused its configuration
        (a bad bundle, no card for ``device: cuda``).  A respawn would
        refuse again, so the slot is ``failed`` for good and the fleet's
        start fails (``start_error``; ``main`` exits 2)."""
        last = ""
        try:
            with open(slot.log_path, errors="replace") as f:
                lines = [ln.strip() for ln in f if ln.strip()]
            last = lines[-1][:300] if lines else ""
        except OSError as e:
            last = f"its log {slot.log_path} is unreadable: {e}"
        msg = f"replica {slot.name} refused to start (exit 2)" + (
            f": {last}" if last else "")
        with self._slots_lock:
            slot.state = "failed"
            if self.start_error is None:
                self.start_error = msg
        self.router.counters.inc("fleet_start_refusals_total")
        self._event("replica_start_refused", replica=slot.name,
                    error=last)

    def _schedule_respawn(self, slot: _Slot) -> None:
        self.router.counters.inc("fleet_respawns_total")
        with self._slots_lock:
            slot.restarts += 1
            backoff = min(self.backoff_s * (2 ** max(0, slot.restarts - 1)),
                          self.backoff_max_s)
            slot.next_spawn_at = time.monotonic() + backoff
            slot.state = "down"

    # ------------------------------------------------------------- monitor

    def _tick(self) -> None:
        now = time.monotonic()
        slots = self._slots_snapshot()
        # the serve-chaos clock starts once the initial spawn is all up
        # (unless arm_chaos started it first)
        if self._armed_mono is None and slots and all(
                s.state == "up" for s in slots):
            self._armed_mono = now
        # declared serving chaos (ESTORCH_CHAOS): same plan + ledger as
        # training faults, keyed on seconds since the fleet armed
        due = ([] if self._armed_mono is None
               else _chaos.serve_faults(now - self._armed_mono))
        for ev in due:
            idx = int(ev.get("replica", 0))
            if not 0 <= idx < len(slots):
                continue
            slot = slots[idx]
            proc = slot.proc
            if proc is None or proc.poll() is not None:
                continue
            if ev["kind"] == "kill_replica":
                os.kill(proc.pid, signal.SIGKILL)
                self._event("chaos_kill_replica", replica=slot.name,
                            pid=proc.pid)
            else:  # wedge_replica: alive process, silent socket
                os.kill(proc.pid, signal.SIGSTOP)
                self._event("chaos_wedge_replica", replica=slot.name,
                            pid=proc.pid)
        router_health = {r.name: r.health
                        for r in self.router.replicas()}
        for slot in slots:
            if slot.state in ("retiring", "failed"):
                continue  # the scale thread owns a retiring slot's reap
            if slot.state == "starting":
                if slot.proc is not None and slot.proc.poll() is not None:
                    self._event("replica_died", replica=slot.name,
                                exitcode=slot.proc.returncode,
                                during="startup")
                    if slot.proc.returncode == 2:
                        self._refuse_start(slot)
                    else:
                        self._schedule_respawn(slot)
                else:
                    self._check_starting(slot)
                continue
            if slot.state == "up":
                if slot.proc is not None and slot.proc.poll() is not None:
                    self._event("replica_died", replica=slot.name,
                                exitcode=slot.proc.returncode)
                    self._schedule_respawn(slot)
                    continue
                # wedge escalation: process alive, router polls failing
                h = router_health.get(slot.name) or {}
                down = h.get("polled") and not h.get("ok")
                if down:
                    if slot.down_since is None:
                        with self._slots_lock:
                            slot.down_since = now
                    elif now - slot.down_since > self.wedge_kill_s:
                        self.router.counters.inc(
                            "fleet_wedge_kills_total")
                        self._kill_slot(slot, reason="wedged")
                        self._schedule_respawn(slot)
                else:
                    with self._slots_lock:
                        slot.down_since = None
                continue
            # down: respawn when the backoff expires (bounded)
            if slot.restarts > self.max_restarts:
                continue
            if now >= slot.next_spawn_at:
                self._spawn(slot)

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — the monitor IS the
                # supervisor: dying silently would orphan every replica,
                # so a tick bug is recorded and the loop keeps watching
                self.router.counters.inc("fleet_monitor_errors_total")
                self._event("monitor_error", error=repr(e)[:300])
            self._stop.wait(0.2)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._armed_mono = None  # armed when the initial spawn is all up
        for slot in self.slots:
            self._spawn(slot)
        self.router.start_background()
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, name="fleet-monitor", daemon=True)
        self._monitor_thread.start()

    def arm_chaos(self) -> None:
        """Re-zero the serve-chaos clock: ``at_s`` offsets count from
        this call instead of from the initial spawn's readiness."""
        self._armed_mono = time.monotonic()

    def wait_ready(self, timeout_s: float = START_TIMEOUT_S) -> bool:
        """Block until every slot is up (True) or the timeout passes, or
        a replica refused to start (False at once, ``start_error``).
        On readiness, each slot's ``/stats`` cold-start facts are
        recorded (``slot.cold_start``): the INITIAL spawn gets the same
        warmth proof as respawns — ``compiles_at_load == 0``."""
        deadline = time.monotonic() + float(timeout_s)
        ready = False
        while time.monotonic() < deadline:
            if self.start_error is not None:
                return False
            if all(s.state == "up" for s in self._slots_snapshot()):
                ready = True
                break
            if self._stop.wait(0.1):
                return False
        ready = ready or all(s.state == "up"
                             for s in self._slots_snapshot())
        if ready:
            for slot in self._slots_snapshot():
                if slot.cold_start is None:
                    self._record_cold_start(slot)
        return ready

    def _record_cold_start(self, slot: _Slot) -> dict | None:
        """Pin the replica's ``/stats`` ``cold_start`` block on its slot
        (best-effort: a momentarily-slow replica is still up)."""
        addr = slot.address
        if addr is None:
            return None
        host, _, port = addr.partition(":")
        try:
            conn = http.client.HTTPConnection(host, int(port),
                                              timeout=10.0)
        except ValueError:
            return None
        try:
            conn.request("GET", "/stats")
            stats = json.loads(conn.getresponse().read().decode())
            cold = stats.get("cold_start")
        except (OSError, ValueError, http.client.HTTPException):
            return None
        finally:
            conn.close()
        if not isinstance(cold, dict):
            return None
        with self._slots_lock:
            slot.cold_start = cold
        return cold

    def shutdown(self) -> dict:
        self._stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=10)
        final = self.router.shutdown(drain=True)
        slots = self._slots_snapshot()
        for slot in slots:
            proc = slot.proc
            if proc is not None and proc.poll() is None:
                # SIGCONT first: a chaos-SIGSTOPped replica cannot drain
                try:
                    os.kill(proc.pid, signal.SIGCONT)
                except OSError:
                    pass
                proc.terminate()
        deadline = time.monotonic() + 30.0
        for slot in slots:
            proc = slot.proc
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(0.1,
                                      deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    self._event("replica_unreapable", replica=slot.name)
        return final

    def status(self) -> dict:
        with self._ro_lock:
            ro = {"state": self._ro_state, "last": self._ro_result}
        snap = self._slots_snapshot()
        return {
            "bundle": self.bundle,
            "replicas": [{
                "name": s.name, "state": s.state, "address": s.address,
                "restarts": s.restarts,
                "pid": s.proc.pid if s.proc else None,
                "cold_start": s.cold_start,
            } for s in snap],
            "scale": {"desired": self.desired,
                      "actual": sum(1 for s in snap
                                    if s.state == "up")},
            "rollout": ro,
            "events": self.events[-50:],
        }

    # ------------------------------------------------------------- scaling

    def scale_bounds(self) -> tuple[int, int]:
        az = self.autoscale_cfg or {}
        return (int(az.get("min_replicas", 1)),
                int(az.get("max_replicas", 64)))

    def _bundle_identity(self) -> dict:
        """The incumbent bundle's identity facts (MANIFEST.json, read
        torch-free) — what the autoscaler compares its capacity model
        against before touching the fleet."""
        out = {"bundle": self.bundle, "bundle_sha": None,
               "bundle_version": None, "platform": None}
        try:
            with open(os.path.join(self.bundle, "MANIFEST.json")) as f:
                man = json.load(f)
        except (OSError, ValueError):
            return out
        out["bundle_version"] = man.get("version")
        out["bundle_sha"] = (man.get("sha256") or {}).get("arrays.npz")
        out["platform"] = (man.get("warm") or {}).get("platform")
        return out

    def scale_status(self) -> dict:
        snap = self._slots_snapshot()
        lo, hi = self.scale_bounds()
        return {
            "autoscale": bool(self.autoscale_cfg),
            "desired": self.desired,
            "actual": sum(1 for s in snap if s.state == "up"),
            "slots": [{"name": s.name, "state": s.state} for s in snap],
            "min": lo, "max": hi,
            "in_progress": self._scale_lock.locked(),
            "last": self._last_scale,
            **self._bundle_identity(),
        }

    def _scale_cb(self, op: str, data: dict | None) -> dict:
        """The router's /scale delegate: validate, then actuate on a
        dedicated thread — the admin POST answers immediately (the
        autoscaler's decision log records ACCEPTANCE; convergence is
        observable via GET /scale and the store's gauges)."""
        if op == "status":
            return self.scale_status()
        try:
            n = int((data or {})["replicas"])
        except (KeyError, TypeError, ValueError):
            return {"ok": False,
                    "error": "scale needs {'replicas': <int >= 1>}"}
        if self._scale_lock.locked():
            return {"ok": False, "error": "scale already in progress",
                    "desired": self.desired}
        lo, hi = self.scale_bounds()
        clamped = min(max(n, lo), hi)
        cur = len(self._slots_snapshot())
        if clamped == cur and clamped == self.desired:
            return {"ok": True, "noop": True, "desired": clamped,
                    "from": cur}
        reason = str((data or {}).get("reason") or "api")
        t = threading.Thread(target=self.scale_to, args=(clamped,),
                             kwargs={"reason": reason},
                             name="fleet-scale", daemon=True)
        t.start()
        return {"ok": True, "accepted": True, "desired": clamped,
                "from": cur, "clamped": clamped != n}

    def scale_to(self, replicas: int, *, reason: str = "api") -> dict:
        """Converge the fleet to ``replicas`` slots (clamped to the
        autoscale bounds).  Synchronous: returns once added slots are up
        (with their warmth proof) and removed slots are drained, dead
        and forgotten."""
        lo, hi = self.scale_bounds()
        n = min(max(int(replicas), lo), hi)
        t0 = time.monotonic()
        with self._scale_lock:
            with self._ro_lock:
                ro_busy = self._ro_state != "idle"
            if ro_busy:
                # a rollout owns replica membership semantics (canary
                # quarantine); scaling under it could retire the canary
                return {"ok": False, "error": "rollout in progress"}
            cur = len(self._slots_snapshot())
            self.desired = n
            self.router.desired_replicas = n
            result: dict = {"ok": True, "desired": n, "from": cur,
                            "requested": int(replicas), "reason": reason,
                            "added": [], "retired": [],
                            "ts": time.time()}
            if n > cur:
                new_slots = []
                with self._slots_lock:
                    for _ in range(n - cur):
                        slot = _Slot(self._next_index, self.workdir)
                        self._next_index += 1
                        self.slots.append(slot)
                        new_slots.append(slot)
                for slot in new_slots:
                    self._event("scale_up", replica=slot.name,
                                reason=reason)
                    self._spawn(slot)
                # warm gate: every added slot must report ZERO native
                # libraries built or loaded during its bundle load
                # (compiles_at_load, serve/server.py) — scale-up capacity
                # that builds on arrival is late
                deadline = time.monotonic() + self.start_timeout_s
                for slot in new_slots:
                    while (slot.state not in ("up", "failed")
                           and time.monotonic() < deadline):
                        if self._stop.wait(0.1):
                            break
                    cold = (self._record_cold_start(slot)
                            if slot.state == "up" else None)
                    compiles = (cold or {}).get("compiles_at_load")
                    result["added"].append({
                        "replica": slot.name, "state": slot.state,
                        "compiles_at_load": compiles})
                    if compiles == 0:
                        self._event("scale_up_warm", replica=slot.name)
                    else:
                        self.router.counters.inc(
                            "fleet_cold_scale_ups_total")
                        self._event("scale_up_cold", replica=slot.name,
                                    compiles_at_load=compiles)
            elif n < cur:
                for _ in range(cur - n):
                    res = self._retire_one(reason)
                    result["retired"].append(res)
                    if not res.get("ok"):
                        result["ok"] = False
                        break
            result["duration_s"] = round(time.monotonic() - t0, 3)
            self._last_scale = result
            self._event("scale_done", desired=n,
                        ok=result["ok"],
                        added=[a["replica"] for a in result["added"]],
                        retired=[r.get("replica")
                                 for r in result["retired"]])
            return result

    def _retire_one(self, reason: str) -> dict:
        """Drain-then-retire the least-loaded up replica: deselect in
        the router FIRST (no new request can reach it), wait for
        router-side in-flight to hit zero, SIGTERM (the replica's own
        drain answers its internal queue and exits 0), reap, forget."""
        import contextlib

        up = [s for s in self._slots_snapshot() if s.state == "up"]
        if len(up) <= 1:
            return {"ok": False, "error": "nothing retirable "
                                          "(<= 1 replica up)"}
        reps = {r.name: r for r in self.router.replicas()}

        def load_of(slot: _Slot) -> float:
            rep = reps.get(slot.name)
            if rep is None:
                return 0.0
            q = rep.health.get("queue_depth")
            return (0.0 if q is None else float(q)) + rep.inflight

        slot = min(up, key=load_of)
        with self._slots_lock:
            slot.state = "retiring"
        self.router.retire_replica(slot.name)
        self._event("replica_retiring", replica=slot.name, reason=reason)
        rep = reps.get(slot.name)
        drained = True
        deadline = time.monotonic() + RETIRE_INFLIGHT_WAIT_S
        while rep is not None and rep.inflight > 0:
            if time.monotonic() > deadline or self._stop.wait(0.05):
                drained = False
                break
        proc = slot.proc
        exitcode = None
        if proc is not None and proc.poll() is None:
            with contextlib.suppress(OSError):
                os.kill(proc.pid, signal.SIGCONT)  # a wedged corpse
                # cannot run its SIGTERM drain handler
            proc.terminate()
            try:
                proc.wait(timeout=RETIRE_REAP_S)
            except subprocess.TimeoutExpired:
                drained = False
                proc.kill()
                with contextlib.suppress(subprocess.TimeoutExpired):
                    proc.wait(timeout=10)
        if proc is not None:
            exitcode = proc.returncode
        self.router.remove_replica(slot.name)
        with self._slots_lock:
            if slot in self.slots:
                self.slots.remove(slot)
        drained = drained and exitcode == 0
        self._event("replica_retired", replica=slot.name,
                    exitcode=exitcode, drained=drained)
        return {"ok": True, "replica": slot.name, "exitcode": exitcode,
                "drained": drained}

    # ------------------------------------------------------------- rollout

    def _rollout_cb(self, op: str, data: dict | None) -> dict:
        """The router's /rollout delegate."""
        if op == "status":
            return self.status()["rollout"] | {"fleet": True}
        path = os.path.abspath(str(data["path"]))
        with self._ro_lock:
            if self._ro_state != "idle":
                return {"ok": False,
                        "error": f"rollout already {self._ro_state}"}
            self._ro_state = "canary"
            self._ro_result = None
            self._ro_thread = threading.Thread(
                target=self._rollout_thread, args=(path, dict(data or {})),
                name="fleet-rollout", daemon=True)
            self._ro_thread.start()
        return {"ok": True, "state": "canary", "path": path}

    def _reload_replica(self, slot: _Slot, path: str,
                        timeout_s: float = 300.0) -> str | None:
        """POST /reload to one replica; returns an error string or None.
        Never retried: /reload is non-idempotent (a replayed reload
        double-swaps engines)."""
        if slot.address is None:
            return "replica has no address"
        host, _, port = slot.address.partition(":")
        conn = http.client.HTTPConnection(host, int(port),
                                          timeout=timeout_s)
        try:
            body = json.dumps({"path": path}).encode()
            conn.request("POST", "/reload", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                return (f"{resp.status}: "
                        f"{data[:300].decode(errors='replace')}")
            return None
        except (OSError, http.client.HTTPException) as e:
            return f"{type(e).__name__}: {e}"
        finally:
            conn.close()

    def _pick_canary(self) -> _Slot | None:
        up = [s for s in self._slots_snapshot() if s.state == "up"]
        if len(up) < 2:
            return None  # shadow comparison needs a live incumbent
        return up[0]

    def _abort_rollout(self, canary: _Slot, incumbent: str, reason: str,
                       evidence: dict) -> dict:
        """Roll the canary back to the incumbent.  If even the rollback
        reload fails, kill the canary — the respawn path loads
        ``self.bundle`` (still the incumbent), which IS the rollback of
        last resort."""
        self.router.end_canary()
        err = self._reload_replica(canary, incumbent)
        rolled_back = "reload"
        if err is not None:
            self._kill_slot(canary, reason="rollback")
            self._schedule_respawn(canary)
            rolled_back = f"respawn (reload failed: {err})"
        result = {"ok": False, "aborted": True, "reason": reason,
                  "evidence": evidence, "rolled_back": rolled_back,
                  "canary": canary.name, "ts": time.time()}
        self.router.counters.inc("fleet_rollouts_aborted_total")
        self._event("rollout_aborted", reason=reason, canary=canary.name,
                    evidence=evidence)
        return result

    def _rollout_thread(self, path: str, req: dict) -> None:
        cfg = {**self.rollout_cfg,
               **{k: v for k, v in req.items() if k in ROLLOUT_DEFAULTS}}
        incumbent = self.bundle
        result: dict
        try:
            canary = self._pick_canary()
            if canary is None:
                result = {"ok": False, "aborted": True,
                          "reason": "insufficient_fleet",
                          "evidence": {"up": sum(
                              1 for s in self._slots_snapshot()
                              if s.state == "up")},
                          "ts": time.time()}
                self.router.counters.inc("fleet_rollouts_aborted_total")
                self._event("rollout_aborted",
                            reason="insufficient_fleet")
                return
            self._event("rollout_started", path=path,
                        canary=canary.name)
            # quarantine FIRST: from this moment no client request can
            # reach the canary, so the reload below can never leak an
            # unpromoted bundle's answers into live traffic
            self.router.start_canary(
                canary.name, cfg["shadow_fraction"],
                parity_max=int(cfg["parity_samples"]))
            err = self._reload_replica(canary, path)
            if err is not None:
                # the old bundle kept serving (reload's contract): no
                # rollback needed, the fleet never left the incumbent
                self.router.end_canary()
                result = {"ok": False, "aborted": True,
                          "reason": "canary_reload_failed",
                          "evidence": {"error": err},
                          "canary": canary.name, "ts": time.time()}
                self.router.counters.inc("fleet_rollouts_aborted_total")
                self._event("rollout_aborted",
                            reason="canary_reload_failed", error=err)
                return
            self.router.arm_canary()
            deadline = time.monotonic() + float(cfg["window_s"])
            need_parity = (int(cfg["parity_samples"])
                           if cfg["check_parity"] else 0)
            while time.monotonic() < deadline:
                snap = self.router.canary_snapshot()
                if snap is None:
                    break
                if (len(snap["canary_lat"]) >= int(cfg["min_shadow"])
                        and len(snap["parity"]) >= need_parity):
                    break
                if self._stop.wait(0.2):
                    break
            snap = self.router.end_canary() or {
                "canary_lat": [], "incumbent_lat": [], "parity": [],
                "shadow_sent": 0, "shadow_errors": 0, "shadow_dropped": 0}
            counts = {"shadow_sent": snap["shadow_sent"],
                      "shadow_errors": snap["shadow_errors"],
                      "canary_samples": len(snap["canary_lat"]),
                      "incumbent_samples": len(snap["incumbent_lat"]),
                      "parity_samples": len(snap["parity"])}
            if (len(snap["canary_lat"]) < int(cfg["min_shadow"])
                    or len(snap["parity"]) < need_parity
                    or not snap["incumbent_lat"]):
                result = self._abort_rollout(
                    canary, incumbent, "insufficient_traffic", counts)
                return
            # gate (b): bit parity — same obs rows, exact comparison
            if cfg["check_parity"]:
                mismatches = [
                    {"request": req_body[:200], "incumbent": live,
                     "canary": can}
                    for req_body, live, can in snap["parity"]
                    if live != can]
                if mismatches:
                    result = self._abort_rollout(
                        canary, incumbent, "parity", {
                            **counts,
                            "mismatched": len(mismatches),
                            "example": mismatches[0]})
                    return
            # gate (a): canary tail inside the learned band vs incumbent
            verdict = compare_tail(
                [{"endpoint": "/predict", "latency_s": v}
                 for v in snap["canary_lat"]],
                [{"endpoint": "/predict", "latency_s": v}
                 for v in snap["incumbent_lat"]],
                quantile=float(cfg["tail_quantile"]),
                min_band_pct=float(cfg["min_band_pct"]))
            if verdict["verdict"] != "pass":
                result = self._abort_rollout(
                    canary, incumbent, "tail_band", {
                        **counts,
                        "quantile": verdict["quantile"],
                        "groups": verdict["groups"]})
                return
            # promote fleet-wide (the canary already serves the new one)
            failures = {}
            for slot in self._slots_snapshot():
                if slot is canary or slot.state != "up":
                    continue
                err = self._reload_replica(slot, path)
                if err is not None:
                    failures[slot.name] = err
            if failures:
                # partial fleets are worse than either bundle: roll
                # everything (canary included) back to the incumbent
                for slot in self._slots_snapshot():
                    if slot.state != "up":
                        continue
                    if self._reload_replica(slot, incumbent) is not None:
                        self._kill_slot(slot, reason="rollback")
                        self._schedule_respawn(slot)
                result = {"ok": False, "aborted": True,
                          "reason": "promote_failed",
                          "evidence": {**counts, "failures": failures},
                          "canary": canary.name, "ts": time.time()}
                self.router.counters.inc("fleet_rollouts_aborted_total")
                self._event("rollout_aborted", reason="promote_failed",
                            failures=failures)
                return
            self.bundle = path
            result = {"ok": True, "promoted": True, "path": path,
                      "canary": canary.name,
                      "evidence": {**counts,
                                   "tail": verdict["groups"].get(
                                       "/predict")},
                      "ts": time.time()}
            self.router.counters.inc("fleet_rollouts_promoted_total")
            self._event("rollout_promoted", path=path)
        except Exception as e:  # noqa: BLE001 — a rollout bug must land
            # as an aborted result, never a silently-dead thread
            self.router.end_canary()
            result = {"ok": False, "aborted": True,
                      "reason": "internal_error",
                      "evidence": {"error": repr(e)[:300]},
                      "ts": time.time()}
            self.router.counters.inc("fleet_rollouts_aborted_total")
            self._event("rollout_aborted", reason="internal_error",
                        error=repr(e)[:300])
        finally:
            with self._ro_lock:
                self._ro_result = result
                self._ro_state = "idle"


# ------------------------------------------------------------------ CLI

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m estorch_tpu_torch.serve route --fleet",
        description="serving-fleet supervisor: replicas + router + "
                    "canary rollout")
    p.add_argument("--fleet", required=True, metavar="PATH",
                   help="fleet.json (schema 1: bundle, replicas, and the "
                        "serve/router/respawn/rollout/autoscale blocks)")
    p.add_argument("--workdir", default=None, metavar="DIR",
                   help="port files / replica logs (default: "
                        "<fleet.json dir>/fleet_run)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8400,
                   help="router port (0 = ephemeral, see --port-file)")
    p.add_argument("--port-file", default=None, metavar="PATH",
                   help="atomically write the ROUTER's {host,port,pid}")
    p.add_argument("--autoscale", action="store_true",
                   help="embed the autoscaler loop (obs/agg/autoscale.py)"
                        " in this supervisor; needs fleet.json's "
                        "autoscale block with 'store' and 'capacity'")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        config = load_fleet_config(args.fleet)
    except FleetError as e:
        print(f"fleet: {e}", file=sys.stderr)
        return 2
    workdir = args.workdir or os.path.join(
        os.path.dirname(os.path.abspath(args.fleet)), "fleet_run")
    fleet = Fleet(config, workdir, host=args.host, port=args.port)
    stop = threading.Event()

    def _on_signal(signum, frame):
        del frame
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    scaler = None
    if args.autoscale:
        az = config.get("autoscale") or {}
        if not az.get("store") or not az.get("capacity"):
            print("fleet: --autoscale needs fleet.json's autoscale block "
                  "with 'store' and 'capacity'", file=sys.stderr)
            return 2
        if __package__:
            from ..obs.agg import autoscale as _autoscale
        else:
            _autoscale = _load("_estorch_torch_obs_autoscale", os.pardir,
                               "obs", "agg", "autoscale.py")
        policy = {k: v for k, v in az.items()
                  if k in _autoscale.POLICY_DEFAULTS}
        try:
            scaler = _autoscale.Autoscaler(
                az["store"], capacity=az["capacity"],
                actuate=lambda n, reason: fleet.scale_to(n,
                                                         reason=reason),
                fleet_identity=fleet._bundle_identity(),
                target=az.get("target"),
                interval_s=float(az.get("interval_s", 2.0)),
                policy=policy)
        except _autoscale.AutoscaleError as e:
            # the capacity-model refusal (mismatched bundle/platform,
            # unreadable artifact): never supervise with a wrong model
            print(f"fleet: autoscale refused: {e}", file=sys.stderr)
            return 2
    fleet.start()
    if scaler is not None:
        scaler.start_background()
    router = fleet.router
    print(json.dumps({
        "ready": True, "role": "fleet",
        "url": f"http://{router.host}:{router.port}",
        "pid": os.getpid(),
        "replicas": [s.name for s in fleet.slots],
        "bundle": fleet.bundle,
        "autoscale": scaler is not None,
    }), flush=True)
    if args.port_file:
        write_port_file(args.port_file, router.host, router.port)
    while not stop.wait(0.5):
        if fleet.start_error is not None:
            break
    if scaler is not None:
        scaler.stop()
    final = fleet.shutdown()
    print(json.dumps(final, default=float), flush=True)
    if fleet.start_error is not None:
        print(f"fleet: {fleet.start_error}", file=sys.stderr)
        return 2
    return 0 if final["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
