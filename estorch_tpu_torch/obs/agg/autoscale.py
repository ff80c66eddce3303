"""Autoscaler: the serving fleet closes its own control loop.

``python -m estorch_tpu_torch.obs autoscale --store DIR --fleet-admin
host:port --capacity capacity.json`` watches the collector store ALONE
— no live scrapes, no torch — and drives the fleet's ``POST /scale``
admin surface (serve/fleet.py) so capacity follows offered load without
an operator in the loop.  Counterpart of ``estorch_tpu/obs/agg/
autoscale.py`` (the port's own copy; code equal but for
:func:`append_decision`, which creates the log's directory).

Signals (all read from the store for one router target):

* offered load — ``rate()`` of ``estorch_router_requests_total``;
* actual replicas — ``estorch_router_replica_up`` gauges;
* queue pressure — ``estorch_router_replica_queue_depth`` gauges;
* tail vs SLO — histogram-derived p99 of ``estorch_router_route_s``;
* burn-rate alert state — replayed from the collector's
  ``alerts.jsonl`` ledger (rules.py), filtered to the configured
  ``burn_rules``.

Policy:

* ``target = clamp(ceil(offered_rps × headroom / max_rps_at_slo),
  min_replicas, max_replicas)`` — ``max_rps_at_slo`` comes from the
  persisted capacity model (``loadgen --capacity-sweep --out``), whose
  bundle sha / platform MUST match the fleet's (the autoscaler refuses
  a mismatched model, naming both sides);
* scale-UP to ``target`` when demand says so, rate-limited by
  ``up_cooldown_s``; a firing burn-rate alert BYPASSES the cooldown
  when demand agrees, and steps up one replica per cooldown window even
  when demand math is satisfied (an SLO burning at "enough" capacity
  means the model is optimistic right now);
* scale-DOWN only after a SUSTAINED low-watermark window: utilization
  (``offered / (max_rps × current)``) must sit <= ``low_watermark``
  continuously for ``low_hold_s``, then one replica per
  ``down_cooldown_s`` — the per-direction cooldowns + the dead band
  between ``low_watermark`` and ``1/headroom`` are the hysteresis that
  keeps alert flapping from thrashing the fleet.

Every decision is one structured event on an APPEND-ONLY decision log
(``<store>/autoscale_decisions.jsonl``): the full inputs snapshot, the
policy, the controller state before/after, the verdict, and the
actuation result.  ``--replay LOG`` re-derives every verdict from the
recorded inputs bit-exactly (the house determinism contract applied to
control): :func:`decide` is a pure function of (inputs, policy, state).

Stdlib-only, torch-free, file-runnable (``python
estorch_tpu_torch/obs/agg/autoscale.py --selfcheck``) — the sidecar
discipline: the loop that adds capacity when the fleet drowns must not
depend on the runtime that is drowning.
"""

from __future__ import annotations

import argparse
import http.client
import json
import math
import os
import sys
import threading
import time

if __package__:
    from .rules import LEDGER_FILENAME, read_ledger
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

    _rules = _load("_estorch_torch_obs_agg_rules", "rules.py")
    _store = _load("_estorch_torch_obs_agg_store", "store.py")
    LEDGER_FILENAME = _rules.LEDGER_FILENAME
    read_ledger = _rules.read_ledger
    SeriesStore = _store.SeriesStore

AUTOSCALE_SCHEMA = 1
# must match serve/loadgen.py CAPACITY_SCHEMA (the artifact contract;
# this module must stay importable without the serve tree)
CAPACITY_SCHEMA = 1
DECISIONS_FILENAME = "autoscale_decisions.jsonl"

# documented policy knobs; a fleet.json autoscale block or CLI flags
# override individual keys
POLICY_DEFAULTS = {
    "headroom": 1.3,          # spare capacity multiplier on demand
    "min_replicas": 1,
    "max_replicas": 8,
    "window_s": 20.0,         # signal window for rate/p99 reads
    "slo_ms": None,           # None: the capacity artifact's slo_ms
    "up_cooldown_s": 10.0,    # min seconds between scale-ups
    "down_cooldown_s": 60.0,  # min seconds between scale-downs
    "low_watermark": 0.6,     # utilization below this arms scale-down
    "low_hold_s": 30.0,       # sustained low window before stepping
    "burn_rules": [],         # alert rule names meaning "step up now"
    "max_rps_at_slo": None,   # injected from the capacity artifact
}

FRESH_STATE = {"desired": None, "last_up_ts": None,
               "last_down_ts": None, "low_since": None}


class AutoscaleError(RuntimeError):
    """Bad capacity model / store / configuration — refuse loudly."""


# ------------------------------------------------------------- capacity

def validate_capacity(obj) -> list[str]:
    """Structural problems of a parsed capacity artifact ([] if clean)."""
    if not isinstance(obj, dict) or obj.get("schema") != CAPACITY_SCHEMA:
        return [f"capacity artifact must be an object with "
                f"schema={CAPACITY_SCHEMA}"]
    problems = []
    if obj.get("kind") != "capacity":
        problems.append("kind: must be 'capacity'")
    rps = obj.get("max_rps_at_slo")
    if rps is None:
        problems.append("max_rps_at_slo: null (the sweep saturated at "
                        "every rung — no usable capacity model)")
    elif not isinstance(rps, (int, float)) or isinstance(rps, bool) \
            or rps <= 0:
        problems.append("max_rps_at_slo: must be a number > 0")
    slo = obj.get("slo_ms")
    if not isinstance(slo, (int, float)) or isinstance(slo, bool) \
            or slo <= 0:
        problems.append("slo_ms: must be a number > 0")
    if not isinstance(obj.get("rungs"), list) or not obj.get("rungs"):
        problems.append("rungs: must be a non-empty list")
    return problems


def load_capacity(path: str) -> dict:
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        raise AutoscaleError(
            f"{path}: unreadable capacity artifact: {e}") from e
    problems = validate_capacity(obj)
    if problems:
        raise AutoscaleError(f"{path}: " + "; ".join(problems))
    return obj


def capacity_mismatch(capacity: dict, fleet: dict) -> str | None:
    """Why this capacity model must NOT drive that fleet (None = ok).
    Compares bundle sha and platform when BOTH sides carry them —
    naming both sides, so the refusal is actionable."""
    cap_sha, fleet_sha = capacity.get("bundle_sha"), fleet.get("bundle_sha")
    if cap_sha and fleet_sha and cap_sha != fleet_sha:
        return (f"capacity model measured bundle sha {cap_sha[:12]}… but "
                f"the fleet serves bundle sha {fleet_sha[:12]}… "
                f"({fleet.get('bundle')}) — re-run loadgen "
                f"--capacity-sweep --out against the fleet's bundle")
    cap_plat, fleet_plat = capacity.get("platform"), fleet.get("platform")
    if cap_plat and fleet_plat and cap_plat != fleet_plat:
        return (f"capacity model measured on platform {cap_plat!r} but "
                f"the fleet runs on {fleet_plat!r} — per-replica "
                f"max-RPS does not transfer across platforms")
    return None


# ---------------------------------------------------------- decision log

def append_decision(path: str, event: dict) -> None:
    """Append-only: one JSON line per decision.  A torn tail line (the
    process died mid-write) is skipped by every reader.  The log's
    directory is created when missing: a refusal at start is logged
    before any collector has made the store (the JAX package's copy
    raises FileNotFoundError there)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(event) + "\n")
        f.flush()


def read_decisions(path: str, tail: int | None = None) -> list[dict]:
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    if tail is not None:
        lines = lines[-int(tail):]
    out = []
    for ln in lines:
        try:
            row = json.loads(ln)
        except ValueError:
            continue
        if isinstance(row, dict) and row.get("event") == "decision":
            out.append(row)
    return out


def _norm(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def replay(path: str) -> dict:
    """Re-derive every logged verdict from its recorded inputs snapshot
    and compare bit-exactly (canonical-JSON equality) — the determinism
    contract: :func:`decide` is pure, so the log IS the controller.
    Also checks the state CHAIN: each decision's ``state_before`` must
    equal the previous ``state_after`` (restart adoption preserves it)."""
    decisions = read_decisions(path)
    mismatches: list[dict] = []
    prev_after: dict | None = None
    for i, ev in enumerate(decisions):
        verdict2, after2 = decide(ev["inputs"], ev["policy"],
                                  ev["state_before"])
        if _norm(verdict2) != _norm(ev.get("verdict")):
            mismatches.append({"index": i, "kind": "verdict",
                               "logged": ev.get("verdict"),
                               "derived": verdict2})
        if _norm(after2) != _norm(ev.get("state_after")):
            mismatches.append({"index": i, "kind": "state_after",
                               "logged": ev.get("state_after"),
                               "derived": after2})
        if (prev_after is not None
                and _norm(ev.get("state_before")) != _norm(prev_after)):
            mismatches.append({"index": i, "kind": "state_chain",
                               "expected": prev_after,
                               "logged": ev.get("state_before")})
        prev_after = ev.get("state_after")
    return {"ok": not mismatches, "decisions": len(decisions),
            "mismatches": mismatches}


# -------------------------------------------------------------- inputs

def _active_alerts(ledger_path: str) -> list[dict]:
    """Replay firing/resolved transitions into the active set (same
    reconstruction the dash uses)."""
    active: dict[tuple, dict] = {}
    for row in read_ledger(ledger_path, tail=2000):
        key = (row.get("rule"), row.get("target"))
        if row.get("event") == "firing":
            active[key] = row
        elif row.get("event") == "resolved":
            active.pop(key, None)
    return list(active.values())


def read_inputs(store, target: str, *, policy: dict, now: float,
                ledger_path: str | None = None) -> dict:
    """One point-in-time snapshot of every policy input, from the store
    alone.  This dict is recorded verbatim in the decision event —
    replay re-derives the verdict from IT, never from the store."""
    window = float(policy["window_s"])
    labels = {"target": target}
    inc = store.increase("estorch_router_requests_total", labels,
                         window, now)
    offered = None if inc is None else inc / window
    ups = store.latest("estorch_router_replica_up", labels, window, now)
    actual = sum(1 for _ts, _lab, v in ups.values() if v == 1.0)
    queues = store.latest("estorch_router_replica_queue_depth", labels,
                          window, now)
    queue_depth = (sum(v for _ts, _lab, v in queues.values())
                   if queues else None)
    p99_s = store.quantile("estorch_router_route_s", 0.99, labels,
                           window, now)
    desired_gauge = store.latest("estorch_router_desired_replicas",
                                 labels, window, now)
    reported_desired = None
    for _ts, _lab, v in desired_gauge.values():
        reported_desired = int(v)
    alerts = (_active_alerts(ledger_path)
              if ledger_path else [])
    alerts = [a for a in alerts if a.get("target") == target]
    burn_rules = set(policy.get("burn_rules") or [])
    return {
        "ts": now,
        "target": target,
        "window_s": window,
        "offered_rps": offered,
        "p99_ms": None if p99_s is None else p99_s * 1e3,
        "queue_depth": queue_depth,
        "actual_replicas": actual,
        "replicas_known": len(ups),
        "reported_desired": reported_desired,
        "alerts_active": sorted(a.get("rule") or "" for a in alerts),
        "burn_firing": sorted((a.get("rule") or "") for a in alerts
                              if (a.get("rule") or "") in burn_rules),
    }


# -------------------------------------------------------------- policy

def decide(inputs: dict, policy: dict, state: dict
           ) -> tuple[dict, dict]:
    """PURE policy step: ``(inputs, policy, state) -> (verdict,
    state_after)``.  No clocks, no I/O, no randomness — the decision
    log replays bit-exactly because nothing here can diverge from the
    recorded snapshot."""
    now = float(inputs["ts"])
    lo = int(policy["min_replicas"])
    hi = int(policy["max_replicas"])
    cap = policy.get("max_rps_at_slo")
    cur = state.get("desired")
    if cur is None:
        cur = inputs.get("actual_replicas") or lo
    cur = max(1, int(cur))
    offered = inputs.get("offered_rps")
    if offered is None or not cap:
        target, util = cur, None  # no signal / no model: hold
    else:
        target = math.ceil(float(offered) * float(policy["headroom"])
                           / float(cap))
        util = float(offered) / (float(cap) * cur)
    target = min(max(target, lo), hi)
    burn = list(inputs.get("burn_firing") or [])
    up_ok = (state.get("last_up_ts") is None
             or now - state["last_up_ts"] >= float(policy["up_cooldown_s"]))
    down_ok = (state.get("last_down_ts") is None
               or now - state["last_down_ts"]
               >= float(policy["down_cooldown_s"]))
    low = (target < cur and util is not None
           and util <= float(policy["low_watermark"]))

    action, desired, reason = "hold", cur, "steady"
    new_state = dict(state)
    new_state["low_since"] = state.get("low_since") if low else None
    if target > cur:
        if burn or up_ok:
            action, desired = "up", target
            reason = ("demand+burn:" + ",".join(burn)) if burn \
                else "demand"
        else:
            reason = "up_cooldown"
    elif burn:
        # demand math satisfied but the SLO is burning: the capacity
        # model is optimistic right now — step one, per cooldown window
        if cur >= hi:
            reason = "burn_at_max"
        elif up_ok:
            action, desired = "up", cur + 1
            reason = "burn:" + ",".join(burn)
        else:
            reason = "burn_cooldown"
    elif low:
        if new_state["low_since"] is None:
            new_state["low_since"] = now
            reason = "low_watermark_arming"
        elif now - new_state["low_since"] < float(policy["low_hold_s"]):
            reason = "low_watermark_holding"
        elif not down_ok:
            reason = "down_cooldown"
        else:
            # one replica per window: a gentle descent re-proves the
            # low watermark at each step instead of free-falling
            action, desired = "down", max(cur - 1, target, lo)
            reason = "low_watermark"
    if action == "up":
        new_state["last_up_ts"] = now
        new_state["low_since"] = None
    elif action == "down":
        new_state["last_down_ts"] = now
        new_state["low_since"] = now  # re-arm: next step holds again
    new_state["desired"] = desired
    verdict = {"action": action, "desired": desired, "current": cur,
               "target": target, "utilization": util, "reason": reason,
               "burn": burn}
    return verdict, new_state


# ------------------------------------------------------------ autoscaler

class Autoscaler:
    """The control loop: read inputs → decide → actuate → log.

    Actuation is either HTTP (``fleet_admin`` host:port — ``POST
    /scale`` on the fleet's router) or a direct callable (``actuate(n,
    reason)`` — the ``--autoscale`` mode embedded in the fleet
    supervisor).  ``fleet_identity`` (or the fleet's ``GET /scale``
    status when actuating over HTTP) is checked against the capacity
    model BEFORE the first actuation — a mismatched model is refused,
    naming both sides."""

    def __init__(self, store_root: str, *, capacity,
                 fleet_admin: str | None = None, actuate=None,
                 fleet_identity: dict | None = None,
                 target: str | None = None, policy: dict | None = None,
                 interval_s: float = 2.0, log_path: str | None = None,
                 dry_run: bool = False):
        self.store_root = os.path.abspath(store_root)
        self.store = SeriesStore(self.store_root)
        self.capacity = (capacity if isinstance(capacity, dict)
                         else load_capacity(str(capacity)))
        problems = validate_capacity(self.capacity)
        if problems:
            raise AutoscaleError("capacity artifact: "
                                 + "; ".join(problems))
        self.policy = {**POLICY_DEFAULTS, **(policy or {})}
        self.policy["max_rps_at_slo"] = self.capacity["max_rps_at_slo"]
        if self.policy.get("slo_ms") is None:
            self.policy["slo_ms"] = self.capacity.get("slo_ms")
        self.fleet_admin = fleet_admin
        self.actuate_fn = actuate
        self.dry_run = bool(dry_run)
        self.target = target
        self.interval_s = float(interval_s)
        self.log_path = log_path or os.path.join(self.store_root,
                                                 DECISIONS_FILENAME)
        self.ledger_path = os.path.join(self.store_root, LEDGER_FILENAME)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks_done = 0
        # first contact over HTTP only makes sense when there is an
        # HTTP admin; callable actuators vouch via fleet_identity
        self._checked_fleet = fleet_admin is None
        if fleet_identity is not None:
            self._refuse_on_mismatch(fleet_identity)
            self._checked_fleet = True
        # restart adoption: the last logged decision's state_after IS
        # the controller state (keeps the replayed chain unbroken and
        # the cooldowns honest across a daemon restart)
        tail = read_decisions(self.log_path, tail=1)
        self.state = (dict(tail[-1]["state_after"]) if tail
                      else dict(FRESH_STATE))

    # ----------------------------------------------------------- fleet

    def _refuse_on_mismatch(self, fleet_identity: dict) -> None:
        why = capacity_mismatch(self.capacity, fleet_identity or {})
        if why:
            append_decision(self.log_path, {
                "schema": AUTOSCALE_SCHEMA, "ts": time.time(),
                "event": "refused", "reason": why})
            raise AutoscaleError(why)

    def _fleet_request(self, method: str, path: str,
                       payload: dict | None = None) -> dict:
        host, _, port = str(self.fleet_admin).partition(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=10.0)
        try:
            body = (json.dumps(payload).encode()
                    if payload is not None else None)
            conn.request(method, path, body,
                         {"Content-Type": "application/json"}
                         if body else {})
            resp = conn.getresponse()
            data = resp.read()
            try:
                out = json.loads(data.decode() or "{}")
            except ValueError:
                out = {"raw": data[:200].decode(errors="replace")}
            out["_status"] = resp.status
            return out
        finally:
            conn.close()

    def ensure_fleet(self) -> None:
        """First-contact gate (HTTP actuation): fetch the fleet's scale
        status and refuse a mismatched capacity model."""
        if self._checked_fleet:
            return
        try:
            status = self._fleet_request("GET", "/scale")
        except (OSError, http.client.HTTPException) as e:
            raise AutoscaleError(
                f"fleet admin {self.fleet_admin} unreachable: "
                f"{type(e).__name__}: {e}") from e
        self._refuse_on_mismatch(status)
        self._checked_fleet = True

    def _discover_target(self, now: float) -> str | None:
        """The router target this store is watching (unambiguous or
        bust — scaling the wrong fleet is worse than not scaling)."""
        names = self.store.label_values("estorch_router_requests_total",
                                        "target",
                                        float(self.policy["window_s"]),
                                        now)
        if not names:
            return None
        if len(names) > 1 and self.target is None:
            raise AutoscaleError(
                f"multiple router targets in the store ({sorted(names)}) "
                f"— pass --target")
        return sorted(names)[0]

    # ------------------------------------------------------------ loop

    def _actuate(self, desired: int, reason: str) -> dict:
        if self.dry_run:
            return {"attempted": False, "dry_run": True}
        if self.actuate_fn is not None:
            try:
                res = self.actuate_fn(desired, reason)
            except Exception as e:  # noqa: BLE001 — an actuation bug
                # must land in the log, never kill the control loop
                return {"attempted": True, "ok": False,
                        "error": repr(e)[:300]}
            ok = bool(res.get("ok")) if isinstance(res, dict) else True
            return {"attempted": True, "ok": ok, "result": res}
        try:
            res = self._fleet_request("POST", "/scale",
                                      {"replicas": int(desired),
                                       "reason": reason})
        except (OSError, http.client.HTTPException) as e:
            return {"attempted": True, "ok": False,
                    "error": f"{type(e).__name__}: {e}"}
        return {"attempted": True, "ok": res.get("_status") == 200
                and bool(res.get("ok")), "result": res}

    def tick(self, now: float | None = None) -> dict | None:
        """One control cycle; returns the logged decision event (None
        when no router target reports yet)."""
        now = time.time() if now is None else float(now)
        self.ensure_fleet()
        target = self.target or self._discover_target(now)
        if target is None:
            return None
        inputs = read_inputs(self.store, target, policy=self.policy,
                             now=now, ledger_path=self.ledger_path)
        state_before = dict(self.state)
        verdict, state_after = decide(inputs, self.policy, state_before)
        actuation = {"attempted": False}
        if verdict["action"] in ("up", "down"):
            actuation = self._actuate(verdict["desired"],
                                      verdict["reason"])
        event = {
            "schema": AUTOSCALE_SCHEMA,
            "ts": now,
            "event": "decision",
            "target": target,
            "inputs": inputs,
            "policy": dict(self.policy),
            "state_before": state_before,
            "verdict": verdict,
            "state_after": state_after,
            "actuation": actuation,
        }
        append_decision(self.log_path, event)
        self.state = state_after
        return event

    def run(self, max_ticks: int | None = None) -> int:
        n = 0
        while not self._stop.is_set():
            try:
                self.tick()
            except AutoscaleError:
                raise
            except Exception as e:  # noqa: BLE001 — a flaky store read
                # must not kill the daemon; the next tick re-reads
                append_decision(self.log_path, {
                    "schema": AUTOSCALE_SCHEMA, "ts": time.time(),
                    "event": "tick_error", "error": repr(e)[:300]})
            n += 1
            self.ticks_done = n
            if max_ticks is not None and n >= max_ticks:
                break
            self._stop.wait(self.interval_s)
        return n

    def start_background(self) -> None:
        self._thread = threading.Thread(target=self.run,
                                        name="autoscaler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)


# ---------------------------------------------------------- selfcheck

def _mk_capacity(max_rps: float = 10.0, *, bundle_sha: str = "cafe" * 16,
                 platform: str = "cpu") -> dict:
    return {"schema": CAPACITY_SCHEMA, "kind": "capacity",
            "created_ts": 0.0, "slo_ms": 50.0, "quantile": "p99",
            "max_rps_at_slo": float(max_rps), "saturated": False,
            "rungs": [{"offered_rps": max_rps, "ok": True}],
            "bundle_sha": bundle_sha, "bundle_version": 1,
            "platform": platform}


def _seed_store(store, ts: float, *, requests_total: float,
                replicas: int, target: str = "router-1") -> None:
    samples = [{"name": "estorch_router_requests_total",
                "labels": {"target": target},
                "value": float(requests_total)}]
    for i in range(replicas):
        samples.append({"name": "estorch_router_replica_up",
                        "labels": {"target": target,
                                   "replica": f"r{i}"},
                        "value": 1.0})
        samples.append({"name": "estorch_router_replica_queue_depth",
                        "labels": {"target": target,
                                   "replica": f"r{i}"},
                        "value": 0.0})
    store.append(samples, ts=ts)


def selfcheck() -> int:
    """The policy + log + refusal contract against a synthetic store:
    demand scale-up, cooldown suppression, burn-rate step, sustained
    low-watermark scale-down, bit-exact replay, tamper detection, and
    the mismatched-capacity refusal naming both sides."""
    import tempfile

    problems: list[str] = []
    with tempfile.TemporaryDirectory() as td:
        store = SeriesStore(os.path.join(td, "store"))
        t0 = 1_000_000.0
        _seed_store(store, t0, requests_total=0.0, replicas=2)
        _seed_store(store, t0 + 10, requests_total=300.0, replicas=2)
        cap_path = os.path.join(td, "capacity.json")
        with open(cap_path, "w") as f:
            json.dump(_mk_capacity(10.0), f)
        calls: list = []

        def fake_actuate(n, reason):
            calls.append((n, reason))
            return {"ok": True, "desired": n}

        policy = {"min_replicas": 2, "max_replicas": 6,
                  "headroom": 1.3, "window_s": 10.0,
                  "up_cooldown_s": 5.0, "down_cooldown_s": 5.0,
                  "low_watermark": 0.5, "low_hold_s": 4.0,
                  "burn_rules": ["p99-slo"]}
        az = Autoscaler(os.path.join(td, "store"), capacity=cap_path,
                        actuate=fake_actuate,
                        fleet_identity={"bundle_sha": "cafe" * 16,
                                        "platform": "cpu",
                                        "bundle": "/b"},
                        policy=policy)
        # demand up: 30 rps over the window, 10 rps/replica capacity,
        # headroom 1.3 → ceil(3.9) = 4
        ev = az.tick(now=t0 + 10)
        if (ev["verdict"]["action"], ev["verdict"]["desired"]) \
                != ("up", 4):
            problems.append(f"demand up: {ev['verdict']}")
        if calls != [(4, "demand")]:
            problems.append(f"actuation: {calls}")
        # cooldown: one second later demand spikes further (40 rps →
        # target 6) but the up-cooldown suppresses the step
        _seed_store(store, t0 + 11, requests_total=700.0, replicas=2)
        ev = az.tick(now=t0 + 11)
        if (ev["verdict"]["action"], ev["verdict"]["reason"]) \
                != ("hold", "up_cooldown"):
            problems.append(f"cooldown: {ev['verdict']}")
        # burn-rate step: demand satisfied (15 rps at 4 replicas) but
        # the SLO alert fires → +1 once the cooldown has passed
        _seed_store(store, t0 + 20, requests_total=1000.0, replicas=4)
        _seed_store(store, t0 + 25, requests_total=1150.0, replicas=4)
        with open(os.path.join(td, "store", LEDGER_FILENAME), "a") as f:
            f.write(json.dumps({"ts": t0 + 24, "event": "firing",
                                "rule": "p99-slo",
                                "target": "router-1"}) + "\n")
        ev = az.tick(now=t0 + 25)
        if (ev["verdict"]["action"], ev["verdict"]["desired"],
                ev["verdict"]["reason"]) != ("up", 5, "burn:p99-slo"):
            problems.append(f"burn step: {ev['verdict']}")
        # resolved alert + sustained low utilization → arm, hold, then
        # step down one replica per down-cooldown window
        with open(os.path.join(td, "store", LEDGER_FILENAME), "a") as f:
            f.write(json.dumps({"ts": t0 + 26, "event": "resolved",
                                "rule": "p99-slo",
                                "target": "router-1"}) + "\n")
        base = 1150.0
        verdicts = []
        for dt in (30.0, 32.0, 35.0, 41.0):
            base += 10.0  # trickle traffic: utilization far below 0.5
            _seed_store(store, t0 + dt, requests_total=base, replicas=5)
            verdicts.append(az.tick(now=t0 + dt)["verdict"])
        shape = [(v["action"], v["reason"]) for v in verdicts]
        if shape != [("hold", "low_watermark_arming"),
                     ("hold", "low_watermark_holding"),
                     ("down", "low_watermark"),
                     ("down", "low_watermark")] \
                or verdicts[-1]["desired"] != 3:
            problems.append(f"low watermark: {verdicts}")
        # bit-exact replay of everything logged above
        rep = replay(az.log_path)
        if not rep["ok"] or rep["decisions"] != 7:
            problems.append(f"replay: {rep}")
        # tamper detection: flip one verdict, replay must flag it
        tampered = os.path.join(td, "tampered.jsonl")
        rows = [json.loads(ln) for ln in open(az.log_path)]
        rows[0]["verdict"]["desired"] = 99
        with open(tampered, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        if replay(tampered)["ok"]:
            problems.append("tampered log replayed clean")
        # the refusal names both sides
        try:
            Autoscaler(os.path.join(td, "store"), capacity=cap_path,
                       actuate=fake_actuate,
                       fleet_identity={"bundle_sha": "dead" * 16,
                                       "platform": "cpu",
                                       "bundle": "/other"})
            problems.append("mismatched capacity model accepted")
        except AutoscaleError as e:
            if "cafecafecafe" not in str(e) or "deaddeaddead" not in str(e):
                problems.append(f"refusal names neither side: {e}")
        # junk artifacts are refused
        if not validate_capacity({"schema": 99}):
            problems.append("junk capacity validated")
        if not validate_capacity(_mk_capacity(10.0)
                                 | {"max_rps_at_slo": None}):
            problems.append("saturated capacity validated")
    for p in problems:
        print(f"FAIL: {p}")
    print(json.dumps({"selfcheck": "autoscale",
                      "ok": not problems,
                      "problems": problems}))
    return 0 if not problems else 1


# ------------------------------------------------------------------ CLI

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m estorch_tpu_torch.obs autoscale",
        description="autoscaler daemon: collector store + capacity "
                    "model -> fleet POST /scale")
    p.add_argument("--store", metavar="DIR",
                   help="collector store root (obs/agg/store.py)")
    p.add_argument("--fleet-admin", metavar="HOST:PORT",
                   help="the fleet router's admin address "
                        "(POST /scale)")
    p.add_argument("--capacity", metavar="PATH",
                   help="capacity.json from loadgen --capacity-sweep "
                        "--out")
    p.add_argument("--target", default=None,
                   help="router target label in the store (default: "
                        "auto-discover; ambiguity is an error)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between control cycles")
    p.add_argument("--ticks", type=int, default=None,
                   help="stop after N cycles (default: run forever)")
    p.add_argument("--once", action="store_true",
                   help="one cycle, print the decision event, exit")
    p.add_argument("--dry-run", action="store_true",
                   help="decide + log but never actuate")
    p.add_argument("--min", type=int, default=None, dest="min_replicas")
    p.add_argument("--max", type=int, default=None, dest="max_replicas")
    p.add_argument("--headroom", type=float, default=None)
    p.add_argument("--window", type=float, default=None, dest="window_s")
    p.add_argument("--slo-ms", type=float, default=None, dest="slo_ms")
    p.add_argument("--up-cooldown", type=float, default=None,
                   dest="up_cooldown_s")
    p.add_argument("--down-cooldown", type=float, default=None,
                   dest="down_cooldown_s")
    p.add_argument("--low-watermark", type=float, default=None,
                   dest="low_watermark")
    p.add_argument("--low-hold", type=float, default=None,
                   dest="low_hold_s")
    p.add_argument("--burn-rule", action="append", default=None,
                   metavar="NAME", dest="burn_rules",
                   help="alert rule name treated as a burn-rate breach "
                        "(repeatable)")
    p.add_argument("--decision-log", default=None, metavar="PATH",
                   help=f"append-only decision log (default: "
                        f"<store>/{DECISIONS_FILENAME})")
    p.add_argument("--replay", default=None, metavar="LOG",
                   help="re-derive every decision in LOG from its "
                        "recorded inputs and verify bit-exactness")
    p.add_argument("--selfcheck", action="store_true",
                   help="synthetic-store policy/log/refusal gate "
                        "(CI)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.selfcheck:
        return selfcheck()
    if args.replay:
        res = replay(args.replay)
        print(json.dumps(res, indent=1))
        return 0 if res["ok"] else 1
    if not args.store or not args.capacity:
        build_parser().error("--store and --capacity are required "
                             "(or --replay / --selfcheck)")
    if not args.fleet_admin and not args.dry_run:
        build_parser().error("--fleet-admin is required (or --dry-run)")
    policy = {k: v for k, v in vars(args).items()
              if k in POLICY_DEFAULTS and v is not None}
    try:
        az = Autoscaler(args.store, capacity=args.capacity,
                        fleet_admin=args.fleet_admin,
                        target=args.target, policy=policy,
                        interval_s=args.interval,
                        log_path=args.decision_log,
                        dry_run=args.dry_run)
    except AutoscaleError as e:
        print(f"autoscale: {e}", file=sys.stderr)
        return 2
    if args.once:
        try:
            ev = az.tick()
        except AutoscaleError as e:
            print(f"autoscale: {e}", file=sys.stderr)
            return 2
        print(json.dumps(ev, indent=1, default=float))
        return 0
    print(json.dumps({"ready": True, "role": "autoscaler",
                      "store": az.store_root, "log": az.log_path,
                      "fleet_admin": args.fleet_admin,
                      "policy": az.policy, "pid": os.getpid()}),
          flush=True)
    try:
        az.run(max_ticks=args.ticks)
    except AutoscaleError as e:
        print(f"autoscale: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        print(json.dumps({"autoscale": "interrupted",
                          "ticks": az.ticks_done}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
