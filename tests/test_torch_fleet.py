"""The port's serving fleet (``estorch_tpu_torch/serve/router.py``,
``serve/fleet.py``, the chaos plan's serve events) against the JAX
package's, and the fleet end to end on the CPU.

Against the JAX package's modules, in process, on the same inputs: the
circuit breaker's transitions under one clock, ``validate_fleet_config``'s
messages (apart from the port's ``serve.device``, which replaces
``serve.cpu_devices``), ``parse_replica_spec``, and ``serve_faults``' due
and once semantics with one ledger shared across both packages' plans.

The port alone, with ``"device": "cpu"``: a 2-replica fleet whose answers
through the router are bit-equal to the port's ``ES.predict`` on the
anchor batch and within 1e-6 of the JAX package's predictor on the same
parameters (carried across by ``interop``); a declared ``kill_replica``
under load with zero client errors and a warm respawn; a canary rollout
promoted (a re-export) and one aborted on bit parity (one parameter
moved); scaling 2 → 3 → 2 under load; ``route --fleet`` through the CLI
(its process never maps torch); a replica that refuses to start (exit 2)
failing the fleet's start instead of crash-looping; and the file-run
forms of the router and the fleet, which import neither torch nor any
package.  The wedge (SIGSTOP) case is ``slow``: its escalation waits out
poll timeouts and a respawn.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from estorch_tpu import ES as JES
from estorch_tpu import JaxAgent
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu.envs.pendulum import Pendulum as JPendulum
from estorch_tpu.parallel import population_mesh
from estorch_tpu.resilience import chaos as jchaos
from estorch_tpu.serve import fleet as jfleet
from estorch_tpu.serve import router as jrouter
from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, Pendulum, adam, interop
from estorch_tpu_torch.resilience import chaos as tchaos
from estorch_tpu_torch.serve import fleet as tfleet
from estorch_tpu_torch.serve import router as trouter
from estorch_tpu_torch.serve.loadgen import run_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_PK = {"action_dim": 1, "hidden": (24, 24), "discrete": False, "action_scale": 2.0}
ANCHOR = 4  # the replicas' --max-batch: the top of the ladder, always served


# =====================================================================
# against the JAX package, in process
# =====================================================================

def test_circuit_breaker_transitions_equal(monkeypatch):
    """One seeded sequence of allow / success / failure / clock steps
    through both packages' breakers: the same answers and states."""
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    rng = np.random.default_rng(0)
    for threshold, open_s in ((1, 0.5), (3, 1.0), (2, 0.0)):
        tb, jb = trouter.CircuitBreaker(threshold, open_s), jrouter.CircuitBreaker(threshold, open_s)
        states = set()
        for _ in range(400):
            op = rng.choice(["allow", "ok", "fail", "tick"], p=[0.35, 0.2, 0.3, 0.15])
            if op == "allow":
                assert tb.allow() == jb.allow()
            elif op == "ok":
                tb.record_success(), jb.record_success()
            elif op == "fail":
                assert tb.record_failure() == jb.record_failure()
            else:
                clock[0] += float(rng.uniform(0.0, 1.5))
            assert (tb.state, tb.failures, tb.opens_total) == (jb.state, jb.failures,
                                                                jb.opens_total)
            states.add(tb.state)
        assert states == {trouter.BREAKER_CLOSED, trouter.BREAKER_OPEN,
                          trouter.BREAKER_HALF_OPEN}


FLEET_DOCS = [
    [],
    {"schema": 99},
    {"schema": 1},
    {"schema": 1, "replicas": 0},
    {"schema": 1, "bundle": 3, "replicas": True},
    {"schema": 1, "bundle": "b", "replicas": 2},
    {"schema": 1, "bundle": "b", "replicas": 2, "rollout": {"shadow_fraction": 2.0}},
    {"schema": 1, "bundle": "b", "replicas": 2, "rollout": {"shadow_fraction": 0}},
    {"schema": 1, "bundle": "b", "replicas": 2, "serve": [], "router": 1, "respawn": "x"},
    {"schema": 1, "bundle": "b", "replicas": 2,
     "autoscale": {"min_replicas": 5, "max_replicas": 2}},
    {"schema": 1, "bundle": "b", "replicas": 2,
     "autoscale": {"min_replicas": 0, "max_replicas": True}},
    {"schema": 1, "bundle": "b", "replicas": 2, "serve": {"max_batch": 8, "dtype": "bf16"}},
]


@pytest.mark.parametrize("doc", FLEET_DOCS)
def test_validate_fleet_config_messages_equal(doc):
    assert tfleet.validate_fleet_config(doc) == jfleet.validate_fleet_config(doc)


def test_validate_fleet_config_names_device_for_cpu_devices():
    base = {"schema": 1, "bundle": "b", "replicas": 2}
    assert jfleet.validate_fleet_config({**base, "serve": {"cpu_devices": 8}}) == []
    probs = tfleet.validate_fleet_config({**base, "serve": {"cpu_devices": 8}})
    assert len(probs) == 1 and "serve.device" in probs[0] and "cpu_devices" in probs[0]
    probs = tfleet.validate_fleet_config({**base, "serve": {"no_warm": True}})
    assert len(probs) == 1 and "no_warm" in probs[0]
    assert tfleet.validate_fleet_config({**base, "serve": {"device": ""}}) != []
    for dev in ("cpu", "cuda", "cuda:0"):
        assert tfleet.validate_fleet_config({**base, "serve": {"device": dev}}) == []


def test_serve_argv_passes_the_device():
    f = tfleet.Fleet.__new__(tfleet.Fleet)
    f.workdir, f.bundle = "/w", "/b"
    slot = tfleet._Slot(0, "/w")
    for serve, dev in (({}, "cuda"), ({"device": "cpu", "max_batch": 64}, "cpu")):
        f.config = {"serve": serve}
        argv = f._serve_argv(slot)
        assert argv[1:3] == ["-m", "estorch_tpu_torch.serve"]
        assert argv[argv.index("--device") + 1] == dev
        assert "--cpu-devices" not in argv and "--no-warm" not in argv
    assert argv[argv.index("--max-batch") + 1] == "64"


@pytest.mark.parametrize("spec", ["a=h:1,b=h:2", " a=h:1 , ", "r0=127.0.0.1:8321",
                                  "nonsense", "", "a=", "=h:1,b=h:2"])
def test_parse_replica_spec_equal(spec):
    def run(mod):
        try:
            return mod.parse_replica_spec(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(trouter) == run(jrouter)


def test_serve_faults_due_and_once_with_a_shared_ledger(tmp_path, monkeypatch):
    """Both packages parse one plan; their claims interleave on one ledger:
    each event fires once in total, due by ``at_s``, untouched by the
    generation clock."""
    ledger = str(tmp_path / "ledger")
    plan = {"events": [{"kind": "kill_replica", "at_s": 1.0, "replica": 1},
                       {"kind": "wedge_replica", "at_s": 5.0, "replica": 0},
                       {"kind": "kill_replica", "at_s": 5.0, "replica": 0},
                       {"kind": "die", "gen": 3}],
            "ledger": ledger}
    monkeypatch.setenv(tchaos.CHAOS_ENV, json.dumps(plan))
    tchaos.reset_cache(), jchaos.reset_cache()
    try:
        claimed = []
        for t, mod in ((0.5, tchaos), (0.5, jchaos), (2.0, jchaos), (2.0, tchaos),
                       (9.0, tchaos), (9.0, jchaos)):
            claimed.append([(e["kind"], e["id"]) for e in mod.serve_faults(t)])
        assert claimed == [[], [], [("kill_replica", 0)], [],
                           [("wedge_replica", 1), ("kill_replica", 2)], []]
        assert sorted(int(x) for x in open(ledger).read().split()) == [0, 1, 2]
        assert [e["kind"] for e in tchaos.active_plan().events_at(3)] == ["die"]
        # a fresh plan over the same ledger (a restarted fleet) skips them all
        fresh = tchaos.ChaosPlan.parse(json.dumps(plan))
        assert fresh.serve_events_due(100.0) == []
        # the same due and once semantics without a ledger, event by event
        spec = [{"kind": "kill_replica", "at_s": 1.0, "replica": 1},
                {"kind": "wedge_replica", "at_s": 5.0, "replica": 0}]
        tp, jp = tchaos.ChaosPlan(spec), jchaos.ChaosPlan(spec)
        for t in (0.5, 2.0, 2.0, 9.0, 9.0):
            assert tp.serve_events_due(t) == jp.serve_events_due(t)
        assert tchaos.ChaosPlan.parse(tp.to_json()).events == jp.events
    finally:
        monkeypatch.delenv(tchaos.CHAOS_ENV)
        tchaos.reset_cache(), jchaos.reset_cache()
    with pytest.raises(ValueError, match="at_s"):
        tchaos.ChaosPlan([{"kind": "wedge_replica", "replica": 0}])


def test_serve_faults_costs_nothing_without_a_plan(monkeypatch):
    monkeypatch.delenv(tchaos.CHAOS_ENV, raising=False)
    assert tchaos.serve_faults(1e9) == []


# =====================================================================
# router mechanics over stdlib toy replicas
# =====================================================================

def _toy_replica(*, fail=False):
    state = {"traces": []}

    class Toy(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _j(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._j(200, {"ok": True, "draining": False, "queue_depth": 0,
                          "request_ms": {"p99": 1.0}})

        def do_POST(self):
            data = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
            state["traces"].append(self.headers.get("X-Trace-Id"))
            if fail:
                self._j(500, {"error": "injected"})
            else:
                self._j(200, {"action": [2.0 * v for v in data["obs"]]})

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Toy)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, state


def _post(url, payload, timeout=30):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read()), dict(r.headers)


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def test_router_fails_over_traces_and_refuses_without_a_fleet():
    a, _ = _toy_replica()
    b, bstate = _toy_replica()
    router = trouter.Router([("ra", f"127.0.0.1:{a.server_address[1]}"),
                             ("rb", f"127.0.0.1:{b.server_address[1]}")],
                            port=0, poll_interval_s=30.0)
    router.start_background()
    try:
        url = f"http://{router.host}:{router.port}"
        deadline = time.monotonic() + 30
        while not all(r.health.get("polled") for r in router.replicas()):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        a.shutdown(), a.server_close()
        for i in range(8):
            out, hdrs = _post(url + "/predict", {"obs": [float(i)]})
            assert out["action"] == [2.0 * i] and hdrs["X-Upstream"] == "rb"
        assert hdrs["X-Trace-Id"] in bstate["traces"]
        st = router.stats()
        assert st["counters"]["router_retries_total"] >= 1
        assert {r["name"]: r["breaker"] for r in st["replicas"]}["ra"] == trouter.BREAKER_OPEN
        for path in ("/rollout", "/scale"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + path, {"path": "/x", "replicas": 2})
            assert e.value.code == 409
    finally:
        router.shutdown(drain=False)
        b.shutdown(), b.server_close()


@pytest.mark.parametrize("server", ["router", "replica"])
def test_listen_backlog_holds_a_burst_of_connects(server):
    """64 clients connecting at once to a router or a replica that has
    not accepted yet all complete their handshakes (ROADMAP F18): with
    socketserver's backlog of 5 the kernel dropped the SYNs past it, and
    each such client waited a second for its resend."""
    import selectors
    import socket

    from estorch_tpu_torch.serve import server as tserver

    cls = trouter._RouterHttpd if server == "router" else tserver._Httpd
    srv = cls(("127.0.0.1", 0), BaseHTTPRequestHandler)  # never serves: nothing accepts
    socks = []
    try:
        sel = selectors.DefaultSelector()
        for _ in range(64):
            s = socket.socket()
            s.setblocking(False)
            s.connect_ex(srv.server_address)
            sel.register(s, selectors.EVENT_WRITE)
            socks.append(s)
        done, deadline = set(), time.monotonic() + 0.5
        while len(done) < len(socks) and time.monotonic() < deadline:
            for key, _ in sel.select(timeout=0.05):
                done.add(key.fileobj)
                sel.unregister(key.fileobj)
        assert len(done) == 64, f"{len(done)} of 64 handshakes within 0.5 s"
        assert all(s.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR) == 0 for s in socks)
    finally:
        for s in socks:
            s.close()
        srv.server_close()


# =====================================================================
# the port's fleet on the CPU
# =====================================================================

def _jax_es():
    return JES(JMLPPolicy, JaxAgent(JPendulum(), horizon=20), optax.adam, population_size=8,
               sigma=0.05, policy_kwargs=dict(SMALL_PK), obs_norm=True,
               optimizer_kwargs={"learning_rate": 1e-2}, seed=0, table_size=1 << 14,
               telemetry=False, mesh=population_mesh(jax.devices()[:1]))


def _port_es():
    return ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, population_size=8,
              sigma=0.05, policy_kwargs=dict(SMALL_PK), obs_norm=True,
              optimizer_kwargs={"learning_rate": 1e-2}, seed=0, table_size=1 << 14,
              device="cpu", telemetry=False)


def _obs(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The JAX ES's params and obs stats carried into a port ES, exported
    (the incumbent, warm), re-exported (a good canary) and exported with
    one parameter moved (a bad canary)."""
    root = tmp_path_factory.mktemp("fleet_bundles")
    jes, tes = _jax_es(), _port_es()
    rng = np.random.default_rng(5)
    count = np.float32(250.0)
    mean = rng.standard_normal(3).astype(np.float32)
    m2 = (count * rng.uniform(0.2, 3.0, 3)).astype(np.float32)
    jes.state = jes.state._replace(obs_stats=tuple(jnp.asarray(x) for x in (count, mean, m2)))
    flat, _ = interop.params_from_jax(np.asarray(jes.state.params_flat), tes.spec)
    tes.state = tes.state._replace(params_flat=flat,
                                   obs_stats=interop.obs_stats_from_jax((count, mean, m2)))
    incumbent = tes.export_bundle(str(root / "incumbent"), warm=True, warm_max_batch=ANCHOR)
    good = tes.export_bundle(str(root / "good"))
    moved = flat.clone()
    moved[7] += 1e-3
    tes_bad = _port_es()
    tes_bad.state = tes.state._replace(params_flat=moved)
    bad = tes_bad.export_bundle(str(root / "bad"))
    obs = _obs(ANCHOR)
    return {"incumbent": incumbent, "good": good, "bad": bad, "obs": obs,
            "ref": np.asarray(tes.predict(obs), np.float32),
            "jax": np.asarray(jes.predict(jnp.asarray(obs)), np.float32)}


def _fleet_config(bundle, **over):
    cfg = {"schema": 1, "bundle": bundle, "replicas": 2,
           "serve": {"max_batch": ANCHOR, "device": "cpu"},
           "router": {"retry_budget": 2, "breaker_open_s": 0.5, "upstream_timeout_s": 30.0},
           "respawn": {"backoff_s": 0.2},
           "rollout": {"shadow_fraction": 0.9, "min_shadow": 12, "parity_samples": 4,
                       "window_s": 60}}
    cfg.update(over)
    return cfg


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f"timed out after {timeout_s}s waiting for {what}")


def _served(url, obs):
    """Each row of ``obs`` as its own /predict, float32 answers stacked."""
    return np.stack([np.asarray(_post(url + "/predict", {"obs": o.tolist()})[0]["action"],
                                np.float32) for o in obs])


class _Background:
    """Closed-loop load in short windows until stopped; errors summed."""

    def __init__(self, addr, obs, conns=4):
        self.res = {"requests": 0, "errors": 0, "shed": 0}
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                r = run_load(addr, conns=conns, duration_s=0.5, obs=obs, timeout_s=60.0)
                for k in self.res:
                    self.res[k] += r[k]

        self._t = threading.Thread(target=loop, daemon=True)
        self._t.start()

    def stop(self):
        self._stop.set()
        self._t.join(timeout=120)
        assert not self._t.is_alive()
        return self.res


@pytest.fixture(scope="class")
def fleet(bundles, tmp_path_factory):
    f = tfleet.Fleet(_fleet_config(bundles["incumbent"]),
                     str(tmp_path_factory.mktemp("fleet") / "run"), port=0)
    f.start()
    try:
        assert f.wait_ready(180), f.status()
        yield f
    finally:
        final = f.shutdown()
    assert final["clean"], final


class TestFleetOnCPU:
    def test_answers_are_es_predict_bits(self, fleet, bundles):
        url = f"http://{fleet.router.host}:{fleet.router.port}"
        got = _served(url, bundles["obs"])
        assert got.tobytes() == bundles["ref"].tobytes()
        np.testing.assert_allclose(got, bundles["jax"], rtol=1e-6, atol=1e-6)
        st = _get(url + "/stats")
        assert sorted(r["name"] for r in st["replicas"]) == ["r0", "r1"]
        for slot in fleet.slots:  # each replica alone answers the same bits
            assert _served(f"http://{slot.address}", bundles["obs"]).tobytes() == \
                bundles["ref"].tobytes()
            assert slot.cold_start["compiles_at_load"] == 0
            with open(slot.log_path) as f:
                ready = json.loads(f.readline())
            assert ready["device"]["platform"] == "cpu" and ready["memory"] is None

    def test_kill_replica_under_load(self, fleet, bundles, tmp_path, monkeypatch):
        monkeypatch.setenv(tchaos.CHAOS_ENV, json.dumps({
            "events": [{"kind": "kill_replica", "at_s": 1.0, "replica": 1}],
            "ledger": str(tmp_path / "ledger")}))
        fleet.arm_chaos()
        addr = f"{fleet.router.host}:{fleet.router.port}"
        load = run_load(addr, conns=6, duration_s=4.0, obs=bundles["obs"][0].tolist(),
                        timeout_s=60.0)
        assert load["errors"] == 0 and load["shed"] == 0 and load["requests"] > 50, load
        assert "chaos_kill_replica" in [e["event"] for e in fleet.events]
        assert fleet.router.counters.get("router_breaker_opens_total") >= 1
        _wait(lambda: (fleet.slots[1].restarts >= 1 and fleet.slots[1].state == "up"
                       and {r.name: r.breaker.state for r in fleet.router.replicas()}["r1"]
                       == trouter.BREAKER_CLOSED), 120, "r1's respawn")
        cold = _get(f"http://{fleet.slots[1].address}/stats")["cold_start"]
        assert cold["compiles_at_load"] == 0, cold
        a = _served(f"http://{fleet.slots[0].address}", bundles["obs"])
        b = _served(f"http://{fleet.slots[1].address}", bundles["obs"])
        assert a.tobytes() == b.tobytes() == bundles["ref"].tobytes()

    def _rollout(self, fleet, bundles, path, **req):
        addr = f"{fleet.router.host}:{fleet.router.port}"
        bg = _Background(addr, bundles["obs"][1].tolist())
        try:
            out, _ = _post(f"http://{addr}/rollout", {"path": path, **req})
            assert out["ok"] and out["state"] == "canary", out
            ro = _wait(lambda: (lambda r: r if r["state"] == "idle" and r["last"] else None)(
                fleet.status()["rollout"]), 120, "the rollout's end")
        finally:
            res = bg.stop()
        assert res["errors"] == 0 and res["shed"] == 0 and res["requests"] > 0, res
        return ro["last"]

    def test_canary_promotes_a_reexport_and_aborts_on_parity(self, fleet, bundles):
        url = f"http://{fleet.router.host}:{fleet.router.port}"
        last = self._rollout(fleet, bundles, bundles["bad"])
        assert last["aborted"] and last["reason"] == "parity", last
        assert last["evidence"]["mismatched"] >= 1 and "example" in last["evidence"]
        assert fleet.bundle == bundles["incumbent"]
        for slot in fleet.slots:
            assert _served(f"http://{slot.address}", bundles["obs"]).tobytes() == \
                bundles["ref"].tobytes()
        # the tail gate is not under test here: a wide band keeps a busy
        # CPU's latency spread from deciding a same-parameter rollout
        last = self._rollout(fleet, bundles, bundles["good"], min_band_pct=400.0)
        assert last.get("promoted"), last
        assert last["evidence"]["parity_samples"] >= 4
        assert fleet.bundle == bundles["good"]
        assert _served(url, bundles["obs"]).tobytes() == bundles["ref"].tobytes()

    def test_scale_2_3_2_under_load(self, fleet, bundles):
        addr = f"{fleet.router.host}:{fleet.router.port}"
        url = f"http://{addr}"
        bg = _Background(addr, bundles["obs"][2].tolist())
        try:
            out, _ = _post(url + "/scale", {"replicas": 3})
            assert out["ok"] and out["accepted"] and out["desired"] == 3, out
            up = _wait(lambda: (lambda s: s if s["actual"] == 3 and not s["in_progress"]
                                and s["last"] else None)(_get(url + "/scale")), 180, "3 up")
            assert up["last"]["added"][0]["compiles_at_load"] == 0, up["last"]
            out, _ = _post(url + "/scale", {"replicas": 2})
            assert out["ok"], out
            down = _wait(lambda: (lambda s: s if s["actual"] == 2 and not s["in_progress"]
                                  and s["last"]["retired"] else None)(_get(url + "/scale")),
                         120, "back to 2")
        finally:
            res = bg.stop()
        assert res["errors"] == 0 and res["shed"] == 0 and res["requests"] > 0, res
        retired = down["last"]["retired"][0]
        assert retired["ok"] and retired["drained"] and retired["exitcode"] == 0, retired
        assert len(fleet.slots) == 2
        assert _served(url, bundles["obs"]).tobytes() == bundles["ref"].tobytes()


def test_route_fleet_cli_end_to_end(bundles, tmp_path):
    """``python -m estorch_tpu_torch.serve route --fleet fleet.json``: the
    ready line, routed answers equal to ``ES.predict``, a supervisor that
    never maps torch, a clean SIGTERM drain (exit 0)."""
    cfg = tmp_path / "fleet.json"
    cfg.write_text(json.dumps({"schema": 1, "bundle": bundles["incumbent"], "replicas": 2,
                               "serve": {"max_batch": ANCHOR, "device": "cpu"}}))
    p = subprocess.Popen([sys.executable, "-m", "estorch_tpu_torch.serve", "route", "--fleet",
                          str(cfg), "--port", "0", "--workdir", str(tmp_path / "run")],
                         stdout=subprocess.PIPE, text=True, cwd=REPO, start_new_session=True)
    try:
        ready = json.loads(p.stdout.readline())
        assert ready["role"] == "fleet" and ready["replicas"] == ["r0", "r1"]
        url = ready["url"]
        _wait(lambda: _get(url + "/scale")["actual"] == 2, 180, "both replicas")
        assert _served(url, bundles["obs"]).tobytes() == bundles["ref"].tobytes()
        if os.path.exists(f"/proc/{p.pid}/maps"):
            with open(f"/proc/{p.pid}/maps") as f:
                assert "libtorch" not in f.read()
        p.send_signal(signal.SIGTERM)
        rest, _ = p.communicate(timeout=90)
        final = json.loads(rest.strip().splitlines()[-1])
        assert final["clean"] and p.returncode == 0, (final, p.returncode)
    finally:
        # the whole session: a supervisor killed alone leaves its replicas
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait(timeout=30)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


@pytest.mark.skipif(not sys.platform.startswith("linux"), reason="reads /proc")
def test_replicas_exit_when_their_supervisor_is_killed(bundles, tmp_path):
    """A SIGKILLed supervisor leaves no replica behind: each notices it was
    reparented, drains and exits (ROADMAP F20)."""
    cfg = tmp_path / "fleet.json"
    cfg.write_text(json.dumps({"schema": 1, "bundle": bundles["incumbent"], "replicas": 2,
                               "serve": {"max_batch": ANCHOR, "device": "cpu"}}))
    p = subprocess.Popen([sys.executable, "-m", "estorch_tpu_torch.serve", "route", "--fleet",
                          str(cfg), "--port", "0", "--workdir", str(tmp_path / "run")],
                         stdout=subprocess.PIPE, text=True, cwd=REPO, start_new_session=True)
    try:
        url = json.loads(p.stdout.readline())["url"]
        _wait(lambda: _get(url + "/scale")["actual"] == 2, 180, "both replicas")
        pids = [json.loads((tmp_path / "run" / f"r{i}_port.json").read_text())["pid"]
                for i in range(2)]
        assert all(_alive(pid) for pid in pids)
        p.kill()
        p.wait(timeout=30)
        _wait(lambda: not any(_alive(pid) for pid in pids), 60, "the replicas' exit")
        for i in range(2):
            assert '"orphaned": true' in (tmp_path / "run" / f"r{i}.log").read_text()
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait(timeout=30)


def test_a_replica_refusing_to_start_fails_the_fleet(tmp_path):
    """A replica that exits 2 while starting (here: no bundle at the path)
    marks its slot failed, is never respawned, and the fleet exits 2."""
    cfg = tmp_path / "fleet.json"
    cfg.write_text(json.dumps({"schema": 1, "bundle": str(tmp_path / "missing"),
                               "replicas": 2, "serve": {"device": "cpu"},
                               "respawn": {"backoff_s": 0.1}}))
    r = subprocess.run([sys.executable, "-m", "estorch_tpu_torch.serve", "route", "--fleet",
                        str(cfg), "--port", "0", "--workdir", str(tmp_path / "run")],
                       capture_output=True, text=True, timeout=180, cwd=REPO)
    assert r.returncode == 2, (r.stdout[-2000:], r.stderr[-2000:])
    assert "refused to start (exit 2)" in r.stderr
    logs = [(tmp_path / "run" / f"r{i}.log").read_text() for i in range(2)]
    # one start each: no crash loop
    assert all(log.count("serve:") <= 1 for log in logs), logs


@pytest.mark.parametrize("form", ["module", "file"])
def test_route_autoscale_refusals(form, bundles, tmp_path):
    """``route --fleet --autoscale`` embeds the autoscaler: without the
    autoscale block's store and capacity it exits 2, and a capacity model
    measured on another bundle is refused before any replica spawns."""
    from estorch_tpu_torch.obs.agg.autoscale import _mk_capacity

    head = ([sys.executable, "-m", "estorch_tpu_torch.serve", "route"] if form == "module"
            else [sys.executable, os.path.join(REPO, "estorch_tpu_torch", "serve", "router.py")])
    cfg = tmp_path / "fleet.json"
    cfg.write_text(json.dumps({"schema": 1, "bundle": bundles["incumbent"], "replicas": 2,
                               "serve": {"device": "cpu"}}))
    r = subprocess.run(head + ["--fleet", str(cfg), "--autoscale", "--port", "0"],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 2 and "autoscale block" in r.stderr, r.stderr[-2000:]
    cap = tmp_path / "capacity.json"
    cap.write_text(json.dumps(_mk_capacity(bundle_sha="beef" * 16, platform="cpu")))
    cfg.write_text(json.dumps({"schema": 1, "bundle": bundles["incumbent"], "replicas": 2,
                               "serve": {"device": "cpu"},
                               "autoscale": {"store": str(tmp_path / "store"),
                                             "capacity": str(cap)}}))
    r = subprocess.run(head + ["--fleet", str(cfg), "--autoscale", "--port", "0",
                               "--workdir", str(tmp_path / "run")],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 2 and "autoscale refused" in r.stderr, r.stderr[-2000:]
    assert not (tmp_path / "run" / "r0.log").exists()


@pytest.mark.parametrize("name", ["router", "fleet"])
def test_file_run_loads_no_torch_and_no_package(name, tmp_path):
    path = os.path.join(REPO, "estorch_tpu_torch", "serve", f"{name}.py")
    cfg = tmp_path / "fleet.json"
    cfg.write_text(json.dumps({"schema": 1, "bundle": "b", "replicas": 2,
                               "serve": {"device": "cpu"}}))
    srv, _ = _toy_replica()
    probe = (
        "import importlib.util, json, sys, time, urllib.request\n"
        f"spec = importlib.util.spec_from_file_location('m', {path!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "def bad():\n"
        "    return sorted(k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'estorch_tpu', 'estorch_tpu_torch'))\n"
        "assert not bad(), bad()\n"
        + ("router = m.Router([('ra', '127.0.0.1:%d')], port=0)\n"
           "router.start_background()\n"
           "req = urllib.request.Request(f'http://{router.host}:{router.port}/predict', "
           "json.dumps({'obs': [3.0]}).encode(), {'Content-Type': 'application/json'})\n"
           "for _ in range(100):\n"
           "    try:\n"
           "        out = json.loads(urllib.request.urlopen(req, timeout=10).read()); break\n"
           "    except Exception:\n"
           "        time.sleep(0.1)\n"
           "assert out['action'] == [6.0], out\n"
           "router.shutdown(drain=False)\n" % srv.server_address[1]
           if name == "router" else
           f"cfg = m.load_fleet_config({str(cfg)!r})\n"
           "assert cfg['replicas'] == 2 and cfg['serve']['device'] == 'cpu'\n"
           "assert m.validate_fleet_config({'schema': 1}) != []\n")
        + "assert not bad(), bad()\n"
        "print('FILE_RUN_OK')\n")
    try:
        r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                           timeout=120)
    finally:
        srv.shutdown(), srv.server_close()
    assert r.returncode == 0 and "FILE_RUN_OK" in r.stdout, r.stderr[-2000:]


@pytest.mark.slow
def test_wedge_replica_is_escalated_and_respawned(bundles, tmp_path, monkeypatch):
    """A declared ``wedge_replica`` (SIGSTOP: an alive process, a silent
    socket): the breaker opens on poll timeouts, the fleet escalates to
    SIGKILL and respawns, and the other replica answers every request."""
    f = tfleet.Fleet(_fleet_config(
        bundles["incumbent"],
        router={"breaker_open_s": 0.5, "poll_timeout_s": 0.5, "upstream_timeout_s": 3.0},
        respawn={"backoff_s": 0.2, "wedge_kill_s": 2.0}), str(tmp_path / "run"), port=0)
    f.start()
    try:
        assert f.wait_ready(180), f.status()
        monkeypatch.setenv(tchaos.CHAOS_ENV, json.dumps({
            "events": [{"kind": "wedge_replica", "at_s": 0.5, "replica": 0}],
            "ledger": str(tmp_path / "ledger")}))
        f.arm_chaos()
        load = run_load(f"{f.router.host}:{f.router.port}", conns=4, duration_s=5.0,
                        obs=bundles["obs"][0].tolist(), timeout_s=60.0)
        assert load["errors"] == 0 and load["shed"] == 0, load
        _wait(lambda: (f.router.counters.get("fleet_wedge_kills_total")
                       and f.slots[0].state == "up"), 120, "the wedge's escalation")
        assert "chaos_wedge_replica" in [e["event"] for e in f.events]
    finally:
        f.shutdown()
