"""The port's span and counter hub against the JAX package's.

``estorch_tpu_torch/obs`` against ``estorch_tpu/obs``: counters and
histogram quantiles equal for the same observations (the exact small-N
path, the bucket path, the staleness ladder), snapshots that cross between
the packages, span names clean across two threads, a disabled hub that
swallows writes, the environment protocol, and, for small device, host,
pooled, novelty and IW-ES runs, records whose ``phases`` keys equal the
JAX package's and that pass its ``validate_record``.
"""

import json
import math
import os
import random
import threading

import jax
import numpy as np
import optax
import pytest
import torch

from estorch_tpu import ES as JES
from estorch_tpu import IW_ES as JIW_ES
from estorch_tpu import NSR_ES as JNSR_ES
from estorch_tpu import JaxAgent
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu import PooledAgent as JPooledAgent
from estorch_tpu.envs import CartPole as JCartPole
from estorch_tpu.obs import counters as jcounters
from estorch_tpu.obs import hist as jhist
from estorch_tpu.obs import spans as jspans
from estorch_tpu.obs.summarize import validate_record
from estorch_tpu.parallel import population_mesh
from estorch_tpu_torch import (ES, IW_ES, NSR_ES, CartPole, DeviceAgent, MLPPolicy, PooledAgent,
                               adam)
from estorch_tpu_torch import obs as tobs
from estorch_tpu_torch.obs import hist as thist
from estorch_tpu_torch.obs import summarize as tsummarize
from test_scheduler import QuadAgent, TinyPolicy

CARTPOLE_POLICY = {"action_dim": 2, "hidden": (8,)}
PENDULUM_POLICY = {"action_dim": 1, "hidden": (8,), "discrete": False, "action_scale": 2.0}


# ---------------------------------------------------------------------------
# counters and histograms
# ---------------------------------------------------------------------------


def test_counters_equal_jax():
    t, j = tobs.Counters(), jcounters.Counters()
    for c in (t, j):
        c.inc("env_steps", 200)
        c.inc("env_steps", 55)
        c.inc("generations")
        c.gauge("overlap_efficiency", 0.75)
        c.gauge("overlap_efficiency", 0.5)
    assert t.snapshot() == j.snapshot()
    assert t.get("missing", -1) == j.get("missing", -1) == -1
    assert t.sample_peak_rss() > 0 and "peak_rss_mb" in t.snapshot()


def _observe_both(values, n=1, **ladder):
    t, j = thist.Histogram(**ladder), jhist.Histogram(**ladder)
    for v in values:
        t.observe(v, n)
        j.observe(v, n)
    return t, j


QUANTILES = (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0)


@pytest.mark.parametrize("case", ["small", "bucket", "staleness", "edges", "weighted"])
def test_histogram_quantiles_equal_jax(case):
    rng = random.Random(0)
    if case == "small":  # the exact path: nearest rank
        t, j = _observe_both([rng.uniform(1e-4, 1e-1) for _ in range(100)])
    elif case == "bucket":  # past the exact cap: geometric bucket midpoints
        t, j = _observe_both([rng.expovariate(100.0) for _ in range(5000)])
        assert t._exact is None
    elif case == "staleness":  # the scheduler's small-integer ladder
        t, j = _observe_both([rng.randint(0, 20) for _ in range(400)], lo=0.5, decades=4,
                             per_decade=3)
    elif case == "edges":  # underflow, overflow, exact edges, non-finite dropped
        vals = [0.0, 1e-7, 1e-5, 1e3, 5e5, float("nan"), float("inf")]
        vals += [1e-5 * 10 ** (k / 12) for k in range(96)] * 3
        t, j = _observe_both(vals)
    else:  # weighted observations past the cap
        t, j = _observe_both([rng.uniform(0.01, 10.0) for _ in range(40)], n=9)
    assert (t.count, t.sum) == (j.count, j.sum)
    for q in QUANTILES:
        tq, jq = t.quantile(q), j.quantile(q)
        assert tq == jq or (math.isnan(tq) and math.isnan(jq)), q
    assert t.to_dict() == j.to_dict()


def test_histogram_snapshots_cross_packages():
    """The port's snapshots load in the JAX package and give its quantiles;
    the registries agree name for name."""
    rng = random.Random(1)
    vals = [rng.expovariate(10.0) for _ in range(700)]
    reg_t, reg_j = tobs.Histograms(), jhist.Histograms()
    for v in vals:
        reg_t.observe("async/eval_s", v)
        reg_j.observe("async/eval_s", v)
        reg_t.observe("async/staleness", int(v * 30), lo=0.5, decades=4, per_decade=3)
        reg_j.observe("async/staleness", int(v * 30), lo=0.5, decades=4, per_decade=3)
    assert reg_t.snapshot() == reg_j.snapshot()
    assert reg_t.snapshot(compact=True) == reg_j.snapshot(compact=True)
    for name, snap in reg_t.snapshot(compact=True).items():
        back = jhist.Histogram.from_dict(json.loads(json.dumps(snap)))
        for q in QUANTILES:
            assert back.quantile(q) == reg_j.get(name).quantile(q)
    assert reg_t.quantile("async/eval_s", 0.99) == reg_j.quantile("async/eval_s", 0.99)
    assert reg_t.quantile("absent", 0.5) is None


# ---------------------------------------------------------------------------
# the hub
# ---------------------------------------------------------------------------


def test_span_names_clean_across_threads():
    """Two threads nest spans at once; per-thread stacks keep the names."""
    hub = tobs.Telemetry()
    barrier = threading.Barrier(2)

    def work(outer, inner):
        for _ in range(20):
            with hub.phase(outer):
                barrier.wait()
                with hub.phase(inner):
                    barrier.wait()

    threads = [threading.Thread(target=work, args=a)
               for a in (("async", "dispatch"), ("eval", "sample"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert set(hub.take_phases()) == {"async", "async/dispatch", "eval", "eval/sample"}
    assert hub.hists.get("phase/eval/sample").count == 20


def test_disabled_hub_swallows_writes(monkeypatch):
    for hub in (tobs.NULL_TELEMETRY, tobs.Telemetry(enabled=False),
                tobs.resolve_telemetry(False)):
        hub.counters.inc("env_steps", 5)
        hub.counters.gauge("g", 1.0)
        hub.hists.observe("h", 1.0)
        with hub.phase("eval"):
            pass
        hub.event("x")
        assert hub.counters.snapshot() == {}
        assert hub.hists.snapshot() == {}
        assert hub.take_phases() == {}
        assert len(hub.recorder) == 0
    monkeypatch.setenv(tobs.OBS_DISABLE_ENV, "0")
    assert not tobs.resolve_telemetry(None).enabled
    assert not jspans.resolve_telemetry(None).enabled
    monkeypatch.delenv(tobs.OBS_DISABLE_ENV)
    assert tobs.resolve_telemetry(None).enabled
    hub = tobs.Telemetry()
    assert tobs.resolve_telemetry(hub) is hub
    with pytest.raises(TypeError, match="telemetry must be"):
        tobs.resolve_telemetry("on")


def test_heartbeat_env_and_rejection_discards_spans(monkeypatch, tmp_path):
    path = str(tmp_path / "hb.json")
    monkeypatch.setenv(tobs.HEARTBEAT_ENV, path)
    hub = tobs.resolve_telemetry(None)
    with hub.trace_ctx("d3"), hub.phase("async"):
        hub.event("async_dispatch", dispatch=3)
    beat = json.load(open(path))
    assert beat["phase"] == "async" and beat["generation"] == 0
    assert hub.recorder.events()[0]["trace"] == "d3"
    hub.discard_phases()
    with hub.phase("eval"):
        pass
    assert set(hub.take_phases()) == {"eval"}
    assert json.load(open(path))["phase"] == "between_generations"
    assert hub.counters.get("generations") == 1


# ---------------------------------------------------------------------------
# records against the JAX package's
# ---------------------------------------------------------------------------


def _mesh():
    return population_mesh(jax.devices()[:1])


def _device_kw(**kw):
    base = dict(population_size=16, sigma=0.1, seed=3, policy_kwargs=CARTPOLE_POLICY,
                optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 15)
    base.update(kw)
    return base


def _phase_keys(es) -> set:
    return {k for r in es.history for k in r["phases"]}


def _check_records(tes, jes) -> None:
    assert _phase_keys(tes) == _phase_keys(jes)
    for r in tes.history:
        assert "phases" in r
        assert validate_record(json.loads(json.dumps(r))) == []
        assert tsummarize.validate_record(json.loads(json.dumps(r))) == []


def test_device_records_match_jax():
    jes = JES(JMLPPolicy, JaxAgent, optax.adam, mesh=_mesh(),
              agent_kwargs={"env": JCartPole(), "horizon": 20}, **_device_kw())
    tes = ES(MLPPolicy, DeviceAgent(CartPole(), horizon=20), adam, device="cpu", **_device_kw())
    jes.train(2, verbose=False)
    tes.train(2, verbose=False)
    _check_records(tes, jes)
    assert _phase_keys(tes) == {"dispatch", "device", "host_sync", "record"}
    assert tes.obs.counters.get("env_steps") == sum(r["env_steps"] for r in tes.history)


def test_host_records_match_jax():
    kw = dict(population_size=8, sigma=0.05, seed=0, optimizer_kwargs={"lr": 0.05},
              table_size=1 << 12)
    jes = JES(TinyPolicy, QuadAgent, torch.optim.Adam, **kw)
    tes = ES(TinyPolicy, QuadAgent, torch.optim.Adam, device="cpu", **kw)
    jes.train(2, verbose=False)
    tes.train(2, verbose=False)
    _check_records(tes, jes)
    jes.train_async(2, verbose=False)
    tes.train_async(2, verbose=False)
    _check_records(tes, jes)
    assert tes.obs.counters.get("async_updates") == jes.obs.counters.get("async_updates") == 2


def test_pooled_records_match_jax():
    kw = _device_kw(policy_kwargs=PENDULUM_POLICY, obs_norm=True)
    jes = JES(JMLPPolicy, JPooledAgent("pendulum", horizon=20), optax.adam, mesh=_mesh(), **kw)
    tes = ES(MLPPolicy, PooledAgent("pendulum", horizon=20), adam, device="cpu", **kw)
    jes.train(2, verbose=False)
    tes.train(2, verbose=False)
    _check_records(tes, jes)
    assert "update/obsnorm_merge" in _phase_keys(tes)


def test_novelty_and_iwes_records_match_jax():
    agent_kw = {"env": JCartPole(), "horizon": 20}
    jns = JNSR_ES(JMLPPolicy, JaxAgent, optax.adam, mesh=_mesh(), agent_kwargs=agent_kw,
                  meta_population_size=2, k=3, **_device_kw())
    tns = NSR_ES(MLPPolicy, DeviceAgent(CartPole(), horizon=20), adam, device="cpu",
                 meta_population_size=2, k=3, **_device_kw())
    jns.train(2, verbose=False)
    tns.train(2, verbose=False)
    _check_records(tns, jns)
    iw = dict(reuse_window=1, ess_min=1e-6)
    jiw = JIW_ES(JMLPPolicy, JaxAgent, optax.adam, mesh=_mesh(), agent_kwargs=agent_kw, **iw,
                 **_device_kw())
    tiw = IW_ES(MLPPolicy, DeviceAgent(CartPole(), horizon=20), adam, device="cpu", **iw,
                **_device_kw())
    jiw.train(2, verbose=False)
    tiw.train(2, verbose=False)
    _check_records(tiw, jiw)
    assert {"reuse_ratios", "sample"} <= _phase_keys(tiw)


def test_rejection_counts_and_keeps_phases_clean():
    """A collapsed generation (every member NaN) is rejected: counted, its
    spans dropped, the re-run's record carrying one generation's spans."""
    es = ES(TinyPolicy, QuadAgent, torch.optim.Adam, device="cpu", population_size=8,
            sigma=0.05, seed=0, optimizer_kwargs={"lr": 0.05}, table_size=1 << 12)
    calls = {"n": 0}
    evaluate = es.engine.evaluate

    def flaky(state, offs=None):
        ev = evaluate(state, offs=offs)
        calls["n"] += 1
        return ev._replace(fitness=np.full_like(ev.fitness, np.nan)) if calls["n"] == 1 else ev

    es.engine.evaluate = flaky
    es.train(1, verbose=False)
    assert es.obs.counters.get("generations_rejected") == 1
    assert es.obs.recorder.events()[-1]["kind"] == "span"
    assert any(e["name"] == "generation_rejected" for e in es.obs.recorder.events())
    assert es.obs.counters.get("generations") == 1
    assert np.isfinite(list(es.history[0]["phases"].values())).all()


# ---------------------------------------------------------------------------
# sinks, manifest, heartbeat reader and the summarizer
# ---------------------------------------------------------------------------


def _port_device_es(**kw):
    return ES(MLPPolicy, DeviceAgent(CartPole(), horizon=20), adam, device="cpu",
              **_device_kw(**kw))


def _jax_device_es(**kw):
    return JES(JMLPPolicy, JaxAgent, optax.adam, mesh=_mesh(),
               agent_kwargs={"env": JCartPole(), "horizon": 20}, **_device_kw(**kw))


def test_sinks_round_trip(tmp_path):
    """JsonlSink appends what JsonlSink.read and the JAX package's reader
    give back; MultiSink fans out and echoes; TensorBoardSink writes
    scalars (or raises JAX's ImportError where tensorboard is missing)."""
    from estorch_tpu.obs.sinks import JsonlSink as JJsonlSink

    from estorch_tpu_torch.obs import JsonlSink, MultiSink, TensorBoardSink

    es = _port_device_es()
    path = str(tmp_path / "run.jsonl")
    sink = JsonlSink(path)
    seen = []
    es.train(2, log_fn=MultiSink([sink, seen.append], echo=True))
    sink.close()
    back = JsonlSink.read(path)
    assert back == JJsonlSink.read(path) == json.loads(json.dumps(seen))
    assert [r["generation"] for r in back] == [0, 1]
    try:
        tb = TensorBoardSink(str(tmp_path / "tb"))
    except ImportError as e:
        assert "tensorboard" in str(e)
    else:
        for r in seen:
            tb(r)
        tb.close()
        assert os.listdir(tmp_path / "tb")


def test_manifest_has_the_jax_keys(tmp_path):
    """The port's manifest has the JAX package's schema and keys, with
    ``torch``/``cuda`` where JAX writes ``jax``; ``run_manifest``'s config
    has JAX's keys and values for the same ES; the device entry is
    ``{"id", "platform", "kind", "process_index"}``; a wrong schema raises."""
    from estorch_tpu.obs import manifest as jmanifest

    from estorch_tpu_torch.obs import manifest as tmanifest

    t = _port_device_es().run_manifest()
    j = _jax_device_es().run_manifest()
    assert set(t) - {"torch", "cuda"} == set(j) - {"jax"}
    assert t["schema"] == j["schema"] == tmanifest.MANIFEST_SCHEMA
    assert t["config"] == j["config"]
    assert set(t["devices"][0]) == set(j["devices"][0])
    assert t["devices"] == [{"id": 0, "platform": "cpu", "kind": "cpu", "process_index": 0}]
    path = tmanifest.write_manifest(str(tmp_path / "m.json"), t)
    assert tmanifest.load_manifest(path) == jmanifest.load_manifest(path) == json.loads(
        json.dumps(t))
    json.dump({"schema": 99}, open(path, "w"))
    with pytest.raises(ValueError, match="manifest schema 99"):
        tmanifest.load_manifest(path)
    host = ES(TinyPolicy, QuadAgent, torch.optim.Adam, device="cpu", population_size=8,
              optimizer_kwargs={"lr": 0.05}, table_size=1 << 12).run_manifest()
    jhost = JES(TinyPolicy, QuadAgent, torch.optim.Adam, population_size=8,
                optimizer_kwargs={"lr": 0.05}, table_size=1 << 12).run_manifest()
    assert host["config"] == jhost["config"]


def test_read_and_describe_heartbeat_equal_jax(tmp_path):
    from estorch_tpu.obs import recorder as jrecorder

    from estorch_tpu_torch.obs import recorder as trecorder

    path = str(tmp_path / "hb.json")
    assert trecorder.read_heartbeat(path) is None
    assert trecorder.describe_heartbeat(path) == jrecorder.describe_heartbeat(path)
    trecorder.Heartbeat(path).beat("eval", 7, {"env_steps": 3})
    t, j = trecorder.read_heartbeat(path), jrecorder.read_heartbeat(path)
    assert set(t) == set(j) and t["phase"] == "eval" and t["generation"] == 7
    assert 0 <= t["age_s"] < 60
    assert trecorder.describe_heartbeat(path) == "last phase=eval gen=7 heartbeat 0s ago"
    assert trecorder.STALE_AFTER_S == jrecorder.STALE_AFTER_S
    rec = trecorder.FlightRecorder(capacity=2)
    assert rec.last() is None
    for i in range(3):
        rec.add("event", f"e{i}")
    assert rec.last()["name"] == "e2"
    ring = str(tmp_path / "ring.jsonl")
    open(ring, "w").write('{"kind": "event", "name": "old"}\n{"torn')
    rec.dump_jsonl(ring)
    assert [e["name"] for e in map(json.loads, open(ring))] == ["old", "e1", "e2"]


def _write_jsonl(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r, default=float) + "\n")


def test_summarize_equals_jax_on_port_and_jax_runs(tmp_path):
    """For a port run's JSONL (sync and async records), a JAX run's, and a
    supervised run's manifest: the port's ``summarize`` gives the JAX
    package's dict; both selfchecks are clean; every port record passes
    the port's ``validate_record``; a torn final line is dropped by both."""
    import importlib

    from estorch_tpu_torch.obs import summarize as tsum

    jsum = importlib.import_module("estorch_tpu.obs.summarize")  # the package exports a function

    assert tsum.selfcheck() == [] == jsum.selfcheck()
    tes = _port_device_es()
    tes.train(3, verbose=False)
    host = ES(TinyPolicy, QuadAgent, torch.optim.Adam, device="cpu", population_size=8,
              sigma=0.05, optimizer_kwargs={"lr": 0.05}, table_size=1 << 12)
    host.train_async(3, verbose=False)
    jes = _jax_device_es()
    jes.train(3, verbose=False)
    manifest = str(tmp_path / "manifest.json")
    json.dump({"resilience": {"restart_count": 1, "completed": True,
                              "restarts": [{"reason": "child died with exit code -9"}],
                              "counters": {"generations_rejected": 2,
                                           "generations_skipped": 1}}}, open(manifest, "w"))
    for name, records in (("port", tes.history), ("async", host.history),
                          ("jax", jes.history), ("replayed", tes.history + tes.history[1:])):
        path = str(tmp_path / f"{name}.jsonl")
        _write_jsonl(path, records)
        if name != "jax":
            for r in tsum.load_records(path):
                assert tsum.validate_record(r) == [], name
        loaded = tsum.load_records(path)
        assert loaded == jsum.load_records(path)
        for kw in ({}, {"manifest_path": manifest}):
            t, j = tsum.summarize(loaded, **kw), jsum.summarize(loaded, **kw)
            assert t == j, name
            assert tsum.format_summary(t) == jsum.format_summary(j), name
        with open(path, "a") as f:
            f.write('{"generation": 9, "rew')
        assert tsum.load_records_tolerant(path) == jsum.load_records_tolerant(path)
    assert "async" in tsum.summarize(host.history)


def test_cli_summarize(tmp_path):
    """``python -m estorch_tpu_torch.obs``: ``summarize --selfcheck``, a run
    with its heartbeat and manifest beside it (found without flags), the
    JSON form, ``trace``, and the JAX package's fleet subcommands (item 9)
    named as not ported."""
    import subprocess
    import sys

    from estorch_tpu_torch.obs import JsonlSink

    root = tmp_path / "run"
    root.mkdir()
    es = _port_device_es()
    sink = JsonlSink(str(root / "run.jsonl"))
    es.train(2, log_fn=sink)
    sink.close()
    es.write_manifest(str(root / "manifest.json"))
    tobs.Heartbeat(str(root / "heartbeat.json")).beat("eval", 2)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "estorch_tpu_torch.obs", *args], cwd=repo,
                              capture_output=True, text=True, timeout=120)

    out = cli("summarize", "--selfcheck")
    assert out.returncode == 0 and "obs selfcheck: OK" in out.stdout
    out = cli("summarize", str(root / "run.jsonl"))
    assert out.returncode == 0 and "generations      2" in out.stdout
    assert "heartbeat fresh: last phase=eval gen=2" in out.stdout
    out = cli("summarize", str(root / "run.jsonl"), "--json")
    assert json.loads(out.stdout)["generations"] == 2
    out = cli("trace", str(root / "run.jsonl"))  # ported with item 6b
    assert out.returncode == 0 and os.path.exists(root / "trace.json")
    out = cli("collect")
    assert out.returncode == 3 and "item 9" in out.stderr
