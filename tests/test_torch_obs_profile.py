"""The port's performance-attribution layer against the JAX package's.

``estorch_tpu_torch/obs/profile`` against ``estorch_tpu/obs/profile`` on
the same inputs, exact unless a test says otherwise: the cost model over a
grid of configurations, ``profile_records`` and ``format_profile`` on
seeded records under four rooflines, the compile ledger and the hub's
``compile_event``, and the first record's ``cost_model`` of a small ES on
the standard, streamed, decomposed bf16, low-rank and host backends equal
to the JAX ES's.  The H100 roofline is chosen for its card and refused
for any other; the port's compiles (the native libraries' first loads) are
recorded once, by the ES whose engine loaded them; ``obs/trace.py`` writes
a torch.profiler trace; the ``profile`` CLI's exit codes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from estorch_tpu import ES as JES
from estorch_tpu import JaxAgent
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu.envs import Pendulum as JPendulum
from estorch_tpu.obs import spans as jspans
from estorch_tpu.obs.profile import costmodel as jcost
from estorch_tpu.obs.profile import ledger as jledger
from estorch_tpu.obs.profile import report as jreport
from estorch_tpu.obs.profile import roofline as jroof
from estorch_tpu.parallel import population_mesh
from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, Pendulum, adam
from estorch_tpu_torch.obs import __main__ as tcli
from estorch_tpu_torch.obs import spans as tspans
from estorch_tpu_torch.obs.profile import costmodel as tcost
from estorch_tpu_torch.obs.profile import ledger as tledger
from estorch_tpu_torch.obs.profile import report as treport
from estorch_tpu_torch.obs.profile import roofline as troof
from estorch_tpu_torch.obs.trace import annotate, timed_generations, trace
from estorch_tpu_torch.ops import _build
from test_scheduler import QuadAgent, TinyPolicy

REPO = Path(__file__).resolve().parents[1]
PENDULUM_8X8 = {"action_dim": 1, "hidden": (8, 8), "discrete": False, "action_scale": 2.0}
SHAPES = [(3, 64), (64, 64), (64, 1)]
PARAM_DIM = sum(m * n for m, n in SHAPES) + 64 + 64 + 1


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mirrored", [True, False])
@pytest.mark.parametrize("low_rank", [0, 1, 4])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_generation_cost_equals_jax(mirrored, low_rank, dtype_bytes):
    """Every horizon, episode count, noise kind and mesh of the grid gives
    JAX's dict, and ``phase_cost_for`` JAX's cost of every phase."""
    for horizon in (200, None):
        for episodes in (1, 3):
            for noise in ("table", "program"):
                for n_devices, model_shards in ((1, 1), (8, 1), (4, 2)):
                    kw = dict(population=4096, matmul_shapes=SHAPES, param_dim=PARAM_DIM,
                              horizon=horizon, episodes_per_member=episodes,
                              mirrored=mirrored, low_rank=low_rank, dtype_bytes=dtype_bytes,
                              noise=noise, n_devices=n_devices, model_shards=model_shards)
                    t, j = tcost.generation_cost(**kw), jcost.generation_cost(**kw)
                    assert t == j, kw
                    for phase in ("eval", "sample", "update", "device", "dispatch",
                                  "host_sync", "record"):
                        for steps, gens in ((819_200, 1), (3_276_800, 4), (17, 3)):
                            assert (tcost.phase_cost_for(t, phase, env_steps=steps,
                                                         n_generations=gens)
                                    == jcost.phase_cost_for(j, phase, env_steps=steps,
                                                            n_generations=gens))
    assert tcost.FUSED_PHASES == jcost.FUSED_PHASES
    assert tcost.MODELED_PHASES == jcost.MODELED_PHASES
    assert tcost.COST_MODEL_SCHEMA == jcost.COST_MODEL_SCHEMA
    assert tcost.lowrank_noise_dim(SHAPES, 2, PARAM_DIM) == jcost.lowrank_noise_dim(
        SHAPES, 2, PARAM_DIM)
    assert tcost.matmul_flops(SHAPES) == jcost.matmul_flops(SHAPES)


def test_compiled_cost_facts_are_empty_for_what_the_port_builds():
    """The duck-typed contract: objects without ``cost_analysis()`` /
    ``memory_analysis()`` (a ctypes library, a path) give ``{}``; one with
    them gives JAX's facts."""

    class Compiled:
        def cost_analysis(self):
            return [{"flops": 12.0, "bytes accessed": 40.0}]

        def memory_analysis(self):
            return type("M", (), {"argument_size_in_bytes": 8, "output_size_in_bytes": 4,
                                  "temp_size_in_bytes": 0})()

    for obj in (object(), Path("lib.so"), None, 3):
        assert tcost.compiled_cost_facts(obj) == {} == jcost.compiled_cost_facts(obj)
    assert tcost.compiled_cost_facts(Compiled()) == jcost.compiled_cost_facts(Compiled())
    assert tcost.compiled_cost_facts(Compiled())["xla_flops"] == 12.0


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def test_h100_roofline_for_its_card_and_none_for_others():
    want = {"platform": "gpu", "basis": "h100_sxm_datasheet_f32",
            "peak_flops_per_s": 67e12, "peak_bytes_per_s": 3.35e12}
    assert troof.H100_SXM_ROOFLINE == want
    assert troof.platform_roofline("gpu", kind="NVIDIA H100 80GB HBM3") == want
    assert troof.platform_roofline("gpu", kind="NVIDIA H100 SXM5 80GB") == want
    rates_only = {"platform": "gpu", "basis": None, "peak_flops_per_s": None,
                  "peak_bytes_per_s": None}
    for kind in (None, "", "NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB",
                 "NVIDIA GeForce RTX 4090"):
        assert troof.platform_roofline("gpu", kind=kind) == rates_only, kind
    # without a kind the JAX package's honest answer for a card, and never
    # the host's calibrated CPU peaks
    assert troof.platform_roofline("gpu") == jroof.platform_roofline("gpu") == rates_only
    assert troof.platform_roofline("tpu") == jroof.platform_roofline("tpu")
    assert troof.TPU_V5E_ROOFLINE == jroof.TPU_V5E_ROOFLINE
    assert (troof.platform_roofline("cpu", measure=False)
            == jroof.platform_roofline("cpu", measure=False))
    cal = troof.measure_cpu_roofline(budget_s=0.02, gemm_n=64, copy_mb=1)
    assert cal["basis"] == "cpu_calibrated" and cal["peak_flops_per_s"] > 0


# ---------------------------------------------------------------------------
# profile report
# ---------------------------------------------------------------------------


def seeded_records(seed: int, n: int = 6) -> list[dict]:
    """A device-backend run's records: random phase seconds, a replayed
    generation, the cost model and compile events in the first record."""
    rng = np.random.default_rng(seed)
    model = jcost.generation_cost(population=4096, matmul_shapes=SHAPES, param_dim=PARAM_DIM,
                                  horizon=200)
    recs = []
    for g in range(n):
        phases = {"dispatch": float(rng.uniform(0.1, 0.5)), "device": float(rng.uniform(0, .05)),
                  "host_sync": float(rng.uniform(0, 1e-3)), "record": float(rng.uniform(0, 1e-3)),
                  "record/best": float(rng.uniform(0, 1e-4))}
        wall = sum(v for k, v in phases.items() if "/" not in k)
        steps = int(rng.integers(700_000, 819_201))
        rec = {"generation": g, "env_steps": steps, "env_steps_per_sec": steps / wall,
               "wall_time_s": wall, "reward_mean": float(rng.normal()), "reward_max": 1.0,
               "best_reward": 1.0, "n_failed": 0, "phases": phases}
        if g == 0:
            rec["cost_model"] = model
            rec["compile_events"] = [
                {"program": "noise_kernels", "compile_s": float(rng.uniform(0, 3)),
                 "generation": 0, "cached": False, "library": "libestorch_noise_kernels-x.so"},
                {"program": "generation_step", "compile_s": 2.5, "generation": 0,
                 "xla_flops": float(rng.uniform(1e9, 1e10)), "peak_bytes": 1.5e9}]
        recs.append(json.loads(json.dumps(rec)))
    recs.append(dict(recs[2]))  # a supervisor replay: the last occurrence wins
    return recs


@pytest.mark.parametrize("roof", ["synthetic", "h100", "tpu", "rates_only"])
def test_profile_records_and_format_equal_jax(roof):
    roofline = {"synthetic": {"platform": "synthetic", "basis": "test",
                              "peak_flops_per_s": 1e12, "peak_bytes_per_s": 1e11},
                "h100": troof.H100_SXM_ROOFLINE,
                "tpu": troof.TPU_V5E_ROOFLINE,
                "rates_only": troof.platform_roofline("gpu")}[roof]
    for seed in range(3):
        recs = seeded_records(seed)
        t, j = treport.profile_records(recs, roofline), jreport.profile_records(recs, roofline)
        assert t == j
        assert treport.format_profile(t) == jreport.format_profile(j)
        assert treport.find_cost_model(recs) == jreport.find_cost_model(recs)
        assert treport._dedup_replays(recs) == jreport._dedup_replays(recs)
    bare = [{k: v for k, v in r.items() if k not in ("cost_model", "compile_events", "phases")}
            for r in seeded_records(9)]
    for recs in (bare, [], seeded_records(4)[:1]):
        t, j = treport.profile_records(recs, roofline), jreport.profile_records(recs, roofline)
        assert t == j and treport.format_profile(t) == jreport.format_profile(j)


def test_profile_of_an_h100_run_reports_shares():
    """The device phase of a card run is rated against the data sheet: its
    shares are the modeled cost over the phase seconds over the peaks."""
    recs = seeded_records(5)
    p = treport.profile_records(recs, troof.H100_SXM_ROOFLINE)
    dedup = treport._dedup_replays(recs)
    secs = sum(r["phases"]["device"] for r in dedup)
    cost = tcost.phase_cost_for(recs[0]["cost_model"], "device",
                                env_steps=sum(r["env_steps"] for r in dedup),
                                n_generations=len(dedup))
    row = p["phases"]["device"]
    assert p["basis"] == "h100_sxm_datasheet_f32"
    assert row["mfu"] == pytest.approx(cost["flops"] / secs / 67e12, rel=1e-12)
    assert row["bw_util"] == pytest.approx(cost["bytes"] / secs / 3.35e12, rel=1e-12)
    assert "mfu" not in p["phases"]["dispatch"]  # no modeled cost


def test_profile_selfcheck_is_clean():
    assert treport.selfcheck() == [] == jreport.selfcheck()


# ---------------------------------------------------------------------------
# compile ledger and the hub
# ---------------------------------------------------------------------------


def test_ledger_and_compile_event_equal_jax():
    """The same compile events give the same ledger entries, flat gauges,
    counters and flushes in both hubs."""
    th, jh = tspans.Telemetry(), jspans.Telemetry()
    for hub in (th, jh):
        hub.compile_event("noise_kernels", 1.2345678, cached=False, library="lib-a.so")
        hub.take_phases()
        hub.compile_event("envpool", 0.25, cached=True, library="libenvpool-b.so",
                          count_recompiles=0)
    assert th.compile_ledger.entries() == jh.compile_ledger.entries()
    assert th.counters.snapshot().keys() == jh.counters.snapshot().keys()
    for k, v in jh.counters.snapshot().items():
        if k != "peak_rss_mb":
            assert th.counters.get(k) == v, k
    assert th.take_compile_events() == jh.take_compile_events()
    assert th.take_compile_events() == [] == jh.take_compile_events()
    entries = th.compile_ledger.entries()
    assert tledger.ledger_counters(entries) == jledger.ledger_counters(entries)
    assert (tledger.collect_compile_events([{"compile_events": entries}, {}, "x"])
            == jledger.collect_compile_events([{"compile_events": entries}, {}, "x"]))
    assert (tledger.LEDGER_SCHEMA, tledger._FACT_PREFIX) == (jledger.LEDGER_SCHEMA,
                                                             jledger._FACT_PREFIX)
    off = tspans.Telemetry(enabled=False)
    assert off.compile_event("x", 1.0) is None and off.take_compile_events() == []
    off.set_cost_model({"a": 1})
    assert off.cost_model is None


def test_observe_with_exemplars_equals_jax():
    th, jh = tspans.Telemetry(), jspans.Telemetry()
    rng = np.random.default_rng(3)
    for i, v in enumerate(rng.exponential(0.01, 600)):
        for hub in (th, jh):
            hub.observe("lat", float(v), exemplar=f"t{i}" if i % 7 == 0 else None)
    assert th.hists.snapshot() == jh.hists.snapshot()
    assert th.hists.get("lat").slow_exemplars(0.9) == jh.hists.get("lat").slow_exemplars(0.9)


# ---------------------------------------------------------------------------
# ES: the cost model in the first record, and the port's compiles
# ---------------------------------------------------------------------------


def _pendulum_pair(**over):
    kw = dict(population_size=16, sigma=0.05, seed=0, policy_kwargs=PENDULUM_8X8,
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16)
    kw.update(over)
    jes = JES(JMLPPolicy, JaxAgent(JPendulum(), horizon=20), optax.adam,
              mesh=population_mesh(jax.devices()[:1]), telemetry=True, **kw)
    tes = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, device="cpu",
             telemetry=True, **kw)
    return jes, tes


@pytest.mark.parametrize("path", ["standard", "streamed", "decomposed_bf16", "low_rank_1",
                                  "host"])
def test_es_cost_model_in_record_0_equals_jax(path):
    if path == "host":
        kw = dict(population_size=16, sigma=0.05, seed=0, optimizer_kwargs={"lr": 1e-2},
                  table_size=1 << 12, telemetry=True)
        jes = JES(TinyPolicy, QuadAgent, torch.optim.Adam, **kw)
        tes = ES(TinyPolicy, QuadAgent, torch.optim.Adam, device="cpu", **kw)
    else:
        over = {"standard": {}, "streamed": {"streamed": True, "noise_kernel": True},
                "decomposed_bf16": {"decomposed": True, "compute_dtype": "bfloat16"},
                "low_rank_1": {"low_rank": 1}}[path]
        jes, tes = _pendulum_pair(**over)
    assert jes.obs.cost_model is not None
    tes.train(2, verbose=False)
    assert tes.history[0]["cost_model"] == jes.obs.cost_model
    assert "cost_model" not in tes.history[1]
    assert "compile_events" not in tes.history[0]  # nothing native loaded on the CPU path
    assert tes.compile_time_s == 0.0


def test_no_cost_model_when_the_hub_is_off():
    tes = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=5), adam, device="cpu",
             population_size=8, policy_kwargs=PENDULUM_8X8, table_size=1 << 12,
             optimizer_kwargs={"learning_rate": 1e-2}, telemetry=False)
    tes.train(1, verbose=False)
    assert tes.obs.cost_model is None and "cost_model" not in tes.history[0]


def test_a_library_load_is_recorded_once_by_the_es_that_caused_it():
    """A load noted while an ES trains lands in its next record (cached,
    library, seconds) and in ``compile_time_s``; a second ES built later
    records none, and a load from before an ES existed is nobody's."""
    _build.note_library_load("noise_kernels_before", 9.0, 0.5, False, Path("/x/early.so"))
    a = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=5), adam, device="cpu",
           population_size=8, policy_kwargs=PENDULUM_8X8, table_size=1 << 12,
           optimizer_kwargs={"learning_rate": 1e-2})
    a.train(1, verbose=False)
    _build.note_library_load("noise_kernels_test", 1.5, 0.25, False, Path("/x/lib-test.so"))
    b = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=5), adam, device="cpu",
           population_size=8, policy_kwargs=PENDULUM_8X8, table_size=1 << 12,
           optimizer_kwargs={"learning_rate": 1e-2})
    a.train(1, verbose=False)
    b.train(1, verbose=False)
    assert "compile_events" not in a.history[0]
    ev = a.history[1]["compile_events"]
    assert ev == [{"program": "noise_kernels_test", "compile_s": 1.75, "generation": 1,
                   "cached": False, "library": "lib-test.so"}]
    assert a.compile_time_s == 1.75
    assert a.obs.counters.get("compile_s_noise_kernels_test") == 1.75
    assert a.obs.counters.get("recompiles") == 1
    assert "compile_events" not in b.history[0] and b.compile_time_s == 0.0
    stats = timed_generations(a, n=1, warmup=0)
    assert stats["compile_time_s"] == 1.75 and stats["generations"] == 1


def test_envpool_load_rides_a_fresh_process_first_record(tmp_path):
    """In a fresh process the pooled ES's engine loads the envpool: its
    first record carries the ``envpool`` compile event."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from estorch_tpu_torch import ES, MLPPolicy, PooledAgent, adam\n"
        "es = ES(MLPPolicy, PooledAgent('cartpole', horizon=10), adam, device='cpu',\n"
        "        population_size=8, table_size=1 << 12, telemetry=True,\n"
        "        optimizer_kwargs={'learning_rate': 1e-2},\n"
        "        policy_kwargs={'action_dim': 2, 'hidden': (8,)})\n"
        "es.train(1, verbose=False)\n"
        "print(json.dumps({'ev': es.history[0].get('compile_events'),\n"
        "                  'cs': es.compile_time_s}))\n")
    env = dict(os.environ, ESTORCH_OBS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    (ev,) = got["ev"]
    assert ev["program"] == "envpool" and isinstance(ev["cached"], bool)
    assert ev["library"].startswith("libenvpool-") and ev["library"].endswith(".so")
    assert ev["generation"] == 0 and got["cs"] == pytest.approx(ev["compile_s"], abs=1e-6)


# ---------------------------------------------------------------------------
# obs/trace.py on torch.profiler, and the profile CLI
# ---------------------------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        with annotate("my_phase"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = list((tmp_path / "tr").glob("*.pt.trace.json"))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "my_phase" in names and any(str(n).startswith("aten::") for n in names)


def test_profile_cli_exit_codes(tmp_path, capsys):
    recs = seeded_records(7)
    jsonl = tmp_path / "run.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in recs) + '{"generation": 9, "env')
    (tmp_path / "manifest.json").write_text(json.dumps(
        {"schema": 1, "devices": [{"id": 0, "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                                   "process_index": 0}]}))
    assert tcli.main(["profile", str(jsonl), "--json"]) == 0
    p = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert p["basis"] == "h100_sxm_datasheet_f32" and p["platform"] == "gpu"
    assert p == jreport.profile_records(recs, troof.H100_SXM_ROOFLINE)
    (tmp_path / "manifest.json").write_text(json.dumps(
        {"schema": 1, "devices": [{"platform": "gpu", "kind": "NVIDIA A100-SXM4-80GB"}]}))
    assert tcli.main(["profile", str(jsonl), "--json"]) == 0
    p = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert p["basis"] is None and "mfu" not in p["phases"]["device"]
    assert tcli.main(["profile", str(jsonl), "--platform", "cpu"]) == 0
    assert "cpu_calibrated" in capsys.readouterr().out
    assert tcli.main(["profile", "--selfcheck"]) == 0
    assert tcli.main(["profile"]) == 3
    assert tcli.main(["profile", str(tmp_path / "missing.jsonl")]) == 1
    with pytest.raises(SystemExit):
        tcli.main(["profile", str(jsonl), "--platform", "mps"])
