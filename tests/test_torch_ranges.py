"""The port's profiler ranges (``obs/trace.py`` ``annotate``): named
``estorch.<phase>`` ranges on the device path's phases while a profiler
collects, and one shared no-op otherwise."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from estorch_tpu_torch import ES, CartPole, DeviceAgent, MLPPolicy, adam
from estorch_tpu_torch.obs import trace as otrace
from estorch_tpu_torch.obs.spans import Telemetry

HORIZON, POPULATION, CHUNK = 6, 16, 4
GENERATION = ("sample", "eval", "rank", "update", "dispatch", "device", "host_sync", "record")


def _es(telemetry):
    return ES(MLPPolicy, DeviceAgent(CartPole(), horizon=HORIZON), adam, device="cpu",
              population_size=POPULATION, sigma=0.1, seed=3, eval_chunk=CHUNK,
              policy_kwargs={"action_dim": 2, "hidden": (8,)},
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 15,
              telemetry=telemetry)


def _ranges(fn) -> list[tuple[str, int, int]]:
    """The ``estorch.*`` ranges recorded while ``fn`` runs under the
    profiler: (name, start ns, end ns)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.name().startswith("estorch.")]


@pytest.mark.parametrize("telemetry", [True, False])
def test_a_generation_records_each_phase_once(telemetry):
    es = _es(telemetry)
    gens = 2
    got = _ranges(lambda: es.train(gens, verbose=False))
    names = [n for n, _, _ in got]
    for phase in GENERATION:
        assert names.count("estorch." + phase) == gens, phase
    chunks = POPULATION // CHUNK
    evals = [(s, e) for n, s, e in got if n == "estorch.eval"]
    for phase in ("forward", "step"):
        inner = [(s, e) for n, s, e in got if n == "estorch." + phase]
        assert len(inner) == gens * chunks * HORIZON
        for s, e in inner:
            assert any(es_ <= s and e <= ee for es_, ee in evals)
    assert set(names) == {"estorch." + p for p in GENERATION + ("forward", "step")}


def test_the_engine_phases_follow_one_another_inside_dispatch():
    es = _es(False)
    got = {n: (s, e) for n, s, e in _ranges(lambda: es.train(1, verbose=False))
           if n in {"estorch." + p for p in GENERATION}}
    order = [got["estorch." + p] for p in ("sample", "eval", "rank", "update")]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    d = got["estorch.dispatch"]
    assert d[0] <= order[0][0] and order[-1][1] <= d[1] <= got["estorch.device"][0]


def test_the_hub_keeps_its_phase_keys_under_the_profiler():
    es = _es(True)
    _ranges(lambda: es.train(2, verbose=False))
    es.train(1, verbose=False)
    assert [set(r["phases"]) for r in es.history] == [
        {"dispatch", "device", "host_sync", "record"}] * 3


def test_off_trace_annotate_is_one_shared_no_op():
    assert not otrace.profiling()
    assert otrace.annotate("estorch.a") is otrace.annotate("estorch.b") is otrace.NULL_RANGE
    assert Telemetry(enabled=False).phase("dispatch") is otrace.NULL_RANGE
    with profile(activities=[ProfilerActivity.CPU]):
        assert otrace.profiling()
        assert otrace.annotate("estorch.a") is not otrace.NULL_RANGE
        assert Telemetry(enabled=False).phase("dispatch") is not otrace.NULL_RANGE


def test_a_range_is_no_user_annotation():
    """A user annotation would be copied onto the card's timeline, where it
    reads as device work; the ranges are ordinary record functions."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = otrace.annotate("estorch.x")
        for _ in range(3):  # a range made once may be entered again
            with r:
                torch.ones(4).sum()
    got = [e for e in prof.events() if e.name == "estorch.x"]
    assert len(got) == 3 and not any(e.is_user_annotation for e in got)
