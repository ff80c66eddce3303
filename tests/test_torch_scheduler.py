"""The port's barrier-free generations against the JAX package's.

``estorch_tpu_torch/algo/scheduler.py`` against ``estorch_tpu/algo/
scheduler.py`` (the cases of ``tests/test_scheduler.py``, with the same
``TinyPolicy``/``QuadAgent``): a fold run's event log replays bit for bit
in the port, each package replays the other's log to its parameters
within ``CROSS_RTOL``, the fold of a mixed-staleness batch gives JAX's
gradient, the accounting holds, a rejected update keeps the center, and
the overlap scheduler equals ``train`` bit for bit.
"""

import json
import os
import time

import numpy as np
import optax
import pytest
import torch

from estorch_tpu import ES as JES
from estorch_tpu import JaxAgent
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu.algo import scheduler as jsched
from estorch_tpu.envs import CartPole as JCartPole
from estorch_tpu.obs.summarize import validate_record
from estorch_tpu.resilience import chaos as jchaos
from estorch_tpu_torch import ES, CartPole, DeviceAgent, MLPPolicy, adam
from estorch_tpu_torch.algo import scheduler as tsched
from estorch_tpu_torch.resilience import chaos as tchaos
from test_scheduler import QuadAgent, TinyPolicy

# a replay of the other package's log: the port's fold sums in the
# kernel's order, JAX's row by row in float32, so after 5 Adam updates
# the centers differ by float32 rounding: the largest difference over the
# largest parameter (measured 1.8e-7)
CROSS_RTOL = 1e-6
# the async block's mean λ is rounded to 4 places in both packages
LAMBDA_ATOL = 1e-4

STRAGGLERS = [
    {"kind": "straggler", "gen": 1, "member": 2, "sleep_s": 0.15, "jitter_s": 0.1},
    {"kind": "straggler", "gen": 3, "member": 0, "sleep_s": 0.1},
]


def _host_kw(**kw):
    base = dict(population_size=8, sigma=0.05, seed=0, optimizer_kwargs={"lr": 0.05},
                table_size=1 << 12)
    base.update(kw)
    return base


def make_host(**kw):
    return ES(TinyPolicy, QuadAgent, torch.optim.Adam, device="cpu", **_host_kw(**kw))


def make_jax_host(**kw):
    return JES(TinyPolicy, QuadAgent, torch.optim.Adam, **_host_kw(**kw))


@pytest.fixture
def chaos_env():
    """Set ``ESTORCH_CHAOS`` for both packages (each caches its plan)."""
    def set_plan(events):
        os.environ[tchaos.CHAOS_ENV] = json.dumps({"events": events})
        tchaos.reset_cache()
        jchaos.reset_cache()

    yield set_plan
    os.environ.pop(tchaos.CHAOS_ENV, None)
    tchaos.reset_cache()
    jchaos.reset_cache()


def assert_params_close(actual, desired) -> None:
    actual, desired = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    assert np.abs(actual - desired).max() <= CROSS_RTOL * np.abs(desired).max()


def params_bytes(es) -> bytes:
    return np.asarray(es.state.params_flat, np.float32).tobytes()


def async_blocks(es) -> list[dict]:
    return [r["async"] for r in es.history]


def assert_async_match(a_hist: list[dict], b_hist: list[dict]) -> None:
    assert len(a_hist) == len(b_hist)
    for a, b in zip(a_hist, b_hist):
        for key in ("consumed", "fresh", "folded", "max_staleness", "consumed_dispatches"):
            assert a[key] == b[key], key
        if a["mean_lambda"] is None:
            assert b["mean_lambda"] is None
        else:
            assert a["mean_lambda"] == pytest.approx(b["mean_lambda"], abs=LAMBDA_ATOL)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


def test_replay_bit_identical_and_matches_live(chaos_env):
    """A straggler run's log, JSON round-tripped, replays twice bit for bit,
    equal to the live run, history included."""
    chaos_env(STRAGGLERS)
    live = make_host()
    live.train_async(5, n_proc=2, verbose=False)
    log = json.loads(json.dumps(live.async_event_log.to_dict()))
    r1, r2 = make_host(), make_host()
    r1.train_async(5, replay=log, verbose=False)
    r2.train_async(5, replay=log, verbose=False)
    assert params_bytes(r1) == params_bytes(r2) == params_bytes(live)
    assert len(r1.history) == len(live.history) == 5
    for a, b in zip(live.history, r1.history):
        assert a["reward_mean"] == b["reward_mean"]
        assert a["async"]["folded"] == b["async"]["folded"]
    assert sum(r["async"]["folded"] for r in live.history) > 0  # stale results folded


def test_process_mode_replay_matches_live():
    es = make_host(worker_mode="process")
    try:
        es.train_async(4, n_proc=2, verbose=False)
        log = es.async_event_log.to_dict()
    finally:
        es.engine.close()
    r = make_host()  # replay is pure math: thread mode does
    r.train_async(4, replay=log, verbose=False)
    assert params_bytes(es) == params_bytes(r)


def test_port_replays_jax_log(chaos_env):
    """JAX's live fold run under stragglers, replayed by the port: JAX's
    parameters within CROSS_RTOL, the async blocks equal."""
    chaos_env(STRAGGLERS)
    jlive = make_jax_host()
    jlive.train_async(5, n_proc=2, verbose=False)
    log = json.loads(json.dumps(jlive.async_event_log.to_dict()))
    assert sum(r["async"]["folded"] for r in jlive.history) > 0
    r = make_host()
    r.train_async(5, replay=log, verbose=False)
    assert_params_close(r.state.params_flat.numpy(), jlive.state.params_flat)
    assert_async_match(async_blocks(r), async_blocks(jlive))
    for a, b in zip(r.history, jlive.history):
        assert a["reward_mean"] == b["reward_mean"]  # the logged fitness, ranked as logged


def test_jax_replays_port_log(chaos_env):
    chaos_env(STRAGGLERS)
    live = make_host()
    live.train_async(5, n_proc=2, verbose=False)
    log = json.loads(json.dumps(live.async_event_log.to_dict()))
    jr = make_jax_host()
    jr.train_async(5, replay=log, verbose=False)
    assert_params_close(jr.state.params_flat, live.state.params_flat.numpy())
    assert_async_match(async_blocks(jr), async_blocks(live))


def test_replay_validates_n_steps():
    es = make_host()
    es.train_async(2, verbose=False)
    with pytest.raises(ValueError, match="RECORDED schedule"):
        make_host().train_async(3, replay=es.async_event_log, verbose=False)


# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------


def _capture_grad(engine, store: list):
    apply_grad = engine.apply_grad

    def capture(state, grad):
        store.append(np.array(torch.as_tensor(grad).cpu(), np.float64)
                     if isinstance(grad, torch.Tensor) else np.array(grad, np.float64))
        return apply_grad(state, grad)

    engine.apply_grad = capture


def test_fold_batch_matches_jax():
    """A hand-made mixed-staleness batch: members of a dispatch two center
    versions old (σ 0.05) and of the current one (σ 0.045), with a NaN.
    The port's one-launch fold gives JAX's row-by-row gradient, the same
    mean λ and the same canonical order."""
    jes, tes = make_jax_host(), make_host()
    dim = tes.engine.dim
    rng = np.random.default_rng(3)
    p_old = np.asarray(jes.state.params_flat, np.float32)
    p_new = (p_old + rng.normal(0, 0.01, dim)).astype(np.float32)
    offs_old = tes.engine._pair_offsets(tes.state._replace(generation=5))
    offs_new = tes.engine._pair_offsets(tes.state._replace(generation=7))
    np.testing.assert_array_equal(offs_old, jes.engine._pair_offsets(
        jes.state._replace(generation=5)))
    jes.state = jes.state._replace(params_flat=p_new, sigma=0.045, generation=2)
    tes.state = tes.state._replace(params_flat=torch.from_numpy(p_new), sigma=0.045,
                                   generation=2)
    js, ts = jsched.GenerationScheduler(jes), tsched.GenerationScheduler(tes)
    js._sources = {5: jsched.Source(5, 0, p_old, 0.05, offs_old),
                   7: jsched.Source(7, 2, p_new, 0.045, offs_new)}
    ts._sources = {5: tsched.Source(5, 0, torch.from_numpy(p_old), 0.05, offs_old),
                   7: tsched.Source(7, 2, torch.from_numpy(p_new), 0.045, offs_new)}
    fit = rng.normal(-3, 1, 8).astype(np.float32)
    fit[4] = np.nan
    members = [(7, 3), (5, 0), (7, 1), (5, 5), (5, 2), (7, 6), (5, 7), (7, 0)]
    jgrads, tgrads = [], []
    _capture_grad(jes.engine, jgrads)
    _capture_grad(tes.engine, tgrads)
    jb = [jsched.Arrival(d, i, float(f), 1, 0.0) for (d, i), f in zip(members, fit)]
    tb = [tsched.Arrival(d, i, float(f), 1, 0.0) for (d, i), f in zip(members, fit)]
    _, jnorm, jfit, jstats = js._fold_batch(jb, 2)
    _, tnorm, tfit, tstats = ts._fold_batch(tb, 2)
    np.testing.assert_array_equal(tfit, jfit)
    assert tstats["fresh"] == jstats["fresh"] == 4
    assert tstats["folded"] == jstats["folded"] == 4
    assert tstats["max_staleness"] == jstats["max_staleness"] == 2
    assert tstats["consumed_by_dispatch"] == jstats["consumed_by_dispatch"]
    assert tstats["mean_lambda"] == pytest.approx(jstats["mean_lambda"], abs=LAMBDA_ATOL)
    np.testing.assert_allclose(tgrads[0], jgrads[0], rtol=1e-5, atol=1e-6)
    assert tnorm == pytest.approx(jnorm, rel=1e-6)


def test_fold_stats_are_float64(monkeypatch):
    """The stale members' ε·d and ‖ε‖², and ‖d‖², reach the importance
    ratios as float64 sums.  log λ differs between members by terms of size
    |ε·d|, so a float32 dot's rounding, which depends on the device's
    summation order, would move λ and the update with it: a log replayed on
    the card and on the CPU would part."""
    from estorch_tpu_torch.host.engine import member_sign_offset

    tes = make_host()
    dim, sigma = tes.engine.dim, 0.05
    rng = np.random.default_rng(5)
    p_old = tes.state.params_flat.numpy().copy()
    p_new = (p_old + rng.normal(0, 0.5, dim)).astype(np.float32)
    offs_old = tes.engine._pair_offsets(tes.state._replace(generation=5))
    tes.state = tes.state._replace(params_flat=torch.from_numpy(p_new), generation=2)
    ts = tsched.GenerationScheduler(tes)
    ts._sources = {5: tsched.Source(5, 0, torch.from_numpy(p_old), sigma, offs_old)}
    seen = []
    lambdas = tsched.clipped_stale_lambdas

    def spy(dots, norms, d2, c, n, clip):
        seen.append((np.array(dots), np.array(norms), d2))
        return lambdas(dots, norms, d2, c, n, clip)

    monkeypatch.setattr(tsched, "clipped_stale_lambdas", spy)
    batch = [tsched.Arrival(5, i, float(f), 1, 0.0) for i, f in enumerate(rng.normal(size=8))]
    ts._fold_batch(batch, 2)
    dots, norms, d2 = seen[0]
    d = ((torch.from_numpy(p_old) - torch.from_numpy(p_new)) / sigma).double().numpy()
    table = tes.engine.table.double().numpy()
    for i in range(8):
        sign, off = member_sign_offset(offs_old, i, True)
        eps = table[off:off + dim]
        assert dots[i] == pytest.approx(sign * (eps @ d), rel=1e-12)
        assert norms[i] == pytest.approx(eps @ eps, rel=1e-12)
    assert d2 == pytest.approx(d @ d, rel=1e-12)


# ---------------------------------------------------------------------------
# accounting and rejection
# ---------------------------------------------------------------------------


def test_every_result_accounted(chaos_env):
    """max_stale=1 and a long straggler force discards: every dispatched
    member is consumed, discarded or lost, and the counters agree."""
    chaos_env([{"kind": "straggler", "gen": 0, "member": 3, "sleep_s": 0.6}])
    es = make_host()
    es.train_async(6, n_proc=2, verbose=False, max_stale=1)
    log = es.async_event_log
    consumed = sum(len(u["consumed"]) for u in log.updates)
    dispatched = len(log.dispatches) * es.population_size
    assert dispatched == consumed + len(log.discarded) + len(log.lost)
    assert es.obs.counters.get("stale_discarded") == len(log.discarded) > 0
    assert sum(r["async"]["consumed"] for r in es.history) == consumed


def test_rejected_update_protects_center_and_replays(chaos_env):
    chaos_env([{"kind": "nan_update", "gen": 2}])
    es = make_host()
    es.train_async(5, verbose=False)
    assert es.obs.counters.get("generations_rejected") >= 1
    assert len(es.history) == 5
    assert torch.isfinite(es.state.params_flat).all()
    r = make_host()
    r.train_async(5, replay=es.async_event_log.to_dict(), verbose=False)
    assert params_bytes(es) == params_bytes(r)


def test_nan_fitness_burst_rejected_then_recovers(chaos_env):
    chaos_env([{"kind": "nan_fitness", "gen": 1, "member": "all"}])
    es = make_host()
    es.train_async(4, verbose=False)
    assert len(es.history) == 4
    assert es.obs.counters.get("generations_rejected") >= 1
    assert torch.isfinite(es.state.params_flat).all()


def test_async_beats_barrier_and_learns(chaos_env):
    """The same straggler plan: the fold finishes faster than the barrier
    loop, folds the stragglers and keeps a solid part of its progress."""
    plan = tchaos.ChaosPlan.generate(seed=0, n_generations=12, straggler_every=2,
                                     straggler_sleep_s=0.2, straggler_jitter_s=0.1,
                                     population_size=8)
    events = [{k: v for k, v in e.items() if k != "id"} for e in plan.events]
    chaos_env(events)
    t0 = time.perf_counter()
    es_sync = make_host(seed=1, optimizer_kwargs={"lr": 0.02})
    es_sync.train(12, n_proc=2, verbose=False)
    sync_s = time.perf_counter() - t0
    chaos_env(events)
    t0 = time.perf_counter()
    es_async = make_host(seed=1, optimizer_kwargs={"lr": 0.02})
    es_async.train_async(12, n_proc=2, verbose=False)
    async_s = time.perf_counter() - t0
    assert async_s < sync_s * 0.85, (async_s, sync_s)
    assert sum(r["async"]["folded"] for r in es_async.history) > 0
    first = es_sync.history[0]["reward_mean"]
    sync_final = es_sync.history[-1]["reward_mean"]
    async_final = es_async.history[-1]["reward_mean"]
    assert sync_final > first
    assert async_final >= first + 0.3 * (sync_final - first), (first, sync_final, async_final)


def test_overlap_efficiency_gauges_and_spans(chaos_env):
    chaos_env([{"kind": "straggler", "gen": 1, "member": 1, "sleep_s": 0.2}])
    es = make_host()
    es.train_async(4, n_proc=2, verbose=False)
    snap = es.obs.counters.snapshot()
    assert snap.get("async_updates") == 4
    assert 0.0 <= snap.get("overlap_efficiency", -1) <= 1.0
    assert 0.0 <= snap.get("stale_reuse_ratio", -1) <= 1.0
    assert snap.get("results_folded", 0) > 0
    phases = {k for r in es.history for k in r["phases"]}
    assert {"async/dispatch", "async/fold"} <= phases


def test_async_records_validate():
    es = make_host()
    es.train_async(3, verbose=False)
    for r in es.history:
        rec = json.loads(json.dumps(r))
        assert validate_record(rec) == []
        assert r["async"]["consumed"] == r["async"]["fresh"] + r["async"]["folded"]


# ---------------------------------------------------------------------------
# overlap
# ---------------------------------------------------------------------------


def _cartpole(cls_es, agent, policy, optimizer, **kw):
    return cls_es(policy, agent, optimizer, population_size=16, sigma=0.1, seed=7,
                  policy_kwargs={"action_dim": 2, "hidden": (8,)},
                  optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 15, **kw)


def test_overlap_bit_identical_to_train_on_device():
    def make():
        return _cartpole(ES, DeviceAgent(CartPole(), horizon=50), MLPPolicy, adam, device="cpu")

    es_sync, es_ov = make(), make()
    es_sync.train(4, verbose=False)
    es_ov.train_async(4, verbose=False)  # auto: overlap on the device backend
    assert params_bytes(es_sync) == params_bytes(es_ov)
    assert [r["reward_mean"] for r in es_sync.history] == [r["reward_mean"] for r in es_ov.history]
    assert any("async/dispatch" in r["phases"] for r in es_ov.history)
    # the JAX package's overlap spans the same phase names on this backend
    jes = _cartpole(JES, JaxAgent, JMLPPolicy, optax.adam,
                    agent_kwargs={"env": JCartPole(), "horizon": 50})
    jes.train_async(2, verbose=False)
    assert ({k for r in es_ov.history for k in r["phases"]}
            == {k for r in jes.history for k in r["phases"]})


def test_overlap_on_host_strategy():
    es_sync, es_ov = make_host(), make_host()
    es_sync.train(3, verbose=False)
    es_ov.train_async(3, strategy="overlap", verbose=False)
    assert params_bytes(es_sync) == params_bytes(es_ov)


def test_overlap_spans_do_not_interleave_across_threads():
    es = make_host()
    es.train_async(4, strategy="overlap", n_proc=2, verbose=False)
    allowed = {"sample", "eval", "update", "record", "host_sync", "async", "async/dispatch"}
    seen = {k for r in es.history for k in r["phases"]}
    assert seen <= allowed, seen - allowed


def test_overlap_rejection_discards_speculative_and_matches_train(chaos_env):
    """A nan_update generation under overlap: its speculative successor is
    drained and counted, the re-run ends bit-identical to a clean train."""
    clean = make_host()
    clean.train(4, verbose=False)
    chaos_env([{"kind": "nan_update", "gen": 1}])
    es = make_host()
    es.train_async(4, strategy="overlap", verbose=False)
    assert es.obs.counters.get("generations_rejected") == 1
    assert es.obs.counters.get("speculative_discarded") == 1
    assert params_bytes(es) == params_bytes(clean)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def test_arg_validation():
    es = make_host()
    with pytest.raises(ValueError, match="strategy"):
        es.train_async(1, strategy="bogus")
    with pytest.raises(ValueError, match="replay"):
        es.train_async(1, strategy="overlap", replay={"updates": []})
    with pytest.raises(ValueError, match="max_stale"):
        tsched.GenerationScheduler(es, max_stale=0)
    with pytest.raises(ValueError, match="iw_clip"):
        tsched.GenerationScheduler(es, iw_clip=0.5)
    assert es.async_event_log is None


def test_fold_requires_host_backend():
    es = _cartpole(ES, DeviceAgent(CartPole(), horizon=10), MLPPolicy, adam, device="cpu")
    with pytest.raises(ValueError, match="overlap"):
        tsched.GenerationScheduler(es)
    with pytest.raises(ValueError, match="overlap"):
        es.train_async(1, strategy="fold")
