"""The port's chaos plans and training hooks against the JAX package's.

``estorch_tpu_torch/resilience/chaos.py`` against ``estorch_tpu/resilience/
chaos.py``: ``ChaosPlan.generate`` gives the same plan JSON for the same
seed, straggler stalls the same jitter, ``parse`` the same kinds and
errors.  The hooks on the host and pooled engines: a ``nan_fitness`` burst
and a ``nan_update`` are rejected, counted, and re-run, to the clean run's
parameters bit for bit on the host engine and to the JAX package's run
under the same plan on the pooled one; ``rollout_exc`` gives a NaN member,
in thread and fork workers; ``kill_worker`` kills a fork worker whose
members are retried on the survivors.
"""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estorch_tpu.resilience import chaos as jchaos
from estorch_tpu_torch import ES
from estorch_tpu_torch.resilience import chaos as tchaos
from test_scheduler import QuadAgent, TinyPolicy
from test_torch_pooled import CARTPOLE_POLICY, pooled_pair

GENERATE_CASES = [
    dict(seed=0, n_generations=12, straggler_every=2, straggler_sleep_s=0.25,
         straggler_jitter_s=0.15, population_size=16),
    dict(seed=3, n_generations=12, straggler_every=3, straggler_sleep_s=0.4,
         straggler_jitter_s=0.2, population_size=16, kill_every=6, n_workers=2),
    dict(seed=11, n_generations=30, p_rollout_exc=0.3, p_nan_burst=0.2, population_size=64,
         kill_every=5, n_workers=8, ledger="run/chaos_ledger"),
    dict(seed=5, n_generations=10, straggle_host_every=2, straggle_host=1,
         straggle_host_sleep_s=0.5, straggle_host_jitter_s=0.2, straggler_every=4,
         population_size=1000, straggler_sleep_s=1.0),
]


@pytest.fixture
def chaos_env():
    def set_plan(events):
        os.environ[tchaos.CHAOS_ENV] = json.dumps({"events": events})
        tchaos.reset_cache()

    yield set_plan
    os.environ.pop(tchaos.CHAOS_ENV, None)
    tchaos.reset_cache()


def make_host(**kw):
    base = dict(population_size=8, sigma=0.05, seed=0, optimizer_kwargs={"lr": 0.05},
                table_size=1 << 12, device="cpu")
    base.update(kw)
    return ES(TinyPolicy, QuadAgent, torch.optim.Adam, **base)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", GENERATE_CASES)
def test_generate_equals_jax(case):
    plan = tchaos.ChaosPlan.generate(**case)
    assert plan.to_json() == jchaos.ChaosPlan.generate(**case).to_json()
    assert plan.events == jchaos.ChaosPlan.generate(**case).events
    assert plan.to_json() == tchaos.ChaosPlan.parse(plan.to_json()).to_json()


def test_straggler_jitter_equals_jax():
    plan = tchaos.ChaosPlan.generate(**GENERATE_CASES[0])
    stragglers = [e for e in plan.events if e["kind"] == "straggler"]
    assert len(stragglers) == 6
    for ev in stragglers:
        assert tchaos.straggler_sleep_s(ev) == jchaos.straggler_sleep_s(ev)
        assert 0.25 <= tchaos.straggler_sleep_s(ev) < 0.4
    fixed = {"kind": "straggler", "gen": 1, "sleep_s": 0.3, "id": 1}
    assert tchaos.straggler_sleep_s(fixed) == jchaos.straggler_sleep_s(fixed) == 0.3


def test_parse_accepts_every_jax_kind():
    assert tchaos.KINDS == jchaos.KINDS
    events = [{"kind": k, "at_s": 1.0} if k in jchaos.SERVE_KINDS else {"kind": k, "gen": 2}
              for k in jchaos.KINDS]
    plan = tchaos.ChaosPlan.parse(json.dumps({"events": events}))
    assert [e["kind"] for e in plan.events] == list(jchaos.KINDS)
    assert {e["kind"] for e in plan.events_at(2)} == set(jchaos.KINDS) - set(jchaos.SERVE_KINDS)
    for bad, match in (([{"kind": "meteor", "gen": 1}], "unknown chaos event kind"),
                       ([{"kind": "straggler"}], "has no 'gen'"),
                       ([{"kind": "kill_replica", "replica": 0}], "has no 'at_s'")):
        with pytest.raises(ValueError, match=match):
            tchaos.ChaosPlan(bad)
        with pytest.raises(ValueError, match=match):
            jchaos.ChaosPlan(bad)


def test_fire_once_and_ledger(tmp_path):
    ledger = str(tmp_path / "ledger")
    a = tchaos.ChaosPlan([{"kind": "nan_update", "gen": 1}], ledger=ledger)
    b = tchaos.ChaosPlan.parse(a.to_json())  # another process's copy of the plan
    ev = a.events_at(1)[0]
    assert a.fire(ev) and not a.fire(ev)
    assert not b.fire(b.events_at(1)[0])  # the ledger says it fired
    assert open(ledger).read() == "0\n"


def test_mutate_fitness_equals_jax(chaos_env):
    fit = np.arange(8, dtype=np.float32)
    events = [{"kind": "nan_fitness", "gen": 2, "member": [1, 5]},
              {"kind": "nan_fitness", "gen": 3}]
    chaos_env(events)
    jchaos.reset_cache()
    try:
        for g in (1, 2, 2, 3):
            out = tchaos.mutate_fitness(g, fit)
            np.testing.assert_array_equal(out, jchaos.mutate_fitness(g, fit))
        assert np.isnan(tchaos.mutate_fitness(2, fit)).sum() == 0  # fired once
        assert not np.isnan(fit).any()  # the input is never modified
    finally:
        jchaos.reset_cache()


# ---------------------------------------------------------------------------
# the hooks on the engines
# ---------------------------------------------------------------------------


def test_nan_fitness_on_host_rejected_and_rerun(chaos_env):
    clean = make_host()
    clean.train(3, verbose=False)
    chaos_env([{"kind": "nan_fitness", "gen": 1, "member": "all"}])
    es = make_host()
    es.train(3, verbose=False)
    assert es.obs.counters.get("generations_rejected") == 1
    assert torch.equal(es.state.params_flat, clean.state.params_flat)
    assert [r["reward_mean"] for r in es.history] == [r["reward_mean"] for r in clean.history]


def test_nan_update_on_host_rejected_and_rerun(chaos_env):
    clean = make_host()
    clean.train(3, verbose=False)
    chaos_env([{"kind": "nan_update", "gen": 2}])
    es = make_host()
    es.train(3, verbose=False)
    assert es.obs.counters.get("generations_rejected") == 1
    assert es.obs.recorder.events()[-1]["name"] != "generation_rejected"
    assert torch.equal(es.state.params_flat, clean.state.params_flat)


def test_nan_fitness_on_pooled_rejected_as_jax(chaos_env):
    """The pooled re-run of a rejected generation steps the pools' next
    episodes (the pools seed once, in the JAX package too), so it is held
    against the JAX package's pooled run under the same plan, from JAX's
    table, params and offsets: both reject generation 1 once and end on
    the same trajectory."""
    chaos_env([{"kind": "nan_fitness", "gen": 1, "member": "all"}])
    jchaos.reset_cache()
    try:
        jes, tes = pooled_pair({"env_name": "cartpole", "horizon": 30}, CARTPOLE_POLICY)
        j0 = jes.state
        tes.engine.core.all_pair_offsets = lambda st: torch.from_numpy(np.array(
            jes.engine.core.all_pair_offsets(j0._replace(generation=jnp.int32(st.generation)))))
        jes.train(3, verbose=False)
        tes.train(3, verbose=False)
    finally:
        jchaos.reset_cache()
    assert tes.obs.counters.get("generations_rejected") == 1
    assert [r["reward_mean"] for r in tes.history] == [r["reward_mean"] for r in jes.history]
    np.testing.assert_allclose(tes.state.params_flat.numpy(), np.asarray(jes.state.params_flat),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_rollout_exc_gives_a_nan_member(chaos_env, worker_mode):
    chaos_env([{"kind": "rollout_exc", "gen": 1, "member": 3}])
    es = make_host(worker_mode=worker_mode)
    try:
        es.train(2, n_proc=2, verbose=False)
    finally:
        es.engine.close()
    assert [r["n_failed"] for r in es.history] == [0, 1]
    assert es.obs.counters.get("rollout_failures") == 1
    assert es.obs.counters.get("generations_rejected") == 0


def test_kill_worker_retried_on_survivors(chaos_env):
    """A fork worker killed at generation 1's start: its members are
    retried on the survivor (same θ, same fitness), it comes back at the
    next generation, and the run equals a clean one."""
    clean = make_host()
    clean.train(3, verbose=False)
    chaos_env([{"kind": "kill_worker", "gen": 1, "worker": 0}])
    es = make_host(worker_mode="process")
    try:
        es.train(3, n_proc=2, verbose=False)
    finally:
        es.engine.close()
    snap = es.obs.counters.snapshot()
    assert snap["chaos_worker_kills"] == 1
    assert snap["workers_respawned"] == 1
    assert snap.get("members_retried", 0) + snap.get("worker_send_failures", 0) >= 1
    assert torch.equal(es.state.params_flat, clean.state.params_flat)


def test_kill_worker_retried_when_reaping_lags(chaos_env):
    """The kill race made deterministic: the killed worker's pipe reaches
    EOF before ``waitpid`` can see it die.  Its ``is_alive()`` is made to
    stay True for the first calls after the kill, as under load; the pool
    must still count it dead from the EOF, retry its members on the
    survivor, respawn it once, and end on the clean run's params."""
    clean = make_host()
    clean.train(3, verbose=False)
    chaos_env([{"kind": "kill_worker", "gen": 1, "worker": 0}])
    es = make_host(worker_mode="process")
    real_kill = es.engine.chaos_kill_workers

    def kill_then_lag(generation):
        real_kill(generation)
        if generation != 1:
            return
        proc = es.engine._proc_pool._procs[0]
        real_is_alive, calls = proc.is_alive, [0]

        def lagging_is_alive():
            calls[0] += 1
            return True if calls[0] <= 8 else real_is_alive()

        proc.is_alive = lagging_is_alive

    es.engine.chaos_kill_workers = kill_then_lag
    try:
        es.train(3, n_proc=2, verbose=False)
    finally:
        es.engine.close()
    snap = es.obs.counters.snapshot()
    assert snap["chaos_worker_kills"] == 1
    assert snap["members_retried"] == 4
    assert snap["workers_respawned"] == 1
    assert [r["n_failed"] for r in es.history] == [0, 0, 0]
    assert torch.equal(es.state.params_flat, clean.state.params_flat)


def _train_and_report_workers(queue):
    es = make_host(worker_mode="process")
    es.train(1, n_proc=2, verbose=False)
    queue.put(es.engine._proc_pool.worker_pids)
    time.sleep(600)  # until killed


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as f:
            return "\tZ" in next(line for line in f if line.startswith("State:"))
    except OSError:
        return True


def test_workers_exit_when_their_parent_is_killed():
    """A SIGKILLed trainer (the supervisor's ``die``) leaves its fork
    workers without EOF on their pipes (each holds parent ends it
    inherited); they notice the reparenting and exit within a few polls."""
    import multiprocessing as mp
    import signal

    ctx = mp.get_context("fork")
    queue = ctx.Queue()
    trainer = ctx.Process(target=_train_and_report_workers, args=(queue,))
    trainer.start()
    try:
        pids = queue.get(timeout=60)
    finally:
        os.kill(trainer.pid, signal.SIGKILL)
        trainer.join(10)
    deadline = time.monotonic() + 15
    while not all(_gone(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert all(_gone(p) for p in pids), f"orphaned workers still alive: {pids}"
