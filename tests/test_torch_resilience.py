"""The port's resilience layer against the JAX package's, on the CPU.

``run_resilient`` contains a checkpoint-write crash (rolled back, re-run,
re-saved: the run ends bit-exact, with the JAX package's skip count and
latest checkpoint) and re-raises a persistent fault, as the JAX package's
does.  The ``Supervisor`` drives the chaos demo of ``tests/test_resilience.
py`` (a worker SIGKILL at generation 5, a checkpoint-write crash at 8, a
NaN burst at 9, a SIGKILL of the whole training process at 12) to the
clean run's params bit for bit, with one restart, the manifest's counters
and every record once, and ``python -m estorch_tpu_torch.obs summarize``
reports the restart; a wedged child is killed by the heartbeat watchdog
and the run resumes.  The interleaver's copy replays races as the JAX
package's does.

The supervised children are spawned and import this module for their
factory, so it imports nothing of JAX at module level.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from estorch_tpu_torch import ES
from estorch_tpu_torch.resilience import (CHAOS_ENV, CoopLock, DeadlockError, Interleaver,
                                          Supervisor, run_interleaved, run_resilient)
from estorch_tpu_torch.resilience import chaos as tchaos
from estorch_tpu_torch.utils import PeriodicCheckpointer, restore_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TinyMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                       torch.nn.Linear(8, 2))

    def forward(self, x):
        return self.net(x)


class QuadAgent:
    """A deterministic fitness: an exact recovery needs an oracle."""

    target = 0.1

    def rollout(self, policy):
        with torch.no_grad():
            vec = torch.nn.utils.parameters_to_vector(policy.parameters())
            reward = -float(((vec - self.target) ** 2).sum())
        self.last_episode_steps = 1
        return reward


class AlwaysDeadAgent:
    def rollout(self, policy):
        raise RuntimeError("env permanently dead")


HOST_KW = dict(population_size=8, sigma=0.05, seed=3, optimizer_kwargs={"lr": 0.05},
               table_size=1 << 12)


def make_es(worker_mode="process", agent=QuadAgent):
    return ES(TinyMLP, agent, torch.optim.Adam, worker_mode=worker_mode, device="cpu",
              **HOST_KW)


def jax_es(worker_mode="process", agent=QuadAgent):
    from estorch_tpu import ES as JES

    return JES(TinyMLP, agent, torch.optim.Adam, worker_mode=worker_mode, **HOST_KW)


def child_factory():
    """The supervised children's factory (spawned: a fresh interpreter)."""
    return make_es("process")


@pytest.fixture
def chaos_plan(monkeypatch):
    """Set ``ESTORCH_CHAOS`` and reset both packages' cached plans."""
    def reset():
        tchaos.reset_cache()
        if "estorch_tpu.resilience.chaos" in sys.modules:
            sys.modules["estorch_tpu.resilience.chaos"].reset_cache()

    def set_plan(plan: dict):
        monkeypatch.setenv(CHAOS_ENV, json.dumps(plan))
        reset()

    yield set_plan
    monkeypatch.delenv(CHAOS_ENV, raising=False)
    reset()


# ---------------------------------------------------------------------
# run_resilient
# ---------------------------------------------------------------------


def test_checkpoint_write_crash_skipped_and_bit_exact(tmp_path, chaos_plan):
    """A crash inside the save after generation 1 (``es.generation`` 2)
    rolls that generation back; it re-runs and re-saves.  The run ends on
    the clean run's params bit for bit with exactly 4 records and
    ``latest()`` at ``gen_00000003``; the JAX package's run under the same
    plan skips once too and ends within the host path's 2e-6."""
    from estorch_tpu.resilience import run_resilient as jrun_resilient
    from estorch_tpu.utils.checkpoint import PeriodicCheckpointer as JPeriodicCheckpointer

    clean = make_es("thread")
    clean.train(4, verbose=False)
    plan = {"events": [{"kind": "ckpt_crash", "gen": 2}]}
    chaos_plan(plan)
    es = make_es("thread")
    ck = PeriodicCheckpointer(es, str(tmp_path / "cks"), every=2)
    run_resilient(es, 4, checkpointer=ck)
    assert es.generation == 4
    assert es.obs.counters.get("generations_skipped") == 1
    assert any(e["name"] == "generation_skipped" for e in es.obs.recorder.events())
    assert torch.equal(es.state.params_flat, clean.state.params_flat)
    assert ck.latest().endswith("gen_00000003")
    assert os.path.isdir(tmp_path / "cks" / "gen_00000001" / "state")
    assert [r["generation"] for r in es.history] == [0, 1, 2, 3]

    chaos_plan(plan)
    jes = jax_es("thread")
    jck = JPeriodicCheckpointer(jes, str(tmp_path / "jcks"), every=2)
    jrun_resilient(jes, 4, checkpointer=jck)
    assert jes.obs.counters.get("generations_skipped") == 1
    assert os.path.basename(jck.latest()) == os.path.basename(ck.latest())
    np.testing.assert_allclose(es.state.params_flat.numpy(), np.asarray(jes.state.params_flat),
                               rtol=0, atol=2e-6)


def test_device_path_crash_and_poisoned_update_contained(tmp_path, chaos_plan):
    """The card's phase-13 (ab) case at a small size on the CPU: the
    streamed Pendulum path with the kernel update, a crash in the save at
    ``es.generation`` 2 (skipped) and a poisoned update at generation 3
    (rejected by ``train``'s guard): the clean run's params bit for bit."""
    from estorch_tpu_torch import DeviceAgent, MLPPolicy, Pendulum, adam

    def cell():
        return ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, device="cpu",
                  population_size=16, sigma=0.05, table_size=1 << 16, streamed=True,
                  noise_kernel=True, optimizer_kwargs={"learning_rate": 1e-2},
                  policy_kwargs={"action_dim": 1, "hidden": (8, 8), "discrete": False,
                                 "action_scale": 2.0})

    clean = cell()
    clean.train(5, verbose=False)
    chaos_plan({"events": [{"kind": "ckpt_crash", "gen": 2}, {"kind": "nan_update", "gen": 3}]})
    es = cell()
    ck = PeriodicCheckpointer(es, str(tmp_path / "cks"), every=1, max_to_keep=2)
    run_resilient(es, 5, checkpointer=ck)
    assert es.obs.counters.get("generations_skipped") == 1
    assert es.obs.counters.get("generations_rejected") == 1
    assert torch.equal(es.state.params_flat, clean.state.params_flat)
    assert [r["generation"] for r in es.history] == list(range(5))
    assert sorted(os.listdir(tmp_path / "cks")) == ["gen_00000003", "gen_00000004"]


def test_iwes_reuse_window_rolled_back_with_the_generation(tmp_path, chaos_plan):
    """F11: IW-ES appends the generation to its reuse window before the
    record's save runs.  A crash in that save must roll the window back
    too, or the re-run reuses its own aborted samples at ratio 1: the run
    is bit-identical to an uninterrupted one, params and each record's
    ``reused_gens`` and ``ess``."""
    from estorch_tpu_torch import IW_ES, DeviceAgent, MLPPolicy, Pendulum, adam

    def cell():
        return IW_ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, device="cpu",
                     population_size=16, sigma=0.1, table_size=1 << 16, reuse_window=2,
                     ess_min=0.5, optimizer_kwargs={"learning_rate": 1e-3},
                     policy_kwargs={"action_dim": 1, "hidden": (8, 8), "discrete": False,
                                    "action_scale": 2.0})

    clean = cell()
    clean.train(4, verbose=False)
    chaos_plan({"events": [{"kind": "ckpt_crash", "gen": 2}]})
    es = cell()
    run_resilient(es, 4, checkpointer=PeriodicCheckpointer(es, str(tmp_path / "cks"), every=1))
    assert es.obs.counters.get("generations_skipped") == 1
    assert torch.equal(es.state.params_flat, clean.state.params_flat)
    for key in ("generation", "reused_gens", "ess", "reused_prev", "grad_norm"):
        assert [r[key] for r in es.history] == [r[key] for r in clean.history], key
    assert len(es._prev) == len(clean._prev) == 2
    assert (es._dry_gens, es._dry_best_ess) == (clean._dry_gens, clean._dry_best_ess)


def test_novelty_meta_rng_rolled_back_with_the_generation(tmp_path, chaos_plan):
    """F12: the novelty family draws the generation's center from its meta
    RNG before anything can fail.  Crashes in the saves at generations 2,
    4 and 6 must not move the draws: NSR-ES over 8 generations gives the
    clean run's ``meta_index`` and every center's params bit for bit."""
    from estorch_tpu_torch import NSR_ES, CartPole, DeviceAgent, MLPPolicy, adam

    def cell():
        return NSR_ES(MLPPolicy, DeviceAgent(CartPole(), horizon=30), adam, device="cpu",
                      population_size=16, sigma=0.05, table_size=1 << 16,
                      meta_population_size=3, k=3,
                      optimizer_kwargs={"learning_rate": 1e-2},
                      policy_kwargs={"action_dim": 2, "hidden": (8,)})

    clean = cell()
    clean.train(8, verbose=False)
    chaos_plan({"events": [{"kind": "ckpt_crash", "gen": g} for g in (2, 4, 6)]})
    es = cell()
    run_resilient(es, 8, checkpointer=PeriodicCheckpointer(es, str(tmp_path / "cks"), every=1))
    assert es.obs.counters.get("generations_skipped") == 3
    assert [r["meta_index"] for r in es.history] == [r["meta_index"] for r in clean.history]
    for a, b in zip(es.meta_states, clean.meta_states):
        assert torch.equal(a.params_flat, b.params_flat)
    assert es._rng.bit_generator.state == clean._rng.bit_generator.state


def test_spawned_child_reads_its_own_peak_rss():
    """F13: a spawned child's ``peak_rss_mb`` is its own high-water mark
    (``VmHWM``), not its parent's: ``ru_maxrss`` carries the parent's
    resident set across the exec.  The parent holds 400 MB it touched;
    the child, which loads ``obs/counters.py`` alone, reads far less."""
    code = ("import importlib.util, json\n"
            "spec = importlib.util.spec_from_file_location('c', {path!r})\n"
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
            "c = m.Counters(); c.sample_peak_rss()\n"
            "print(json.dumps(c.snapshot()))\n").format(
        path=os.path.join(REPO, "estorch_tpu_torch", "obs", "counters.py"))
    held = np.ones(400 * 2**20 // 8)  # touched: resident in the parent
    from estorch_tpu_torch.obs.counters import Counters

    parent = Counters()
    parent.sample_peak_rss()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, check=True)
    child_mb = json.loads(out.stdout)["peak_rss_mb"]
    del held
    assert parent.get("peak_rss_mb") > 400
    assert 0 < child_mb < parent.get("peak_rss_mb") - 300, (child_mb, parent.snapshot())


def test_persistent_failure_reraises():
    """An env that always raises: every member NaN, each attempt rejected
    by ``train``'s guard and skipped, then re-raised, in both packages."""
    from estorch_tpu.resilience import run_resilient as jrun_resilient

    for es, run in ((make_es("thread", AlwaysDeadAgent), run_resilient),
                    (jax_es("thread", AlwaysDeadAgent), jrun_resilient)):
        with pytest.raises(RuntimeError, match="valid fitness"):
            run(es, 2, max_consecutive_skips=1)
        assert es.obs.counters.get("generations_skipped") == 2
        assert es.generation == 0


# ---------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------


def test_chaos_run_supervised_to_bit_exact_completion(tmp_path, chaos_plan):
    """The chaos demo: a worker SIGKILL at generation 5, a checkpoint-write
    crash at 8's save, a NaN burst over the whole population at 9 and a
    SIGKILL of the training process at 12.  The Supervisor drives the run
    to 16 and its final checkpoint holds the clean run's params bit for
    bit: one restart (exit -SIGKILL), the manifest's cross-restart
    counters, records 0–15 each once, and the CLI reports the restart."""
    clean = make_es("process")
    try:
        clean.train(16, n_proc=2, verbose=False)
    finally:
        clean.engine.close()
    root = tmp_path / "run"
    chaos_plan({"events": [{"kind": "kill_worker", "gen": 5, "worker": 0},
                           {"kind": "ckpt_crash", "gen": 8},
                           {"kind": "nan_fitness", "gen": 9, "member": "all"},
                           {"kind": "die", "gen": 12}],
                "ledger": str(tmp_path / "chaos_ledger")})
    sup = Supervisor(child_factory, str(root), target_generation=16, every=4, n_proc=2,
                     max_restarts=3, backoff_s=0.1, poll_s=0.25, startup_grace_s=300.0)
    res = sup.run()
    assert res["ok"], f"supervisor failed: {res}"
    assert len(res["restarts"]) == 1
    assert res["restarts"][0]["exitcode"] == -signal.SIGKILL

    es = make_es("process")
    restore_checkpoint(es, res["checkpoint"])
    assert es.generation == 16
    assert torch.equal(es.state.params_flat, clean.state.params_flat)

    resil = json.load(open(root / "manifest.json"))["resilience"]
    assert resil["completed"] is True and resil["restart_count"] == 1
    assert resil["counters"]["generations_rejected"] >= 1  # the NaN burst
    assert resil["counters"]["generations_skipped"] >= 1  # the checkpoint crash
    assert resil["counters"]["workers_respawned"] >= 1  # the worker kill
    assert resil["counters"]["supervisor_resumes"] == 1
    counters = json.load(open(root / "counters.json"))
    assert counters["restart_count"] == 1 and counters["completed"] is True

    records = [json.loads(line) for line in open(root / "run.jsonl")]
    assert [r["generation"] for r in records] == list(range(16))
    assert all(r["n_failed"] == 0 for r in records)  # full participation

    out = subprocess.run([sys.executable, "-m", "estorch_tpu_torch.obs", "summarize",
                          str(root / "run.jsonl")], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "restarts         1 (completed=True)" in out.stdout
    assert "generations_rejected" in out.stdout


def test_wedged_child_killed_by_watchdog_and_resumed(tmp_path, chaos_plan):
    """A child that stops beating (a ``wedge``: a long silent sleep before
    generation 2) is killed by the staleness watchdog, and the run resumes
    from the last checkpoint to the clean run's params.  The 15 s limit
    stays above a loaded machine's longest gap between a healthy child's
    beats (its setup: the manifest's git call alone may take 5 s)."""
    clean = make_es("process")
    try:
        clean.train(4, n_proc=2, verbose=False)
    finally:
        clean.engine.close()
    root = tmp_path / "run"
    chaos_plan({"events": [{"kind": "wedge", "gen": 2, "sleep_s": 300.0}],
                "ledger": str(tmp_path / "chaos_ledger")})
    sup = Supervisor(child_factory, str(root), target_generation=4, every=1, n_proc=2,
                     max_restarts=2, backoff_s=0.1, poll_s=0.25, stale_after_s=15.0,
                     startup_grace_s=300.0)
    res = sup.run()
    assert res["ok"], f"supervisor failed: {res}"
    assert len(res["restarts"]) == 1
    assert "stale" in res["restarts"][0]["reason"]
    es = make_es("process")
    restore_checkpoint(es, res["checkpoint"])
    assert es.generation == 4
    assert torch.equal(es.state.params_flat, clean.state.params_flat)


def test_supervisor_arguments_as_jax():
    with pytest.raises(ValueError, match="exactly one of es_factory"):
        Supervisor(None, "x", 1)
    with pytest.raises(ValueError, match="ckpt_root is required"):
        Supervisor(child_factory, "", 1)


# ---------------------------------------------------------------------
# the interleaver
# ---------------------------------------------------------------------


class Counter:
    """Shared state with a torn read-modify-write."""

    def __init__(self):
        self.n = 0


def racy_workers(box, per_worker=20):
    def worker():
        for _ in range(per_worker):
            cur = box.n
            cur = cur + 1
            box.n = cur
    return [worker, worker]


def test_same_seed_is_bit_identical():
    runs = []
    for _ in range(2):
        box = Counter()
        runs.append((run_interleaved(racy_workers(box), seed=1234), box.n))
    (r1, n1), (r2, n2) = runs
    assert r1.replays(r2) and r1.schedule == r2.schedule and r1.switches == r2.switches
    assert n1 == n2


def test_a_seed_exists_that_loses_updates():
    losing = None
    for seed in range(32):
        box = Counter()
        run_interleaved(racy_workers(box), seed=seed)
        if box.n < 40:
            losing = seed
            break
    assert losing is not None, "no seed exposed the race"
    box_a, box_b = Counter(), Counter()
    ra = run_interleaved(racy_workers(box_a), seed=losing)
    rb = run_interleaved(racy_workers(box_b), seed=losing)
    assert ra.replays(rb) and box_a.n == box_b.n < 40


def test_different_seeds_differ():
    assert len({run_interleaved(racy_workers(Counter()), seed=s).schedule
                for s in range(6)}) > 1


def test_cooplock_fixes_every_seed():
    for seed in range(8):
        box, holder = Counter(), []

        def worker():
            for _ in range(20):
                with holder[0]:
                    cur = box.n
                    cur = cur + 1
                    box.n = cur

        itl = Interleaver([worker, worker], seed=seed)
        holder.append(CoopLock(itl))
        itl.run()
        assert box.n == 40, f"seed {seed} lost updates under lock"


def test_values_and_errors_propagate():
    assert run_interleaved([lambda: "a", lambda: "b"], seed=0).values == ("a", "b")

    def boom():
        raise ValueError("torn")

    with pytest.raises(ValueError, match="torn"):
        run_interleaved([boom, lambda: None], seed=0)


def test_runaway_loop_fails_fast():
    def spin():
        while True:
            pass

    with pytest.raises(DeadlockError):
        run_interleaved([spin, spin], seed=0, max_steps=200)


def test_schedules_equal_jax_for_the_same_seed():
    """The port's copy and the JAX package's make the same handoff
    decisions for the same seed and the same worker code."""
    from estorch_tpu.resilience import run_interleaved as jrun_interleaved

    for seed in (0, 7, 1234):
        t, j = Counter(), Counter()
        rt = run_interleaved(racy_workers(t), seed=seed)
        rj = jrun_interleaved(racy_workers(j), seed=seed)
        assert rt.schedule == rj.schedule and t.n == j.n
