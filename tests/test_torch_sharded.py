"""The param-sharded engine (``parallel/sharded.py``) across gloo ranks on the
CPU, against the JAX package's ``ShardedESEngine`` and against the port's
own replicated world 1.  The counterpart of ``tests/test_sharded.py``.

Ranks are real processes: this file run as a script is one rank
(``python tests/test_torch_sharded.py MODE RANK POP MODEL RDV WORK
[DEVICE]``; ``tests/test_torch_cuda.py`` runs its mode ``card`` on a card),
joined by gloo through a file store under the test's temporary directory,
with bounded timeouts.  The module imports no JAX at load; the JAX
references are built in a fixture on the 8 virtual CPU devices, with a
``(pop, model)`` mesh of ``Auto`` axes (ROADMAP F4), and their draws
(table, offsets, reset states, program noise) handed to the ranks as npz.

The workload is CartPole, MLP (16,), population 32, horizon 50,
``eval_chunk`` 8, 3 generations.  Tolerances: fitness and params within
JAX's own sharded A/B gate (``bench.py``: rtol 2e-4, atol 1e-5), the
contractions and sums being float32 products in another order.  The port's
own program stream (ROADMAP F24) gives the same noise bits on every mesh
shape, and table mode equals the port's replicated world 1 bit for bit here
(the update's float64 partials, F22).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from estorch_tpu_torch import ES, CartPole, DeviceAgent, MLPPolicy, adam, interop
from estorch_tpu_torch.parallel import Sample, mesh as tmesh, multihost

REPO = Path(__file__).resolve().parent.parent
POLICY = {"action_dim": 2, "hidden": (16,), "discrete": True}
HORIZON = 50
GENS = 3
RANK_TIMEOUT_S = 60.0
ATOL, RTOL = 1e-5, 2e-4  # JAX's sharded A/B gate
SHAPES = [(1, 2), (2, 1), (2, 2)]
# the forward's other cases: dense_0's kernel split on its input dim
# (row-parallel), the head's kernel whole beside its split bias
USER_RULES = ((r"dense_0/kernel$", tmesh.P(tmesh.MODEL_AXIS, None)),
              (r"head/kernel$", tmesh.P()),
              (r"bias$", tmesh.P(tmesh.MODEL_AXIS)),
              (r".*", tmesh.P()))


def sharded_es(mesh=None, env=None, **over) -> ES:
    kw = dict(population_size=32, sigma=0.1, seed=0, policy_kwargs=POLICY,
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16, eval_chunk=8,
              telemetry=False, shard_params=True)
    kw.update(over)
    if mesh is None:
        kw["device"] = "cpu"
    else:
        kw["mesh"] = mesh
    return ES(MLPPolicy, DeviceAgent(env or CartPole(), horizon=HORIZON), adam, **kw)


class NanCartPole(CartPole):
    """CartPole whose rewards are NaN: every member's fitness is, so the
    population collapses and the generation must be rolled back."""

    def step_p(self, params, states, actions):
        s, o, r, d = super().step_p(params, states, actions)
        return s, o, r * float("nan"), d


def injected(ref, prefix: str):
    """A ``noise_source`` serving JAX's program draws from ``ref``."""

    def source(generation, leaf, rows, elements, factor):
        name = f"{prefix}{generation}_leaf{leaf}" + ("" if factor is None else "ab"[factor])
        return torch.from_numpy(ref[name])[rows][:, elements.cpu()]

    return source


def noise_rows(es, rows: int) -> np.ndarray:
    """Generation 0's ε of the first ``rows`` noise rows, gathered (dim,)."""
    eng = es.engine
    draws = eng._draws(es.state, None)
    out = []
    for r in range(rows):
        local = torch.cat([eng._dense_noise(i, torch.tensor([r]), draws)[0]
                           for i in range(len(eng.layout.leaves))])
        out.append(eng.layout.gather(local).cpu().numpy())
    return np.stack(out)


# ---------------------------------------------------------------- the ranks


def _join(rank: int, pop: int, model: int, rdv: str, device: str = "cpu"):
    assert multihost.initialize(f"file://{rdv}", num_processes=pop * model, process_id=rank,
                                device=device, cpu_collectives=True, timeout_s=RANK_TIMEOUT_S)
    return multihost.global_hyperscale_mesh(pop, model)


def _replay_jax(es, ref, prefix: str, program: bool) -> dict:
    """``GENS`` generations from JAX's initial params and draws."""
    if not program:
        es.engine.table = es.table = interop.table_from_numpy(ref["table"])
    else:
        es.engine.noise_source = injected(ref, prefix)
    flat, _ = interop.params_from_jax(ref[f"{prefix}params0"], es.spec)
    es.state = es.engine.init_state(flat, seed=0)
    out = {}
    for g in range(ref[f"{prefix}gens"]):
        offs = None if program else torch.from_numpy(ref[f"{prefix}offsets{g}"])
        sample = Sample(offs, torch.from_numpy(ref[f"{prefix}states{g}"]))
        es.state, m = es.engine.generation_step(es.state, sample)
        out[f"{prefix}fitness{g}"] = m["fitness"].numpy()
        out[f"{prefix}steps{g}"] = np.int64(m["steps"])
        out[f"{prefix}params{g}"] = es.state.params_flat.numpy()
    return out


def rank_main(rank: int, pop: int, model: int, rdv: str, work: Path) -> None:
    mesh = _join(rank, pop, model, rdv)
    out = {"shape": np.asarray(mesh.devices.shape)}
    ref = np.load(work / "jax.npz")
    # table mode from JAX's draws, and from the port's own (against world 1)
    out.update(_replay_jax(sharded_es(mesh, noise_mode="table"), ref, "t", program=False))
    es = sharded_es(mesh, noise_mode="table")
    es.train(GENS, verbose=False)
    out["table_params"] = es.state.params_flat.numpy()
    out["table_local"] = es.state.params_local.numpy()
    out["table_steps"] = np.asarray([r["env_steps"] for r in es.history])
    # the port's program stream: generation 0's noise, then training
    es = sharded_es(mesh)
    out["noise0"] = noise_rows(es, 4)
    es.train(GENS, verbose=False)
    out["program_params"] = es.state.params_flat.numpy()
    out["program_local"] = es.state.params_local.numpy()
    # population 10: a ghost noise row when the pop shards are 2
    es = sharded_es(mesh, population_size=10)
    es.train(2, verbose=False)
    out["pop10_params"] = es.state.params_flat.numpy()
    if (pop, model) == (1, 2):
        out.update(_rank_1x2_extras(mesh, ref, work))
    np.savez(work / f"{pop}x{model}_rank{rank}.npz", **out)


def _rank_1x2_extras(mesh, ref, work: Path) -> dict:
    from estorch_tpu_torch.resilience import chaos, run_resilient
    from estorch_tpu_torch.utils import PeriodicCheckpointer

    out = {}
    # periodic checkpoints: every rank saves (the gather), rank 0 writes
    es = sharded_es(mesh)
    ck = PeriodicCheckpointer(es, str(work / "ck1x2"), every=1, max_to_keep=2)
    es.train(GENS, verbose=False, log_fn=ck.on_record)
    ck.close()
    out["ck_params"] = es.state.params_flat.numpy()
    out["ck_mu"] = es.engine.layout.gather(es.state.opt_state.mu).numpy()
    out["ck_root"] = np.asarray(str(work / "ck1x2"))
    # JAX's program draws, dense and low rank 2
    out.update(_replay_jax(sharded_es(mesh), ref, "p", program=True))
    out.update(_replay_jax(sharded_es(mesh, low_rank=2), ref, "l", program=True))
    es = sharded_es(mesh, low_rank=2)
    es.train(GENS, verbose=False)
    out["lowrank_params"] = es.state.params_flat.numpy()
    # user rules: a row-parallel kernel beside its sharded bias, and a whole
    # kernel beside a sharded bias
    es = sharded_es(mesh, noise_mode="table", partition_rules=USER_RULES)
    es.train(GENS, verbose=False)
    out["user_rules_params"] = es.state.params_flat.numpy()
    out["user_rules_report"] = np.asarray(json.dumps(es.engine.sharding_report()))
    # a collapsed population: rolled back in the engine on every rank
    es = sharded_es(mesh, env=NanCartPole())
    before = es.state
    new, m = es.engine.generation_step(before)
    out["nan_rolled_back"] = np.bool_(new is before and new.generation == 0
                                      and int(m["n_valid"]) == 0)
    # best_theta gathered against member_params of the best member
    es = sharded_es(mesh)
    new, m = es.engine.generation_step(es.state)
    best = int(torch.argmax(m["fitness"]))
    out["best_theta"] = es.engine.layout.gather(m["best_theta"]).numpy()
    out["best_member"] = es.engine.member_params(es.state, best).numpy()
    # ES end to end in table mode: records, manifest, best member
    es = sharded_es(mesh, noise_mode="table", telemetry=True)
    es.train(2, verbose=False)
    idx = int(np.argmax([r["reward_max"] for r in es.history]))
    out["manifest"] = np.asarray(json.dumps(es.run_manifest()["config"]))
    out["cost_sharding"] = np.asarray(json.dumps(es.history[0]["cost_model"]["sharding"]))
    out["best_flat"] = es._best_flat.numpy()
    out["best_gen"] = np.int64(idx)
    # the poisoned update of generation 1 rejected alike on both ranks, and
    # run_resilient rolling a raising generation back
    os.environ["ESTORCH_CHAOS"] = json.dumps({"events": [{"kind": "nan_update", "gen": 1}]})
    chaos.reset_cache()
    try:
        es = sharded_es(mesh, telemetry=True)
        es.train(3, verbose=False)
        out["poison_rejected"] = np.int64(es.obs.counters.snapshot()["generations_rejected"])
        out["poison_params"] = es.state.params_flat.numpy()
    finally:
        del os.environ["ESTORCH_CHAOS"]
        chaos.reset_cache()
    es = sharded_es(mesh, telemetry=True)
    real = es.engine.generation_step
    calls = {"n": 0}

    def flaky(state, sample=None):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected")
        return real(state, sample)

    es.engine.generation_step = flaky
    run_resilient(es, 3)
    out["resilient_params"] = es.state.params_flat.numpy()
    out["resilient_skips"] = np.int64(es.obs.counters.snapshot().get("generations_skipped", 0))
    # the overlap scheduler, bit-identical to train
    es = sharded_es(mesh)
    es.train_async(3, strategy="overlap", verbose=False)
    out["overlap_params"] = es.state.params_flat.numpy()
    # scenarios compose: the per-variant block on every record
    from estorch_tpu_torch.scenarios import default_distribution

    dist = default_distribution(CartPole(), n_variants=4, spread=0.3, seed=1)
    es = sharded_es(mesh, scenarios=dist)
    es.train(2, verbose=False)
    out["scenario_counts"] = np.asarray([sum(r["scenarios"]["counts"]) for r in es.history])
    return out


def rank_kill(rank: int, pop: int, model: int, rdv: str, work: Path) -> None:
    mesh = _join(rank, pop, model, rdv)
    es = sharded_es(mesh)
    es.train(1, verbose=False)
    if rank == 1:
        os.kill(os.getpid(), 9)  # SIGKILL: no goodbye to the group
    t0 = time.perf_counter()
    try:
        es.train(2, verbose=False)
        got = {"error": None}
    except tmesh.CollectiveError as e:
        got = {"error": type(e).__name__, "message": str(e)}
    got["seconds"] = time.perf_counter() - t0
    (work / "kill_rank0.json").write_text(json.dumps(got))


def rank_card(rank: int, pop: int, model: int, rdv: str, work: Path,
              device: str = "cuda:0") -> None:
    """Program mode on ``device`` (the card test): generation 0's noise,
    3 generations, the local shards."""
    mesh = _join(rank, pop, model, rdv, device)
    es = sharded_es(mesh)
    noise = noise_rows(es, 4)
    es.train(GENS, verbose=False)
    np.savez(work / f"card_{pop}x{model}_rank{rank}.npz", noise0=noise,
             params=es.state.params_flat.cpu().numpy(),
             local=es.state.params_local.cpu().numpy())


MODES = {"main": rank_main, "kill": rank_kill, "card": rank_card}


def launch(mode: str, pop: int, model: int, work: Path, deadline_s: float = 240.0,
           device: str | None = None) -> list:
    """Start the ``pop·model`` ranks of ``mode`` and wait for them; returns
    their (returncode, stderr tail)."""
    rdv = work / f"{mode}{pop}x{model}.rdv"
    rdv.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("ESTORCH_CHAOS", None)
    extra = [device] if device else []
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r), str(pop), str(model),
                               str(rdv), str(work), *extra],
                              env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                              text=True)
             for r in range(pop * model)]
    outs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=deadline_s)
            outs.append((p.returncode, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _all_ok(outs):
    for rc, err in outs:
        assert rc == 0, err


# ----------------------------------------------------- the JAX reference


def _jax_reference(work: Path) -> dict:
    """JAX's ``ShardedESEngine`` on a (2, 2) ``Auto`` mesh: table mode,
    program mode and program low rank 2, ``GENS`` generations each, their
    draws saved for the ranks.  Returns JAX's results."""
    import jax
    import optax
    from jax.sharding import AxisType, Mesh
    from test_torch_envs import jax_resets

    import estorch_tpu.envs as jenvs
    from estorch_tpu import ES as JES
    from estorch_tpu import JaxAgent
    from estorch_tpu import MLPPolicy as JMLPPolicy
    from estorch_tpu.ops.lowrank import lowrank_program_factors
    from estorch_tpu.ops.noise import program_noise, row_noise_key
    from estorch_tpu.parallel import mesh as jmesh
    from estorch_tpu.parallel.engine import _gen_keys

    def auto_mesh(pop_shards=None, model_shards=None, devices=None):
        devs = np.asarray(jax.devices()[:4]).reshape(2, 2)
        return Mesh(devs, (jmesh.POP_AXIS, jmesh.MODEL_AXIS), axis_types=(AxisType.Auto,) * 2)

    saved, jout = {}, {}
    tenv = CartPole()
    cases = (("t", {"noise_mode": "table"}), ("p", {}), ("l", {"low_rank": 2}))
    orig = jmesh.hyperscale_mesh
    jmesh.hyperscale_mesh = auto_mesh  # estorch_tpu/algo/es.py imports it at call time
    try:
        for prefix, over in cases:
            jes = JES(JMLPPolicy, JaxAgent(jenvs.CartPole(), horizon=HORIZON), optax.adam,
                      population_size=32, sigma=0.1, seed=0, policy_kwargs=POLICY,
                      optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16,
                      eval_chunk=8, shard_params=True, telemetry=False, **over)
            eng = jes.engine
            assert dict(zip(eng.mesh.axis_names, eng.mesh.devices.shape)) == {"pop": 2,
                                                                               "model": 2}
            if prefix == "t":
                saved["table"] = np.asarray(jes.table.data)
            saved[f"{prefix}params0"] = np.asarray(jes.state.params_flat)
            gens = GENS if prefix != "l" else 2
            saved[f"{prefix}gens"] = np.int64(gens)
            rows = eng.rows_global
            for g in range(gens):
                st = jes.state
                okey, rkey = _gen_keys(st)
                saved[f"{prefix}states{g}"] = jax_resets(
                    eng.env, tenv, jax.random.split(rkey, rows)).numpy()
                if prefix == "t":
                    saved[f"{prefix}offsets{g}"] = np.asarray(eng._offsets(okey))
                else:
                    with jax.threefry_partitionable(True):
                        for i, lk in enumerate(eng._leaf_keys(okey)):
                            shape = eng.leaf_shapes[i]
                            if i in eng._factored:
                                m, n = eng._factored[i]
                                ab = [lowrank_program_factors(2, m, n, row_noise_key(lk, r))
                                      for r in range(rows)]
                                saved[f"{prefix}{g}_leaf{i}a"] = np.stack(
                                    [np.asarray(a).reshape(-1) for a, _ in ab])
                                saved[f"{prefix}{g}_leaf{i}b"] = np.stack(
                                    [np.asarray(b).reshape(-1) for _, b in ab])
                            else:
                                saved[f"{prefix}{g}_leaf{i}"] = np.stack(
                                    [np.asarray(program_noise(lk, r, shape)).reshape(-1)
                                     for r in range(rows)])
                jes.state, jm = eng.generation_step(st)
                jout[f"{prefix}fitness{g}"] = np.asarray(jm["fitness"])
                jout[f"{prefix}steps{g}"] = int(jm["steps"])
                jout[f"{prefix}params{g}"] = np.asarray(jes.state.params_flat)
    finally:
        jmesh.hyperscale_mesh = orig
    np.savez(work / "jax.npz", **saved)
    return jout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's reference, then the ranks at (1, 2), (2, 1) and (2, 2)."""
    work = tmp_path_factory.mktemp("sharded")
    jout = _jax_reference(work)
    for pop, model in SHAPES:
        _all_ok(launch("main", pop, model, work))
    ranks = {(pop, model): [dict(np.load(work / f"{pop}x{model}_rank{r}.npz"))
                            for r in range(pop * model)]
             for pop, model in SHAPES}
    return jout, ranks


def _port(flat_jax: np.ndarray) -> np.ndarray:
    flat, _ = interop.params_from_jax(flat_jax, sharded_es().spec)
    return flat.numpy()


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1", "2x2"])
def test_table_mode_matches_jax_sharded(runs, shape):
    """Table mode from JAX's table, params, offsets and reset states:
    fitness, alive steps and params of each generation within JAX's gate."""
    jout, ranks = runs
    got = ranks[shape][0]
    for g in range(GENS):
        _close(got[f"tfitness{g}"], jout[f"tfitness{g}"], f"{shape} fitness {g}")
        assert int(got[f"tsteps{g}"]) == jout[f"tsteps{g}"]
        _close(got[f"tparams{g}"], _port(jout[f"tparams{g}"]), f"{shape} params {g}")


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1", "2x2"])
def test_table_mode_equals_the_replicated_world_1(runs, shape):
    """The port's own draws: table mode at each shape against
    ``ESEngine`` at world 1 from the same seed with the kernel update
    (float64 sums rounded once on both sides: bit-equal here; held at JAX's
    gate)."""
    _, ranks = runs
    kw = dict(population_size=32, sigma=0.1, seed=0, policy_kwargs=POLICY,
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16, eval_chunk=8,
              telemetry=False, device="cpu", noise_kernel=True)
    w1 = ES(MLPPolicy, DeviceAgent(CartPole(), horizon=HORIZON), adam, **kw)
    w1.train(GENS, verbose=False)
    got = ranks[shape][0]
    np.testing.assert_array_equal(got["table_steps"], [r["env_steps"] for r in w1.history])
    _close(got["table_params"], w1.state.params_flat.numpy(), f"{shape}")


def test_program_mode_with_jax_draws_matches_jax(runs):
    """Program mode at (1, 2) with JAX's program noise injected, dense and
    low rank 2 (JAX's factors A, B), against JAX's program mode."""
    jout, ranks = runs
    got = ranks[(1, 2)][0]
    for prefix, gens in (("p", GENS), ("l", 2)):
        for g in range(gens):
            _close(got[f"{prefix}fitness{g}"], jout[f"{prefix}fitness{g}"], f"{prefix} fit {g}")
            assert int(got[f"{prefix}steps{g}"]) == jout[f"{prefix}steps{g}"]
            _close(got[f"{prefix}params{g}"], _port(jout[f"{prefix}params{g}"]),
                   f"{prefix} params {g}")


def test_program_noise_is_mesh_shape_invariant(runs):
    """The port's own stream: generation 0's noise bit-identical at (1, 1),
    (1, 2), (2, 1) and (2, 2), and the params after 3 generations within
    the gate (the counterpart of ``test_program_mode_mesh_shape_invariance``)."""
    _, ranks = runs
    es = sharded_es()
    noise = noise_rows(es, 4)
    es.train(GENS, verbose=False)
    for shape in SHAPES:
        got = ranks[shape][0]
        assert got["noise0"].tobytes() == noise.tobytes(), shape
        _close(got["program_params"], es.state.params_flat.numpy(), f"{shape}")
    # a standard normal's first two moments over these rows, loosely
    assert abs(noise.mean()) < 0.1 and abs(noise.std() - 1) < 0.1


def test_ghost_padded_population_matches_one_rank(runs):
    """Population 10 (5 noise rows: a ghost row at 2 pop shards) against
    the (1, 1) mesh."""
    _, ranks = runs
    es = sharded_es(population_size=10)
    es.train(2, verbose=False)
    for shape in SHAPES:
        _close(ranks[shape][0]["pop10_params"], es.state.params_flat.numpy(), f"{shape}")


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1", "2x2"])
def test_shared_shards_are_bit_identical(runs, shape):
    """Every rank ends with the same gathered params, and ranks of one
    model index (the same shards) hold the same local bits."""
    _, ranks = runs
    pop, model = shape
    rs = ranks[shape]
    for key in ("table_params", "program_params", "pop10_params"):
        assert all(r[key].tobytes() == rs[0][key].tobytes() for r in rs), key
    for r in range(model, pop * model):
        for key in ("table_local", "program_local"):
            assert rs[r][key].tobytes() == rs[r % model][key].tobytes(), (r, key)


def test_low_rank_program_mode_trains_and_stays_finite(runs):
    _, ranks = runs
    got = ranks[(1, 2)]
    assert np.isfinite(got[0]["lowrank_params"]).all()
    assert got[0]["lowrank_params"].tobytes() == got[1]["lowrank_params"].tobytes()
    assert not np.array_equal(got[0]["lowrank_params"], got[0]["program_params"])


def test_user_rules_row_parallel_and_whole_kernels(runs):
    """User rules at (1, 2): a row-parallel kernel (partial products
    summed, the split bias added by its owner) and a whole kernel beside a
    split bias, against the replicated world 1 in table mode."""
    _, ranks = runs
    got = ranks[(1, 2)][0]
    report = json.loads(str(got["user_rules_report"]))
    assert report["dense_0/kernel"] == str(tmesh.P(tmesh.MODEL_AXIS, None))
    assert report["head/kernel"] == str(tmesh.P(None, None))
    assert report["head/bias"] == str(tmesh.P(tmesh.MODEL_AXIS))
    w1 = sharded_es(noise_mode="table")
    w1.train(GENS, verbose=False)
    _close(got["user_rules_params"], w1.state.params_flat.numpy(), "user rules")


def test_collapsed_population_rolls_back_on_every_rank(runs):
    _, ranks = runs
    assert all(bool(r["nan_rolled_back"]) for r in ranks[(1, 2)])


def test_best_theta_is_the_best_member(runs):
    _, ranks = runs
    for r in ranks[(1, 2)]:
        assert r["best_theta"].tobytes() == r["best_member"].tobytes()


def test_es_end_to_end_sharded(runs):
    """``ES(shard_params=True)`` at (1, 2): the manifest names the noise
    mode, the mesh and the rules' JSON; the cost model's sharding block
    has the model shards; the best member is ``member_params`` of the
    best generation's best member (table mode, checked against the
    replicated world 1's best)."""
    from estorch_tpu_torch.parallel.mesh import DEFAULT_PARTITION_RULES, partition_rules_to_json

    _, ranks = runs
    got = ranks[(1, 2)][0]
    cfg = json.loads(str(got["manifest"]))
    assert cfg["shard_params"] is True and cfg["noise_mode"] == "table"
    assert cfg["mesh_axes"] == {"pop": 1, "model": 2}
    assert cfg["partition_rules"] == json.loads(json.dumps(
        partition_rules_to_json(DEFAULT_PARTITION_RULES)))
    sharding = json.loads(str(got["cost_sharding"]))
    assert sharding["model_shards"] == 2 and sharding["n_devices"] == 2
    w1 = sharded_es(noise_mode="table")
    w1.train(2, verbose=False)
    _close(got["best_flat"], w1._best_flat.numpy(), "best member")


def test_poisoned_update_rejected_alike_and_resumed(runs):
    """A ``nan_update`` at generation 1 is rejected on both ranks (one
    rejection each, then the run goes on); the run ends where a clean run
    ends (the re-run generation draws the same sample)."""
    _, ranks = runs
    rs = ranks[(1, 2)]
    assert [int(r["poison_rejected"]) for r in rs] == [1, 1]
    assert rs[0]["poison_params"].tobytes() == rs[1]["poison_params"].tobytes()
    _close(rs[0]["poison_params"], rs[0]["program_params"], "poisoned run")


def test_run_resilient_overlap_and_scenarios_compose(runs):
    _, ranks = runs
    got = ranks[(1, 2)][0]
    assert int(got["resilient_skips"]) == 1
    assert got["resilient_params"].tobytes() == got["program_params"].tobytes()
    assert got["overlap_params"].tobytes() == got["program_params"].tobytes()
    np.testing.assert_array_equal(got["scenario_counts"], [32, 32])


def test_periodic_checkpoints_gather_on_every_rank(runs):
    """A ``PeriodicCheckpointer`` on both ranks of (1, 2): every rank
    reaches the gather, rank 0 writes the whole params and Adam moments,
    and only the newest two checkpoints are kept."""
    _, ranks = runs
    got = ranks[(1, 2)][0]
    root = Path(str(got["ck_root"]))
    assert sorted(d.name for d in root.iterdir()) == [f"gen_{g:08d}" for g in (1, 2)]
    payload = torch.load(root / "gen_00000002" / "state" / "payload.pt", weights_only=True)
    st = payload["states"][0]
    assert st["params_flat"].numpy().tobytes() == got["ck_params"].tobytes()
    assert st["opt_state"]["mu"].numpy().tobytes() == got["ck_mu"].tobytes()
    assert all(r["ck_params"].tobytes() == got["ck_params"].tobytes() for r in ranks[(1, 2)])


def test_killed_rank_is_a_timed_error(tmp_path):
    """Rank 1 of (1, 2) SIGKILLs itself after a generation; rank 0's next
    collective raises ``CollectiveError`` naming the timeout, within it."""
    outs = launch("kill", 1, 2, tmp_path)
    assert outs[0][0] == 0, outs[0][1]
    got = json.loads((tmp_path / "kill_rank0.json").read_text())
    assert got["error"] == "CollectiveError", got
    assert "timeout" in got["message"]
    assert got["seconds"] < RANK_TIMEOUT_S + 30


# ------------------------------------------------------- in one process


def test_options_are_validated_as_jax():
    """The sharding keywords without ``shard_params`` raise ``ValueError``
    as JAX's do; the engine refuses what JAX's refuses."""
    from estorch_tpu_torch import PooledAgent, RecurrentPolicy

    for kw in ({"model_shards": 2}, {"partition_rules": []}, {"noise_mode": "program"}):
        with pytest.raises(ValueError, match="pass shard_params=True"):
            sharded_es(shard_params=False, **kw)
    with pytest.raises(ValueError, match="noise_mode must be auto"):
        sharded_es(shard_params=True, noise_mode="bad")
    for kw, match in (({"streamed": True}, "streamed is a replicated-engine option"),
                      ({"noise_kernel": True}, "noise_kernel is a replicated"),
                      ({"decomposed": True}, "decomposed is a replicated"),
                      ({"obs_norm": True}, "obs_norm is a replicated"),
                      ({"compute_dtype": "bfloat16"}, "runs in float32"),
                      ({"episodes_per_member": 2}, "episodes_per_member"),
                      ({"noise_mode": "table", "low_rank": 1}, "low_rank noise is generated")):
        with pytest.raises(ValueError, match=match):
            sharded_es(shard_params=True, **kw)
    with pytest.raises(ValueError, match="feedforward"):
        ES(RecurrentPolicy, DeviceAgent(CartPole(), horizon=5), adam, device="cpu",
           shard_params=True, policy_kwargs={"action_dim": 2}, table_size=1 << 14,
           optimizer_kwargs={"learning_rate": 1e-2})
    with pytest.raises(ValueError, match="device-native rollouts"):
        ES(MLPPolicy, PooledAgent("cartpole", horizon=5), adam, device="cpu",
           shard_params=True, policy_kwargs=POLICY, table_size=1 << 14,
           optimizer_kwargs={"learning_rate": 1e-2})
    with pytest.raises(TypeError, match="HyperscaleMesh"):
        sharded_es(shard_params=True, mesh=tmesh.single_device_mesh("cpu"))
    from estorch_tpu_torch.parallel.engine import EngineConfig
    from estorch_tpu_torch.parallel.sharded import ShardedESEngine

    cfg = EngineConfig(population_size=4, sigma=0.1, horizon=5)
    with pytest.raises(ValueError, match="needs a NoiseTable"):
        ShardedESEngine(CartPole(), MLPPolicy(**POLICY), sharded_es().spec, None, adam(1e-2),
                        cfg, tmesh.hyperscale_mesh(devices="cpu"), noise_mode="table")
    with pytest.raises(ValueError, match="mesh"):
        ShardedESEngine(CartPole(), MLPPolicy(**POLICY), sharded_es().spec, None, adam(1e-2),
                        cfg, tmesh.single_device_mesh("cpu"))


def test_program_mode_allocates_no_table_and_one_rank_is_world_1():
    """Program mode holds no table; table mode at (1, 1) is the replicated
    ``ESEngine`` with the kernel update (its float64 sum rounded once, as
    the sharded update's) bit for bit: fitness, params, update norms, best
    member."""
    es = sharded_es(shard_params=True)
    assert es.table is None and es.engine.table is None
    kw = dict(population_size=32, sigma=0.1, seed=0, policy_kwargs=POLICY,
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16, eval_chunk=8,
              telemetry=False, device="cpu", noise_kernel=True)
    a = ES(MLPPolicy, DeviceAgent(CartPole(), horizon=HORIZON), adam, **kw)
    b = sharded_es(shard_params=True, noise_mode="table")
    a.train(GENS, verbose=False)
    b.train(GENS, verbose=False)
    assert torch.equal(a.state.params_flat, b.state.params_flat)
    assert [r["grad_norm"] for r in a.history] == [r["grad_norm"] for r in b.history]
    assert torch.equal(a._best_flat, b._best_flat)


def test_program_noise_stream_moments():
    """The port's program stream (Threefry-2x32-20, then Box–Muller): over
    2^20 draws the first two moments, and the correlation of neighbouring
    elements and of neighbouring rows, within sampling error (5 standard
    errors)."""
    from estorch_tpu_torch.ops.noise import leaf_noise_keys, program_noise

    key = leaf_noise_keys(3, 7, 2)[1]
    z = program_noise(key, torch.arange(64), torch.arange(1 << 14)).double()
    n = z.numel()
    se = 5.0 / np.sqrt(n)
    assert abs(float(z.mean())) < se
    assert abs(float(z.var()) - 1.0) < 5.0 * np.sqrt(2.0 / n)
    zc = z - z.mean()
    elem = float((zc[:, 1:] * zc[:, :-1]).mean() / zc.var())
    rows = float((zc[1:] * zc[:-1]).mean() / zc.var())
    assert abs(elem) < se and abs(rows) < se


def test_program_noise_threefry_is_the_published_function():
    """The one Threefry of the stream (in place, the generator's) equals
    Random123's threefry2x32_20 test vector (key 0, counter 0) and JAX's
    ``threefry_2x32`` word for word at 64 counters under each of 4 random
    keys; the int form the keys are derived with is the same function."""
    import jax.numpy as jnp
    from jax.extend.random import threefry_2x32

    from estorch_tpu_torch.ops.noise import threefry2x32, threefry2x32_

    w0, w1 = torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64)
    threefry2x32_((0, 0), w0, w1)
    assert (int(w0), int(w1)) == (0x6B200159, 0x99BA4EFE)
    rng = np.random.default_rng(5)
    for _ in range(4):
        key = tuple(int(v) for v in rng.integers(0, 1 << 32, 2))
        x = rng.integers(0, 1 << 32, (2, 64))
        w0, w1 = torch.from_numpy(x[0].copy()), torch.from_numpy(x[1].copy())
        threefry2x32_(key, w0, w1)
        want = np.asarray(threefry_2x32(jnp.asarray(key, jnp.uint32),
                                        jnp.asarray(x.reshape(-1), jnp.uint32))).astype(np.int64)
        np.testing.assert_array_equal(w0.numpy(), want[:64])
        np.testing.assert_array_equal(w1.numpy(), want[64:])
        assert threefry2x32(key, int(x[0, 0]), int(x[1, 0])) == (int(want[0]), int(want[64]))


def test_pbt_refuses_a_sharded_es():
    from estorch_tpu_torch.scenarios import PBTController

    with pytest.raises(ValueError, match="sharded"):
        PBTController(sharded_es(shard_params=True), n_centers=2)


def test_elastic_host_from_a_shard_spec(tmp_path):
    """A thread host built from a spec with ``shard`` (table mode at (1,
    1)) serves the coordinator's replicated engine: the same fitness as a
    replicated host, so the folded run equals one with a replicated host."""
    from estorch_tpu_torch.parallel.elastic import (ElasticCoordinator, es_from_spec,
                                                    run_host_thread)

    spec = {"env": "CartPole", "population_size": 16, "horizon": 30, "seed": 3,
            "table_size": 1 << 16, "device": "cpu", "telemetry": False}
    host_es = es_from_spec(dict(spec, shard=True))
    assert host_es._shard_params and host_es._noise_mode == "table"
    params = []
    for shard in (True, False):
        coord_es = es_from_spec(spec)
        fleet = ElasticCoordinator(join_grace_s=60.0)
        worker = run_host_thread(fleet.address, es_from_spec(dict(spec, shard=shard)), 0)[0]
        try:
            coord_es.train_elastic(3, fleet=fleet, verbose=False)
        finally:
            fleet.close()
            worker.stop()
        params.append(coord_es.state.params_flat)
    assert torch.equal(params[0], params[1])


if __name__ == "__main__":
    mode, rank, pop, model, rdv, work = sys.argv[1:7]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        MODES[mode](int(rank), int(pop), int(model), rdv, Path(work), *sys.argv[7:])
