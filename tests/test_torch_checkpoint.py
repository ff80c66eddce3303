"""The port's checkpoint (``estorch_tpu_torch/utils/checkpoint.py``) and
``interop.restore_from_jax`` against the JAX package, on the CPU.

Resume is bit-exact on the device and host backends: a run checkpointed at
generation 2, restored into a fresh object and continued ends on the
uninterrupted run's params.  On the pooled backend the state restores bit
for bit and the run continues; the pools' env streams are not part of a
checkpoint in either package, so the episodes after a resume are new ones.
History, the best member, the NSRA archive, weight and meta RNG survive;
mismatches and unfinalized directories raise the JAX package's
``ValueError``s; ``meta.json`` carries the JAX package's keys.  A JAX
checkpoint's content carried across with ``restore_from_jax`` continues on
JAX's draws to JAX's own continuation, and a resumed IW-ES (whose reuse
window neither package saves) follows JAX's resumed IW-ES.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch
from test_scheduler import QuadAgent, TinyPolicy
from test_torch_envs import jax_sample
from test_torch_iwes import iw_pair
from test_torch_novelty import check_runs, device_pair

import estorch_tpu.envs as jenvs
import estorch_tpu.utils.checkpoint as jckpt
from estorch_tpu import ES as JES
from estorch_tpu import NSRA_ES as JNSRA_ES
from estorch_tpu import JaxAgent
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu.parallel import population_mesh
from estorch_tpu_torch import (ES, NSRA_ES, CartPole, DeviceAgent, MLPPolicy, Pendulum,
                               PooledAgent, adam, interop)
from estorch_tpu_torch.utils import (PeriodicCheckpointer, latest_checkpoint,
                                     restore_checkpoint, save_checkpoint)
from estorch_tpu_torch.utils import checkpoint as tckpt

CARTPOLE_POLICY = {"action_dim": 2, "hidden": (8,)}
PENDULUM_POLICY = {"action_dim": 1, "hidden": (8, 8), "discrete": False, "action_scale": 2.0}
DEVICE_KW = dict(population_size=16, sigma=0.1, seed=3, policy_kwargs=CARTPOLE_POLICY,
                 optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16)


def device_es(cls=ES, **over):
    kw = dict(DEVICE_KW, **over)
    return cls(MLPPolicy, DeviceAgent(CartPole(), horizon=50), adam, device="cpu", **kw)


def jax_device_es(cls=JES, **over):
    kw = dict(DEVICE_KW, **over)
    return cls(JMLPPolicy, JaxAgent(jenvs.CartPole(), horizon=50), optax.adam,
               mesh=population_mesh(jax.devices()[:1]), telemetry=False, **kw)


def host_es(**over):
    kw = dict(population_size=8, sigma=0.05, seed=1, optimizer_kwargs={"lr": 0.05},
              table_size=1 << 12, device="cpu", **over)
    return ES(TinyPolicy, QuadAgent, torch.optim.Adam, **kw)


def pooled_es(**over):
    kw = dict(population_size=16, sigma=0.1, seed=2, policy_kwargs=PENDULUM_POLICY,
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 14, obs_norm=True)
    kw.update(over)
    return ES(MLPPolicy, PooledAgent("pendulum", horizon=40), adam, device="cpu", **kw)


def assert_states_equal(a, b):
    """Two engine states bit for bit, tensors and scalars alike."""
    for name, x in a._asdict().items():
        y = getattr(b, name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        elif isinstance(x, tuple):
            for u, v in zip(x, y, strict=True):
                assert (torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v), name
        elif isinstance(x, dict):  # a torch optimizer's state dict
            assert torch.equal(x["state"][0]["exp_avg"], y["state"][0]["exp_avg"]), name
        else:
            assert x == y, name


# ------------------------------------------------------------- exact resume


@pytest.mark.parametrize("make", [device_es, host_es], ids=["device", "host"])
def test_resume_is_exact(tmp_path, make):
    """Train 4; a second run checkpointed at 2, restored into a fresh object
    and continued 2 more ends on the same params, bit for bit."""
    ref = make()
    ref.train(4, verbose=False)
    a = make()
    a.train(2, verbose=False)
    save_checkpoint(a, str(tmp_path / "ck"))
    b = make()
    restore_checkpoint(b, str(tmp_path / "ck"))
    assert b.generation == 2
    assert_states_equal(b.state, a.state)
    b.train(2, verbose=False)
    assert torch.equal(ref.state.params_flat, b.state.params_flat)
    assert b.state.generation == 4
    assert [r["reward_mean"] for r in b.history] == [r["reward_mean"] for r in ref.history]


def test_pooled_state_restores_exactly_and_continues(tmp_path):
    """Pendulum with obs_norm on the pooled backend: the restored state
    (params, Adam moments, σ, the Welford triple) equals the saved one bit
    for bit, and the restored run trains on (as the JAX package's
    ``test_pooled_resume_is_exact``)."""
    a = pooled_es()
    a.train(2, verbose=False)
    save_checkpoint(a, str(tmp_path / "ck"))
    b = pooled_es()
    restore_checkpoint(b, str(tmp_path / "ck"))
    assert b.generation == 2
    assert_states_equal(b.state, a.state)
    b.train(1, verbose=False)
    assert b.generation == 3 and torch.isfinite(b.state.params_flat).all()
    a.engine.close()
    b.engine.close()


def test_history_and_best_survive_resume(tmp_path):
    a = device_es()
    a.train(3, verbose=False)
    save_checkpoint(a, str(tmp_path / "ck"))
    b = device_es()
    restore_checkpoint(b, str(tmp_path / "ck"))
    assert [r["generation"] for r in b.history] == [0, 1, 2]
    assert b.history[2]["reward_max"] == a.history[2]["reward_max"]
    assert b.best_reward == a.best_reward
    assert torch.equal(b._best_flat, a._best_flat)
    b.train(1, verbose=False)
    assert [r["generation"] for r in b.history] == [0, 1, 2, 3]


def test_nsra_archive_weight_and_meta_rng_survive_resume(tmp_path):
    """NSRA-ES: the archive, the centers' BCs, w and its stagnation, every
    center and the meta RNG's position come back, and the resumed run picks
    the uninterrupted run's meta-individuals and ends on its params."""
    def mk():
        return device_es(NSRA_ES, meta_population_size=2, k=3, weight=0.8)

    ref = mk()
    ref.train(5, verbose=False)
    a = mk()
    a.train(3, verbose=False)
    save_checkpoint(a, str(tmp_path / "ck"))
    b = mk()
    restore_checkpoint(b, str(tmp_path / "ck"))
    np.testing.assert_array_equal(b.archive.bcs, a.archive.bcs)
    for x, y in zip(b._center_bc, a._center_bc, strict=True):
        np.testing.assert_array_equal(x, y)
    assert (b.weight, b._stagnation) == (a.weight, a._stagnation)
    assert b._rng.bit_generator.state == a._rng.bit_generator.state
    for sa, sb in zip(a.meta_states, b.meta_states, strict=True):
        assert_states_equal(sb, sa)
    b.train(2, verbose=False)
    assert [r["meta_index"] for r in b.history[3:]] == [r["meta_index"] for r in ref.history[3:]]
    for sr, sb in zip(ref.meta_states, b.meta_states, strict=True):
        assert torch.equal(sr.params_flat, sb.params_flat)


def test_meta_json_has_the_jax_keys(tmp_path):
    """The same NSRA-ES configuration checkpointed by both packages: the
    same ``meta.json`` keys, and equal values but for ``format_version``
    and the meta RNG's state (each package's own)."""
    kw = dict(meta_population_size=2, k=3, weight=0.6)
    j = jax_device_es(JNSRA_ES, **kw)
    t = device_es(NSRA_ES, **kw)
    j.train(1, verbose=False)
    t.train(1, verbose=False)
    jckpt.save_checkpoint(j, str(tmp_path / "j"))
    save_checkpoint(t, str(tmp_path / "t"))
    jm = json.load(open(tmp_path / "j" / "meta.json"))
    tm = json.load(open(tmp_path / "t" / "meta.json"))
    assert set(tm) == set(jm)
    for key in set(jm) - {"format_version", "meta_rng_state", "nsra_weight",
                          "nsra_stagnation"}:
        assert tm[key] == jm[key], key
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


@pytest.mark.parametrize("case", ["backend", "algo", "obs_norm", "format"])
def test_mismatch_raises(tmp_path, case):
    """A checkpoint restored into the wrong object raises JAX's ValueError."""
    a = pooled_es() if case == "obs_norm" else device_es()
    a.train(1, verbose=False)
    save_checkpoint(a, str(tmp_path / "ck"))
    if case == "format":
        meta = json.load(open(tmp_path / "ck" / "meta.json"))
        meta["format_version"] = 3  # the JAX package's
        json.dump(meta, open(tmp_path / "ck" / "meta.json", "w"))
    other = {"backend": host_es, "algo": lambda: device_es(NSRA_ES, meta_population_size=2, k=3),
             "obs_norm": lambda: pooled_es(obs_norm=False), "format": device_es}[case]()
    match = {"backend": "backend 'device' != this object's 'host'",
             "algo": "algo 'ES' != this object's 'NSRA_ES'",
             "obs_norm": "written with obs_norm=True", "format": "format v3"}[case]
    with pytest.raises(ValueError, match=match):
        restore_checkpoint(other, str(tmp_path / "ck"))
    for es in (a, other):
        if hasattr(es.engine, "close"):
            es.engine.close()


def test_payload_holds_cpu_tensors_loadable_weights_only(tmp_path):
    """A payload holds CPU tensors, loadable with ``weights_only=True``."""
    a = device_es()
    a.train(1, verbose=False)
    save_checkpoint(a, str(tmp_path / "ck"))
    tree = torch.load(tmp_path / "ck" / "state" / tckpt.PAYLOAD, weights_only=True)
    assert tree["states"][0]["params_flat"].device.type == "cpu"
    assert tree["generation"] == 1 and tree["states"][0]["opt_state"]["count"] == 1


# ------------------------------------------------------- periodic and async


def test_periodic_every_k_and_gc(tmp_path):
    es = device_es()
    ck = PeriodicCheckpointer(es, str(tmp_path / "cks"), every=2, max_to_keep=2)
    es.train(6, log_fn=ck.on_record)
    kept = sorted(os.listdir(tmp_path / "cks"))
    assert kept == ["gen_00000003", "gen_00000005"]  # gens 1, 3, 5 saved; 1 collected
    assert ck.latest().endswith(kept[-1])


def test_async_save_restores_bit_exact(tmp_path):
    """An async save taken at generation 2 holds generation 2's state
    although training goes on before it is waited for."""
    es = device_es()
    es.train(2, verbose=False)
    handle = save_checkpoint(es, str(tmp_path / "ck"), asynchronous=True)
    es.train(2, verbose=False)
    handle.wait()
    handle.wait()  # idempotent
    b = device_es()
    restore_checkpoint(b, str(tmp_path / "ck"))
    ref = device_es()
    ref.train(2, verbose=False)
    assert b.generation == 2
    assert torch.equal(b.state.params_flat, ref.state.params_flat)


def test_periodic_async_resume_exact(tmp_path):
    es = device_es()
    ck = PeriodicCheckpointer(es, str(tmp_path / "cks"), every=2, max_to_keep=2,
                              asynchronous=True)
    es.train(4, log_fn=ck.on_record)
    ck.wait()
    b = device_es()
    restore_checkpoint(b, ck.latest())
    assert b.generation == 4
    assert torch.equal(es.state.params_flat, b.state.params_flat)


def test_async_gc_deferred_until_durable(tmp_path, monkeypatch):
    """With ``max_to_keep=1`` the old checkpoint stays until the new async
    save is durable: the writer is held at its commit while the test looks."""
    es = device_es()
    es.train(1, verbose=False)
    ck = PeriodicCheckpointer(es, str(tmp_path / "cks"), every=1, max_to_keep=1,
                              asynchronous=True)
    ck.save(0)
    ck.wait()
    first = ck.latest()
    import threading

    gate = threading.Event()
    commit = tckpt._commit_payload

    def held_commit(tree, path):
        gate.wait(30)
        commit(tree, path)

    monkeypatch.setattr(tckpt, "_commit_payload", held_commit)
    ck.save(1)
    assert os.path.isdir(os.path.join(first, "state"))  # in flight: still there
    assert ck.latest() == first
    gate.set()
    ck.close()
    assert sorted(os.listdir(tmp_path / "cks")) == ["gen_00000001"]


def test_unfinalized_dir_raises_and_latest_skips_it(tmp_path):
    es = device_es()
    es.train(2, verbose=False)
    ck = PeriodicCheckpointer(es, str(tmp_path / "cks"), every=1)
    good = ck.save(1)
    partial = os.path.join(str(tmp_path / "cks"), "gen_00000099")
    shutil.copytree(good, partial)
    shutil.rmtree(os.path.join(partial, "state"))
    assert ck.latest() == good == latest_checkpoint(str(tmp_path / "cks"))
    with pytest.raises(ValueError, match="no finalized state"):
        restore_checkpoint(device_es(), partial)


# -------------------------------------------------------- across packages


def jax_checkpoint_content(jes, path):
    """A JAX checkpoint written to ``path`` and read back as numpy:
    ``(tree, meta, history)``."""
    jckpt.save_checkpoint(jes, str(path))
    tree = ocp.StandardCheckpointer().restore(str(path / "state"), jckpt._state_tree(jes))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    meta = json.load(open(path / "meta.json"))
    return tree, meta, json.load(open(path / "history.json"))


def test_jax_checkpoint_carried_across_continues_as_jax(tmp_path):
    """CartPole, pop 16: a JAX run checkpointed at generation 2, its content
    carried into a fresh port ES with ``restore_from_jax``, then 2 more
    generations on JAX's draws, against JAX's own continuation: params
    within 1e-6 relative, Adam's count exact, the records' reward means
    equal."""
    jes = jax_device_es()
    tes = device_es()
    tes.engine.table = tes.table = interop.table_from_numpy(np.asarray(jes.table.data))
    j0 = jes.state
    tes.engine.sample = lambda st: jax_sample(jes, tes.env,
                                              j0._replace(generation=jnp.int32(st.generation)))
    jes.train(2, verbose=False)
    tree, meta, history = jax_checkpoint_content(jes, tmp_path / "j")
    interop.restore_from_jax(tes, tree, meta, history)
    assert tes.generation == 2 and tes.state.opt_state.count == 2
    assert tes.best_reward == jes.best_reward
    jes.train(2, verbose=False)
    tes.train(2, verbose=False)
    assert tes.state.opt_state.count == int(jes.state.opt_state[0].count) == 4
    np.testing.assert_allclose(tes.state.params_flat.numpy(), np.asarray(jes.state.params_flat),
                               rtol=1e-6, atol=1e-7)
    assert [r["reward_mean"] for r in tes.history] == [r["reward_mean"] for r in jes.history]


def test_jax_nsra_checkpoint_carried_across_continues_as_jax(tmp_path):
    """NSRA-ES on Pendulum with JAX's draws injected: JAX's checkpoint at
    generation 2 carries the archive, the centers' BCs, w, the meta RNG
    and both centers; the port's continuation picks JAX's meta-individuals
    and follows JAX's within the novelty tests' tolerances."""
    jes, tes = device_pair("NSRA_ES", jenvs.Pendulum(), Pendulum(), PENDULUM_POLICY, 20,
                           weight=0.6)
    type(tes).__name__ = "NSRA_ES"  # the injecting subclass checks in as the algorithm
    jes.train(2, verbose=False)
    tree, meta, history = jax_checkpoint_content(jes, tmp_path / "j")
    interop.restore_from_jax(tes, tree, meta, history)
    assert (tes.weight, tes._stagnation) == (jes.weight, jes._stagnation)
    assert tes._rng.bit_generator.state == jes._rng.bit_generator.state
    np.testing.assert_array_equal(tes.archive.bcs, jes.archive.bcs)
    check_runs(jes, tes, 2, "nsra carried across")


def test_restore_from_jax_rejects_a_mismatch(tmp_path):
    jes = jax_device_es()
    jes.train(1, verbose=False)
    tree, meta, history = jax_checkpoint_content(jes, tmp_path / "j")
    with pytest.raises(ValueError, match="algo 'ES' != this object's 'NSRA_ES'"):
        interop.restore_from_jax(device_es(NSRA_ES, meta_population_size=2, k=3), tree, meta)
    with pytest.raises(ValueError, match="device and pooled"):
        interop.restore_from_jax(host_es(), tree, meta)


def test_resumed_iwes_follows_jax_resumed_iwes(tmp_path):
    """IW-ES (reuse window 2) checkpointed at generation 2 and resumed 2
    generations, in each package from its own checkpoint.  Neither saves
    the reuse window, so both resumed runs start with it empty: the reuse
    decisions equal (nothing at the first resumed generation, one window
    at the second), and params within the IW-ES trajectory test's 2e-5."""
    jes, tes = iw_pair()
    jes.train(2, verbose=False)
    tes.train(2, verbose=False)
    jckpt.save_checkpoint(jes, str(tmp_path / "j"))
    save_checkpoint(tes, str(tmp_path / "t"))
    jb, tb = iw_pair()
    jckpt.restore_checkpoint(jb, str(tmp_path / "j"))
    restore_checkpoint(tb, str(tmp_path / "t"))
    assert len(tb._prev) == len(jb._prev) == 0
    jb.train(2, verbose=False)
    tb.train(2, verbose=False)
    assert [r["reused_gens"] for r in tb.history[2:]] == \
        [r["reused_gens"] for r in jb.history[2:]] == [0, 1]
    np.testing.assert_allclose(tb.state.params_flat.numpy(), np.asarray(jb.state.params_flat),
                               rtol=0, atol=2e-5)
