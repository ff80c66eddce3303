"""The port's novelty family (NS_ES, NSR_ES, NSRA_ES, NoveltyArchive) and the
engine's split path against the JAX package, on the CPU.

The archive is held bit for bit on the same NumPy BCs.  Whole runs take the
JAX side's draws: its table, each meta-center's initial params, and for
each generation of a center the JAX key's offsets, member reset states and
center-episode state, handed over through ``interop`` as in
``tests/test_torch_recurrent.py``.  The port's center m carries seed m, so
its engine's draws can be routed to JAX's center m (:func:`inject`).  The
meta index is drawn from one ``default_rng(seed)`` stream on both sides.
The pooled runs share their C++ pools' seeds, the host runs the NumPy table
and the ``SeedSequence`` offsets, so those two need only the params.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_envs import jax_resets
from test_torch_host import BCAgent, TorchMLP
from test_torch_recurrent import rec_pair, rec_sample

import estorch_tpu.envs as jenvs
from estorch_tpu import NS_ES as JNS_ES
from estorch_tpu import NSR_ES as JNSR_ES
from estorch_tpu import NSRA_ES as JNSRA_ES
from estorch_tpu import JaxAgent
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu import NoveltyArchive as JNoveltyArchive
from estorch_tpu import PooledAgent as JPooledAgent
from estorch_tpu import RecurrentPolicy as JRecurrentPolicy
from estorch_tpu.parallel import population_mesh
from estorch_tpu.parallel.engine import _gen_keys
from estorch_tpu_torch import (
    ES,
    NS_ES,
    NSR_ES,
    NSRA_ES,
    CartPole,
    DeviceAgent,
    MLPPolicy,
    NoveltyArchive,
    Pendulum,
    PooledAgent,
    RecurrentPolicy,
    adam,
    interop,
)

PAIRS = {"NS_ES": (JNS_ES, NS_ES), "NSR_ES": (JNSR_ES, NSR_ES), "NSRA_ES": (JNSRA_ES, NSRA_ES)}
PENDULUM_POLICY = {"action_dim": 1, "hidden": (8, 8), "discrete": False, "action_scale": 2.0}

# ------------------------------------------------------------------ archive


def _bcs(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32) * 3.0


@pytest.mark.parametrize("k,max_size,dim", [(3, 0, 4), (10, 0, 2), (2, 5, 3), (4, 1, 1)],
                         ids=["k3", "k_over_size", "evict_5", "evict_1"])
def test_archive_bit_equal_to_jax(k, max_size, dim):
    """Adds, FIFO eviction, novelty of batched and single queries, the
    empty archive and the state-dict round trip: bit-equal (tolerance 0,
    the same NumPy operations on the same float32 BCs)."""
    jar, tar = JNoveltyArchive(k=k, max_size=max_size), NoveltyArchive(k=k, max_size=max_size)
    q = _bcs(1, 9, dim)
    np.testing.assert_array_equal(tar.novelty(q), jar.novelty(q))  # empty: ones
    for i, bc in enumerate(_bcs(0, 12, dim)):
        jar.add(bc)
        tar.add(bc.astype(np.float64))  # any dtype: stored as float32
        assert len(tar) == len(jar)
        np.testing.assert_array_equal(tar.bcs, jar.bcs)
        np.testing.assert_array_equal(tar.novelty(q), jar.novelty(q), err_msg=f"add {i}")
        assert tar.novelty(q[0]) == jar.novelty(q[0])
    assert np.ndim(tar.novelty(q[0])) == 0
    sd = tar.state_dict()
    assert sd.keys() == jar.state_dict().keys()
    back = NoveltyArchive.from_state_dict(jar.state_dict())
    assert (back.k, back.bc_dim, back.max_size) == (k, dim, max_size)
    np.testing.assert_array_equal(back.novelty(q), jar.novelty(q))
    np.testing.assert_array_equal(NoveltyArchive.from_state_dict(sd).bcs, jar.bcs)


def test_archive_knn_oracle_and_errors():
    """Novelty is the mean of the k smallest Euclidean distances (a brute
    force oracle, rtol 1e-5: the float64 |q|²+|a|²−2q·a identity against a
    float32 norm); a BC of another dim and a negative max_size raise."""
    ar = NoveltyArchive(k=3)
    a = _bcs(2, 20, 4)
    for row in a:
        ar.add(row)
    q = _bcs(3, 7, 4)
    want = [np.sort(np.linalg.norm(a - row, axis=1))[:3].mean() for row in q]
    np.testing.assert_allclose(ar.novelty(q), want, rtol=1e-5)
    with pytest.raises(ValueError, match="dim"):
        ar.add(np.zeros(5))
    with pytest.raises(ValueError, match="max_size"):
        NoveltyArchive(max_size=-1)


# ------------------------------------------------------------- weights

FITNESS = np.array([3.0, 1.0, 2.0, 5.0, np.nan, 4.0], dtype=np.float32)
NOVELTY = np.array([0.1, 0.9, 0.5, 0.2, 0.7, 0.3], dtype=np.float32)


def _small(cls, **extra):
    return cls(MLPPolicy, DeviceAgent(CartPole(), horizon=10), adam, device="cpu",
               population_size=8, sigma=0.1, policy_kwargs={"action_dim": 2, "hidden": (4,)},
               optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 12,
               meta_population_size=2, k=3, **extra)


@pytest.mark.parametrize("name", list(PAIRS))
def test_weight_mixing_matches_jax(name):
    """Each variant's weights, with and without a failed (NaN) member, equal
    the JAX class's methods run on the same inputs (tolerance 0); NSRA at
    w = 0.25."""
    jcls, tcls = PAIRS[name]
    es = _small(tcls, **({"weight": 0.25} if name == "NSRA_ES" else {}))
    ok = np.isfinite(FITNESS)
    np.testing.assert_array_equal(es._combine_weights(FITNESS[ok], NOVELTY[ok]),
                                  jcls._combine_weights(es, FITNESS[ok], NOVELTY[ok]))
    got = es._weights_with_failures(FITNESS, NOVELTY)
    np.testing.assert_array_equal(got, jcls._weights_with_failures(es, FITNESS, NOVELTY))
    assert got[4] == 0.0
    with pytest.raises(RuntimeError, match="valid fitness"):
        es._weights_with_failures(np.full(6, np.nan, np.float32), NOVELTY)


def test_nsra_schedule_matches_jax():
    """w rises on a new best (capped at 1), decays by weight_delta after
    ``stagnation_patience`` generations without one (floored at 0), in the
    same steps as JAX's ``_post_update`` (tolerance 0)."""
    port = _small(NSRA_ES, weight=0.5, weight_delta=0.3, stagnation_patience=2)
    ref = copy.copy(port)
    seen = []
    for improved in [True] * 3 + [False] * 10:
        a, b = {"improved_best": improved}, {"improved_best": improved}
        port._post_update(a)
        JNSRA_ES._post_update(ref, b)
        assert a["nsra_weight"] == b["nsra_weight"] == port.weight == ref.weight
        seen.append(port.weight)
    assert max(seen) == 1.0 and seen[-1] == 0.0


# ------------------------------------------------------ injecting JAX's draws


def inject(tes, jes):
    """Hand JAX's table and meta-centers' params to the port and route the
    port engine's draws (samples, offsets, probe and center-episode states)
    to the JAX key of the same center at the same generation: port center m
    has seed m.  Called before the port seeds its archive."""
    eng = tes.engine
    eng.table = tes.table = interop.table_from_numpy(np.asarray(jes.table.data))
    jstates = list(jes.meta_states)

    def jstate(st):
        return jstates[st.seed]._replace(generation=jnp.int32(st.generation))

    def center_states(st):
        _, rkey = _gen_keys(jstate(st))
        return jax_resets(jes.env, tes.env, jax.random.fold_in(rkey, 2**31 - 1)[None])

    eng.sample = lambda st: rec_sample(jes, tes.env, jstate(st))
    eng.all_pair_offsets = lambda st: torch.from_numpy(
        np.array(jes.engine.all_pair_offsets(jstate(st))))
    eng.probe_states = lambda st: rec_sample(jes, tes.env, jstate(st)).probe_states
    eng.center_states = center_states
    tes.meta_states = [
        eng.init_state(interop.params_from_jax(np.asarray(js.params_flat), tes.spec)[0], seed=m)
        for m, js in enumerate(jstates)]
    tes.state = tes.meta_states[0]


def with_jax_draws(tcls, jes):
    """``tcls`` with :func:`inject` run just before the archive is seeded."""

    class Injected(tcls):
        def _seed_archive(self):
            inject(self, jes)
            super()._seed_archive()

    return Injected


def device_pair(name, jenv, tenv, policy_kwargs, horizon, jpolicy=JMLPPolicy,
                tpolicy=MLPPolicy, **kw):
    jcls, tcls = PAIRS[name]
    common = dict(population_size=16, sigma=0.1, seed=7, policy_kwargs=policy_kwargs,
                  optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 15,
                  meta_population_size=2, k=3)
    common.update(kw)
    jes = jcls(jpolicy, JaxAgent(jenv, horizon=horizon), optax.adam,
               mesh=population_mesh(jax.devices()[:1]), telemetry=False, **common)
    tes = with_jax_draws(tcls, jes)(tpolicy, DeviceAgent(tenv, horizon=horizon), adam,
                                    device="cpu", **common)
    return jes, tes


def meta_sums(es):
    return [round(float(np.asarray(s.params_flat).sum()), 5) for s in es.meta_states]


# ------------------------------------------------------------ the split path

SPLIT_CASES = {
    "standard": (JMLPPolicy, MLPPolicy, PENDULUM_POLICY, {}),
    "noise_kernel": (JMLPPolicy, MLPPolicy, PENDULUM_POLICY, {"noise_kernel": True}),
    "streamed_noise_kernel": (JMLPPolicy, MLPPolicy, PENDULUM_POLICY,
                              {"streamed": True, "noise_kernel": True}),
    "low_rank": (JMLPPolicy, MLPPolicy, PENDULUM_POLICY, {"low_rank": 2}),
    "recurrent_low_rank_tree": (JRecurrentPolicy, RecurrentPolicy,
                                dict(PENDULUM_POLICY, hidden=(8,), gru_size=8), {"low_rank": 1}),
    "obs_norm": (JMLPPolicy, MLPPolicy, PENDULUM_POLICY,
                 {"obs_norm": True, "obs_probe_episodes": 2}),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_path_matches_jax(name):
    """``evaluate`` then ``apply_weights`` with weights made on the host (a
    seeded NumPy draw, not ranks), on each forward, against the JAX engine's
    ``evaluate`` and ``apply_weights`` from the same state: fitness within
    1e-5 relative, BC within 1e-4 and alive steps equal; the update norm
    within 1e-5 relative, params within 1e-6 (one Adam step), and with
    obs_norm the stats refreshed from the generation's probe episodes (count
    equal, moments within 1e-5).  The port's ``apply_weights`` draws its
    offsets and probe states itself (``all_pair_offsets``,
    ``probe_states``), here routed to JAX's."""
    jpolicy, tpolicy, pk, opts = SPLIT_CASES[name]
    jes, tes = rec_pair(jenvs.Pendulum(), Pendulum(), jpolicy, tpolicy, pk, 20, **opts)
    sample = rec_sample(jes, tes.env, jes.state)
    tes.engine.sample = lambda st: sample
    tes.engine.all_pair_offsets = lambda st: sample.offsets
    tes.engine.probe_states = lambda st: sample.probe_states
    jev = jes.engine.evaluate(jes.state)
    tev = tes.engine.evaluate(tes.state)
    np.testing.assert_allclose(tev.fitness.numpy(), np.asarray(jev.fitness), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tev.bc.numpy(), np.asarray(jev.bc), rtol=1e-4, atol=1e-4)
    assert int(tev.steps) == int(jev.steps)
    w = np.random.default_rng(4).uniform(-0.5, 0.5, 16).astype(np.float32)
    jnew, jg = jes.engine.apply_weights(jes.state, jnp.asarray(w))
    tnew, tg = tes.engine.apply_weights(tes.state, torch.from_numpy(w))
    np.testing.assert_allclose(float(tg), float(jg), rtol=1e-5)
    np.testing.assert_allclose(tnew.params_flat.numpy(), np.asarray(jnew.params_flat), rtol=0,
                               atol=1e-6)
    assert tnew.generation == 1
    if opts.get("obs_norm"):
        assert float(tnew.obs_stats[0]) == float(jnew.obs_stats[0]) > 1.0
        for i in (1, 2):
            np.testing.assert_allclose(tnew.obs_stats[i].numpy(), np.asarray(jnew.obs_stats[i]),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("episodes", [1, 2])
def test_split_draws_replay_the_sample(episodes):
    """``all_pair_offsets`` and ``probe_states``, which ``apply_weights``
    draws, are :meth:`sample`'s offsets and probe states of the same
    generation, bit for bit (tolerance 0), with one and two episodes a
    member."""
    es = _small(NS_ES, obs_norm=True, obs_probe_episodes=3, episodes_per_member=episodes)
    eng, st = es.engine, es.state._replace(generation=5)
    sample = eng.sample(st)
    assert torch.equal(eng.all_pair_offsets(st), sample.offsets)
    assert sample.probe_states.shape[0] == 3
    assert torch.equal(eng.probe_states(st), sample.probe_states)


# ------------------------------------------------------------ golden recipes

GOLDEN_EXTRA = {"NS_ES": {}, "NSR_ES": {}, "NSRA_ES": {"weight": 0.7}}


@pytest.mark.parametrize("name", list(PAIRS))
def test_golden_recipe_matches_jax_goldens(name):
    """The tier-1 golden recipes (``tests/test_goldens.py``: CartPole, MLP
    (8,), pop 16, σ 0.1, seed 7, horizon 50, M 2, k 3, 3 generations) from
    JAX's draws: reward means equal to ``GOLDENS[name]`` (CartPole returns
    count alive steps, so equal actions give equal returns), the meta
    indices equal, meta-centers' param sums and the archive sum within
    2e-4, as the JAX golden test holds them."""
    from test_goldens import GOLDENS

    jes, tes = device_pair(name, jenvs.CartPole(), CartPole(),
                           {"action_dim": 2, "hidden": (8,)}, 50, **GOLDEN_EXTRA[name])
    tes.train(3, verbose=False)
    g = GOLDENS[name]
    assert [round(r["reward_mean"], 4) for r in tes.history] == g["reward_means"]
    assert [r["meta_index"] for r in tes.history] == g["meta_indices"]
    np.testing.assert_allclose(meta_sums(tes), g["meta_sums"], atol=2e-4)
    np.testing.assert_allclose(round(float(tes.archive.bcs.sum()), 5), g["archive_sum"],
                               atol=2e-4)
    assert len(tes.archive) == 2 + 3
    for key in ("center_reward", "novelty_mean", "novelty_max", "archive_size", "phases"):
        assert key in tes.history[-1]
    if name == "NSRA_ES":
        assert 0.0 <= tes.history[-1]["nsra_weight"] <= 1.0


def check_runs(jes, tes, gens, what, fit_rtol=1e-5, params_atol=1e-5):
    """Both runs generation by generation: the meta index, the records'
    reward means (``fit_rtol``), novelty means (1e-4 relative), archive
    sizes and center rewards (1e-4 relative), then every center's params
    (``params_atol``) and the archive (1e-4)."""
    for gen in range(gens):
        jes.train(1, verbose=False)
        tes.train(1, verbose=False)
        j, t = jes.history[-1], tes.history[-1]
        msg = f"{what} gen {gen}"
        assert t["meta_index"] == j["meta_index"], msg
        assert t["archive_size"] == j["archive_size"], msg
        np.testing.assert_allclose(t["reward_mean"], j["reward_mean"], rtol=fit_rtol,
                                   atol=fit_rtol, err_msg=msg)
        np.testing.assert_allclose(t["novelty_mean"], j["novelty_mean"], rtol=1e-4, err_msg=msg)
        np.testing.assert_allclose(t["center_reward"], j["center_reward"], rtol=1e-4,
                                   atol=1e-4, err_msg=msg)
        assert t["env_steps"] == j["env_steps"], msg
    for tst, jst in zip(tes.meta_states, jes.meta_states):
        np.testing.assert_allclose(np.asarray(tst.params_flat, np.float32),
                                   np.asarray(jst.params_flat), rtol=0, atol=params_atol,
                                   err_msg=what)
    np.testing.assert_allclose(tes.archive.bcs, jes.archive.bcs, rtol=1e-4, atol=1e-4,
                               err_msg=what)


def test_streamed_kernel_nsr_es_matches_jax():
    """NSR-ES on the cell's options (``streamed=True, noise_kernel=True``:
    the JAX package's Pallas kernels in interpret mode, the port's plain
    versions on the CPU), Pendulum MLP (8, 8), pop 16, horizon 20, M 3,
    k 3, 3 generations.  Tolerance: float32 over 20 steps and Adam steps,
    summed in other orders (reward means 1e-5 relative, params 1e-5)."""
    jes, tes = device_pair("NSR_ES", jenvs.Pendulum(), Pendulum(), PENDULUM_POLICY, 20,
                           sigma=0.05, seed=0, table_size=1 << 16, meta_population_size=3,
                           streamed=True, noise_kernel=True)
    check_runs(jes, tes, 3, "streamed+nk")


@pytest.mark.parametrize("opts", [{"obs_norm": True}, {"low_rank": 1}, {"decomposed": True}],
                         ids=["obs_norm", "low_rank", "decomposed"])
def test_device_options_nsra_es_match_jax(opts):
    """NSRA-ES (w 0.5) on the other device forwards: the split path's
    ``apply_weights`` refreshes the obs stats from the generation's probe
    draw (JAX's ``fold_in(rkey, 2**31-2)`` states), the low-rank update
    reduces factored rows, decomposed runs x@W + c(x@E).  Pendulum, 2
    generations; tolerances as the streamed test's."""
    jes, tes = device_pair("NSRA_ES", jenvs.Pendulum(), Pendulum(), PENDULUM_POLICY, 20,
                           sigma=0.05, seed=1, table_size=1 << 16, weight=0.5, **opts)
    check_runs(jes, tes, 2, str(opts))
    if opts.get("obs_norm"):
        for tst, jst in zip(tes.meta_states, jes.meta_states):
            assert float(tst.obs_stats[0]) == float(jst.obs_stats[0])
            np.testing.assert_allclose(tst.obs_stats[1].numpy(), np.asarray(jst.obs_stats[1]),
                                       rtol=1e-5, atol=1e-5)


def test_recurrent_ns_es_matches_jax():
    """NS-ES with a GRU policy (``RecurrentPolicy``, hidden (8,), GRU 8) on
    CartPole, the golden recipe's settings, 3 generations: reward means
    equal (alive steps), params within 1e-5."""
    jes, tes = device_pair("NS_ES", jenvs.CartPole(), CartPole(),
                           {"action_dim": 2, "hidden": (8,), "gru_size": 8}, 50,
                           jpolicy=JRecurrentPolicy, tpolicy=RecurrentPolicy)
    check_runs(jes, tes, 3, "recurrent", fit_rtol=0)


# ------------------------------------------------------- pooled and host


def test_pooled_ns_es_matches_jax():
    """NS-ES on ``PooledAgent("cartpole")`` (the C++ envpool, pools seeded
    alike) with JAX's table, params and offsets: 3 generations, reward
    means and center rewards equal (the same actions step the same envs),
    params within 1e-6."""
    kw = dict(population_size=16, sigma=0.1, seed=0, policy_kwargs={"action_dim": 2,
              "hidden": (16,)}, optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16,
              meta_population_size=2, k=3)
    agent = {"env_name": "cartpole", "horizon": 30}
    jes = JNS_ES(JMLPPolicy, JPooledAgent(**agent), optax.adam,
                 mesh=population_mesh(jax.devices()[:1]), telemetry=False, **kw)
    jstates = list(jes.meta_states)

    class Injected(NS_ES):
        def _seed_archive(self):
            core = self.engine.core
            self.table = core.table = interop.table_from_numpy(np.asarray(jes.table.data))
            core.all_pair_offsets = lambda st: torch.from_numpy(np.array(
                jes.engine.core.all_pair_offsets(
                    jstates[st.seed]._replace(generation=jnp.int32(st.generation)))))
            self.meta_states = [self.engine.init_state(interop.params_from_jax(
                np.asarray(js.params_flat), self.spec)[0], seed=m)
                for m, js in enumerate(jstates)]
            self.state = self.meta_states[0]
            super()._seed_archive()

    tes = Injected(MLPPolicy, PooledAgent(**agent), adam, device="cpu", **kw)
    try:
        np.testing.assert_array_equal(tes.archive.bcs, jes.archive.bcs)
        check_runs(jes, tes, 3, "pooled", fit_rtol=0, params_atol=1e-6)
        e = tes.evaluate_policy(4, meta_index=1, seed=3, return_details=True)
        je = jes.evaluate_policy(4, meta_index=1, seed=3, return_details=True)
        np.testing.assert_array_equal(e["rewards"], je["rewards"])
    finally:
        tes.engine.close()
        jes.engine.pool.close()
        jes.engine.center_pool.close()


@pytest.mark.parametrize("name,extra", [("NS_ES", {}), ("NSRA_ES", {"weight": 0.7})])
def test_host_novelty_matches_jax(name, extra):
    """The host path (``TestHostNovelty``): a torch MLP and an agent whose
    ``rollout`` returns (reward, BC) with the first two params as the BC,
    pop 32, M 2 (center 1 from ``policy_factory()``, key seed + 7919), k 3,
    3 generations: meta indices and archive sizes equal, reward means
    within 1e-6 relative (measured: equal), params within 2e-6 (the
    reduction's sum order, as ``tests/test_torch_host.py``)."""
    jcls, tcls = PAIRS[name]
    kw = dict(population_size=32, sigma=0.05, seed=0, policy_kwargs={"hidden": 8},
              optimizer_kwargs={"lr": 0.05}, table_size=1 << 16, meta_population_size=2, k=3,
              **extra)
    jes = jcls(TorchMLP, BCAgent, torch.optim.Adam, telemetry=False, **kw)
    tes = tcls(TorchMLP, BCAgent, torch.optim.Adam, device="cpu", **kw)
    assert tes.backend == "host"
    for tst, jst in zip(tes.meta_states, jes.meta_states):
        np.testing.assert_array_equal(tst.params_flat.numpy(), np.asarray(jst.params_flat))
        assert tst.key == jst.key
    assert not np.array_equal(tes.meta_states[0].params_flat, tes.meta_states[1].params_flat)
    check_runs(jes, tes, 3, name, fit_rtol=1e-6, params_atol=2e-6)
    assert len(tes.archive) == 2 + 3
    e1 = tes.evaluate_policy(2, meta_index=1)
    assert e1["episodes"] == 2 and np.isfinite(e1["mean"])


# ------------------------------------------------------------- meta_index


def test_evaluate_policy_meta_index_on_the_device_path():
    """``meta_index=m`` evaluates center m: the same episodes as a plain ES
    whose state is that center (tolerance 0), distinct centers, and JAX's
    ``ValueError``s with ``use_best`` and on a plain ``ES``."""
    es = _small(NS_ES)
    es.train(2, verbose=False)
    plain = ES(MLPPolicy, DeviceAgent(CartPole(), horizon=10), adam, device="cpu",
               population_size=8, sigma=0.1, policy_kwargs={"action_dim": 2, "hidden": (4,)},
               optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 12)
    for m in (0, 1):
        plain.state = es.meta_states[m]
        got = es.evaluate_policy(3, seed=5, meta_index=m, return_details=True)
        want = plain.evaluate_policy(3, seed=5, return_details=True)
        np.testing.assert_array_equal(got["rewards"], want["rewards"])
        np.testing.assert_array_equal(got["bc"], want["bc"])
    assert not torch.equal(es.meta_states[0].params_flat, es.meta_states[1].params_flat)
    with pytest.raises(ValueError, match="use_best"):
        es.evaluate_policy(2, meta_index=0, use_best=True)
    with pytest.raises(ValueError, match="novelty family"):
        plain.evaluate_policy(2, meta_index=0)


def test_scenarios_and_archive_cap():
    """``scenarios`` raises JAX's ValueError before the base class is built;
    ``archive_max_size`` caps the archive (FIFO)."""
    with pytest.raises(ValueError, match="scenarios is not wired into the novelty family"):
        NS_ES(MLPPolicy, object(), adam, scenarios=object())
    es = _small(NSR_ES, archive_max_size=3)
    es.train(3, verbose=False)
    assert len(es.archive) == 3 and es.archive.max_size == 3


# ------------------------------------------------------------------ recipes


@pytest.mark.parametrize("name", ["humanoid_nsres", "halfcheetah_nsres"])
def test_nsres_recipes_take_the_jax_options(name, monkeypatch):
    """The port's novelty recipes build ``NSR_ES`` with the JAX recipes'
    options (``estorch_tpu/configs.py:256-273``, ``:333-365``)."""
    import estorch_tpu
    import estorch_tpu.configs as jconfigs
    from estorch_tpu_torch import configs

    seen = []
    monkeypatch.setattr(configs, "NSR_ES", lambda **kw: seen.append(kw))
    monkeypatch.setattr(estorch_tpu, "NSR_ES", lambda **kw: seen.append(kw))
    getattr(configs, name)()
    getattr(jconfigs, name)()
    port_kw, jax_kw = seen
    assert port_kw.keys() == jax_kw.keys()
    for key in ("population_size", "sigma", "k", "meta_population_size", "policy_kwargs",
                "agent_kwargs", "optimizer_kwargs", "weight_decay"):
        assert port_kw.get(key) == jax_kw.get(key), key
    assert port_kw["policy"].__name__ == jax_kw["policy"].__name__
    assert port_kw["agent"].__name__ == jax_kw["agent"].__name__


@pytest.mark.parametrize("name", ["humanoid_nsres", "halfcheetah_nsres"])
def test_nsres_recipe_trains_one_generation(name, monkeypatch):
    """Each recipe at population 8 for one generation on MuJoCo (halfcheetah
    at horizon 30, its pool ``SyncVectorEnv``): the archive holds the 3
    centers' BCs and the updated center's, of the recipe's BC size (the
    final torso (x, y); the x-position)."""
    pytest.importorskip("mujoco")
    from estorch_tpu_torch import configs

    monkeypatch.setattr("os.sched_getaffinity", lambda pid: {0})
    over = {"population_size": 8, "device": "cpu", "table_size": 1 << 18}
    if name == "halfcheetah_nsres":
        over["agent_kwargs"] = {"env_name": "gym:HalfCheetah-v5", "horizon": 30,
                                "env_kwargs": {"exclude_current_positions_from_observation":
                                               False},
                                "bc_indices": (0,)}
    es = getattr(configs, name)(**over)
    try:
        assert isinstance(es, NSR_ES)
        es.train(1, verbose=False)
    finally:
        es.engine.close()
    rec = es.history[0]
    assert es.backend == ("host" if name == "humanoid_nsres" else "pooled")
    assert len(es.archive) == 4 and es.archive.bc_dim == (2 if name == "humanoid_nsres" else 1)
    assert rec["n_failed"] == 0 and np.isfinite(rec["reward_mean"])
