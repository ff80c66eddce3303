"""The port's IW-ES (``algo/iwes.py``) and the engine's reuse reductions
(``ESEngine.noise_stats``, ``apply_weights_reuse``) against the JAX
package, on the CPU.

The module functions are NumPy on both sides and held equal.  The
reductions take the JAX side's table, state and offsets.  A whole IW-ES run
takes the JAX side's draws each generation (its params, table, offsets and
member reset states, routed as in ``tests/test_torch_novelty.py``).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_host import QuadraticAgent, TorchMLP
from test_torch_recurrent import rec_sample

import estorch_tpu.envs as jenvs
from estorch_tpu import IW_ES as JIW_ES
from estorch_tpu import ES as JES
from estorch_tpu import JaxAgent
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu.algo import iwes as jiwes
from estorch_tpu.parallel import population_mesh
from estorch_tpu_torch import ES, IW_ES, CartPole, DeviceAgent, MLPPolicy, Pendulum, PooledAgent
from estorch_tpu_torch import adam, interop
from estorch_tpu_torch.algo import iwes

PENDULUM_POLICY = {"action_dim": 1, "hidden": (8, 8), "discrete": False, "action_scale": 2.0}


def _jax_kw(**kw):
    return dict(kw, mesh=population_mesh(jax.devices()[:1]), telemetry=False)


# -------------------------------------------------------- module functions


@pytest.mark.parametrize("c,clip", [(1.0, 2.0), (1.03, 1.5), (0.97, 100.0)],
                         ids=["c1", "c_above_1", "c_below_1"])
def test_module_functions_equal_jax(c, clip):
    """``stale_log_ratios``, ``mirrored_member_stats`` and
    ``clipped_stale_lambdas`` against JAX's on the same float32 inputs:
    equal (tolerance 0: the same NumPy operations)."""
    rng = np.random.default_rng(0)
    pairs, dim = 12, 97
    dots = rng.normal(size=pairs).astype(np.float32)
    norms = (dim + rng.normal(size=pairs) * 10).astype(np.float32)
    md, mn = iwes.mirrored_member_stats(dots, norms)
    jmd, jmn = jiwes.mirrored_member_stats(dots, norms)
    np.testing.assert_array_equal(md, jmd)
    np.testing.assert_array_equal(mn, jmn)
    assert md.shape == (2 * pairs,) and md[1] == -md[0]
    for args in ((md, mn, 0.7, c, dim), (dots, norms, 3.1, c, dim)):
        np.testing.assert_array_equal(iwes.stale_log_ratios(*args), jiwes.stale_log_ratios(*args))
        got = iwes.clipped_stale_lambdas(*args, clip)
        np.testing.assert_array_equal(got, jiwes.clipped_stale_lambdas(*args, clip))
        assert got.dtype == np.float32 and got.max() <= clip


# ---------------------------------------------------------- the reductions


def _pair(mirrored=True, **over):
    """A JAX ES and the port's on Pendulum, the port holding the JAX side's
    table and initial state."""
    kw = dict(population_size=16, sigma=0.1, seed=0, policy_kwargs=PENDULUM_POLICY,
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16,
              mirrored=mirrored, **over)
    jes = JES(JMLPPolicy, JaxAgent(jenvs.Pendulum(), horizon=20), optax.adam, **_jax_kw(**kw))
    tes = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, device="cpu", **kw)
    tes.engine.table = tes.table = interop.table_from_numpy(np.asarray(jes.table.data))
    flat, _ = interop.params_from_jax(np.asarray(jes.state.params_flat), tes.spec)
    tes.state = tes.engine.init_state(flat, seed=0)
    return jes, tes


def test_noise_stats_matches_jax():
    """(ε·d, |ε|²) of 40 rows, chunked 8 at a time as ``grad_chunk`` sets,
    against JAX's ``noise_stats``: within 1e-6 relative (float32 dot
    products of dim 97 in another order)."""
    jes, tes = _pair(grad_chunk=8)
    rng = np.random.default_rng(1)
    dim = tes.spec.dim
    offs = rng.integers(0, (1 << 16) - dim, size=40).astype(np.int32)
    d = rng.normal(size=dim).astype(np.float32)
    jd, jn = jes.engine.noise_stats(jnp.asarray(offs), jnp.asarray(d))
    td, tn = tes.engine.noise_stats(torch.from_numpy(offs), torch.from_numpy(d))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)


@pytest.mark.parametrize("mirrored,window", [(True, 1), (True, 2), (False, 2)],
                         ids=["mirrored_w1", "mirrored_w2", "unmirrored_w2"])
def test_apply_weights_reuse_matches_jax(mirrored, window):
    """The fresh-weights term, Σ old_w·ε_old over ``window`` old
    generations' rows and coeff_d @ d_stack, then the Adam step, against
    JAX's ``apply_weights_reuse`` from the same state: the update norm
    within 1e-6 relative, params within 1e-6 (one Adam step of lr 1e-2)."""
    jes, tes = _pair(mirrored=mirrored, grad_chunk=8)
    rng = np.random.default_rng(2)
    n, dim = 16, tes.spec.dim
    rows = n // 2 if mirrored else n
    w = (rng.random(n) - 0.5).astype(np.float32)
    old_offs = rng.integers(0, (1 << 16) - dim, size=rows * window).astype(np.int32)
    old_w = (rng.random(rows * window) * 0.01).astype(np.float32)
    d_stack = (rng.normal(size=(window, dim)) * 0.1).astype(np.float32)
    coeff = (rng.random(window) * 0.01).astype(np.float32)
    jnew, jg = jes.engine.apply_weights_reuse(jes.state, jnp.asarray(w), jnp.asarray(old_offs),
                                              jnp.asarray(old_w), jnp.asarray(d_stack),
                                              jnp.asarray(coeff))
    offs = torch.from_numpy(np.array(jes.engine.all_pair_offsets(jes.state)))
    tes.engine.all_pair_offsets = lambda st: offs
    tnew, tg = tes.engine.apply_weights_reuse(tes.state, torch.from_numpy(w),
                                              torch.from_numpy(old_offs),
                                              torch.from_numpy(old_w), torch.from_numpy(d_stack),
                                              torch.from_numpy(coeff))
    np.testing.assert_allclose(float(tg), float(jg), rtol=1e-6)
    np.testing.assert_allclose(tnew.params_flat.numpy(), np.asarray(jnew.params_flat), rtol=0,
                               atol=1e-6)
    assert tnew.generation == 1


def test_reductions_need_dense_noise():
    """Under ``low_rank`` both reductions raise JAX's ValueError."""
    tes = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=5), adam, device="cpu",
             population_size=8, policy_kwargs=PENDULUM_POLICY, table_size=1 << 12, low_rank=1,
             optimizer_kwargs={"learning_rate": 1e-2})
    d = torch.zeros(tes.spec.dim)
    with pytest.raises(ValueError, match="noise_stats needs the dense"):
        tes.engine.noise_stats(torch.zeros(2, dtype=torch.int32), d)
    with pytest.raises(ValueError, match="apply_weights_reuse needs the dense"):
        tes.engine.apply_weights_reuse(tes.state, torch.zeros(8),
                                       torch.zeros(4, dtype=torch.int32), torch.zeros(4),
                                       d[None], torch.zeros(1))


# ------------------------------------------------------------- trajectory

IW_SETTING = dict(population_size=16, sigma=0.1, seed=0, policy_kwargs=PENDULUM_POLICY,
                  optimizer_kwargs={"learning_rate": 1e-3}, table_size=1 << 16,
                  reuse_window=2, ess_min=0.5)


def iw_pair(**over):
    """JAX's IW_ES and the port's, the port taking the JAX side's table,
    params and each generation's draws (one center: seed 0 ↔ JAX's key)."""
    kw = dict(IW_SETTING, **over)
    jes = JIW_ES(JMLPPolicy, JaxAgent(jenvs.Pendulum(), horizon=20), optax.adam, **_jax_kw(**kw))
    tes = IW_ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, device="cpu", **kw)
    eng = tes.engine
    eng.table = tes.table = interop.table_from_numpy(np.asarray(jes.table.data))
    j0 = jes.state

    def jstate(st):
        return j0._replace(generation=jnp.int32(st.generation))

    eng.sample = lambda st: rec_sample(jes, tes.env, jstate(st))
    eng.all_pair_offsets = lambda st: torch.from_numpy(
        np.array(jes.engine.all_pair_offsets(jstate(st))))
    flat, _ = interop.params_from_jax(np.asarray(j0.params_flat), tes.spec)
    tes.state = eng.init_state(flat, seed=0)
    return jes, tes


@pytest.mark.parametrize("forward", [{}, {"decomposed": True}], ids=["standard", "decomposed"])
def test_iw_trajectory_with_reuse_matches_jax(forward):
    """Pendulum MLP (8, 8), pop 16, σ 0.1, Adam 1e-3 (≈ σ/√dim: small
    moves, so reuse is admitted), ``reuse_window=2``, 4 generations: the
    reuse decisions and reused counts equal, ESS within 1e-4 relative
    (JAX's reaches 14.4–15.9 against the threshold 8, clear of it), reward
    means within 1e-5 relative, params within 2e-5."""
    jes, tes = iw_pair(**forward)
    jes.train(4, verbose=False)
    tes.train(4, verbose=False)
    for j, t in zip(jes.history, tes.history):
        assert (t["reused_prev"], t["reused_gens"], t["effective_samples"]) == \
            (j["reused_prev"], j["reused_gens"], j["effective_samples"])
        np.testing.assert_allclose(t["ess"], j["ess"], rtol=1e-4)
        np.testing.assert_allclose(t["reward_mean"], j["reward_mean"], rtol=1e-5)
    assert [r["reused_gens"] for r in tes.history] == [0, 1, 2, 2]
    np.testing.assert_allclose(tes.state.params_flat.numpy(), np.asarray(jes.state.params_flat),
                               rtol=0, atol=2e-5)


def test_iw_records_and_dead_generation():
    """Generation 0 reuses nothing; fewer than 2 valid fresh members raise
    with the state intact; a violent step never passes the ESS guard and
    warns once, naming the lr ≲ σ/√dim fix (as JAX's slow test)."""
    es = IW_ES(MLPPolicy, DeviceAgent(CartPole(), horizon=10), adam, device="cpu",
               population_size=16, sigma=0.1, policy_kwargs={"action_dim": 2, "hidden": (8,)},
               optimizer_kwargs={"learning_rate": 5.0}, table_size=1 << 14)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        es.train(IW_ES.DRY_WARN_AFTER + 3, verbose=False)
    msgs = [w for w in caught if issubclass(w.category, RuntimeWarning)
            and "ESS guard" in str(w.message)]
    assert len(msgs) == 1 and "sigma/sqrt(dim)" in str(msgs[0].message)
    assert not any(r["reused_prev"] for r in es.history)
    r0 = es.history[0]
    assert r0["reused_prev"] is False and r0["effective_samples"] == 16 and "ess" in r0
    state = es.state
    real = es.engine.evaluate

    def dead(st, sample=None):
        ev = real(st, sample)
        return ev._replace(fitness=torch.full_like(ev.fitness, float("nan")))

    es.engine.evaluate = dead
    with pytest.raises(RuntimeError, match="valid fitness"):
        es.train(1, verbose=False)
    assert es.state is state


def _host_agent():
    return dict(policy=TorchMLP, agent=QuadraticAgent, optimizer=torch.optim.Adam,
                policy_kwargs={"hidden": 8}, optimizer_kwargs={"lr": 0.05})


def _iw(agent=None, **over):
    return IW_ES(MLPPolicy, agent or DeviceAgent(Pendulum(), horizon=5), adam, device="cpu",
                 population_size=8, policy_kwargs=PENDULUM_POLICY, table_size=1 << 12,
                 optimizer_kwargs={"learning_rate": 1e-2}, **over)


@pytest.mark.parametrize("build,match", [
    (lambda: _iw(ess_min=0.0), "ess_min must be in"),
    (lambda: _iw(reuse_window=0), "reuse_window must be"),
    (lambda: IW_ES(device="cpu", population_size=4, **_host_agent()), "device-path algorithm"),
    (lambda: _iw(PooledAgent("pendulum", horizon=5)), "device-path algorithm"),
    (lambda: _iw(low_rank=1), "does not support low_rank"),
    (lambda: _iw(streamed=True), "streamed/noise_kernel"),
    (lambda: _iw(noise_kernel=True), "streamed/noise_kernel"),
    (lambda: _iw(obs_norm=True), "does not support obs_norm"),
], ids=["ess_min", "reuse_window", "host", "pooled", "low_rank", "streamed", "noise_kernel",
        "obs_norm"])
def test_rejected_combinations_raise_as_in_jax(build, match):
    """The JAX package's ValueErrors (``estorch_tpu/algo/iwes.py:108-148``)."""
    with pytest.raises(ValueError, match=match):
        build()
