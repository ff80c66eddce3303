"""The public names the port added last (ROADMAP item 11) against the JAX
package's on the same numpy inputs: ``ops.count_params``,
``ops.normalized_score``, ``envs.EnvSpec``, ``envs.make_rollout`` and
``envs.make_population_rollout`` (``doctor.probe_device`` is held in
``tests/test_torch_doctor.py``).  The rollouts take the initial states
where JAX's take keys: JAX's reset states of the same keys are handed over
(``test_torch_envs.jax_resets``).  Tolerances: CartPole's returns and steps
equal (alive steps), its BC (the final observation) within 1e-5; Pendulum's
float32 returns within 1e-5 relative (XLA fuses the physics' multiply-adds,
ROADMAP's note on ``collect_reference_batch``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import estorch_tpu.envs as jenvs
import estorch_tpu_torch.envs as tenvs
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu import RecurrentPolicy as JRecurrentPolicy
from estorch_tpu import ops as jops
from estorch_tpu_torch import MLPPolicy, RecurrentPolicy, interop, ops
from estorch_tpu_torch.ops.params import make_param_spec
from test_torch_envs import jax_resets


def test_count_params_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": {"kernel": rng.normal(size=(3, 4)), "bias": rng.normal(size=4)},
            "b": [rng.normal(size=(2, 2, 5)), rng.normal(size=())], "c": None}
    assert ops.count_params(tree) == jops.count_params(tree) == 12 + 4 + 20 + 1
    jm = JMLPPolicy(action_dim=2, hidden=(8, 8))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((4,)))
    tm = MLPPolicy(action_dim=2, hidden=(8, 8))
    assert ops.count_params(tm.init_params(4, torch.Generator())) == jops.count_params(v)


@pytest.mark.parametrize("kind", ["normal", "constant", "one"])
def test_normalized_score_matches_jax(kind):
    rng = np.random.default_rng(1)
    x = {"normal": rng.normal(3.0, 2.0, size=257), "constant": np.full(16, 4.5),
         "one": np.asarray([7.0])}[kind].astype(np.float32)
    want = np.asarray(jops.normalized_score(jnp.asarray(x)))
    got = ops.normalized_score(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if kind != "normal":
        np.testing.assert_array_equal(got, np.zeros_like(x))


@pytest.mark.parametrize("name", ["CartPole", "Pendulum", "Cheetah2D"])
def test_env_spec_matches_jax(name):
    jenv, tenv = getattr(jenvs, name)(), getattr(tenvs, name)()
    for horizon in (None, 17):
        want = jenvs.EnvSpec.of(jenv, horizon)
        got = tenvs.EnvSpec.of(tenv, horizon)
        assert {f: getattr(got, f) for f in ("obs_dim", "action_dim", "discrete", "horizon",
                                             "bc_dim")} == want.__dict__


def _mlp_pair(jenv, action_dim, discrete, seed=0):
    kw = {"action_dim": action_dim, "hidden": (8,), "discrete": discrete}
    if not discrete:
        kw["action_scale"] = 2.0
    jm = JMLPPolicy(**kw)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((jenv.obs_dim,)))
    tm = MLPPolicy(**kw)
    _, spec = make_param_spec(tm.init_params(jenv.obs_dim, torch.Generator()))
    return jm, v, tm, spec


def _check(got, want, rtol):
    np.testing.assert_allclose(got.total_reward.numpy(), np.asarray(want.total_reward),
                               rtol=rtol, atol=rtol)
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    np.testing.assert_allclose(got.bc.numpy(), np.asarray(want.bc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,rtol", [("CartPole", 0.0), ("Pendulum", 1e-5)])
def test_make_rollout_matches_jax(name, rtol):
    """One episode from JAX's reset of the same key, the MLP's params
    handed over: return, alive steps and BC."""
    jenv, tenv = getattr(jenvs, name)(), getattr(tenvs, name)()
    jm, v, tm, spec = _mlp_pair(jenv, 2 if jenv.discrete else 1, jenv.discrete)
    horizon = 60
    key = jax.random.PRNGKey(3)
    want = jenvs.make_rollout(jenv, lambda p, o: jm.apply({"params": p}, o), horizon)(
        v["params"], key)
    _, params = interop.params_from_jax(np.asarray(jax.flatten_util.ravel_pytree(
        v["params"])[0]), spec)
    got = tenvs.make_rollout(tenv, tm.apply_params, horizon)(
        params, jax_resets(jenv, tenv, key[None])[0])
    assert got.total_reward.shape == () and got.bc.shape == (jenv.bc_dim,)
    _check(got, want, rtol)


def test_make_rollout_threads_a_recurrent_carry_as_jax():
    """A GRU policy's carry from ``carry_init`` through one CartPole
    episode."""
    jenv, tenv = jenvs.CartPole(), tenvs.CartPole()
    kw = {"action_dim": 2, "hidden": (8,), "gru_size": 8}
    jm, tm = JRecurrentPolicy(**kw), RecurrentPolicy(**kw)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((4,)), jm.carry_init())
    _, spec = make_param_spec(tm.init_params(4, torch.Generator()))
    _, params = interop.params_from_jax(np.asarray(jax.flatten_util.ravel_pytree(
        v["params"])[0]), spec)
    key = jax.random.PRNGKey(9)
    want = jenvs.make_rollout(jenv, lambda p, o, h: jm.apply({"params": p}, o, h), 80,
                              carry_init=jm.carry_init)(v["params"], key)
    got = tenvs.make_rollout(tenv, tm.apply_params, 80, carry_init=tm.carry_init)(
        params, jax_resets(jenv, tenv, key[None])[0])
    _check(got, want, 0.0)


@pytest.mark.parametrize("name,rtol", [("CartPole", 0.0), ("Pendulum", 1e-5)])
def test_make_population_rollout_matches_jax(name, rtol):
    """Six members' stacked params (the center plus noise) from JAX's
    resets of six keys: every member's return, steps and BC."""
    jenv, tenv = getattr(jenvs, name)(), getattr(tenvs, name)()
    jm, v, tm, spec = _mlp_pair(jenv, 2 if jenv.discrete else 1, jenv.discrete)
    flat, unravel = jax.flatten_util.ravel_pytree(v["params"])
    rng = np.random.default_rng(2)
    thetas = np.asarray(flat)[None] + 0.3 * rng.normal(size=(6, flat.shape[0])).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    want = jenvs.make_population_rollout(jenv, lambda p, o: jm.apply({"params": p}, o), 60)(
        jax.vmap(unravel)(jnp.asarray(thetas)), keys)
    tflat = torch.stack([interop.params_from_jax(t, spec)[0] for t in thetas])
    got = tenvs.make_population_rollout(tenv, tm.apply_params, 60)(
        spec.unravel(tflat), jax_resets(jenv, tenv, keys))
    assert got.total_reward.shape == (6,)
    _check(got, want, rtol)


@pytest.mark.parametrize("channel", ["with_obs_moments", "with_env_metrics"])
def test_make_rollout_aux_channels_match_jax(channel):
    """The episode's aux channel as JAX's: the raw observations' count, sum
    and sum of squares over the alive steps (Pendulum), or the summed gait
    metrics (Cheetah2D), within 1e-4 relative (float32 sums of physics
    XLA fuses)."""
    name = "Pendulum" if channel == "with_obs_moments" else "Cheetah2D"
    jenv, tenv = getattr(jenvs, name)(), getattr(tenvs, name)()
    jm, v, tm, spec = _mlp_pair(jenv, jenv.action_dim, False)
    key = jax.random.PRNGKey(6)
    _, want = jenvs.make_rollout(jenv, lambda p, o: jm.apply({"params": p}, o), 30,
                                 **{channel: True})(v["params"], key)
    _, params = interop.params_from_jax(np.asarray(jax.flatten_util.ravel_pytree(
        v["params"])[0]), spec)
    _, got = tenvs.make_rollout(tenv, tm.apply_params, 30, **{channel: True})(
        params, jax_resets(jenv, tenv, key[None])[0])
    want = want if isinstance(want, tuple) else (want,)
    got = tuple(got) if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_make_population_rollout_threads_a_learned_carry_as_jax():
    """Four members of a GRU policy with a learned episode-start carry
    (``carry_init(params)``, each member's own) through CartPole."""
    jenv, tenv = jenvs.CartPole(), tenvs.CartPole()
    kw = {"action_dim": 2, "hidden": (8,), "gru_size": 8, "learned_carry": True}
    jm, tm = JRecurrentPolicy(**kw), RecurrentPolicy(**kw)
    v = jm.init(jax.random.PRNGKey(1), jnp.zeros((4,)), jm.carry_init())
    flat, unravel = jax.flatten_util.ravel_pytree(v["params"])
    _, spec = make_param_spec(tm.init_params(4, torch.Generator()))
    rng = np.random.default_rng(3)
    thetas = np.asarray(flat)[None] + 0.3 * rng.normal(size=(4, flat.shape[0])).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    want = jenvs.make_population_rollout(
        jenv, lambda p, o, h: jm.apply({"params": p}, o, h), 60,
        carry_init=lambda p: jm.carry_init(p))(jax.vmap(unravel)(jnp.asarray(thetas)), keys)
    tflat = torch.stack([interop.params_from_jax(t, spec)[0] for t in thetas])
    got = tenvs.make_population_rollout(tenv, tm.apply_params, 60, carry_init=tm.carry_init)(
        spec.unravel(tflat), jax_resets(jenv, tenv, keys))
    _check(got, want, 0.0)
