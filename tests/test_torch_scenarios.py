"""The port's scenario suite (``estorch_tpu_torch/scenarios``) against the
JAX package's (``estorch_tpu/scenarios``).

Every parameterized family's ``step_p`` is held against ``jax.vmap`` of
JAX's with the same per-member params; the distribution, ``ScenarioEnv``,
the fitness helpers, ``obs summarize``'s section and PBT's decisions
against JAX's on the same inputs; whole ES generations under scenarios
against the JAX engine from injected draws (params, table, offsets, reset
states and JAX's drawn variant table, ``interop``).  The two packages'
variant streams differ (threefry against the port's SeedSequence-seeded
generators), so a test that needs equal constants hands JAX's table over.
JAX's threefry observation noise cannot be injected: the port's noise is
held by the ``ScenarioEnv`` tests (twins, scale, determinism).
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import estorch_tpu.envs as jenvs
import estorch_tpu.scenarios as jsc
import estorch_tpu_torch.envs as tenvs
import estorch_tpu_torch.scenarios as tsc
from estorch_tpu import ES as JES
from estorch_tpu import JaxAgent
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu.parallel import population_mesh
from estorch_tpu.parallel.engine import _gen_keys
from estorch_tpu_torch import ES, NS_ES, DeviceAgent, MLPPolicy, adam, interop, sgd
from estorch_tpu_torch.envs.locomotion import _physics_step, _scaled_consts
from estorch_tpu_torch.parallel import Sample
from test_torch_envs import check_generation

FAMILIES = ["Pendulum", "CartPole", "Acrobot", "MountainCar", "MountainCarContinuous",
            "Hopper2D", "Cheetah2D", "Swimmer2D"]
PLANAR = ["Hopper2D", "Walker2D", "Humanoid2D", "Cheetah2D", "Swimmer2D"]
PEND_POLICY = {"action_dim": 1, "hidden": (8,), "discrete": False, "action_scale": 2.0}


def _pair(name):
    return getattr(jenvs, name)(), getattr(tenvs, name)()


def _key_words(key) -> np.ndarray:
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return np.asarray(key)


def _member_params(env, n: int, seed: int) -> dict:
    """Each member's own draw in ±30 % of every declared constant."""
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(0.7 * v, 1.3 * v, n).astype(np.float32)
            for k, v in env.scenario_defaults().items()}


def _actions(env, n: int, rng) -> np.ndarray:
    if env.discrete:
        return rng.integers(0, env.action_dim, n)
    return rng.uniform(-1.5, 1.5, (n, env.action_dim)).astype(np.float32)


def _reset_both(jenv, tenv, n: int, seed: int):
    sj, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(seed), n))
    return sj, interop.env_states_from_jax(tenv, sj)


# ------------------------------------------------------- params + distribution


def test_params_mapping_is_sorted_and_immutable():
    p = tsc.ScenarioParams({"m": torch.tensor(1.0), "g": torch.tensor(9.8)})
    assert p.names == ("g", "m") and list(p) == ["g", "m"] and len(p) == 2
    assert "g" in p and p.get("absent") is None and float(p["g"]) == pytest.approx(9.8)
    with pytest.raises(TypeError):
        p["g"] = torch.tensor(1.0)
    assert tsc.OBS_NOISE == jsc.OBS_NOISE == "obs_noise"
    for name in FAMILIES:
        jenv, tenv = _pair(name)
        assert tsc.scenario_field_names(tenv) == jsc.scenario_field_names(jenv)
        assert tenv.scenario_defaults() == jenv.scenario_defaults()


def _boring():
    class Boring:
        pass

    return Boring()


class _NoStepP:
    SCENARIO_FIELDS = ("x",)
    bc_dim = 1


# each case builds an invalid object with either package's namespace; both
# raise the same exception type with the same text
ERROR_CASES = {
    "lo_above_hi": lambda m, e: m.Range(2.0, 1.0),
    "log_needs_positive": lambda m, e: m.LogRange(0.0, 1.0),
    "not_finite": lambda m, e: m.Range(0.0, float("inf")),
    "no_variants": lambda m, e: m.ScenarioDistribution({"g": (1.0, 2.0)}, n_variants=0),
    "no_ranges": lambda m, e: m.ScenarioDistribution({}),
    "bad_range": lambda m, e: m.ScenarioDistribution({"g": 3.0}),
    "unknown_field": lambda m, e: m.ScenarioDistribution(
        {"warp_factor": (1.0, 9.0)}, 4).validate_for(e.Pendulum()),
    "unparameterized_env": lambda m, e: m.default_distribution(_boring()),
    "spread": lambda m, e: m.default_distribution(e.Pendulum(), spread=1.0),
    "schema": lambda m, e: m.ScenarioDistribution.from_json({"schema": 2}),
    "wrapper_has_no_step_p": lambda m, e: m.ScenarioEnv(
        e.PositionOnly(e.Walker2D()), m.ScenarioDistribution({"mass_scale": (0.9, 1.1)}, 2)),
    "no_step_p": lambda m, e: m.ScenarioEnv(_NoStepP(), m.ScenarioDistribution({"x": (0, 1)}, 2)),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_validation_raises_jax_text(case):
    build = ERROR_CASES[case]
    with pytest.raises(Exception) as want:
        build(jsc, jenvs)
    with pytest.raises(type(want.value)) as got:
        build(tsc, tenvs)
    assert str(got.value) == str(want.value)


def test_draws_deterministic_and_in_bounds():
    dist = tsc.ScenarioDistribution({"g": (7.0, 13.0), "m": tsc.LogRange(0.5, 2.0)},
                                    n_variants=16, seed=3)
    a = dist.draw_concrete(5)
    assert a == tsc.ScenarioDistribution(dict(dist.ranges), 16, seed=3).draw_concrete(5)
    assert a != dist.draw_concrete(6)
    for v in range(16):
        d = dist.draw_concrete(v)
        assert 7.0 <= d["g"] <= 13.0 and 0.5 <= d["m"] <= 2.0
    assert (tsc.ScenarioDistribution({"g": (7.0, 13.0)}, 4, seed=1).draw_concrete(0)
            != tsc.ScenarioDistribution({"g": (7.0, 13.0)}, 4, seed=2).draw_concrete(0))
    # a variant's draw depends on (seed, variant) alone, not on n_variants
    assert (tsc.ScenarioDistribution(dict(dist.ranges), 40, seed=3).draw_concrete(5) == a)
    # log-uniform: the log of the draws spreads evenly over [log lo, log hi]
    wide = tsc.ScenarioDistribution({"m": tsc.LogRange(0.01, 100.0)}, 4000, seed=0)
    logs = np.log10(wide.draw_all()["m"].numpy())
    assert abs(logs.mean()) < 0.1 and abs((logs < 0).mean() - 0.5) < 0.05


def test_draw_all_and_tensor_draws_read_one_table():
    dist = tsc.default_distribution(tenvs.Pendulum(), n_variants=5, spread=0.2, obs_noise=0.1)
    stacked = dist.draw_all()
    assert stacked.names == dist.names == ("g", "l", "m", "max_torque", "obs_noise")
    for i, name in enumerate(dist.names):
        assert stacked[name].shape == (5,) and stacked[name].dtype == torch.float32
        for v in range(5):
            assert float(dist.draw(v)[name]) == dist.draw_concrete(v)[name] \
                == float(stacked[name][v])
    variants = torch.tensor([4, 0, 0, 3])
    rows = dist.draw(variants)
    for name in dist.names:
        assert torch.equal(rows[name], stacked[name][variants])
    assert dist.table() is dist.table()  # drawn once


def test_spec_json_round_trip_and_equal_to_jax():
    ranges = {"g": (7.0, 13.0), "m": (0.5, 2.0)}
    dist = tsc.ScenarioDistribution(dict(ranges, m=tsc.LogRange(0.5, 2.0)), 12, seed=9)
    jdist = jsc.ScenarioDistribution(dict(ranges, m=jsc.LogRange(0.5, 2.0)), 12, seed=9)
    spec = json.loads(json.dumps(dist.spec_json()))
    assert spec == json.loads(json.dumps(jdist.spec_json()))
    clone = tsc.ScenarioDistribution.from_json(spec)
    assert clone.draw_concrete(7) == dist.draw_concrete(7)
    assert clone.n_variants == 12 and clone.seed == 9 and repr(clone) == repr(jdist)


@pytest.mark.parametrize("name", FAMILIES)
def test_default_distribution_spec_equals_jax(name):
    jenv, tenv = _pair(name)
    j = jsc.default_distribution(jenv, n_variants=7, spread=0.25, obs_noise=0.02, seed=4)
    t = tsc.default_distribution(tenv, n_variants=7, spread=0.25, obs_noise=0.02, seed=4)
    assert t.spec_json() == j.spec_json()


def test_the_variant_stream_is_its_own():
    """Salted as JAX salts its key: a distribution seeded with ES's own seed
    shares no generator seed with the engine's streams."""
    from estorch_tpu_torch.ops.noise import (SCENARIO_STREAM_SALT, scenario_variant_generator,
                                             scenario_variant_seed)
    from estorch_tpu_torch.parallel.engine import _seed_of, generation_seed

    from estorch_tpu.ops.noise import SCENARIO_STREAM_SALT as JAX_SALT

    assert SCENARIO_STREAM_SALT == JAX_SALT
    seeds = {scenario_variant_seed(0, v) for v in range(64)}
    assert len(seeds) == 64
    engine = {generation_seed(0, g) for g in range(64)} | {_seed_of(0, g, s) for g in range(64)
                                                          for s in (1, 2, 3)}
    assert not seeds & engine
    a = torch.rand(3, generator=scenario_variant_generator(5, 2))
    assert torch.equal(a, torch.rand(3, generator=scenario_variant_generator(5, 2)))


def test_interop_hands_over_jax_table():
    jdist = jsc.default_distribution(jenvs.CartPole(), n_variants=6, spread=0.3, seed=2)
    drawn = {n: np.asarray(v) for n, v in jdist.draw_all().items()}
    dist = interop.scenario_distribution_from_jax(jdist.spec_json(), drawn)
    for v in range(6):
        want = jdist.draw_concrete(v)
        assert dist.draw_concrete(v) == pytest.approx(want, rel=0, abs=0)
    with pytest.raises(ValueError, match="does not match"):
        interop.scenario_distribution_from_jax(
            jdist.spec_json(), {n: a[:3] for n, a in drawn.items()})


# ----------------------------------------------------------------- step_p


@pytest.mark.parametrize("name", FAMILIES)
def test_step_p_none_is_step_bit_for_bit(name):
    jenv, tenv = _pair(name)
    _, st = _reset_both(jenv, tenv, 32, 0)
    a = torch.from_numpy(_actions(tenv, 32, np.random.default_rng(0)))
    for x, y in zip(tenv.step(st, a), tenv.step_p(None, st, a)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", FAMILIES)
def test_step_p_with_defaults_as_tensors_matches_step(name):
    """The family's own defaults, one per member as tensors: within 1e-6 of
    the Python-float path (float32 folds of the constants differ a little
    from Python's float64 folds, as in JAX)."""
    jenv, tenv = _pair(name)
    n = 32
    _, st = _reset_both(jenv, tenv, n, 1)
    params = tsc.ScenarioParams({k: torch.full((n,), v, dtype=torch.float32)
                                 for k, v in tenv.scenario_defaults().items()})
    a = torch.from_numpy(_actions(tenv, n, np.random.default_rng(1)))
    for x, y in zip(tenv.step(st, a), tenv.step_p(params, st, a)):
        if x.dtype == torch.bool:
            assert torch.equal(x, y)
        else:
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-6, atol=1e-6)


# one env step from JAX's reset states under each member's own params: the
# atol of tests/test_torch_envs.py (Acrobot's RK4 3.5e-6 of fused
# multiply-adds over 50 steps; one step here) and of the planar first env
# step of tests/test_torch_locomotion.py (state 5e-5, obs and reward 1e-5)
STEP_TOL = {"Acrobot": (1e-5, 1e-5), "Hopper2D": (5e-5, 1e-5), "Cheetah2D": (5e-5, 1e-5),
            "Swimmer2D": (5e-5, 1e-5)}


@pytest.mark.parametrize("name", FAMILIES)
def test_step_p_matches_jax_with_member_params(name):
    jenv, tenv = _pair(name)
    n = 64
    sj, st = _reset_both(jenv, tenv, n, 2)
    draw = _member_params(jenv, n, 3)
    a = _actions(jenv, n, np.random.default_rng(4))
    nj, oj, rj, dj = jax.jit(jax.vmap(jenv.step_p))(
        jsc.ScenarioParams({k: jnp.asarray(v) for k, v in draw.items()}), sj, jnp.asarray(a))
    tparams = tsc.ScenarioParams({k: torch.from_numpy(v) for k, v in draw.items()})
    nt, ot, rt, dt = tenv.step_p(tparams, st, torch.from_numpy(a))
    state_atol, atol = STEP_TOL.get(name, (1e-6, 1e-6))
    np.testing.assert_allclose(nt.numpy(), interop.env_states_from_jax(tenv, nj).numpy(),
                               rtol=1e-6, atol=state_atol)
    np.testing.assert_allclose(ot.numpy(), np.array(oj), rtol=1e-6, atol=atol)
    np.testing.assert_allclose(rt.numpy(), np.broadcast_to(np.array(rj), rt.shape),
                               rtol=1e-6, atol=atol)
    np.testing.assert_array_equal(dt.numpy(), np.broadcast_to(np.array(dj), dt.shape))
    # and the draw matters: the plain step lands elsewhere
    assert not torch.allclose(tenv.step(st, torch.from_numpy(a))[0], nt)


@pytest.mark.parametrize("name", PLANAR)
def test_scaled_physics_step_matches_jax(name):
    """One physics step of 64 members under every scale at once, from
    perturbed reset poses: the per-member constants (the inertia from the
    scaled masses) at the tolerance of the plain physics step's test."""
    from estorch_tpu.envs.locomotion import _physics_step as jax_physics_step

    jenv, tenv = _pair(name)
    n = 64
    sj, st = _reset_both(jenv, tenv, n, 5)
    rng = np.random.default_rng(6)
    sj = dict(sj, vel=sj["vel"] + rng.uniform(-1, 1, sj["vel"].shape).astype(np.float32),
              omega=sj["omega"] + rng.uniform(-3, 3, sj["omega"].shape).astype(np.float32))
    st = interop.env_states_from_jax(tenv, sj)
    draw = _member_params(jenv, n, 7)
    a = np.clip(rng.uniform(-1.2, 1.2, (n, jenv.action_dim)), -1, 1).astype(np.float32)

    def jstep(p, s, u):
        return jax_physics_step(jenv._scenario_chain(p), s, u)

    want = jax.jit(jax.vmap(jstep))(jsc.ScenarioParams({k: jnp.asarray(v) for k, v in
                                                        draw.items()}), sj, jnp.asarray(a))
    k, neg_friction = _scaled_consts(tenv.chain, tenv._consts(torch.device("cpu")),
                                     {key: torch.from_numpy(v) for key, v in draw.items()})
    assert k.i_red.shape == (n, tenv.chain.n_joints) and k.div.shape == (n, tenv.chain.n_bodies, 3)
    lay = tenv.layout
    t_act = k.gear * torch.from_numpy(a) * k.i_red
    q, qd = _physics_step(tenv.chain, k, lay.q(st), lay.qd(st), t_act, neg_friction)
    np.testing.assert_allclose(lay.pack(q, qd, lay.t(st)).numpy(),
                               interop.env_states_from_jax(tenv, want).numpy(),
                               rtol=1e-6, atol=1e-5)


def test_locomotion_scales_change_dynamics():
    env = tenvs.Hopper2D()
    st, _ = env.reset(torch.Generator().manual_seed(0), 4)
    act = torch.full((4, env.action_dim), 0.5)
    base = env.step(st, act)[0]
    for name in env.SCENARIO_FIELDS:
        scaled = env.step_p(tsc.ScenarioParams({name: torch.full((4,), 0.5)}), st, act)[0]
        assert not torch.allclose(base, scaled), name
    # an obs-noise-only draw leaves the chain's cached constants in place
    same = env.step_p(tsc.ScenarioParams({"obs_noise": torch.full((4,), 0.5)}), st, act)[0]
    assert torch.equal(base, same)


# ------------------------------------------------------------- ScenarioEnv


def test_protocol_and_variant_column():
    dist = tsc.default_distribution(tenvs.Pendulum(), n_variants=7, spread=0.2)
    env = tsc.ScenarioEnv(tenvs.Pendulum(), dist)
    jenv = jsc.ScenarioEnv(jenvs.Pendulum(), jsc.default_distribution(jenvs.Pendulum(), 7, 0.2))
    for attr in ("obs_dim", "action_dim", "discrete", "default_horizon", "bc_dim",
                 "action_bound", "n_variants"):
        assert getattr(env, attr) == getattr(jenv, attr), attr
    states, obs = env.reset(torch.Generator().manual_seed(4), 50)
    assert states.shape == (50, 2 + 4 + 3) and obs.shape == (50, 3)
    states, obs, reward, done = env.step(states, torch.full((50, 1), 0.1))
    bc = env.behavior(states, obs)
    assert bc.shape == (50, 3)
    v = tsc.variant_of_bc(bc)
    assert np.array_equal(v, np.rint(v)) and v.min() >= 0 and v.max() < 7
    assert len(set(v.tolist())) > 3
    assert float(states[0, -1]) == 1.0  # the step count


def test_variant_determines_params():
    dist = tsc.default_distribution(tenvs.Pendulum(), n_variants=5, spread=0.3)
    env = tsc.ScenarioEnv(tenvs.Pendulum(), dist)
    s1, _ = env.reset(torch.Generator().manual_seed(8), 40)
    s2, _ = env.reset(torch.Generator().manual_seed(8), 40)
    assert torch.equal(s1, s2)
    variants = s1[:, 6].long()
    assert torch.equal(s1[:, 2:6], dist.table()[variants])
    for i in range(40):
        assert float(s1[i, 2]) == dist.draw_concrete(int(variants[i]))["g"]
    # the params ride the state through a step unchanged
    s3 = env.step(s1, torch.zeros(40, 1))[0]
    assert torch.equal(s3[:, 2:8], s1[:, 2:8])


def test_scenario_env_matches_jax_from_injected_states():
    """Twenty steps of JAX's ScenarioEnv (no observation noise) and the
    port's from JAX's reset states, with the JAX table handed over: states,
    obs, rewards and the BC with its variant column."""
    jbase, tbase = _pair("Pendulum")
    jdist = jsc.default_distribution(jbase, n_variants=6, spread=0.3, seed=3)
    drawn = {n: np.asarray(v) for n, v in jdist.draw_all().items()}
    jenv = jsc.ScenarioEnv(jbase, jdist)
    tenv = tsc.ScenarioEnv(tbase, interop.scenario_distribution_from_jax(jdist.spec_json(), drawn))
    n = 32
    sj, oj = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), n))
    sj = (sj[0], sj[1], sj[2], _key_words(sj[3]))
    st = interop.env_states_from_jax(tenv, sj)
    np.testing.assert_allclose(tenv.observe(st).numpy(), np.array(oj), rtol=1e-6, atol=1e-7)
    assert np.array_equal(st[:, -3].numpy(), np.asarray(sj[2], np.float32))
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(1)
    for i in range(20):
        a = rng.uniform(-2.5, 2.5, (n, 1)).astype(np.float32)
        sj, oj, rj, _ = jstep(sj, jnp.asarray(a))
        st, ot, rt, _ = tenv.step(st, torch.from_numpy(a))
        np.testing.assert_allclose(st[:, :2].numpy(), np.array(sj[0]), rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(ot.numpy(), np.array(oj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rt.numpy(), np.array(rj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tenv.behavior(st, ot).numpy(),
                               np.array(jax.vmap(jenv.behavior)(sj, oj)), rtol=1e-5, atol=1e-5)


def _noisy_env(scale=0.5, n_variants=3):
    return tsc.ScenarioEnv(tenvs.Pendulum(), tsc.ScenarioDistribution(
        {"g": (10.0, 10.0), "obs_noise": (scale, scale)}, n_variants, seed=0))


def test_obs_noise_is_a_function_of_the_state():
    env = _noisy_env()
    states, obs = env.reset(torch.Generator().manual_seed(2), 64)
    assert torch.equal(obs, env.observe(states))
    clean = env.base.observe(states[:, :2])
    assert not torch.allclose(obs, clean)
    nstates, nobs, _, _ = env.step(states, torch.zeros(64, 1))
    assert torch.equal(nobs, env.observe(nstates))
    # the next step's noise is a fresh draw
    d0, d1 = obs - clean, nobs - env.base.observe(nstates[:, :2])
    assert float((d0 - d1).abs().min()) > 0
    quiet = tsc.ScenarioEnv(tenvs.Pendulum(), tsc.ScenarioDistribution({"g": (10.0, 10.0)}, 3))
    qs, qo = quiet.reset(torch.Generator().manual_seed(2), 64)
    assert torch.equal(qo, quiet.base.observe(qs[:, :2]))


def test_obs_noise_scale_and_mean_over_many_draws():
    """4096 rows × 8 steps × 3 components of N(0, 1) scaled by 0.5: mean,
    standard deviation, the tails and the correlations of a standard normal
    (bounds at about 5 standard errors)."""
    env = _noisy_env(scale=0.5)
    n = 4096
    states, obs = env.reset(torch.Generator().manual_seed(3), n)
    draws = [(obs - env.base.observe(states[:, :2])) / 0.5]
    for _ in range(7):
        states, obs, _, _ = env.step(states, torch.zeros(n, 1))
        draws.append((obs - env.base.observe(states[:, :2])) / 0.5)
    z = torch.stack(draws).double()  # (steps, n, 3)
    count = z.numel()
    assert abs(float(z.mean())) < 5 / math.sqrt(count)
    assert abs(float(z.std()) - 1.0) < 0.01
    assert abs(float((z.abs() > 1.96).double().mean()) - 0.05) < 0.005
    for a, b in ((z[:-1], z[1:]), (z[..., 0], z[..., 1]), (z[..., 1], z[..., 2])):
        corr = float(((a - a.mean()) * (b - b.mean())).mean() / (a.std() * b.std()))
        assert abs(corr) < 0.02


def test_twins_share_variant_and_observation_noise():
    """The engine draws one row of initial states a mirrored pair; the
    twins' variants, params and noise streams are equal, and so is their
    noise on every step they take alike."""
    dist = tsc.default_distribution(tenvs.Pendulum(), n_variants=10, spread=0.3,
                                    obs_noise=0.05, seed=1)
    es = ES(MLPPolicy, DeviceAgent(tenvs.Pendulum(), horizon=20), adam, device="cpu",
            population_size=64, sigma=0.05, policy_kwargs=PEND_POLICY,
            optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 14, scenarios=dist)
    sample = es.engine.sample(es.state)
    _, _, states = es.engine._members(sample)
    states = states[:, 0]
    assert torch.equal(states[0::2], states[1::2])
    env = es.env
    obs = env.observe(states)
    for _ in range(5):
        states, obs, _, _ = env.step(states, torch.zeros(64, 1))
        assert torch.equal(obs[0::2], obs[1::2])
    assert not torch.equal(obs[0::2][:-1], obs[0::2][1:])
    _, metrics = es.engine.generation_step(es.state)
    v = tsc.variant_of_bc(metrics["bc"])
    assert np.array_equal(v[0::2], v[1::2])


def test_gait_protocol_only_when_base_has_it():
    pend = tsc.ScenarioEnv(tenvs.Pendulum(), tsc.default_distribution(tenvs.Pendulum(), 3))
    assert not hasattr(pend, "step_metrics")
    hop = tsc.ScenarioEnv(tenvs.Hopper2D(), tsc.default_distribution(tenvs.Hopper2D(), 3))
    assert hasattr(hop, "step_metrics") and hop.metric_names == ("upright_fraction",)
    states, obs = hop.reset(torch.Generator().manual_seed(0), 4)
    assert hop.step_metrics(states).shape == (4, 1)
    bc = hop.behavior(states, obs)[0].numpy()
    steps, sums = 10, np.array([7.0])
    want = jsc.ScenarioEnv(jenvs.Hopper2D(), jsc.default_distribution(
        jenvs.Hopper2D(), 3)).episode_metrics(bc, steps, sums)
    assert hop.episode_metrics(bc, steps, sums) == want


# ---------------------------------------------------------- fitness helpers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fitness_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    blocks_t, blocks_j = [], []
    for g in range(4):
        n_var = 6 if g < 3 else 8  # a mixed file folds at the largest width
        fitness = rng.normal(-100, 20, 64)
        fitness[rng.integers(0, 64, 3)] = np.nan
        variants = rng.integers(0, n_var - 1, 64).astype(np.float32)
        bt = tsc.scenario_fitness_block(fitness, variants, n_var)
        bj = jsc.scenario_fitness_block(fitness, variants, n_var)
        np.testing.assert_equal(bt, bj)
        blocks_t.append(bt)
        blocks_j.append(bj)
    np.testing.assert_equal(tsc.merge_scenario_blocks(blocks_t),
                            jsc.merge_scenario_blocks(blocks_j))
    assert tsc.merge_scenario_blocks([]) is None
    lag = dict(blocks_t[0], mean=[-100.0, -102.0, -98.0, -101.0, -99.0, -400.0 - seed])
    assert tsc.worst_variant_callout(lag) == jsc.worst_variant_callout(lag)
    assert tsc.worst_variant_callout(lag)["variant"] == 5
    assert tsc.worst_variant_callout(blocks_t[0]) == jsc.worst_variant_callout(blocks_j[0])


# ------------------------------------------------------------ ES end to end


def _pair_es(jbase, tbase, n_variants=4, policy=PEND_POLICY, **over):
    jdist = jsc.default_distribution(jbase, n_variants=n_variants, spread=0.3, seed=1)
    drawn = {n: np.asarray(v) for n, v in jdist.draw_all().items()}
    tdist = interop.scenario_distribution_from_jax(jdist.spec_json(), drawn)
    kw = dict(population_size=16, sigma=0.05, seed=0, policy_kwargs=policy,
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 14)
    kw.update(over)
    jes = JES(JMLPPolicy, JaxAgent(jbase, horizon=20), optax.adam,
              mesh=population_mesh(jax.devices()[:1]), telemetry=False, scenarios=jdist, **kw)
    tes = ES(MLPPolicy, DeviceAgent(tbase, horizon=20), adam, device="cpu", scenarios=tdist, **kw)
    tes.engine.table = interop.table_from_numpy(np.asarray(jes.table.data))
    flat, _ = interop.params_from_jax(np.asarray(jes.state.params_flat), tes.spec)
    tes.state = tes.engine.init_state(flat, seed=0)
    return jes, tes


def _jax_sample(jes, tenv, jstate) -> Sample:
    cfg = jes.config
    _, rkey = _gen_keys(jstate)
    keys = jax.random.split(rkey, cfg.population_size // 2)
    sj, _ = jax.jit(jax.vmap(jes.env.reset))(keys)
    sj = (sj[0], sj[1], sj[2], _key_words(sj[3]))
    offsets = np.array(jes.engine.all_pair_offsets(jstate))
    return Sample(torch.from_numpy(offsets), interop.env_states_from_jax(tenv, sj))


@pytest.mark.parametrize("name", ["Pendulum", "CartPole"])
def test_three_generation_trajectory_matches_jax(name):
    """Three generations from JAX's params, table, offsets, reset states and
    drawn variants (obs_noise off): fitness, BC with the variant column,
    alive steps, params (atol 2e-5) and update norms as in
    tests/test_torch_envs.py; the record's block equal to JAX's."""
    jbase, tbase = _pair(name)
    policy = (PEND_POLICY if name == "Pendulum"
              else {"action_dim": 2, "hidden": (8,), "discrete": True})
    jes, tes = _pair_es(jbase, tbase, policy=policy)
    for g in range(3):
        jstate = jes.state
        sample = _jax_sample(jes, tes.env, jstate)
        jes.state, jm = jes.engine.generation_step(jstate)
        tes.state, tm = tes.engine.generation_step(tes.state, sample)
        check_generation(jes, tes, jm, tm, f"{name} generation {g}")
        bt = tsc.scenario_fitness_block(tm["fitness"].numpy(), tsc.variant_of_bc(tm["bc"]), 4)
        bj = jsc.scenario_fitness_block(np.asarray(jm["fitness"]),
                                        jsc.variant_of_bc(jm["bc"]), 4)
        assert bt["counts"] == bj["counts"]
        np.testing.assert_allclose(bt["mean"], bj["mean"], rtol=1e-4)


@pytest.fixture(scope="module")
def trained_10v():
    dist = tsc.default_distribution(tenvs.Pendulum(), n_variants=10, spread=0.3, seed=1)
    es = ES(MLPPolicy, DeviceAgent(tenvs.Pendulum(), horizon=20), adam, device="cpu",
            population_size=64, sigma=0.05, policy_kwargs=PEND_POLICY, telemetry=True,
            optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 14, scenarios=dist)
    es.train(3, verbose=False)
    return es


def test_record_block_covers_every_variant(trained_10v):
    seen = set()
    for r in trained_10v.history:
        blk = r["scenarios"]
        assert blk["n_variants"] == 10 and sum(blk["counts"]) == 64
        assert all(c % 2 == 0 for c in blk["counts"])  # twins share their variant
        seen |= {v for v, c in enumerate(blk["counts"]) if c}
    assert seen == set(range(10))


def test_type_checked_and_refused_as_in_jax():
    with pytest.raises(TypeError, match="ScenarioDistribution"):
        ES(MLPPolicy, DeviceAgent(tenvs.Pendulum(), horizon=10), adam, device="cpu",
           policy_kwargs=PEND_POLICY, scenarios={"g": (7.0, 13.0)})
    with pytest.raises(ValueError, match="novelty"):
        NS_ES(MLPPolicy, DeviceAgent(tenvs.Pendulum(), horizon=10), adam, device="cpu",
              scenarios=tsc.default_distribution(tenvs.Pendulum(), 4))
    with pytest.raises(ValueError, match="step_p"):
        ES(MLPPolicy, DeviceAgent(tenvs.PositionOnly(tenvs.Walker2D()), horizon=10), adam,
           device="cpu", scenarios=tsc.ScenarioDistribution({"mass_scale": (0.9, 1.1)}, 2),
           policy_kwargs={"action_dim": 6, "hidden": (8,), "discrete": False})
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="cuda"):
            ES(MLPPolicy, DeviceAgent(tenvs.Pendulum(), horizon=10), adam,
               policy_kwargs=PEND_POLICY, scenarios=tsc.default_distribution(tenvs.Pendulum()))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops_of_a_generation(env, n_variants, **kw) -> int:
    policy = {"action_dim": env.action_dim, "hidden": (8,), "discrete": False,
              "action_scale": 2.0}
    dist = tsc.default_distribution(env, n_variants=n_variants, spread=0.3, obs_noise=0.05,
                                    seed=1)
    es = ES(MLPPolicy, DeviceAgent(env, horizon=10), adam, device="cpu", population_size=16,
            sigma=0.05, policy_kwargs=policy, optimizer_kwargs={"learning_rate": 1e-2},
            table_size=1 << 16, scenarios=dist, telemetry=False, **kw)
    es.train(1, verbose=False)
    # the engine's generation: ES's record keeps a new best's params, a
    # data-dependent handful of ops outside it
    with _CountOps() as count:
        es.engine.generation_step(es.state)
    return count.n


@pytest.mark.parametrize("name,kw", [("Pendulum", {"streamed": True, "noise_kernel": True}),
                                     ("Hopper2D", {})], ids=["pendulum_streamed", "hopper"])
def test_ops_a_generation_do_not_depend_on_the_variant_count(name, kw):
    env = getattr(tenvs, name)()
    counts = [_ops_of_a_generation(env, nv, **kw) for nv in (3, 50)]
    assert counts[0] == counts[1] > 0


def test_overlap_scheduler_carries_the_block():
    dist = tsc.default_distribution(tenvs.Pendulum(), n_variants=5, spread=0.3, seed=1)
    kw = dict(population_size=16, sigma=0.05, policy_kwargs=PEND_POLICY, device="cpu",
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 14, scenarios=dist)
    es = ES(MLPPolicy, DeviceAgent(tenvs.Pendulum(), horizon=20), adam, **kw)
    es.train_async(2, strategy="overlap", verbose=False)
    ref = ES(MLPPolicy, DeviceAgent(tenvs.Pendulum(), horizon=20), adam, **kw)
    ref.train(2, verbose=False)
    for a, b in zip(es.history, ref.history):
        blk = a["scenarios"]
        assert blk["n_variants"] == 5 and sum(blk["counts"]) == 16
        assert blk == b["scenarios"]
    assert torch.equal(es.state.params_flat, ref.state.params_flat)


def test_manifest_and_bundle_name_the_scenarios(trained_10v, tmp_path):
    es = trained_10v
    cfg = es.run_manifest()["config"]
    assert cfg["scenarios"] == es._scenarios.spec_json()
    assert cfg["scenarios"]["n_variants"] == 10 and cfg["scenarios"]["seed"] == 1
    path = es.export_bundle(str(tmp_path / "bundle"))
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    clone = tsc.ScenarioDistribution.from_json(manifest["source"]["scenarios"])
    assert clone.draw_concrete(4) == es._scenarios.draw_concrete(4)
    plain = ES(MLPPolicy, DeviceAgent(tenvs.Pendulum(), horizon=10), adam, device="cpu",
               population_size=8, policy_kwargs=PEND_POLICY, table_size=1 << 14,
               optimizer_kwargs={"learning_rate": 1e-2})
    assert "scenarios" not in plain.run_manifest()["config"]


def test_obs_summarize_section_equals_jax(trained_10v, tmp_path):
    """The port's records through both packages' summarizers: the same
    scenarios section and clauses; the CLI renders it; selfcheck clean."""
    import importlib
    import subprocess

    # the modules (the JAX package's obs re-exports the function under the name)
    jsum = importlib.import_module("estorch_tpu.obs.summarize")
    tsum = importlib.import_module("estorch_tpu_torch.obs.summarize")

    run = tmp_path / "run.jsonl"
    with open(run, "w") as f:
        for r in trained_10v.history:
            f.write(json.dumps(r, default=float) + "\n")
    records = tsum.load_records(str(run))
    assert all(not tsum.validate_record(r) for r in records)
    s = tsum.summarize(records)
    blk = s["scenarios"]
    assert blk == jsum.summarize(records)["scenarios"]
    assert blk["n_variants"] == 10 and blk["coverage"] == 1.0
    assert "scenarios: 10 variants, 100% covered" in s["diagnosis"]
    assert "scenarios" in tsum.format_summary(s)
    assert tsum.selfcheck() == []
    out = subprocess.run([sys.executable, "-m", "estorch_tpu_torch.obs", "summarize", str(run)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "scenarios        10 variants" in out.stdout


def test_evaluate_policy_runs_under_drawn_variants():
    dist = tsc.default_distribution(tenvs.Hopper2D(), n_variants=4, spread=0.3, seed=2)
    es = ES(MLPPolicy, DeviceAgent(tenvs.Hopper2D(), horizon=10), adam, device="cpu",
            population_size=8, sigma=0.05, table_size=1 << 16, scenarios=dist,
            policy_kwargs={"action_dim": 3, "hidden": (8,), "discrete": False},
            optimizer_kwargs={"learning_rate": 1e-2})
    out = es.evaluate_policy(12, seed=3, return_details=True)
    assert out["bc"].shape == (12, 3)
    v = tsc.variant_of_bc(out["bc"])
    assert set(v.tolist()) <= {0.0, 1.0, 2.0, 3.0} and len(set(v.tolist())) > 1
    assert out["gait"]["forward_velocity_mps"].shape == (12,)
    again = es.evaluate_policy(12, seed=3, return_details=True)
    assert np.array_equal(out["rewards"], again["rewards"])


# -------------------------------------------------------------------- PBT


def _pbt_es(optimizer=None, seed=0):
    dist = tsc.default_distribution(tenvs.Pendulum(), n_variants=6, spread=0.3, seed=1)
    opt = optimizer if optimizer is not None else tsc.tunable_optimizer(learning_rate=0.01)
    return ES(MLPPolicy, DeviceAgent(tenvs.Pendulum(), horizon=20), opt, device="cpu",
              population_size=16, sigma=0.05, seed=seed, policy_kwargs=PEND_POLICY,
              table_size=1 << 14, telemetry=True, scenarios=dist)


def test_pbt_validation():
    es = _pbt_es()
    with pytest.raises(ValueError, match="n_centers"):
        tsc.PBTController(es, n_centers=1)
    with pytest.raises(ValueError, match="explore_every"):
        tsc.PBTController(es, explore_every=0)
    with pytest.raises(ValueError, match="init_spread"):
        tsc.PBTController(es, init_spread=0.5)

    class Host:
        backend = "host"

    with pytest.raises(ValueError, match="device-path engines"):
        tsc.PBTController(Host())


def test_pbt_live_run_and_replay_bit_identical():
    es = _pbt_es()
    ctl = tsc.PBTController(es, n_centers=3, explore_every=2, seed=7)
    assert ctl.lr_tunable
    log = ctl.run(5, verbose=False)
    kinds = [e["type"] for e in log["events"]]
    assert kinds.count("init") == 3 and "exploit" in kinds
    for ev in log["events"]:
        if ev["type"] == "exploit":
            assert ev["lr"] is not None and ev["sigma"] > 0
    assert len(es.meta_states) == 3 and log["final"]["best_center"] in (0, 1, 2)
    assert [r["pbt_center"] for r in es.history[:6]] == [0, 1, 2, 0, 1, 2]
    log = json.loads(json.dumps(log))  # a log crosses processes as JSON
    es2 = _pbt_es()
    replayed = tsc.PBTController(es2, n_centers=3, explore_every=2, seed=7).run(
        5, verbose=False, replay=log)
    assert torch.equal(es.state.params_flat, es2.state.params_flat)
    for a, b in zip(es.meta_states, es2.meta_states):
        assert torch.equal(a.params_flat, b.params_flat) and torch.equal(a.sigma, b.sigma)
        assert torch.equal(a.opt_state.hyperparams["learning_rate"],
                           b.opt_state.hyperparams["learning_rate"])
    assert replayed["events"] == log["events"]


def test_pbt_replay_refuses_a_foreign_log():
    es = _pbt_es()
    log = tsc.PBTController(es, n_centers=3, explore_every=2, seed=7).run(3, verbose=False)
    with pytest.raises(ValueError, match="different PBT"):
        tsc.PBTController(_pbt_es(), n_centers=3, explore_every=3, seed=7).run(
            3, verbose=False, replay=log)
    with pytest.raises(ValueError, match="schema"):
        tsc.PBTController(_pbt_es(), n_centers=3, explore_every=2, seed=7).run(
            3, verbose=False, replay=dict(log, schema=2))
    truncated = dict(log, events=log["events"][:2])
    with pytest.raises(ValueError, match="exhausted"):
        tsc.PBTController(_pbt_es(), n_centers=3, explore_every=2, seed=7).run(
            3, verbose=False, replay=truncated)


def test_pbt_exploit_copies_the_top_center():
    """After round 1's exploit, the snapshot ``es.meta_states`` holds the
    destination with the source's params and optimizer moments bit for
    bit, its own seed, and the event's σ and learning rate."""
    es = _pbt_es()
    snaps = []

    def log_fn(rec):
        if rec["pbt_center"] == 0:
            snaps.append(list(getattr(es, "meta_states", [])))

    log = tsc.PBTController(es, n_centers=3, explore_every=1, seed=0).run(
        2, verbose=False, log_fn=log_fn)
    exploits = [e for e in log["events"] if e["type"] == "exploit"]
    assert exploits and exploits[0]["score_src"] >= exploits[0]["score_dst"]
    ev = exploits[0]
    after = snaps[1]  # round 2's snapshot, taken right after the exploit
    src, dst = after[ev["src"]], after[ev["dst"]]
    assert torch.equal(src.params_flat, dst.params_flat)
    assert torch.equal(dst.opt_state.inner_state.mu, src.opt_state.inner_state.mu)
    assert dst.generation == src.generation and dst.seed != src.seed
    assert float(dst.sigma) == pytest.approx(ev["sigma"], rel=1e-7)
    assert float(dst.opt_state.hyperparams["learning_rate"]) == pytest.approx(ev["lr"], rel=1e-7)


def test_pbt_init_events_equal_jax():
    """Both packages decide with NumPy's default_rng(seed): for one seed and
    the same base σ and learning rate, the same ``init`` events."""
    jdist = jsc.default_distribution(jenvs.Pendulum(), n_variants=6, spread=0.3, seed=1)
    jes = JES(JMLPPolicy, JaxAgent(jenvs.Pendulum(), horizon=20),
              jsc.tunable_optimizer(learning_rate=0.01), population_size=16, sigma=0.05,
              seed=0, policy_kwargs=PEND_POLICY, table_size=1 << 14, telemetry=True,
              scenarios=jdist)
    jlog = jsc.PBTController(jes, n_centers=4, explore_every=2, seed=11).run(1, verbose=False)
    tlog = tsc.PBTController(_pbt_es(), n_centers=4, explore_every=2, seed=11).run(
        1, verbose=False)
    assert tlog["meta"] == jlog["meta"]
    jinit = [e for e in jlog["events"] if e["type"] == "init"]
    tinit = [e for e in tlog["events"] if e["type"] == "init"]
    assert len(tinit) == 4 and tinit == jinit


def test_tunable_adam_is_adam_bit_for_bit():
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.standard_normal(257).astype(np.float32))
    plain, tunable = adam(3e-3), tsc.tunable_optimizer(learning_rate=3e-3)
    sp, st = plain.init(p), tunable.init(p)
    assert st.hyperparams["learning_rate"].dtype == torch.float32
    for _ in range(5):
        g = torch.from_numpy(rng.standard_normal(257).astype(np.float32))
        up, sp = plain.update(g, sp)
        ut, st = tunable.update(g, st)
        assert torch.equal(up, ut)
        assert torch.equal(sp.mu, st.inner_state.mu) and torch.equal(sp.nu, st.inner_state.nu)
    # sgd wraps too, and a changed rate is the other rate's update
    us, _ = tsc.tunable_optimizer(sgd, learning_rate=0.5).update(g, tsc.tunable_optimizer(
        sgd, learning_rate=0.5).init(p))
    assert torch.equal(us, sgd(0.5).update(g, None)[0])
    st2 = st._replace(hyperparams={"learning_rate": torch.tensor(1e-3)})
    assert torch.equal(tunable.update(g, st2)[0], adam(1e-3).update(g, sp)[0])


def test_tunable_state_survives_checkpoint_and_run_resilient(tmp_path, monkeypatch):
    """A PBT run's three tunable centers through a checkpoint, and the
    tunable state through run_resilient's rollbacks (a crash in a save and
    a poisoned update): the clean run's params bit for bit."""
    from estorch_tpu_torch.resilience import chaos as tchaos
    from estorch_tpu_torch.resilience.supervisor import run_resilient
    from estorch_tpu_torch.utils.checkpoint import (PeriodicCheckpointer, restore_checkpoint,
                                                    save_checkpoint)

    es = _pbt_es()
    tsc.PBTController(es, n_centers=3, explore_every=2, seed=7).run(3, verbose=False)
    save_checkpoint(es, str(tmp_path / "pbt"))
    back = _pbt_es()
    back.meta_states = [back.state] * 3
    restore_checkpoint(back, str(tmp_path / "pbt"))
    for a, b in zip(es.meta_states, back.meta_states):
        assert torch.equal(a.params_flat, b.params_flat)
        assert torch.equal(a.opt_state.hyperparams["learning_rate"],
                           b.opt_state.hyperparams["learning_rate"])
        assert a.opt_state.inner_state.count == b.opt_state.inner_state.count
        assert torch.equal(a.opt_state.inner_state.nu, b.opt_state.inner_state.nu)
    es.train(2, verbose=False)
    back.train(2, verbose=False)
    assert torch.equal(es.state.params_flat, back.state.params_flat)

    clean = _pbt_es()
    clean.train(5, verbose=False)
    monkeypatch.setenv(tchaos.CHAOS_ENV, json.dumps(
        {"events": [{"kind": "ckpt_crash", "gen": 2}, {"kind": "nan_update", "gen": 3}]}))
    tchaos.reset_cache()
    try:
        run = _pbt_es()
        run_resilient(run, 5, checkpointer=PeriodicCheckpointer(run, str(tmp_path / "cks"),
                                                                every=1))
    finally:
        monkeypatch.delenv(tchaos.CHAOS_ENV)
        tchaos.reset_cache()
    assert run.obs.counters.get("generations_skipped") == 1
    assert run.obs.counters.get("generations_rejected") == 1
    assert torch.equal(run.state.params_flat, clean.state.params_flat)
    assert [r["scenarios"] for r in run.history] == [r["scenarios"] for r in clean.history]
