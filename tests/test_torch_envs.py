"""The port's classic-control and synthetic envs against the JAX package.

Each env is stepped on both sides from the JAX side's reset states with
one seeded numpy action sequence, and whole ES generations of the port's
engine are held against the JAX engine's from injected draws (params,
table, offsets, reset and probe states, as ``tests/test_torch_paths.py``
does for Pendulum).  The helpers at the top are shared with
``tests/test_torch_locomotion.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import estorch_tpu.envs as jenvs
import estorch_tpu_torch.envs as tenvs
from estorch_tpu import ES as JES
from estorch_tpu import JaxAgent
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu.parallel import population_mesh
from estorch_tpu.parallel.engine import _gen_keys
from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, adam, interop
from estorch_tpu_torch.parallel import Sample

# ------------------------------------------------------------ shared helpers


_JAX_RESETS = {}  # one compiled batched reset per JAX env


def jax_resets(jenv, tenv, keys) -> torch.Tensor:
    """The port's states of the JAX ``reset`` over keys of any leading shape."""
    if jenv not in _JAX_RESETS:
        _JAX_RESETS[jenv] = jax.jit(jax.vmap(jenv.reset))
    flat = keys.reshape((-1,) + keys.shape[-1:])
    states, _ = _JAX_RESETS[jenv](flat)
    packed = interop.env_states_from_jax(tenv, states)
    return packed.reshape(keys.shape[:-1] + packed.shape[-1:])


def fold_keys(base, n):
    return jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(n))


def es_pair(jenv, tenv, policy_kwargs, horizon, jopt=optax.adam, topt=adam, **over):
    """The JAX engine on a one-device mesh and the port on the CPU, with the
    same options, then the JAX side's table and initial params handed over
    (and the JAX side's warm-up states, for the port's own warm-up)."""
    kw = dict(population_size=16, sigma=0.05, seed=0, policy_kwargs=policy_kwargs,
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16)
    kw.update(over)
    jes = JES(JMLPPolicy, JaxAgent(jenv, horizon=horizon), jopt,
              mesh=population_mesh(jax.devices()[:1]), telemetry=False, **kw)
    tes = ES(MLPPolicy, DeviceAgent(tenv, horizon=horizon), topt, device="cpu", **kw)
    tes.engine.table = interop.table_from_numpy(np.asarray(jes.table.data))
    flat, _ = interop.params_from_jax(np.asarray(jes.state.params_flat), tes.spec)
    warm = None
    if jes.config.obs_warmup_episodes:
        base = jax.random.fold_in(jes.state.key, 2**31 - 3)
        warm = jax_resets(jenv, tenv, fold_keys(base, jes.config.obs_warmup_episodes))
    tes.state = tes.engine.init_state(flat, seed=0, warmup_states=warm)
    return jes, tes


def jax_sample(jes, tenv, jstate) -> Sample:
    """This generation's draws of the JAX engine, in the port's layout."""
    cfg = jes.config
    _, rkey = _gen_keys(jstate)
    rows = cfg.population_size // 2 if cfg.mirrored else cfg.population_size
    keys = jax.random.split(rkey, rows)
    probe = None
    if cfg.obs_norm:
        base = jax.random.fold_in(rkey, 2**31 - 2)
        probe = jax_resets(jes.env, tenv, fold_keys(base, cfg.obs_probe_episodes))
    offsets = np.array(jes.engine.all_pair_offsets(jstate))
    return Sample(torch.from_numpy(offsets), jax_resets(jes.env, tenv, keys), probe)


def step_both(jes, tes):
    """One generation on both sides from the JAX side's draws."""
    jstate = jes.state
    sample = jax_sample(jes, tes.env, jstate)
    jes.state, jm = jes.engine.generation_step(jstate)
    tes.state, tm = tes.engine.generation_step(tes.state, sample)
    return jstate, jm, tm


def check_generation(jes, tes, jm, tm, what, fitness_rtol=1e-4, fitness_atol=1e-3):
    """Fitness, BC, alive steps, params and update norm of one generation.
    Tolerance: float32 products and sums in another order (and XLA's fused
    multiply-adds), over ≤ 20 env steps and one Adam step."""
    np.testing.assert_allclose(tm["fitness"].numpy(), np.asarray(jm["fitness"]),
                               rtol=fitness_rtol, atol=fitness_atol, err_msg=what)
    np.testing.assert_allclose(tm["bc"].numpy(), np.asarray(jm["bc"]), rtol=1e-4, atol=1e-4,
                               err_msg=what)
    assert int(tm["steps"]) == int(jm["steps"]), what
    assert int(tm["n_valid"]) == int(jm["n_valid"]), what
    np.testing.assert_allclose(tes.state.params_flat.numpy(), np.asarray(jes.state.params_flat),
                               rtol=0, atol=2e-5, err_msg=what)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4,
                               err_msg=what)


# ----------------------------------------------------------------- envs

# (name, constructor kwargs, action kind, atol at rtol 1e-5).  The atol is
# the measured need over 50 steps times about 3: Acrobot's RK4 of dt 0.2
# grows XLA's fused multiply-adds against torch's separate roundings to
# 3.5e-6; the others stay under 2e-7.
ENV_CASES = [
    ("Acrobot", {}, "discrete", 1e-5),
    ("MountainCar", {}, "discrete", 1e-6),
    ("MountainCarContinuous", {}, "continuous", 1e-6),
    ("SyntheticEnv", {}, "continuous", 1e-6),
    ("SyntheticEnv", {"obs_dim": 16, "action_dim": 3}, "continuous", 1e-6),
    ("RecallEnv", {}, "continuous", 1e-6),
]
ENV_IDS = ["acrobot", "mountain_car", "mountain_car_continuous", "synthetic_376_17",
           "synthetic_16_3", "recall"]


@pytest.mark.parametrize("name,kw,kind,atol", ENV_CASES, ids=ENV_IDS)
def test_env_steps_match_jax(name, kw, kind, atol):
    """50 steps of 64 members from JAX's reset states, each side on its own
    trajectory: state, obs and reward within rtol 1e-5 and the stated atol,
    done flags and BCs equal to the same tolerance."""
    jenv, tenv = getattr(jenvs, name)(**kw), getattr(tenvs, name)(**kw)
    n = 64
    sj, oj = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), n))
    st = interop.env_states_from_jax(tenv, sj)
    np.testing.assert_allclose(tenv.observe(st).numpy(), np.array(oj), rtol=1e-6, atol=1e-7)
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(1)
    for i in range(50):
        if kind == "discrete":
            a = rng.integers(0, jenv.action_dim, n)
        else:  # past ±1: the clip matters
            a = rng.uniform(-1.5, 1.5, (n, jenv.action_dim)).astype(np.float32)
        sj, oj, rj, dj = jstep(sj, jnp.asarray(a))
        st, ot, rt, dt = tenv.step(st, torch.from_numpy(a))
        for label, got, want in (("state", st, sj), ("obs", ot, oj), ("reward", rt, rj)):
            np.testing.assert_allclose(got.numpy(), np.broadcast_to(np.array(want), got.shape),
                                       rtol=1e-5, atol=atol, err_msg=f"{label}, step {i}")
        np.testing.assert_array_equal(dt.numpy(), np.broadcast_to(np.array(dj), dt.shape))
    np.testing.assert_allclose(tenv.behavior(st, ot).numpy(),
                               np.array(jax.vmap(jenv.behavior)(sj, oj)), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("cls", ["MountainCar", "MountainCarContinuous"])
def test_mountain_car_left_wall_stops_the_car(cls):
    """A car clipped to -1.2 while moving left stops: the float32 position
    equals the Python float -1.2 once both are float32, as in JAX."""
    jenv, tenv = getattr(jenvs, cls)(), getattr(tenvs, cls)()
    states = np.array([[-1.19, -0.05], [-1.199, -0.005], [-1.2, -0.07], [-1.15, -0.02]],
                      np.float32)
    if cls == "MountainCar":
        actions = np.array([0, 0, 1, 2])
    else:
        actions = np.array([[-1.0], [-1.0], [0.0], [1.0]], np.float32)
    want = jax.vmap(jenv.step)(jnp.asarray(states), jnp.asarray(actions))[0]
    got = tenv.step(torch.from_numpy(states), torch.from_numpy(actions))[0]
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    # the first three hit the wall and stop; the fourth does not reach it
    assert got[:3, 0].tolist() == [np.float32(-1.2)] * 3
    assert got[:3, 1].tolist() == [0.0] * 3
    assert float(got[3, 0]) > -1.2 and float(got[3, 1]) < 0


def test_acrobot_wraps_and_terminates_as_jax():
    """Angles far outside [-π, π) wrap like jnp's floored %, both signs, and
    the tip-height done test and the BC agree on swung-up states."""
    rng = np.random.default_rng(4)
    n = 256
    states = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                       rng.uniform(-3, 3, n), rng.uniform(-6, 6, n)], 1).astype(np.float32)
    states[:8, :2] = [[np.pi, 0.0], [np.pi - 0.05, 0.1], [3.0, -3.0], [-np.pi, 0.0],
                      [0.0, np.pi], [np.pi / 2, np.pi / 2], [-np.pi / 2, -np.pi / 2], [2.9, 0.3]]
    states[:8, 2:] = 0.0
    actions = rng.integers(0, 3, n)
    jenv, tenv = jenvs.Acrobot(), tenvs.Acrobot()
    want = jax.vmap(jenv.step)(jnp.asarray(states), jnp.asarray(actions))
    got = tenv.step(torch.from_numpy(states), torch.from_numpy(actions))
    # angles through the obs's (cos, sin): at ±π a rounding may wrap either way
    np.testing.assert_allclose(got[1].numpy(), np.array(want[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0][:, 2:].numpy(), np.array(want[0])[:, 2:], rtol=1e-5,
                               atol=1e-5)
    assert bool((got[0][:, :2].abs() <= np.pi).all())
    np.testing.assert_array_equal(got[3].numpy(), np.array(want[3]))
    assert 0 < int(got[3].sum()) < n  # both outcomes occur
    np.testing.assert_array_equal(got[2].numpy(), np.array(want[2]))
    np.testing.assert_allclose(tenv.behavior(got[0], got[1]).numpy(),
                               np.array(jax.vmap(jenv.behavior)(want[0], want[1])),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,kw", [
    ("Acrobot", {}), ("MountainCar", {}), ("MountainCarContinuous", {}),
    ("SyntheticEnv", {"obs_dim": 16, "action_dim": 3}), ("RecallEnv", {}),
], ids=["acrobot", "mountain_car", "mountain_car_continuous", "synthetic", "recall"])
def test_reset_ranges(name, kw):
    """The port's own draws cover the JAX package's reset distributions."""
    env = getattr(tenvs, name)(**kw)
    states, obs = env.reset(torch.Generator().manual_seed(0), 4000)
    torch.testing.assert_close(obs, env.observe(states))
    assert obs.shape == (4000, env.obs_dim)
    if name == "Acrobot":
        assert bool((states.abs() <= 0.1).all()) and float(states.abs().max()) > 0.099
    elif name.startswith("MountainCar"):
        pos = states[:, 0]
        assert bool(((pos >= -0.6) & (pos < -0.4)).all()) and bool((states[:, 1] == 0).all())
    elif name == "SyntheticEnv":
        assert abs(float(states.std()) - 0.1) < 0.005 and abs(float(states.mean())) < 0.005
    else:
        assert set(states[:, 0].tolist()) == {-1.0, 1.0} and bool((states[:, 1] == 0).all())
        assert abs(float(states[:, 0].mean())) < 0.05


def test_recall_env_hides_the_signal_after_reset():
    env = tenvs.RecallEnv()
    states, obs = env.reset(torch.Generator().manual_seed(1), 6)
    torch.testing.assert_close(obs, states[:, :1])
    states2, obs2, reward, done = env.step(states, torch.full((6, 1), 2.0))
    assert bool((obs2 == 0).all()) and not bool(done.any())
    torch.testing.assert_close(reward, states[:, 0])  # clip(2) · signal
    torch.testing.assert_close(states2[:, 1], torch.ones(6))


# ------------------------------------------------------ ES trajectories

TRAJECTORY_CASES = {
    # discrete actions: argmax of the policy's logits; no member swings up in
    # 20 steps, so every return is -20 and the ranks break ties by position
    "acrobot": ("Acrobot", {}, {"action_dim": 3, "hidden": (8, 8)}, {}),
    "mountain_car_continuous": ("MountainCarContinuous", {},
                                {"action_dim": 1, "hidden": (8, 8), "discrete": False}, {}),
    "synthetic_streamed": ("SyntheticEnv", {"obs_dim": 16, "action_dim": 3},
                           {"action_dim": 3, "hidden": (8, 8), "discrete": False},
                           {"streamed": True, "noise_kernel": True}),
}


@pytest.mark.parametrize("case", list(TRAJECTORY_CASES))
def test_three_generation_trajectory_matches_jax(case):
    """MLP (8, 8), pop 16, horizon 20, 3 generations from the JAX side's
    draws: fitness rtol 1e-4, params atol 2e-5 (as for Pendulum)."""
    name, kw, policy, over = TRAJECTORY_CASES[case]
    jes, tes = es_pair(getattr(jenvs, name)(**kw), getattr(tenvs, name)(**kw), policy, 20,
                       **over)
    for gen in range(3):
        _, jm, tm = step_both(jes, tes)
        check_generation(jes, tes, jm, tm, f"gen {gen}")
        if case == "acrobot":
            np.testing.assert_array_equal(tm["fitness"].numpy(), np.asarray(jm["fitness"]))
    assert tes.state.generation == 3


def test_every_jax_env_has_a_counterpart():
    """Every env the JAX package exports has a port under the same name,
    with the same static facts (the protocol ``JaxEnv`` is the port's
    ``DeviceEnv``)."""
    import dataclasses

    names = [n for n in jenvs.__all__ if n != "JaxEnv"
             and isinstance(getattr(jenvs, n), type) and hasattr(getattr(jenvs, n), "step")]
    assert len(names) == 14, names
    for name in names:
        assert hasattr(tenvs, name), name
        if name in ("PositionOnly", "DeceptiveValley"):
            jenv = getattr(jenvs, name)(jenvs.Walker2D())
            tenv = getattr(tenvs, name)(tenvs.Walker2D())
        else:
            jenv, tenv = getattr(jenvs, name)(), getattr(tenvs, name)()
            assert [f.name for f in dataclasses.fields(tenv)] == \
                [f.name for f in dataclasses.fields(jenv)], name
        for fact in ("obs_dim", "action_dim", "discrete", "default_horizon", "bc_dim"):
            assert getattr(tenv, fact) == getattr(jenv, fact), (name, fact)
