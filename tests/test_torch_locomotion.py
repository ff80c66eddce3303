"""The port's planar locomotion envs, wrappers, gait metrics and recipes
against the JAX package.

The physics is chaotic: a reset angle moved by one float32 ulp changes a
state by 1e-4 (and, at a contact's onset, briefly by 1e-2) within 20 env
steps in JAX itself.  The port computes each float with JAX's operations
in JAX's order, but XLA on the CPU fuses a·b + c into one rounding where
torch rounds twice, and the two round sin, cos and tanh differently.  So
parity is held tightly for one physics step, at a stated tolerance for one
and twenty env steps, and through ES only at horizons of at most 20; the
seeds below are ones where JAX's states stay more than 1e-5 away from a
termination threshold (asserted), so the done flags must agree exactly.
"""

import dataclasses

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
from estorch_tpu.envs.locomotion import _physics_step as jax_physics_step
from estorch_tpu.parallel import population_mesh
from estorch_tpu_torch import configs, interop, sgd
from estorch_tpu_torch.envs.locomotion import _physics_step
from test_torch_envs import check_generation, es_pair, step_both

PLANAR = ["Swimmer2D", "Hopper2D", "Walker2D", "Humanoid2D", "Cheetah2D"]


def _pair(name):
    if name == "PositionOnly":
        return jenvs.PositionOnly(jenvs.Walker2D()), tenvs.PositionOnly(tenvs.Walker2D())
    if name == "DeceptiveValley":
        return (jenvs.DeceptiveValley(jenvs.Hopper2D(), x_bait=0.002, x_valley=0.01),
                tenvs.DeceptiveValley(tenvs.Hopper2D(), x_bait=0.002, x_valley=0.01))
    return getattr(jenvs, name)(), getattr(tenvs, name)()


def _base(env):
    return getattr(env, "base", env)


@pytest.mark.parametrize("name", PLANAR)
def test_chain_and_reset_pose_match_jax(name):
    """``init_pos`` solved in float64 NumPy equals JAX's bit for bit, and the
    reset pose leaves every joint's anchors within 1e-5 of each other."""
    jenv, tenv = _pair(name)
    assert tenv.chain.init_pos == jenv.chain.init_pos
    assert dataclasses.astuple(tenv.chain) == dataclasses.astuple(jenv.chain)
    ch = tenv.chain
    k = tenv._consts(torch.device("cpu"))
    pos = torch.tensor(ch.init_pos, dtype=torch.float32)
    theta = torch.tensor(ch.init_angle, dtype=torch.float32)
    n_j = ch.n_joints
    body = k.anchor_body[:2 * n_j]
    w = pos[body] + torch.stack([torch.cos(theta), torch.sin(theta)], -1)[body] \
        * k.anchor_lx[:2 * n_j, None]
    torch.testing.assert_close(w[:n_j], w[n_j:], rtol=0, atol=1e-5)
    states, obs = tenv.reset(torch.Generator().manual_seed(0), 500)
    assert states.shape == (500, 6 * ch.n_bodies + 1) and obs.shape == (500, tenv.obs_dim)
    lay = tenv.layout
    torch.testing.assert_close(lay.pos(states), pos.expand(500, -1, -1))
    assert bool((lay.omega(states) == 0).all()) and bool((lay.t(states) == 0).all())
    assert 0.008 < float((lay.theta(states) - theta).std()) < 0.012
    assert 0.008 < float(lay.vel(states).std()) < 0.012


def _contact_states(jenv, n, seed):
    """Reset poses lowered by up to 5 cm (feet in the ground), bent at the
    joints, with random velocities and spins; and actions past ±1."""
    rng = np.random.default_rng(seed)
    ch = jenv.chain
    b = ch.n_bodies
    pos = np.array(ch.init_pos, np.float32) + [0.0, -0.05] * rng.uniform(0, 1, (n, 1, 1))
    states = {"pos": pos.astype(np.float32),
              "theta": (np.array(ch.init_angle) + rng.uniform(-0.3, 0.3, (n, b))).astype(np.float32),
              "vel": rng.uniform(-2, 2, (n, b, 2)).astype(np.float32),
              "omega": rng.uniform(-5, 5, (n, b)).astype(np.float32),
              "t": np.zeros(n, np.int32)}
    return ({k: jnp.asarray(v) for k, v in states.items()},
            rng.uniform(-1.2, 1.2, (n, jenv.action_dim)).astype(np.float32))


@pytest.mark.parametrize("name", PLANAR)
def test_physics_step_matches_jax(name):
    """One physics step of 64 members in contact, joints stretched: rtol
    1e-6, atol 1e-5 (the measured need is up to 6e-6 in velocities, where
    the joint spring's 4000·m multiplies an anchor gap that one fused
    multiply-add moves)."""
    jenv, tenv = _pair(name)
    js, a = _contact_states(jenv, 64, 0)
    act = jnp.clip(jnp.asarray(a), -1.0, 1.0)
    want = jax.jit(jax.vmap(lambda s, u: jax_physics_step(jenv.chain, s, u)))(js, act)
    k = tenv._consts(torch.device("cpu"))
    lay = tenv.layout
    st = interop.env_states_from_jax(tenv, js)
    t_act = k.gear * torch.clamp(torch.from_numpy(a), -1.0, 1.0) * k.i_red
    q, qd = _physics_step(tenv.chain, k, lay.q(st), lay.qd(st), t_act)
    got = lay.pack(q, qd, lay.t(st))
    np.testing.assert_allclose(got.numpy(), interop.env_states_from_jax(tenv, want).numpy(),
                               rtol=1e-6, atol=1e-5)


def _reward_threshold_margin(jenv, jstates, alive) -> float:
    """How far the alive members' torsos are from a termination threshold."""
    base = _base(jenv)
    if base.min_height is None:
        return np.inf
    h = np.array(jstates["pos"][:, 0, 1])
    lean = np.abs(np.array(jstates["theta"][:, 0]) - base.upright_offset)
    return float(min(np.min(np.abs(h - base.min_height)[alive], initial=np.inf),
                     np.min(np.abs(lean - base.max_lean)[alive], initial=np.inf)))


# (env, members, seed): seeds where the 20-step tolerance holds; the test
# asserts that JAX's done steps are not within 1e-5 of a threshold
TWENTY_STEP_CASES = [("Swimmer2D", 16, 0), ("Hopper2D", 16, 0), ("Walker2D", 16, 0),
                     ("Humanoid2D", 16, 2), ("Cheetah2D", 8, 6), ("PositionOnly", 16, 0),
                     ("DeceptiveValley", 16, 0)]


@pytest.mark.parametrize("name,n,seed", TWENTY_STEP_CASES, ids=[c[0] for c in TWENTY_STEP_CASES])
def test_env_steps_match_jax(name, n, seed):
    """From JAX's reset states with one seeded action sequence in [-1, 1]:
    the first env step at rtol 1e-5 with atol 5e-5 on the packed state and
    1e-5 on obs and reward (measured need: 1.5e-5 and 2.1e-6; 8 physics
    steps of the gap above); 20 env steps, dead members frozen as the
    rollout freezes them, at rtol 1e-5, atol 1e-4; done flags equal."""
    jenv, tenv = _pair(name)
    sj, oj = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(seed), n))
    st = interop.env_states_from_jax(tenv, sj)
    np.testing.assert_allclose(tenv.observe(st).numpy(), np.array(oj), rtol=1e-6, atol=1e-6)
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(seed)
    done = np.zeros(n, bool)
    for i in range(20):
        a = rng.uniform(-1, 1, (n, jenv.action_dim)).astype(np.float32)
        nj, oj, rj, dj = jstep(sj, jnp.asarray(a))
        nt, ot, rt, dt = tenv.step(st, torch.from_numpy(a))
        alive = ~done
        atol = (5e-5, 1e-5) if i == 0 else (1e-4, 1e-4)
        for label, got, want, tol in (("state", nt, interop.env_states_from_jax(tenv, nj), atol[0]),
                                      ("obs", ot, np.array(oj), atol[1]),
                                      ("reward", rt, np.array(rj), atol[1])):
            np.testing.assert_allclose(np.asarray(got)[alive], np.asarray(want)[alive],
                                       rtol=1e-5, atol=tol, err_msg=f"{label}, step {i}")
        np.testing.assert_array_equal(dt.numpy()[alive], np.array(dj)[alive])
        assert _reward_threshold_margin(jenv, nj, alive) > 1e-5
        keep = torch.from_numpy(alive)[:, None]
        st = torch.where(keep, nt, st)
        sj = jax.tree_util.tree_map(
            lambda new, old: jnp.where(jnp.asarray(alive).reshape((-1,) + (1,) * (new.ndim - 1)),
                                       new, old), nj, sj)
        done |= np.array(dj)
    np.testing.assert_allclose(tenv.behavior(st, None).numpy(),
                               np.array(jax.vmap(_base(jenv).behavior)(sj, oj)),
                               rtol=1e-5, atol=1e-4)
    if name in ("Hopper2D", "Walker2D"):
        assert done.any() and not done.all()  # the freeze mattered


def test_port_drift_is_the_chaos_of_jax_itself():
    """Humanoid2D, 64 members, 20 steps of actions in [-1, 1]: the port's
    largest distance from JAX is no more than twice JAX's own distance from
    a copy whose reset angles moved by one float32 ulp (measured: 4.5e-4
    against 4.0e-4), so the drift is the physics' chaos, not a port fault."""
    jenv, tenv = _pair("Humanoid2D")
    n = 64
    sj, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(1), n))
    sp = dict(sj, theta=jnp.nextafter(sj["theta"], jnp.inf))
    st = interop.env_states_from_jax(tenv, sj)
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(2)
    for _ in range(20):
        a = rng.uniform(-1, 1, (n, jenv.action_dim)).astype(np.float32)
        sj, sp = jstep(sj, jnp.asarray(a))[0], jstep(sp, jnp.asarray(a))[0]
        st = tenv.step(st, torch.from_numpy(a))[0]
    want = interop.env_states_from_jax(tenv, sj)
    port = float((st - want).abs().max())
    ulp = float((interop.env_states_from_jax(tenv, sp) - want).abs().max())
    print(f"Humanoid2D, 20 steps: port vs JAX {port:.3g}, JAX vs JAX one ulp apart {ulp:.3g}")
    assert 0 < port <= 2 * ulp


def test_hopper_falls_and_terminates():
    jenv, tenv = _pair("Hopper2D")
    js, _ = jenv.reset(jax.random.key(0))
    js = dict(js, pos=js["pos"].at[0, 1].set(0.3))
    _, _, jr, jd = jenv.step(js, jnp.zeros(jenv.action_dim))
    st = interop.env_states_from_jax(tenv, {k: np.asarray(v)[None] for k, v in js.items()})
    _, _, rt, dt = tenv.step(st, torch.zeros(1, 3))
    assert bool(jd) and bool(dt[0])
    np.testing.assert_allclose(float(rt[0]), float(jr), rtol=1e-5)
    # upright and stepped with zero torques, it does not terminate
    st, _ = tenv.reset(torch.Generator().manual_seed(0), 4)
    assert not bool(tenv.step(st, torch.zeros(4, 3))[3].any())


def test_position_only_masks_as_jax_and_rejects_the_swimmer():
    jenv, tenv = _pair("PositionOnly")
    np.testing.assert_array_equal(tenv._mask, jenv._mask)
    states, obs = tenv.reset(torch.Generator().manual_seed(0), 8)
    assert bool((obs[:, 8:] == 0).all()) and bool((obs[:, :8] != 0).any())
    torch.testing.assert_close(obs, tenv.observe(states))
    with pytest.raises(ValueError) as want:
        jenvs.PositionOnly(jenvs.Swimmer2D())
    with pytest.raises(ValueError) as got:
        tenvs.PositionOnly(tenvs.Swimmer2D())
    assert str(got.value) == str(want.value)
    assert "Swimmer2D overrides _obs" in str(got.value)


def test_deceptive_valley_phi_and_return_match_jax():
    """φ on a grid across the bait, valley and rise; the return of a
    20-step rollout of 16 members against JAX's and against its telescoped
    form reward_scale·(φ(x_T) − φ(x_0)) + alive bonus − control cost."""
    jenv = jenvs.DeceptiveValley(jenvs.Cheetah2D(), x_bait=0.002, x_valley=0.01,
                                 reward_scale=2.0)
    tenv = tenvs.DeceptiveValley(tenvs.Cheetah2D(), x_bait=0.002, x_valley=0.01,
                                 reward_scale=2.0)
    x = np.linspace(-0.05, 0.05, 401).astype(np.float32)
    np.testing.assert_allclose(tenv._phi(torch.from_numpy(x)).numpy(),
                               np.array(jenv._phi(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    n, horizon = 16, 20
    keys = jax.random.split(jax.random.key(5), n)
    rng = np.random.default_rng(5)
    w = (0.5 * rng.standard_normal((jenv.obs_dim, jenv.action_dim))).astype(np.float32)
    bias = rng.uniform(-1, 1, (n, jenv.action_dim)).astype(np.float32)
    single = jenvs.make_rollout(jenv, lambda b, o: jnp.tanh(o @ jnp.asarray(w) + b), horizon)
    want = jax.vmap(single)(jnp.asarray(bias), keys)
    s0, o0 = jax.vmap(jenv.reset)(keys)
    st0 = interop.env_states_from_jax(tenv, s0)
    ctrl = torch.zeros(n)

    def apply(obs):
        act = torch.tanh(obs @ torch.from_numpy(w) + torch.from_numpy(bias))
        ctrl.add_(torch.sum(act**2, dim=1))
        return act

    got = tenvs.make_batched_rollout(tenv, horizon)(apply, st0, torch.from_numpy(np.array(o0)))
    np.testing.assert_allclose(got.total_reward.numpy(), np.array(want.total_reward),
                               rtol=1e-4, atol=1e-4)
    x0 = tenv.layout.pos(st0)[:, 0, 0]
    telescoped = (tenv.base.alive_bonus * horizon
                  + 2.0 * (tenv._phi(got.bc[:, 0]) - tenv._phi(x0)) - 0.05 * ctrl)
    np.testing.assert_allclose(got.total_reward.numpy(), telescoped.numpy(), rtol=1e-4, atol=1e-4)
    assert bool((got.bc[:, 0] > 0.002).any())  # some members walked past the bait


@pytest.mark.parametrize("kw", [{"x_bait": 3.0, "x_valley": 3.0}, {"valley_slope": 0.0},
                                {"rise_slope": -1.0}])
def test_deceptive_valley_rejects_bad_geometry(kw):
    with pytest.raises(ValueError) as want:
        jenvs.DeceptiveValley(jenvs.Hopper2D(), **kw)
    with pytest.raises(ValueError) as got:
        tenvs.DeceptiveValley(tenvs.Hopper2D(), **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["Walker2D", "Humanoid2D", "Cheetah2D", "DeceptiveValley"])
def test_env_metrics_match_jax_rollout(name):
    """``make_batched_rollout(with_env_metrics=True)`` against JAX's
    ``make_rollout(with_env_metrics=True)`` vmapped over 16 members at
    horizon 20: the upright-step sums exactly (they count steps), BCs and
    gait summaries at rtol 1e-4, returns at rtol 1e-3 (a foot's contact
    starting one physics step apart moved one Walker2D return by 2.2e-4
    relative: the returns sum velocities, the BCs positions)."""
    jenv, tenv = _pair(name)
    n, horizon = 16, 20
    keys = jax.random.split(jax.random.key(11), n)
    rng = np.random.default_rng(11)
    w = (0.3 * rng.standard_normal((jenv.obs_dim, jenv.action_dim))).astype(np.float32)
    bias = (1.5 * rng.standard_normal((n, jenv.action_dim))).astype(np.float32)
    single = jenvs.make_rollout(jenv, lambda b, o: jnp.tanh(o @ jnp.asarray(w) + b), horizon,
                                with_env_metrics=True)
    want, wsums = jax.vmap(single)(jnp.asarray(bias), keys)
    s0, o0 = jax.vmap(jenv.reset)(keys)
    got, gsums = tenvs.make_batched_rollout(tenv, horizon, with_env_metrics=True)(
        lambda obs: torch.tanh(obs @ torch.from_numpy(w) + torch.from_numpy(bias)),
        interop.env_states_from_jax(tenv, s0), torch.from_numpy(np.array(o0)))
    np.testing.assert_array_equal(got.steps.numpy(), np.array(want.steps))
    np.testing.assert_array_equal(gsums.numpy(), np.array(wsums))
    np.testing.assert_allclose(got.total_reward.numpy(), np.array(want.total_reward),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.bc.numpy(), np.array(want.bc), rtol=1e-4, atol=1e-4)
    for i in range(n):
        g = tenv.episode_metrics(got.bc[i], got.steps[i], gsums[i])
        j = jenv.episode_metrics(np.array(want.bc[i]), np.array(want.steps[i]),
                                 np.array(wsums[i]))
        assert g.keys() == j.keys()
        for key in g:
            np.testing.assert_allclose(g[key], j[key], rtol=1e-4, atol=1e-3, err_msg=key)
    if name == "Walker2D":
        assert 0 < float(gsums.sum()) < float(got.steps.sum())  # the metric varies
    with pytest.raises(ValueError, match="one aux channel per rollout"):
        tenvs.make_batched_rollout(tenv, horizon, with_obs_moments=True, with_env_metrics=True)


WALKER_POLICY = {"action_dim": 6, "hidden": (8, 8), "discrete": False, "action_scale": 1.0}


def test_evaluate_policy_gait_matches_jax(monkeypatch):
    """Walker2D with obs_norm and running stats of a few hundred steps:
    ``evaluate_policy`` from JAX's episode states (the env's reset hands
    them in) against JAX's ``evaluate_policy``: returns, steps, BCs and the
    gait arrays."""
    jes, tes = es_pair(jenvs.Walker2D(), tenvs.Walker2D(), WALKER_POLICY, 20, obs_norm=True)
    rng = np.random.default_rng(2)
    stats = (np.float32(321.0), rng.normal(0, 0.5, 17).astype(np.float32),
             (321.0 * rng.uniform(0.05, 3.0, 17)).astype(np.float32))
    jes.state = jes.state._replace(obs_stats=tuple(jnp.asarray(x) for x in stats))
    tes.state = tes.state._replace(obs_stats=interop.obs_stats_from_jax(stats))
    want = jes.evaluate_policy(n_episodes=8, seed=3, return_details=True)
    s0, _ = jax.vmap(jes.env.reset)(jax.random.split(jax.random.PRNGKey(3), 8))
    states0 = interop.env_states_from_jax(tes.env, s0)
    monkeypatch.setattr(tenvs.Walker2D, "reset",
                        lambda env, generator, n: (states0, env.observe(states0)))
    got = tes.evaluate_policy(n_episodes=8, return_details=True)
    assert got.keys() == want.keys() and got["gait"].keys() == want["gait"].keys()
    np.testing.assert_array_equal(got["steps"], want["steps"])
    np.testing.assert_allclose(got["rewards"], want["rewards"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["bc"], want["bc"], rtol=1e-4, atol=1e-4)
    for key in ("mean", "std", "min", "max"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
    for key in got["gait"]:
        np.testing.assert_allclose(got["gait"][key], want["gait"][key], rtol=1e-4, atol=1e-3,
                                   err_msg=key)
    assert got["episodes"] == 8 and got["gait"]["upright_fraction"].shape == (8,)


def test_best_policy_is_the_best_member_and_use_best_evaluates_it():
    es = configs.walker2d_device(device="cpu", population_size=16, table_size=1 << 16,
                                 policy_kwargs=WALKER_POLICY,
                                 agent_kwargs={"env": tenvs.Walker2D(), "horizon": 10})
    assert es.best_policy is es.policy  # nothing trained yet
    best_gen = None
    for _ in range(3):
        prev = es.state
        es.train(1, verbose=False)
        if es.history[-1]["improved_best"]:
            best_gen = prev
    fit = es.engine.generation_step(best_gen)[1]["fitness"]
    want = es.engine.member_params(best_gen, int(torch.argmax(fit)))
    assert float(fit.max()) == es.best_reward
    torch.testing.assert_close(es.best_policy.params_flat, want, rtol=0, atol=0)
    assert not torch.equal(es.best_policy.params_flat, es.policy.params_flat)
    center = es.evaluate_policy(n_episodes=4, seed=1)
    best = es.evaluate_policy(n_episodes=4, seed=1, use_best=True, return_details=True)
    again = es.evaluate_policy(n_episodes=4, seed=1)
    assert center == again and best["mean"] != center["mean"]
    assert set(best) == {"mean", "std", "min", "max", "episodes", "rewards", "bc", "steps",
                         "gait"}
    with pytest.raises(NotImplementedError, match="item: 4"):
        es.evaluate_policy(meta_index=0)


# --------------------------------------------------------- ES trajectories

CHEETAH_POLICY = {"action_dim": 6, "hidden": (8, 8), "discrete": False, "action_scale": 1.0}
HOPPER_POLICY = {"action_dim": 3, "hidden": (8, 8), "discrete": False, "action_scale": 1.0}
HUMANOID_POLICY = {"action_dim": 10, "hidden": (8, 8), "discrete": False, "action_scale": 1.0}


def test_cheetah_standard_trajectory_matches_jax():
    """Cheetah2D, standard forward, f32, pop 16, horizon 20, 3 generations:
    fitness rtol 1e-4, params atol 2e-5."""
    jes, tes = es_pair(jenvs.Cheetah2D(), tenvs.Cheetah2D(), CHEETAH_POLICY, 20, sigma=0.08)
    for gen in range(3):
        _, jm, tm = step_both(jes, tes)
        check_generation(jes, tes, jm, tm, f"gen {gen}")


def test_hopper_obs_norm_trajectory_matches_jax():
    """Hopper2D with obs_norm, pop 16, horizon 20, 3 generations: members
    terminate, and the obs-norm count, which counts alive steps only, is
    exactly equal."""
    jes, tes = es_pair(jenvs.Hopper2D(), tenvs.Hopper2D(), HOPPER_POLICY, 20, sigma=0.5,
                       obs_norm=True, obs_probe_episodes=2)
    assert float(tes.state.obs_stats[0]) == float(jes.state.obs_stats[0])
    for gen in range(3):
        _, jm, tm = step_both(jes, tes)
        check_generation(jes, tes, jm, tm, f"gen {gen}")
        assert float(tes.state.obs_stats[0]) == float(jes.state.obs_stats[0])
        for i in (1, 2):
            np.testing.assert_allclose(tes.state.obs_stats[i].numpy(),
                                       np.asarray(jes.state.obs_stats[i]), rtol=1e-4, atol=1e-4)
    assert int(tm["steps"]) < 16 * 20  # some members fell


def test_humanoid_low_rank_obs_norm_bf16_generation_matches_jax():
    """Humanoid2D, ``low_rank=1, obs_norm``, bf16, SGD, one generation at
    pop 16, horizon 20 (the pop10k recipe's options at a small size):
    fitness within rtol 1e-3, the ascent directions' cosine ≥ 0.99, the
    obs-norm count exact (as for the bf16 paths of
    ``tests/test_torch_paths.py``)."""
    jes, tes = es_pair(jenvs.Humanoid2D(), tenvs.Humanoid2D(), HUMANOID_POLICY, 20,
                       jopt=optax.sgd, topt=sgd, sigma=0.08, low_rank=1, obs_norm=True,
                       obs_probe_episodes=4, compute_dtype="bfloat16")
    jstate, jm, tm = step_both(jes, tes)
    jf, tf = np.asarray(jm["fitness"]), tm["fitness"].numpy()
    jd = np.asarray(jes.state.params_flat) - np.asarray(jstate.params_flat)
    td = tes.state.params_flat.numpy() - np.asarray(jstate.params_flat)
    cos = float(jd @ td / (np.linalg.norm(jd) * np.linalg.norm(td)))
    print(f"humanoid bf16: fitness max rel err {np.max(np.abs(tf - jf) / np.abs(jf)):.3g}, "
          f"ascent cosine {cos:.6f}")
    np.testing.assert_allclose(tf, jf, rtol=5e-3)
    assert int(tm["steps"]) == int(jm["steps"])
    assert cos >= 0.99, cos
    assert float(tes.state.obs_stats[0]) == float(jes.state.obs_stats[0])


# ------------------------------------------------------------------ recipes

RECIPES = ["cartpole_smoke", "swimmer2d_device", "hopper2d_device", "walker2d_device",
           "humanoid2d_device", "cheetah2d_device", "humanoid2d_pop10k"]


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_builds_with_the_jax_recipes_options(name, monkeypatch):
    """Each device recipe builds on the CPU with the JAX recipe's population,
    σ, horizon, hidden sizes and engine options (small tables: the
    recipes' options, not their memory, are the point)."""
    import estorch_tpu.configs as jconfigs

    captured = {}

    def fake_jes(**kw):
        captured.update(kw)
        return kw

    monkeypatch.setattr("estorch_tpu.ES", fake_jes)
    getattr(jconfigs, name)()
    es = getattr(configs, name)(device="cpu", table_size=1 << 22)
    cfg = es.config
    want_agent = captured["agent_kwargs"]
    assert cfg.population_size == captured["population_size"]
    assert cfg.sigma == captured["sigma"]
    assert cfg.horizon == (want_agent.get("horizon") or want_agent["env"].default_horizon)
    assert type(es.env).__name__ == type(want_agent["env"]).__name__
    assert es.module.hidden == tuple(captured["policy_kwargs"]["hidden"])
    assert es.module.action_dim == captured["policy_kwargs"]["action_dim"]
    assert es.module.discrete == captured["policy_kwargs"].get("discrete", True)
    for option, default in (("low_rank", 0), ("obs_norm", False), ("obs_probe_episodes", 1),
                            ("eval_chunk", 0)):
        assert getattr(cfg, option) == captured.get(option, default), option
    assert es.optimizer.learning_rate == captured["optimizer_kwargs"]["learning_rate"]


@pytest.mark.parametrize("name,item", [("humanoid_nsres", "4"), ("halfcheetah_nsres", "4")])
def test_unported_recipe_raises_naming_its_item(name, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, port queue item: {item}"):
        configs.CONFIGS[name]()


def test_recipe_overrides_and_cli(capsys):
    es = configs.main(["cartpole_smoke", "--generations", "1", "--population", "8",
                       "--device", "cpu"])
    assert es.population_size == 8 and len(es.history) == 1 and es.device.type == "cpu"
    assert "best reward" in capsys.readouterr().out
    over = configs.humanoid2d_device(device="cpu", obs_norm=False, table_size=1 << 20)
    assert not over.config.obs_norm and over.config.obs_probe_episodes == 4
    assert set(configs.CONFIGS) == set(__import__("estorch_tpu.configs").configs.CONFIGS)
