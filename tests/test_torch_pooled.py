"""The port's pooled backend against the JAX package's.

The C++ envpool is the same source built by each package (the port's copy
into ``build/estorch_tpu_torch/``), and its per-env RNGs are seeded by
index, so one seed gives both packages the same env streams: the pools,
the Atari wrapper and whole pooled ES generations are held against JAX
with the JAX side's params, noise table and offsets handed over as numpy.

Rule for fitness: on the discrete envs (CartPole, Pong84) an episode's
return is equal wherever both packages pick the same actions, so it is
held equal, from seeds where no action flips between float32 logits of the
two packages; on Pendulum (continuous actions that differ in the last
bits) it is held to a relative tolerance.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from estorch_tpu import ES as JES
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu import PooledAgent as JPooledAgent
from estorch_tpu.envs.atari_wrappers import AtariPreprocessPool as JAtariPreprocessPool
from estorch_tpu.envs.native_pool import NativeEnvPool as JNativeEnvPool
from estorch_tpu.parallel import population_mesh
from estorch_tpu.utils.fault import rank_weights_with_failures as j_rank_weights
from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, Pendulum, PooledAgent, adam, interop
from estorch_tpu_torch import configs
from estorch_tpu_torch.envs import native_pool
from estorch_tpu_torch.envs.atari_wrappers import AtariPreprocessPool
from estorch_tpu_torch.envs.gym_vec_pool import make_pool, pool_env_spec
from estorch_tpu_torch.envs.native_pool import NativeEnvPool, NumpyEnvPool
from estorch_tpu_torch.parallel import PooledEvalResult
from estorch_tpu_torch.utils.fault import rank_weights_with_failures

CARTPOLE_POLICY = {"action_dim": 2, "hidden": (16,)}
PENDULUM_POLICY = {"action_dim": 1, "hidden": (16,), "discrete": False, "action_scale": 2.0}


def _actions(env, rng, n):
    if env == "pendulum":
        return rng.uniform(-2.5, 2.5, (n, 1)).astype(np.float32)
    return rng.integers(0, 2 if env == "cartpole" else 3, (n, 1)).astype(np.float32)


# ------------------------------------------------------------------ pools


@pytest.mark.parametrize("env", ["cartpole", "pendulum", "pong84"])
def test_native_pool_bit_equal_to_jax(env):
    """200 steps of the same actions from the same seed: obs, reward and
    done bit-equal, whatever the thread counts (2 against 3)."""
    n = 8
    tp = NativeEnvPool(env, n, n_threads=2, seed=7)
    jp = JNativeEnvPool(env, n, n_threads=3, seed=7)
    assert tp.is_native and jp.is_native
    assert tp.obs_shape == jp.obs_shape and tp.n_actions == jp.n_actions
    np.testing.assert_array_equal(tp.reset(), jp.reset())
    rng = np.random.default_rng(1)
    dones = 0
    for _ in range(200):
        a = _actions(env, rng, n)
        to, tr, td = tp.step(a)
        jo, jr, jd = jp.step(a)
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(td, jd)
        dones += int(td.sum())
    if env == "cartpole":
        assert dones > 0  # the auto-reset ran
    tp.close()
    jp.close()
    with pytest.raises(RuntimeError, match="closed"):
        tp.reset()


@pytest.mark.parametrize("env", ["cartpole", "pendulum"])
def test_numpy_pool_matches_cpp(env):
    """The NumPy plain version steps like the C++ pool from the same state,
    at test_native_pool.py's tolerance (rtol 1e-5, atol 1e-6), 50 steps,
    re-aligned each step (their reset streams differ)."""
    n = 16
    cpp = NativeEnvPool(env, n, seed=3)
    npy = NumpyEnvPool(env, n, seed=3)
    assert not npy.is_native
    obs = cpp.reset()
    npy.reset()
    rng = np.random.default_rng(2)
    for _ in range(50):
        if env == "cartpole":
            npy.state = obs.copy()  # the state is the obs
        else:
            npy.state = np.stack([np.arctan2(obs[:, 1], obs[:, 0]), obs[:, 2]], 1)
        a = _actions(env, rng, n)
        oc, rc, dc = cpp.step(a)
        on, rn, dn = npy.step(a)
        live = ~dc
        np.testing.assert_allclose(oc[live], on[live], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rc, rn, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(dc, dn)
        obs = oc
    cpp.close()


def test_envpool_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises with the
    compiler's stderr, and the library goes to the build directory."""
    bad = tmp_path / "envpool.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_pool, "SOURCE", bad)
    monkeypatch.setattr(native_pool, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="envpool build failed(.|\n)*error"):
        native_pool.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_envpool_source_is_the_reference_copy_and_builds_outside_the_package():
    from pathlib import Path

    ref = Path(__file__).resolve().parents[1] / "estorch_tpu" / "native" / "envpool.cpp"
    assert native_pool.SOURCE.read_bytes() == ref.read_bytes()
    lib = native_pool.build()
    assert lib.parent.name == "estorch_tpu_torch" and lib.parent.parent.name == "build"


@pytest.mark.parametrize("max_pool2", [False, True])
def test_atari_wrapper_bit_equal_to_jax(max_pool2):
    """Pong84 with frame_stack 4, action_repeat 2, sticky 0.25: obs, reward
    and done bit-equal to the JAX wrapper over 120 macro-steps (episodes
    end, so the masked rewards and the refill run)."""
    n, seed = 6, 5
    kw = dict(frame_stack=4, action_repeat=2, sticky_prob=0.25, max_pool2=max_pool2)
    tp = AtariPreprocessPool(NativeEnvPool("pong84", n, seed=seed), seed=seed, **kw)
    jp = JAtariPreprocessPool(JNativeEnvPool("pong84", n, seed=seed), seed=seed, **kw)
    assert tp.is_native is True  # a property here, a method in the JAX package
    assert tp.obs_shape == jp.obs_shape == (84, 84, 4)
    np.testing.assert_array_equal(tp.reset(), jp.reset())
    rng = np.random.default_rng(0)
    for _ in range(120):
        a = _actions("pong84", rng, n)
        for got, want in zip(tp.step(a), jp.step(a)):
            np.testing.assert_array_equal(got, want)
    tp.close()
    jp.close()


def test_atari_wrapper_rejects_bad_options():
    pool = NativeEnvPool("cartpole", 2)
    for kw, msg in (({"frame_stack": 0}, "≥1"), ({"sticky_prob": 1.0}, r"\[0, 1\)"),
                    ({"max_pool2": True}, "action_repeat ≥ 2")):
        with pytest.raises(ValueError, match=msg):
            AtariPreprocessPool(pool, **kw)
    pool.close()


def test_rank_weights_with_failures_match_jax():
    """Tied integer returns (the pooled common case: the tie order decides
    the update) and NaN members: the same weights as the JAX package."""
    rng = np.random.default_rng(0)
    for fit in (rng.integers(-3, 4, 64).astype(np.float32),
                np.array([2, 0, 2, np.nan, 1, 2, np.inf, 0, 1, 1], np.float32),
                np.array([5, 5, 5, 5], np.float32)):
        np.testing.assert_array_equal(rank_weights_with_failures(fit), j_rank_weights(fit))
    ties = rank_weights_with_failures(np.array([1, 1, 0], np.float32))
    np.testing.assert_array_equal(ties, [0.0, 0.5, -0.5])  # stable: first tie ranks lower
    with pytest.raises(RuntimeError, match="only 1/3"):
        rank_weights_with_failures(np.array([1, np.nan, np.nan], np.float32))


# ------------------------------------------------------- pooled ES vs JAX


def pooled_pair(agent_kw, policy_kwargs, jpolicy=JMLPPolicy, tpolicy=MLPPolicy, **over):
    """The JAX pooled ES on a one-device mesh and the port's on the CPU with
    the same options, then the JAX side's noise table, initial params and
    VBN statistics handed over."""
    kw = dict(population_size=32, sigma=0.1, seed=0, policy_kwargs=policy_kwargs,
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16)
    kw.update(over)
    jes = JES(jpolicy, JPooledAgent(**agent_kw), optax.adam,
              mesh=population_mesh(jax.devices()[:1]), telemetry=False, **kw)
    tes = ES(tpolicy, PooledAgent(**agent_kw), adam, device="cpu", **kw)
    tes.table = tes.engine.core.table = interop.table_from_numpy(np.asarray(jes.table.data))
    flat, _ = interop.params_from_jax(np.asarray(jes.state.params_flat), tes.spec)
    if "vbn_stats" in jes._frozen:
        stats = jax.tree_util.tree_map(np.asarray, jes._frozen["vbn_stats"])
        tes.module.vbn_stats = interop.vbn_stats_from_jax(stats)
    tes.state = tes.engine.init_state(flat, seed=0)
    return jes, tes


def pooled_step(jes, tes):
    """One generation on both sides from the JAX side's offsets."""
    jstate = jes.state
    offs = torch.from_numpy(np.array(jes.engine.core.all_pair_offsets(jstate)))
    jes.state, jm = jes.engine.generation_step(jstate)
    tes.state, tm = tes.engine.generation_step(tes.state, offs)
    return jm, tm


def check_pooled(jes, tes, jm, tm, what, fitness_rtol=None, params_atol=1e-6, norm_rtol=1e-5):
    """Fitness and BC (the final frame) equal (``fitness_rtol`` None: the
    same actions step the same C++ envs) or, for continuous actions,
    fitness within ``fitness_rtol`` and the BC within 1e-3 (Pendulum's last
    frame after 60 steps moved by up to 1e-4); alive steps and valid counts
    equal; update norm within ``norm_rtol``; params within ``params_atol``."""
    if fitness_rtol is None:
        np.testing.assert_array_equal(tm["fitness"], np.asarray(jm["fitness"]), err_msg=what)
        np.testing.assert_array_equal(tm["bc"], np.asarray(jm["bc"]), err_msg=what)
    else:
        np.testing.assert_allclose(tm["fitness"], np.asarray(jm["fitness"]),
                                   rtol=fitness_rtol, err_msg=what)
        np.testing.assert_allclose(tm["bc"], np.asarray(jm["bc"]), rtol=0, atol=1e-3,
                                   err_msg=what)
    assert tm["steps"] == int(jm["steps"]), what
    assert tm["n_valid"] == int(jm["n_valid"]), what
    np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]), rtol=norm_rtol,
                               err_msg=what)
    np.testing.assert_allclose(tes.state.params_flat.numpy(), np.asarray(jes.state.params_flat),
                               rtol=0, atol=params_atol, err_msg=what)


# (agent, policy, options, fitness rtol, params atol); the fitness rule is in
# the module docstring.  bf16: both packages run the MLP in bf16 products,
# whose roundings differ in the last bit of a bf16 (3 significant digits),
# held at params atol 1e-5 on the same actions.
TRAJECTORIES = [
    ({"env_name": "cartpole", "horizon": 60}, CARTPOLE_POLICY, {}, None, 1e-6),
    ({"env_name": "cartpole", "horizon": 60}, CARTPOLE_POLICY, {"mirrored": False}, None, 1e-6),
    ({"env_name": "cartpole", "horizon": 60, "double_buffer": True}, CARTPOLE_POLICY, {}, None,
     1e-6),
    ({"env_name": "cartpole", "horizon": 60, "bc_indices": (0,)}, CARTPOLE_POLICY, {}, None,
     1e-6),
    ({"env_name": "cartpole", "horizon": 60}, CARTPOLE_POLICY,
     {"noise_kernel": True, "weight_decay": 0.01}, None, 1e-6),
    ({"env_name": "cartpole", "horizon": 60}, CARTPOLE_POLICY,
     {"compute_dtype": "bfloat16"}, None, 1e-5),
    ({"env_name": "pendulum", "horizon": 60}, PENDULUM_POLICY, {"obs_norm": True}, 1e-5, 1e-6),
    ({"env_name": "pendulum", "horizon": 60, "double_buffer": True}, PENDULUM_POLICY,
     {"obs_norm": True}, 1e-5, 1e-6),
]
TRAJECTORY_IDS = ["cartpole", "cartpole_unmirrored", "cartpole_double_buffer",
                  "cartpole_bc_indices", "cartpole_noise_kernel", "cartpole_bf16",
                  "pendulum_obs_norm", "pendulum_obs_norm_double_buffer"]


@pytest.mark.parametrize("agent_kw,policy,opts,fit_rtol,p_atol", TRAJECTORIES,
                         ids=TRAJECTORY_IDS)
def test_pooled_trajectory_matches_jax(agent_kw, policy, opts, fit_rtol, p_atol):
    """Three pooled generations from the JAX side's offsets; with obs_norm
    the Welford triple within 1e-6 (its count exact) after each."""
    jes, tes = pooled_pair(agent_kw, policy, **opts)
    assert tes.backend == "pooled" and tes.engine.bc_dim == jes.engine.bc_dim
    for g in range(3):
        jm, tm = pooled_step(jes, tes)
        check_pooled(jes, tes, jm, tm, f"generation {g}", fit_rtol, p_atol)
        if opts.get("obs_norm"):
            jc, jmean, jm2 = (np.asarray(x) for x in jes.state.obs_stats)
            tc, tmean, tm2 = (x.numpy() for x in tes.state.obs_stats)
            assert float(tc) == float(jc) == 1 + 32 * 60 * (g + 1)  # pendulum never ends
            np.testing.assert_allclose(tmean, jmean, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(tm2 / tc, jm2 / jc, rtol=1e-6, atol=1e-6)


def test_double_buffer_equals_each_half_through_the_sync_path():
    """The double-buffered evaluation is the two halves' sync evaluations
    on pools of the same seeds, concatenated."""
    kw = dict(population_size=16, sigma=0.1, seed=3, device="cpu", table_size=1 << 16,
              policy_kwargs=CARTPOLE_POLICY, optimizer_kwargs={"learning_rate": 1e-2})
    es = ES(MLPPolicy, PooledAgent("cartpole", horizon=80, double_buffer=True), adam, **kw)
    eng = es.engine
    offs = eng.all_pair_offsets(es.state)
    db = eng.evaluate(es.state, offs)
    members = eng.materialize(es.state, offs)
    from estorch_tpu_torch.envs.rollout import population_forward

    halves = []
    for lo, seed in ((0, 3), (8, 3 + 10_007)):
        sub = {k: {n: v[lo:lo + 8] for n, v in leaves.items()} for k, leaves in members.items()}
        pool = NativeEnvPool("cartpole", 8, seed=seed)
        halves.append(eng._run_pool(pool, population_forward(es.module, sub), 8, None, False))
        pool.close()
    np.testing.assert_array_equal(db.fitness, np.concatenate([h.fitness for h in halves]))
    np.testing.assert_array_equal(db.bc, np.concatenate([h.bc for h in halves]))
    assert db.steps == sum(h.steps for h in halves)


def test_evaluate_policy_matches_jax():
    """The pooled ``evaluate_policy``: a fresh pool seeded 20_011 + seed,
    the center's episodes equal to the JAX package's, and ``use_best``."""
    jes, tes = pooled_pair({"env_name": "cartpole", "horizon": 100}, CARTPOLE_POLICY,
                           population_size=16)
    for s in (0, 4):
        want = jes.evaluate_policy(12, seed=s, return_details=True)
        got = tes.evaluate_policy(12, seed=s, return_details=True)
        np.testing.assert_array_equal(got["rewards"], want["rewards"])
        np.testing.assert_allclose(got["bc"], want["bc"], rtol=1e-5, atol=1e-6)
        assert got["mean"] == pytest.approx(want["mean"])
    tes.train(1, verbose=False)
    best = tes.evaluate_policy(4, use_best=True)
    assert best["episodes"] == 4 and np.isfinite(best["mean"])
    center = tes.engine.evaluate_center(tes.state)
    assert int(center.steps) >= 1 and center.bc.shape == (4,)


@pytest.fixture
def sync_gym(monkeypatch):
    """gymnasium first: and with one visible core, both packages' gym pools
    pick ``SyncVectorEnv`` (the same envs in this process; the async form
    forks a worker an env, which a test process with JAX's threads should
    not)."""
    pytest.importorskip("gymnasium")
    monkeypatch.setattr("os.sched_getaffinity", lambda pid: {0})


@pytest.mark.parametrize("env_id", ["CartPole-v1"])
def test_gym_pool_matches_jax(env_id, sync_gym):
    """``gym:CartPole-v1`` through GymVecPool: two pooled generations equal
    to the JAX package's (gymnasium seeds both packages' envs alike)."""
    jes, tes = pooled_pair({"env_name": f"gym:{env_id}", "horizon": 40}, CARTPOLE_POLICY,
                           population_size=8)
    assert not tes.engine.pool.is_native
    for g in range(2):
        jm, tm = pooled_step(jes, tes)
        check_pooled(jes, tes, jm, tm, f"generation {g}")
    tes.engine.close()
    jes.engine.pool.close()
    jes.engine.center_pool.close()


def test_gym_pool_seeds_once_and_rejects_native_kwargs(sync_gym):
    pool = make_pool("gym:CartPole-v1", 3, seed=0)
    a, b = pool.reset(), pool.reset()
    assert not np.array_equal(a, b)  # later resets continue the stream
    pool.close()
    again = make_pool("gym:CartPole-v1", 3, seed=0)
    np.testing.assert_array_equal(again.reset(), a)
    again.close()
    assert pool_env_spec("gym:CartPole-v1")["n_actions"] == 2
    for fn in (make_pool, pool_env_spec):
        args = ("cartpole", 2) if fn is make_pool else ("cartpole",)
        with pytest.raises(ValueError, match="native"):
            fn(*args, env_kwargs={"x": 1})


def test_halfcheetah_pooled_recipe_runs(sync_gym):
    """The recipe at population 8, horizon 30, one generation (MuJoCo in a
    gym.vector pool); HalfCheetah never terminates."""
    pytest.importorskip("mujoco")
    es = configs.halfcheetah_pooled(device="cpu", population_size=8, table_size=1 << 16,
                                    agent_kwargs={"env_name": "gym:HalfCheetah-v5",
                                                  "horizon": 30})
    p0 = es.state.params_flat.clone()
    es.train(1, verbose=False)
    rec = es.history[0]
    assert es.backend == "pooled" and rec["env_steps"] == 8 * 30
    assert np.isfinite(rec["reward_mean"]) and not torch.equal(p0, es.state.params_flat)
    es.engine.close()


def test_pooled_recipes_take_the_jax_options(monkeypatch):
    """pong84_conv, halfcheetah_pooled and humanoid_pooled carry the JAX
    recipes' options, and so does the host recipe humanoid_mirrored (its
    torch policy and agent built by the same helpers); Atari keeps the
    ale_py gate."""
    import estorch_tpu
    import estorch_tpu.configs as jconfigs

    seen = []

    def fake_es(**kw):
        seen.append(kw)

    monkeypatch.setattr(configs, "ES", fake_es)
    monkeypatch.setattr(estorch_tpu, "ES", fake_es)  # the JAX recipes import it at call time
    for name in ("pong84_conv", "halfcheetah_pooled", "humanoid_pooled"):
        seen.clear()
        getattr(configs, name)()
        getattr(jconfigs, name)()
        port_kw, jax_kw = seen
        for key in ("population_size", "sigma", "policy_kwargs", "agent_kwargs",
                    "optimizer_kwargs", "weight_decay", "obs_norm", "table_size"):
            assert port_kw.get(key) == jax_kw.get(key), (name, key)
        assert port_kw["policy"].__name__ == jax_kw["policy"].__name__
        assert port_kw["agent"].__name__ == jax_kw["agent"].__name__ == "PooledAgent"
    seen.clear()
    configs.humanoid_mirrored()
    jconfigs.humanoid_mirrored()
    port_kw, jax_kw = seen
    for key in ("population_size", "sigma", "optimizer", "optimizer_kwargs", "weight_decay"):
        assert port_kw[key] == jax_kw[key], key
    assert port_kw["policy"].__name__ == jax_kw["policy"].__name__ == "MLP"
    assert port_kw["agent"].__name__ == jax_kw["agent"].__name__ == "MujocoAgent"
    try:
        import ale_py  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="ale_py"):
            configs.CONFIGS["atari_frostbite"]()


# ------------------------------------------------------------- rejections

BASE = dict(population_size=8, sigma=0.1, seed=0, policy_kwargs=CARTPOLE_POLICY,
            optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 14)
_PIXELS = {"env_name": "pong84", "frame_stack": 2}


@pytest.mark.parametrize("agent_kw,option,message", [
    ({}, {"episodes_per_member": 2}, "episodes_per_member is a device-path option"),
    ({}, {"streamed": True}, "streamed is a device-path option"),
    ({}, {"decomposed": True}, "decomposed is a device-path option"),
    ({}, {"low_rank": 1}, "low_rank is a device-path option"),
    ({}, {"shard_params": True}, "shard_params needs device-native rollouts"),
    ({}, {"obs_norm": True, "obs_warmup_episodes": 1}, "obs_warmup_episodes is a device-path"),
    ({}, {"scenarios": "a distribution"}, "scenarios needs device-native rollouts"),
    ({}, {"policy_kwargs": dict(CARTPOLE_POLICY, use_vbn=True), "obs_norm": True},
     "VirtualBatchNorm \\+ obs_norm is unsupported"),
    (_PIXELS, {"obs_norm": True}, "obs_norm \\+ Atari preprocessing is unsupported"),
    ({"double_buffer": True}, {"population_size": 7, "mirrored": False},
     "double_buffer needs an even population"),
    ({"bc_indices": (4,)}, {}, "out of range for obs_dim"),
    ({**_PIXELS, "bc_indices": (0,)}, {"policy_kwargs": {"action_dim": 3, "hidden": (4,)}},
     "bc_indices need a 1-D"),
    ({"env_kwargs": {"x": 1}}, {}, "env_kwargs only apply to gym: envs"),
], ids=["episodes", "streamed", "decomposed", "low_rank", "shard_params", "warmup",
        "scenarios", "vbn+obs_norm", "obs_norm+prep", "double_buffer_odd", "bc_range",
        "bc_pixels", "native_env_kwargs"])
def test_pooled_options_raise_as_in_jax(agent_kw, option, message):
    agent = {"env_name": "cartpole", "horizon": 10, **agent_kw}
    kw = dict(BASE, **option)
    if "scenarios" in kw:  # the JAX package checks the type first
        import estorch_tpu.envs as jenvs
        from estorch_tpu.scenarios import default_distribution

        kw["scenarios"] = default_distribution(jenvs.CartPole(), n_variants=2)
    with pytest.raises(ValueError, match=message):
        JES(JMLPPolicy, JPooledAgent(**agent), optax.adam,
            mesh=population_mesh(jax.devices()[:1]), telemetry=False, **kw)
    with pytest.raises(ValueError, match=message):
        ES(MLPPolicy, PooledAgent(**agent), adam, device="cpu", **kw)


class _Recurrent:
    is_recurrent = True

    def __init__(self, **kwargs):
        del kwargs


def test_unported_pooled_options_raise():
    kw = dict(BASE, device="cpu")
    agent = PooledAgent("cartpole", horizon=10)
    # a recurrent pooled policy trains (tests/test_torch_recurrent.py); telemetry waits
    with pytest.raises(NotImplementedError, match="item: 6"):
        ES(_Recurrent, agent, adam, telemetry=True, **kw)
    with pytest.raises(ValueError, match="learned_carry is a device-path feature"):
        ES(_Recurrent, agent, adam, **dict(kw, policy_kwargs={"learned_carry": True}))
    with pytest.raises(NotImplementedError, match="item: 7"):
        ES(MLPPolicy, agent, adam, mesh=object(), **kw)
    with pytest.raises(NotImplementedError, match="item: 4"):
        ES(MLPPolicy, agent, adam, **kw).evaluate_policy(2, meta_index=0)
    # VBN on the device path trains; the per-center evaluation waits for item 4
    with pytest.raises(NotImplementedError, match="item: 4"):
        ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=10), adam, device="cpu",
           policy_kwargs=dict(PENDULUM_POLICY, use_vbn=True), table_size=1 << 14,
           optimizer_kwargs={"learning_rate": 1e-2}).evaluate_policy(2, meta_index=0)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ES(MLPPolicy, agent, adam, **BASE)  # the default device is the card
    with pytest.raises(ValueError, match="unknown env"):
        ES(MLPPolicy, PooledAgent("humanoid"), adam, **kw)


def test_pooled_mlp_vbn_trains_and_rejected_generation_keeps_state():
    """MLP with VBN on the pooled backend: frozen statistics from the pool's
    reference batch (kept by best_policy's copy), and a collapsed
    population (all-NaN fitness) leaves the state as it was."""
    es = ES(MLPPolicy, PooledAgent("cartpole", horizon=30), adam, device="cpu",
            **dict(BASE, policy_kwargs=dict(CARTPOLE_POLICY, use_vbn=True)))
    assert set(es.module.vbn_stats) == {"vbn_0"}
    assert "vbn_0" in es.spec.unravel(es.state.params_flat)
    es.train(2, verbose=False)
    assert np.isfinite(es.history[-1]["reward_mean"])
    assert es.best_policy.vbn_stats is not None
    out = es.policy(torch.zeros(3, 4))
    assert out.shape == (3, 2)
    eng = es.engine
    state = es.state
    eng.evaluate = lambda s, o=None: PooledEvalResult(
        fitness=np.full(8, np.nan, np.float32), bc=np.zeros((8, 4), np.float32), steps=0)
    new_state, m = eng.generation_step(state)
    assert new_state is state and m["n_valid"] == 0
    with pytest.raises(RuntimeError, match="consecutive generations rejected"):
        es.train(1, verbose=False, max_consecutive_rejections=0)
    assert es.state is state
