"""The port's envs, rollout, engine and ES against the JAX package.

The whole slice — streamed forward plus the kernel update reduction — is
run for three generations on both sides from the same params, noise
table, offsets and initial env states (the JAX side's, handed over as
numpy), and the fitness and params must agree.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import estorch_tpu.envs as jenvs
from estorch_tpu import ES as JES
from estorch_tpu import JaxAgent
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu.envs.rollout import make_batched_rollout as jmake_batched_rollout
from estorch_tpu.parallel import population_mesh
from estorch_tpu.parallel.engine import _gen_keys
from estorch_tpu_torch import (ES, CartPole, DeviceAgent, MLPPolicy, Pendulum, PooledAgent, adam,
                               interop)
from estorch_tpu_torch.envs.rollout import make_batched_rollout
from estorch_tpu_torch.parallel import Sample
from estorch_tpu_torch.utils import resolve_device

PENDULUM_POLICY = {"action_dim": 1, "hidden": (8, 8), "discrete": False, "action_scale": 2.0}


# ---------------------------------------------------------------- envs


def _random_states(env_name, rng, n):
    if env_name == "pendulum":
        return np.stack([rng.uniform(-4, 4, n), rng.uniform(-8, 8, n)], 1).astype(np.float32)
    return rng.uniform(-0.3, 0.3, (n, 4)).astype(np.float32)


@pytest.mark.parametrize("env_name", ["pendulum", "cartpole"])
def test_env_step_matches_jax(env_name):
    rng = np.random.default_rng(21)
    n = 64
    states = _random_states(env_name, rng, n)
    if env_name == "pendulum":
        jenv, tenv = jenvs.Pendulum(), Pendulum()
        actions = rng.uniform(-3, 3, (n, 1)).astype(np.float32)  # includes clipped torques
    else:
        jenv, tenv = jenvs.CartPole(), CartPole()
        actions = rng.integers(0, 2, n)
    want = jax.vmap(jenv.step)(jnp.asarray(states), jnp.asarray(actions))
    got = tenv.step(torch.from_numpy(states), torch.from_numpy(actions))
    for name, w, g in zip(("state", "obs", "reward", "done"), want, got):
        np.testing.assert_allclose(g.numpy(), np.broadcast_to(np.asarray(w), g.shape),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(
        tenv.behavior(got[0], got[1]).numpy(),
        np.asarray(jax.vmap(jenv.behavior)(want[0], want[1])), rtol=1e-6, atol=1e-7)
    want_obs = (jax.vmap(jenv._obs)(jnp.asarray(states)) if env_name == "pendulum"
                else states)
    np.testing.assert_allclose(tenv.observe(torch.from_numpy(states)).numpy(),
                               np.asarray(want_obs), rtol=1e-6, atol=1e-7)


def test_pendulum_angle_normalize_is_floored():
    """Angles far outside [-π, π) wrap like jnp's floored %, both signs."""
    rng = np.random.default_rng(5)
    states = np.stack([rng.uniform(-50, 50, 256), rng.uniform(-1, 1, 256)], 1).astype(np.float32)
    actions = np.zeros((256, 1), np.float32)
    want = jax.vmap(jenvs.Pendulum().step)(jnp.asarray(states), jnp.asarray(actions))[2]
    got = Pendulum().step(torch.from_numpy(states), torch.from_numpy(actions))[2]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("env_name", ["pendulum", "cartpole"])
def test_env_reset_ranges(env_name):
    env = Pendulum() if env_name == "pendulum" else CartPole()
    states, obs = env.reset(torch.Generator().manual_seed(0), 1000)
    assert states.shape == (1000, 2 if env_name == "pendulum" else 4)
    assert obs.shape == (1000, env.obs_dim)
    torch.testing.assert_close(obs, env.observe(states))
    bound = torch.tensor([np.pi, 1.0]) if env_name == "pendulum" else torch.full((4,), 0.05)
    assert bool((states.abs() <= bound).all())


# -------------------------------------------------------------- rollout


@pytest.mark.parametrize("env_name", ["pendulum", "cartpole"])
def test_batched_rollout_matches_jax(env_name):
    """A fixed linear policy from the same initial states: same returns,
    alive-step counts and final-frame BCs (CartPole members terminate at
    different steps, which exercises the done mask)."""
    n, horizon = 16, 100
    jenv = jenvs.Pendulum() if env_name == "pendulum" else jenvs.CartPole()
    tenv = Pendulum() if env_name == "pendulum" else CartPole()
    rng = np.random.default_rng(8)
    w = rng.standard_normal((jenv.obs_dim, jenv.action_dim)).astype(np.float32)
    # a per-member bias: some members push one way and fall early
    bias = (2.0 * rng.standard_normal((n, jenv.action_dim))).astype(np.float32)
    keys = jax.random.split(jax.random.key(3), n)
    states0, obs0 = jax.vmap(jenv.reset)(keys)

    def japply(obs):
        out = obs @ jnp.asarray(w) + jnp.asarray(bias)
        return out if jenv.discrete else jnp.tanh(out) * 2.0

    def tapply(obs):
        out = obs @ torch.from_numpy(w) + torch.from_numpy(bias)
        return out if tenv.discrete else torch.tanh(out) * 2.0

    want = jmake_batched_rollout(jenv, horizon)(japply, keys)
    got = make_batched_rollout(tenv, horizon)(
        tapply, torch.from_numpy(np.array(states0)), torch.from_numpy(np.array(obs0)))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    np.testing.assert_allclose(got.total_reward.numpy(), np.asarray(want.total_reward),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.bc.numpy(), np.asarray(want.bc), rtol=1e-4, atol=1e-4)
    if env_name == "cartpole":
        assert len(set(np.asarray(want.steps).tolist())) > 1  # the mask mattered


# ------------------------------------------------------- whole slice


def _jax_es(mirrored, **over):
    return JES(
        JMLPPolicy, JaxAgent(jenvs.Pendulum(), horizon=20), optax.adam,
        population_size=16, sigma=0.05, seed=0, policy_kwargs=PENDULUM_POLICY,
        optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16,
        streamed=True, noise_kernel=True, mirrored=mirrored,
        mesh=population_mesh(jax.devices()[:1]), telemetry=False, **over,
    )


def _torch_es(mirrored, **over):
    kw = dict(population_size=16, sigma=0.05, seed=0, device="cpu",
              policy_kwargs=PENDULUM_POLICY, optimizer_kwargs={"learning_rate": 1e-2},
              table_size=1 << 16, streamed=True, noise_kernel=True, mirrored=mirrored)
    kw.update(over)
    return ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, **kw)


@pytest.mark.parametrize("mirrored,over", [
    (True, {}),
    (False, {}),
    # weight decay before Adam, then σ annealing down to its floor
    (True, {"weight_decay": 0.05, "sigma_decay": 0.9, "sigma_min": 0.042}),
], ids=["mirrored", "unmirrored", "decay_anneal"])
def test_three_generation_trajectory_matches_jax(mirrored, over):
    """Pendulum, MLP (8, 8), pop 16, horizon 20, streamed + noise kernel.

    Tolerance: float32 matmuls and sums taken in another order by XLA and
    torch, compounded over 20 env steps and 3 Adam steps — rtol 1e-4 on
    fitness, atol 2e-5 on params (Adam moves each param ≈ lr = 1e-2 a step).
    """
    jes, tes = _jax_es(mirrored, **over), _torch_es(mirrored, **over)
    tes.engine.table = interop.table_from_numpy(np.asarray(jes.table.data))
    flat, _ = interop.params_from_jax(np.asarray(jes.state.params_flat), tes.spec)
    tes.state = tes.engine.init_state(flat, seed=0)
    n_rows = 8 if mirrored else 16
    for gen in range(3):
        jstate = jes.state
        offsets = np.array(jes.engine.all_pair_offsets(jstate))
        _, rkey = _gen_keys(jstate)
        states0, _ = jax.vmap(jes.env.reset)(jax.random.split(rkey, n_rows))
        sample = Sample(torch.from_numpy(offsets), torch.from_numpy(np.array(states0)))
        jes.state, jm = jes.engine.generation_step(jstate)
        tes.state, tm = tes.engine.generation_step(tes.state, sample)
        np.testing.assert_allclose(tm["fitness"].numpy(), np.asarray(jm["fitness"]),
                                   rtol=1e-4, atol=1e-3, err_msg=f"gen {gen}")
        assert int(tm["n_valid"]) == int(jm["n_valid"]) == 16
        assert int(tm["steps"]) == int(jm["steps"])
        np.testing.assert_allclose(tes.state.params_flat.numpy(),
                                   np.asarray(jes.state.params_flat),
                                   rtol=0, atol=2e-5, err_msg=f"gen {gen}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert float(tes.state.sigma) == float(jes.state.sigma)
    assert tes.state.generation == 3


def test_train_records_and_learning_signal():
    es = _torch_es(True, population_size=32)
    es.train(3, verbose=False)
    assert [r["generation"] for r in es.history] == [0, 1, 2]
    for r in es.history:
        for key in ("reward_mean", "reward_max", "env_steps", "env_steps_per_sec",
                    "grad_norm", "sigma"):
            assert np.isfinite(r[key]), key
        assert r["env_steps"] == 32 * 20
    assert es.best_reward == max(r["reward_max"] for r in es.history)
    assert not torch.equal(es.state.params_flat, _torch_es(True).state.params_flat)
    out = es.policy(torch.zeros(5, 3))
    assert out.shape == (5, 1) and bool((out.abs() <= 2.0).all())


def test_same_seed_same_run_and_rerun_is_identical():
    a, b = _torch_es(True), _torch_es(True)
    s0 = a.state
    s1, m1 = a.engine.generation_step(s0)
    s1b, m1b = a.engine.generation_step(s0)  # re-running a generation
    torch.testing.assert_close(s1.params_flat, s1b.params_flat, rtol=0, atol=0)
    torch.testing.assert_close(m1["fitness"], m1b["fitness"], rtol=0, atol=0)
    b.train(1, verbose=False)
    torch.testing.assert_close(b.state.params_flat, s1.params_flat, rtol=0, atol=0)


def test_rejected_generation_restores_state():
    """All-NaN fitness: every retry is rejected, the state is the
    pre-generation one, and the fault is reported as persistent."""
    es = _torch_es(True)
    bad = es.state.params_flat.clone().fill_(float("nan"))
    es.state = es.state._replace(params_flat=bad)
    with pytest.raises(RuntimeError, match="consecutive"):
        es.train(1, verbose=False, max_consecutive_rejections=2)
    assert es.state.generation == 0 and es.history == []
    assert es.state.params_flat is bad


# -------------------------------------------------- device and options


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=5), adam,
           policy_kwargs=PENDULUM_POLICY, optimizer_kwargs={"learning_rate": 1e-2},
           streamed=True, noise_kernel=True, table_size=1 << 14)
    # the default constructor, no path options: the standard forward
    with pytest.raises(RuntimeError, match="cuda"):
        ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=5), adam,
           policy_kwargs=PENDULUM_POLICY, optimizer_kwargs={"learning_rate": 1e-2})
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_default_constructor_trains_the_standard_forward():
    es = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, device="cpu",
            policy_kwargs=PENDULUM_POLICY, optimizer_kwargs={"learning_rate": 1e-2},
            table_size=1 << 16)
    cfg = es.config
    assert not (cfg.streamed or cfg.noise_kernel or cfg.decomposed or cfg.low_rank
                or cfg.obs_norm)
    p0 = es.state.params_flat.clone()
    es.train(2, verbose=False)
    assert len(es.history) == 2 and np.isfinite(es.history[-1]["reward_mean"])
    assert not torch.equal(p0, es.state.params_flat)


class _RecurrentPolicy:
    """Stands for a recurrent policy: only the marker the ES reads."""

    is_recurrent = True

    def __init__(self, **kwargs):
        del kwargs


class _HostAgent:
    def rollout(self, policy):
        return 0.0


# each case names an option that waited for its ROADMAP.md item; the two
# telemetry cases (the hub came with port item 5) hold it live instead, the
# scenarios case (port item 8) holds the JAX package's TypeError for
# anything but a ScenarioDistribution, the mesh cases (port item 7a) hold a
# world-1 mesh live, anything else refused, and a mesh on the host path
# refused, and the sharding cases (port item 7c) hold the JAX package's
# ValueError for its keywords without shard_params, a mesh that is not a
# HyperscaleMesh refused, and shard_params live on the (1, 1) mesh
@pytest.mark.parametrize("option", [
    {"mesh": "world 1"},
    {"telemetry": True},  # live on the device path
    {"model_shards": 2},  # the param-sharded engine, item 7
    {"agent": "pooled", "telemetry": True},  # live on the pooled path
    {"agent": _HostAgent(), "mesh": object()},  # a mesh on the host path
    {"policy": _RecurrentPolicy, "partition_rules": ()},  # the sharded engine's rules
    {"shard_params": True, "mesh": object()},
    {"shard_params": True},
    {"scenarios": object()},
])
def test_unported_options_raise(option):
    option = dict(option)
    policy = option.pop("policy", MLPPolicy)
    agent = option.pop("agent", DeviceAgent(Pendulum(), horizon=20))
    kw = dict(population_size=16, sigma=0.05, seed=0, device="cpu",
              policy_kwargs=PENDULUM_POLICY, optimizer_kwargs={"learning_rate": 1e-2},
              table_size=1 << 16)
    kw.update(option)
    if "telemetry" in option:
        _check_telemetry_live(policy, agent, kw)
        return
    if "scenarios" in option:
        with pytest.raises(TypeError, match="scenarios must be a ScenarioDistribution"):
            ES(policy, agent, adam, **kw)
        return
    if "mesh" in option and "shard_params" not in option:
        _check_mesh_live(policy, agent, kw)
        return
    _check_sharded_live(policy, agent, kw)


def _check_sharded_live(policy, agent, kw):
    if not kw.get("shard_params"):
        with pytest.raises(ValueError, match="pass shard_params=True"):
            ES(policy, agent, adam, **kw)
        return
    if "mesh" in kw:
        with pytest.raises(TypeError, match="HyperscaleMesh"):
            ES(policy, agent, adam, **kw)
        return
    es = ES(policy, agent, adam, **kw)
    es.train(1, verbose=False)
    assert type(es.engine).__name__ == "ShardedESEngine" and es.table is None
    assert es.mesh.shape == {"pop": 1, "model": 1} and len(es.history) == 1


def _check_mesh_live(policy, agent, kw):
    """A world-1 ``PopulationMesh`` trains (the mesh on the ES); any other
    object is refused with a TypeError, and the host path refuses a mesh."""
    from estorch_tpu_torch.parallel import single_device_mesh

    if isinstance(agent, _HostAgent):
        with pytest.raises(ValueError, match="mesh is a device/pooled-path option"):
            ES(policy, agent, adam, **kw)
        return
    with pytest.raises(TypeError, match="mesh must be a PopulationMesh"):
        ES(policy, agent, adam, **dict(kw, mesh=object()))
    es = ES(policy, agent, adam, **dict(kw, mesh=single_device_mesh("cpu")))
    es.train(1, verbose=False)
    assert es.mesh.devices.size == 1 and len(es.history) == 1


def _check_telemetry_live(policy, agent, kw):
    """``telemetry=True`` on the device or pooled path: every record carries
    the JAX package's phases for that backend, and the hub counts."""
    if agent == "pooled":
        agent = PooledAgent("pendulum", horizon=20)
        want = {"eval", "eval/sample", "update", "record"}
    else:
        want = {"dispatch", "device", "host_sync", "record"}
    es = ES(policy, agent, adam, **kw)
    assert es.obs.enabled
    es.train(2, verbose=False)
    for r in es.history:
        assert set(r["phases"]) == want
        assert all(v >= 0 for v in r["phases"].values())
    snap = es.obs.counters.snapshot()
    assert snap["generations"] == 2
    assert snap["env_steps"] == sum(r["env_steps"] for r in es.history) > 0


@pytest.mark.parametrize("option,message", [
    ({"streamed": True, "decomposed": True}, "streamed IS the kernel form of decomposed"),
    ({"low_rank": 1, "streamed": True}, "low_rank replaces the full-rank noise pathway"),
    ({"low_rank": 1, "noise_kernel": True}, "low_rank replaces the full-rank noise pathway"),
    ({"streamed": True, "compute_dtype": "bfloat16"}, "streamed runs in float32"),
    ({"streamed": True, "episodes_per_member": 2}, "supports episodes_per_member=1"),
    ({"obs_warmup_episodes": 2}, "requires obs_norm=True"),
    ({"compute_dtype": "float16"}, "compute_dtype must be float32 or bfloat16"),
], ids=["streamed+decomposed", "low_rank+streamed", "low_rank+noise_kernel",
        "streamed+bf16", "streamed+episodes", "warmup_without_obs_norm", "float16"])
def test_incompatible_options_raise_as_in_jax(option, message):
    """The combinations the JAX package rejects raise the same ValueError."""
    base = dict(population_size=16, sigma=0.05, seed=0, policy_kwargs=PENDULUM_POLICY,
                optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16)
    with pytest.raises(ValueError, match=message):
        JES(JMLPPolicy, JaxAgent(jenvs.Pendulum(), horizon=20), optax.adam,
            mesh=population_mesh(jax.devices()[:1]), telemetry=False, **base, **option)
    with pytest.raises(ValueError, match=message):
        ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, device="cpu", **base,
           **option)


def test_host_agent_and_vbn_raise():
    # a host agent with a device-path option: the JAX package's ValueError
    with pytest.raises(ValueError, match="streamed is a device-path option"):
        ES(MLPPolicy, _HostAgent(), adam, device="cpu", policy_kwargs=PENDULUM_POLICY,
           optimizer_kwargs={"learning_rate": 1e-2}, streamed=True)
    # VBN on the device path trains; a per-center evaluation is the novelty
    # family's, which a plain ES rejects with the JAX package's ValueError
    es = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, device="cpu",
            policy_kwargs=dict(PENDULUM_POLICY, use_vbn=True),
            optimizer_kwargs={"learning_rate": 1e-2})
    assert set(es.module.vbn_stats) == {"vbn_0", "vbn_1"}
    with pytest.raises(ValueError, match="meta_index applies to the novelty family"):
        es.evaluate_policy(2, meta_index=0)


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import sys, estorch_tpu_torch, estorch_tpu_torch.algo.scheduler\n"
        "import estorch_tpu_torch.utils.checkpoint, estorch_tpu_torch.resilience.supervisor\n"
        "import estorch_tpu_torch.resilience.interleave, estorch_tpu_torch.obs.sinks\n"
        "import estorch_tpu_torch.obs.manifest, estorch_tpu_torch.obs.summarize\n"
        "import estorch_tpu_torch.obs.__main__, estorch_tpu_torch.obs.tracing\n"
        "import estorch_tpu_torch.serve.server, estorch_tpu_torch.serve.__main__\n"
        "import estorch_tpu_torch.serve.warm, estorch_tpu_torch.serve.client\n"
        "import estorch_tpu_torch.serve.loadgen, estorch_tpu_torch.scenarios\n"
        "import estorch_tpu_torch.serve.fleet, estorch_tpu_torch.serve.router\n"
        "import estorch_tpu_torch.obs.agg\n"
        "from estorch_tpu_torch import *  # the package's lazy names load their modules\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('jax', 'flax', 'optax', 'chex'))"
        " or m == 'estorch_tpu' or m.startswith('estorch_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
