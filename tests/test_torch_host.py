"""The port's host backend against the JAX package's, on the CPU.

Both packages run the reference's contract (a torch policy class, an agent
with ``rollout(policy)``, ``torch.optim.Adam``) from the same seed: the same
master policy (torch's generator seeded by ``ES``), the same NumPy noise
table (``default_rng(seed)``) and the same ``SeedSequence`` offsets, so a
member's θ and its rollout are the same in both.  The update differs in its
summation order only: the JAX package adds the pair rows one by one in
float32, the port's ``weighted_noise_sum`` takes ``weights @ rows``.  Each
case names the JAX test in ``tests/test_host_backend.py`` it mirrors.

Tolerances: fitness of the first generation ≤ 1e-6 relative (measured:
bit-equal); params after 3 Adam generations ≤ 2e-6 absolute (measured at
most 2.1e-7 on these agents: Adam's step is about lr·sign(g), so the
reduction's ~1e-7 relative difference moves params by far less than lr).
"""

import inspect
import warnings

import numpy as np
import pytest
import torch

from estorch_tpu import ES as JES
from estorch_tpu.models import TorchRunningObsNorm as JRunningObsNorm
from estorch_tpu.models import TorchVirtualBatchNorm as JVBN
from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, Pendulum, adam
from estorch_tpu_torch.host import HostEngine, HostState
from estorch_tpu_torch.host.engine import load_flat
from estorch_tpu_torch.models import TorchRunningObsNorm, TorchVirtualBatchNorm

PARAMS_ATOL = 2e-6


class TorchMLP(torch.nn.Module):
    def __init__(self, n_in=4, hidden=8, n_out=2):
        super().__init__()
        self.net = torch.nn.Sequential(torch.nn.Linear(n_in, hidden), torch.nn.Tanh(),
                                       torch.nn.Linear(hidden, n_out))

    def forward(self, x):
        return self.net(x)


class QuadraticAgent:
    """Fitness -(||θ - 0.1||²): exact, no env."""

    target = 0.1

    def rollout(self, policy):
        with torch.no_grad():
            vec = torch.nn.utils.parameters_to_vector(policy.parameters())
            reward = -float(((vec - self.target) ** 2).sum())
        self.last_episode_steps = 1
        return reward


class PendulumAgent:
    """A NumPy Pendulum-v1 episode of 30 steps per rollout, the torque
    2·tanh(policy(obs)); each agent draws its initial states from its own
    ``default_rng(0)``.  Observations go to the policy's device."""

    horizon = 30

    def __init__(self):
        self.rng = np.random.default_rng(0)

    def rollout(self, policy):
        device = next(policy.parameters()).device
        th, thdot = self.rng.uniform(-np.pi, np.pi), self.rng.uniform(-1.0, 1.0)
        total = 0.0
        with torch.no_grad():
            for _ in range(self.horizon):
                obs = np.array([np.cos(th), np.sin(th), thdot], np.float32)
                u = float(2.0 * torch.tanh(policy(torch.from_numpy(obs).to(device)))[0])
                total -= ((th + np.pi) % (2 * np.pi) - np.pi) ** 2 + 0.1 * thdot**2 \
                    + 0.001 * u**2
                thdot = np.clip(thdot + (15.0 * np.sin(th) + 3.0 * u) * 0.05, -8.0, 8.0)
                th = th + thdot * 0.05
        self.last_episode_steps = self.horizon
        return total


class BCAgent(QuadraticAgent):
    """Returns (reward, bc), as the reference's novelty agents do."""

    def rollout(self, policy):
        r = super().rollout(policy)
        with torch.no_grad():
            vec = torch.nn.utils.parameters_to_vector(policy.parameters())
        return r, vec[:2].cpu().numpy()


AGENTS = {"quadratic": (QuadraticAgent, {"hidden": 8}),
          "pendulum": (PendulumAgent, {"n_in": 3, "hidden": 8, "n_out": 1})}


def _kw(agent, pop, **extra):
    agent_cls, policy_kwargs = AGENTS[agent]
    kw = dict(population_size=pop, sigma=0.05, seed=0, policy_kwargs=policy_kwargs,
              optimizer_kwargs={"lr": 0.05}, table_size=1 << 16)
    kw.update(extra)
    return agent_cls, kw


def _make(agent="quadratic", pop=32, agent_cls=None, **extra):
    cls, kw = _kw(agent, pop, **extra)
    return ES(TorchMLP, agent_cls or cls, torch.optim.Adam, device="cpu", **kw)


def _pair(agent="quadratic", pop=32, agent_cls=None, **extra):
    cls, kw = _kw(agent, pop, **extra)
    jes = JES(TorchMLP, agent_cls or cls, torch.optim.Adam, telemetry=False, **kw)
    tes = ES(TorchMLP, agent_cls or cls, torch.optim.Adam, device="cpu", **kw)
    return jes, tes


def _params(es) -> np.ndarray:
    p = es.state.params_flat
    return p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


SAMPLINGS = [pytest.param(True, 32, id="mirrored"), pytest.param(False, 32, id="unmirrored"),
             pytest.param(False, 7, id="unmirrored_odd")]


# ----------------------------------------------------------- parity with JAX


@pytest.mark.parametrize("agent", ["quadratic", "pendulum"])
@pytest.mark.parametrize("mirrored,pop", SAMPLINGS)
def test_first_generation_fitness_matches_jax(agent, mirrored, pop):
    """TestHostES::test_backend_detected; the same master, table and θ."""
    jes, tes = _pair(agent, pop, mirrored=mirrored)
    assert tes.backend == jes.backend == "host"
    np.testing.assert_array_equal(_params(tes), _params(jes))
    np.testing.assert_array_equal(tes.engine.table.numpy(), jes.engine.table)
    np.testing.assert_array_equal(tes.engine._pair_offsets(tes.state),
                                  jes.engine._pair_offsets(jes.state))
    jf = jes.engine.evaluate(jes.state).fitness
    tf = tes.engine.evaluate(tes.state).fitness
    np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=0)


@pytest.mark.parametrize("agent", ["quadratic", "pendulum"])
@pytest.mark.parametrize("mirrored,pop", SAMPLINGS)
def test_params_after_three_adam_generations_match_jax(agent, mirrored, pop):
    """TestHostES::test_optimizes_quadratic, TestHostUnmirrored::
    test_odd_population_allowed: three generations, Adam, both packages."""
    jes, tes = _pair(agent, pop, mirrored=mirrored)
    jes.train(3, verbose=False)
    tes.train(3, verbose=False)
    for a, b in zip(tes.history, jes.history):
        assert a["reward_mean"] == pytest.approx(b["reward_mean"], rel=1e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)
        assert a["env_steps"] == b["env_steps"]
    np.testing.assert_allclose(_params(tes), _params(jes), rtol=0, atol=PARAMS_ATOL)
    assert tes.best_reward == pytest.approx(jes.best_reward, rel=1e-6)


def test_member_params_is_the_evaluated_member():
    """TestHostUnmirrored::test_member_theta_matches_evaluated."""
    jes, tes = _pair(pop=8, mirrored=False)
    ev = tes.engine.evaluate(tes.state)
    for i in (0, 3, 7):
        theta = tes.engine.member_params(tes.state, i)
        np.testing.assert_array_equal(theta.numpy(), jes.engine.member_theta(jes.state, i))
        policy = tes.engine.policy_factory()
        load_flat(policy, theta)
        assert QuadraticAgent().rollout(policy) == pytest.approx(float(ev.fitness[i]), rel=1e-6)


def test_n_proc_parallel_matches_serial():
    """TestHostES::test_n_proc_parallel_matches_serial."""
    a = _make()
    a.train(3, n_proc=1, verbose=False)
    b = _make()
    b.train(3, n_proc=4, verbose=False)
    assert b.engine.n_proc == 4 and len(b.engine._workers) == 4
    torch.testing.assert_close(a.state.params_flat, b.state.params_flat, rtol=0, atol=0)


@pytest.mark.parametrize("mirrored", [True, False], ids=["mirrored", "unmirrored"])
def test_process_mode_matches_thread_mode(mirrored):
    """TestProcessWorkers / TestHostUnmirrored::test_process_mode_matches_thread_mode."""
    a = _make(mirrored=mirrored)
    a.train(3, n_proc=2, verbose=False)
    b = _make(mirrored=mirrored, worker_mode="process")
    try:
        b.train(3, n_proc=2, verbose=False)
    finally:
        b.engine.close()
    torch.testing.assert_close(a.state.params_flat, b.state.params_flat, rtol=1e-6, atol=1e-7)


def test_process_mode_pendulum_matches_jax_process_mode():
    """TestProcessWorkers::test_process_mode_matches_thread_mode, across the
    packages: forked workers roll out the same episodes."""
    jes, tes = _pair("pendulum", worker_mode="process")
    try:
        jes.train(2, n_proc=2, verbose=False)
        tes.train(2, n_proc=2, verbose=False)
    finally:
        jes.engine.close()
        tes.engine.close()
    for a, b in zip(tes.history, jes.history):
        assert a["reward_mean"] == pytest.approx(b["reward_mean"], rel=1e-6)
    np.testing.assert_allclose(_params(tes), _params(jes), rtol=0, atol=PARAMS_ATOL)


class _FailsThird(QuadraticAgent):
    def rollout(self, policy):
        self._n = getattr(self, "_n", 0) + 1
        if self._n == 3:
            raise RuntimeError("boom")
        return super().rollout(policy)


def test_raising_member_is_dropped_as_nan():
    """The thread workers' NaN straggler drop, against JAX: the third
    rollout of the one worker raises; its member is NaN and the update
    renormalizes over the survivors."""
    jes, tes = _pair(agent_cls=_FailsThird)
    jes.state, jm = jes.engine.generation_step(jes.state)
    tes.state, tm = tes.engine.generation_step(tes.state)
    assert np.isnan(tm["fitness"][2]) and tm["n_valid"] == jm["n_valid"] == 31
    np.testing.assert_array_equal(np.isnan(tm["fitness"]), np.isnan(jm["fitness"]))
    np.testing.assert_allclose(_params(tes), _params(jes), rtol=0, atol=PARAMS_ATOL)


def test_process_mode_survives_member_exception():
    """TestProcessWorkers::test_process_mode_survives_member_exception."""
    es = _make(agent_cls=_FailsThird, worker_mode="process")
    try:
        es.train(2, n_proc=2, verbose=False)
    finally:
        es.engine.close()
    assert len(es.history) == 2 and es.history[0]["n_failed"] == 2


def test_collapsed_population_leaves_state_untouched():
    class AlwaysFails:
        def rollout(self, policy):
            raise RuntimeError("dead env")

    es = _make(agent_cls=AlwaysFails)
    new, m = es.engine.generation_step(es.state)
    assert new is es.state and m["n_valid"] == 0 and np.isnan(m["grad_norm"])
    with pytest.raises(RuntimeError, match="consecutive generations rejected"):
        es.train(1, verbose=False)


def test_straggler_timeout_nans_slice_without_desync(tmp_path):
    """TestProcessWorkers::test_straggler_timeout_nans_slice_without_desync:
    one worker sleeps past the deadline once; its slice is NaN that
    generation and its late reply is discarded by the next one."""
    flag = str(tmp_path / "slow_claim")
    open(flag, "w").close()

    class SlowOnceAgent(QuadraticAgent):
        def rollout(self, policy):
            import os
            import time

            try:  # an atomic claim: one process sleeps, once
                os.rename(flag, flag + ".claimed")
                time.sleep(1.5)
            except OSError:
                pass
            return super().rollout(policy)

    es = _make(agent_cls=SlowOnceAgent, worker_mode="process", pop=8)
    try:
        es.engine.proc_timeout_s = 0.4
        es.train(1, n_proc=2, verbose=False)
        assert es.history[0]["n_failed"] == 4
        es.engine.proc_timeout_s = 30.0
        ev = es.engine.evaluate(es.state)
        want = [-float(((es.engine.member_params(es.state, i) - 0.1) ** 2).sum())
                for i in range(8)]
        np.testing.assert_allclose(ev.fitness, np.asarray(want, np.float32), rtol=1e-4,
                                   atol=1e-5)
    finally:
        es.engine.close()


def test_sigma_decays_with_floor_and_weight_decay_matches_jax():
    """TestHostSigmaAnnealing::test_sigma_decays_with_floor and
    ::test_record_reports_decaying_sigma, with weight decay, against JAX."""
    jes, tes = _pair(sigma_decay=0.5, sigma_min=0.01, weight_decay=0.01)
    sigmas = [tes.state.sigma]
    for _ in range(4):
        tes.train(1, verbose=False)
        sigmas.append(tes.state.sigma)
    jes.train(4, verbose=False)
    np.testing.assert_allclose(sigmas, [0.05, 0.025, 0.0125, 0.01, 0.01], rtol=1e-6)
    assert [r["sigma"] for r in tes.history] == [r["sigma"] for r in jes.history]
    np.testing.assert_allclose(_params(tes), _params(jes), rtol=0, atol=PARAMS_ATOL)
    plain = _make(sigma_decay=0.5, sigma_min=0.01)
    plain.train(4, verbose=False)
    assert not torch.allclose(plain.state.params_flat, tes.state.params_flat)


def test_optimizer_state_travels_with_the_state():
    """TestHostOptimizerIsolation::test_meta_centers_do_not_share_adam_moments:
    interleaving another center's update changes neither result, and the
    input states stay untouched."""
    es = _make()
    eng = es.engine
    sa = es.state
    sb = eng.init_state(sa.params_flat + 0.3, key=123)
    w = np.linspace(-0.5, 0.5, 32).astype(np.float32)
    a1, _ = eng.apply_weights(sa, w)
    a2, _ = eng.apply_weights(a1, w)
    a1_snapshot = {k: v.clone() for k, v in a1.opt_state["state"][0].items()}
    a1b, _ = eng.apply_weights(sa, w)
    eng.apply_weights(sb, w)
    a2b, _ = eng.apply_weights(a1b, w)
    torch.testing.assert_close(a2.params_flat, a2b.params_flat, rtol=0, atol=0)
    for k, v in a1.opt_state["state"][0].items():
        torch.testing.assert_close(v, a1_snapshot[k], rtol=0, atol=0)
    j = JES(TorchMLP, QuadraticAgent, torch.optim.Adam, telemetry=False, **_kw("quadratic", 32)[1])
    j1, _ = j.engine.apply_weights(j.state, w)
    j2, _ = j.engine.apply_weights(j1, w)
    np.testing.assert_allclose(a2.params_flat.numpy(), j2.params_flat, rtol=0, atol=PARAMS_ATOL)


# ------------------------------------------------------------ VBN, obs norm


class VBNPolicy(torch.nn.Module):
    def __init__(self, vbn_cls=TorchVirtualBatchNorm):
        super().__init__()
        self.l1 = torch.nn.Linear(4, 8)
        self.vbn = vbn_cls(8)
        self.l2 = torch.nn.Linear(8, 2)

    def forward(self, x):
        return self.l2(torch.tanh(self.vbn(self.l1(x))))


class VBNAgent:
    def rollout(self, policy):
        with torch.no_grad():
            out = policy(torch.full((3, 4), 0.5))  # batched: VBN must be frozen already
        self.last_episode_steps = 3
        return -float((out**2).sum())


def test_vbn_freezes_on_first_batch_as_jax():
    """TestHostTorchVBN::test_vbn_freezes_on_first_batch: frozen by the
    first batched forward, the JAX module's values bit for bit."""
    g = torch.Generator().manual_seed(0)
    ref = torch.randn((32, 4), generator=g) * 5 + 2
    later = torch.randn((8, 4), generator=g) * 100
    vbn, jvbn = TorchVirtualBatchNorm(4), JVBN(4)
    out1 = vbn(ref)
    torch.testing.assert_close(out1, jvbn(ref), rtol=0, atol=0)
    mean_after_ref = vbn.ref_mean.clone()
    torch.testing.assert_close(vbn(later), jvbn(later), rtol=0, atol=0)
    torch.testing.assert_close(vbn.ref_mean, mean_after_ref)
    assert abs(float(out1.mean())) < 0.1 and abs(float(out1.var()) - 1.0) < 0.2
    assert [n for n, _ in vbn.named_parameters()] == ["scale", "bias"]  # stats are buffers


def test_vbn_uninitialized_single_obs_raises():
    """TestHostTorchVBN::test_uninitialized_single_obs_raises."""
    with pytest.raises(RuntimeError, match="set_reference"):
        TorchVirtualBatchNorm(4)(torch.randn(4))


def test_freeze_vbn_reaches_thread_and_process_workers():
    """TestProcessWorkers::test_process_workers_carry_master_buffers, and
    the thread workers: workers built (and a fork pool run) before the
    freeze get the master's frozen buffers, and both modes train as the
    JAX package does after its freeze."""
    batch = np.random.default_rng(0).standard_normal((32, 4)).astype(np.float32)
    kw = dict(population_size=8, sigma=0.05, seed=0, optimizer_kwargs={"lr": 1e-2},
              table_size=1 << 12)
    jes = JES(VBNPolicy, VBNAgent, torch.optim.Adam, telemetry=False,
              policy_kwargs={"vbn_cls": JVBN}, **kw)
    jes.engine.freeze_vbn(batch)
    jes.train(2, n_proc=2, verbose=False)
    for mode in ("thread", "process"):
        es = ES(VBNPolicy, VBNAgent, torch.optim.Adam, device="cpu", worker_mode=mode, **kw)
        try:
            es.engine.set_n_proc(2)
            es.engine.evaluate(es.state)  # workers (and the fork pool) before the freeze
            es.engine.freeze_vbn(batch)
            es.train(2, n_proc=2, verbose=False)
        finally:
            es.engine.close()
        assert all(r["n_failed"] == 0 for r in es.history), mode
        for policy, _ in es.engine._workers:
            torch.testing.assert_close(policy.vbn.ref_mean, es.engine.master.vbn.ref_mean)
        torch.testing.assert_close(es.engine.master.vbn.ref_var,
                                   jes.engine.master.vbn.ref_var, rtol=0, atol=0)
        for a, b in zip(es.history, jes.history):
            assert a["reward_mean"] == pytest.approx(b["reward_mean"], rel=1e-6), mode
        np.testing.assert_allclose(_params(es), _params(jes), rtol=0, atol=PARAMS_ATOL)


def test_running_obs_norm_matches_jax():
    """TorchRunningObsNorm, the module the host path's obs_norm error points
    to: the JAX module's stats and outputs after three updates."""
    g = torch.Generator().manual_seed(0)
    norm, jnorm = TorchRunningObsNorm(5, clip=3.0), JRunningObsNorm(5, clip=3.0)
    for n in (7, 1, 40):
        batch = torch.randn((n, 5), generator=g) * 4 + 1
        norm.update(batch)
        jnorm.update(batch)
    norm.update(torch.zeros((0, 5)))
    x = torch.randn((6, 5), generator=g) * 10
    for name in ("count", "mean", "m2"):
        torch.testing.assert_close(getattr(norm, name), getattr(jnorm, name), rtol=0, atol=0)
    torch.testing.assert_close(norm(x), jnorm(x), rtol=0, atol=0)
    assert float(norm(x).abs().max()) <= 3.0
    restored = TorchRunningObsNorm(5, clip=3.0)
    restored.load_state_dict(norm.state_dict())
    torch.testing.assert_close(restored(x), norm(x), rtol=0, atol=0)


# ------------------------------------------------------------------ the ES API


def test_agent_with_gym_env_attribute_routes_to_host():
    """TestHostES::test_agent_with_gym_env_attribute_routes_to_host."""

    class GymStyleAgent(QuadraticAgent):
        def __init__(self):
            self.env = object()  # a gym env: reset/step, no device-env markers

    es = _make(agent_cls=GymStyleAgent)
    assert es.backend == "host"
    es.train(1, verbose=False)
    assert es.history[0]["env_steps"] == 32  # TestHostES::test_env_steps_from_agent_attribute


def test_shared_agent_instance_caps_n_proc():
    """TestHostES::test_shared_agent_instance_caps_n_proc."""
    cls, kw = _kw("quadratic", 32)
    es = ES(TorchMLP, QuadraticAgent(), torch.optim.Adam, device="cpu", **kw)
    with pytest.warns(UserWarning, match="n_proc=1"):
        es.train(1, n_proc=4, verbose=False)
    assert es.engine.n_proc == 1
    classy = _make()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        classy.train(1, n_proc=4, verbose=False)
    assert classy.engine.n_proc == 4


def test_policy_instance_and_bc_agent():
    """A policy instance is deep-copied per worker; a (reward, bc) agent's
    bc comes back per member."""
    policy = TorchMLP(hidden=8)
    es = ES(policy, BCAgent, torch.optim.Adam, device="cpu", population_size=8, sigma=0.05,
            optimizer_kwargs={"lr": 0.05}, table_size=1 << 12)
    ev = es.engine.evaluate(es.state)
    assert ev.bc.shape == (8, 2)
    np.testing.assert_array_equal(ev.bc[3], es.engine.member_params(es.state, 3)[:2].numpy())
    with pytest.raises(ValueError, match="policy_kwargs"):
        ES(policy, BCAgent, torch.optim.Adam, device="cpu", policy_kwargs={"hidden": 8})


def test_best_policy_and_evaluate_policy():
    """TestHostES::test_policy_is_torch_module, ::test_best_policy_params_
    match_best_flat and ::test_evaluate_policy_uses_best_params."""
    jes, es = _pair()
    assert es.best_policy is es.policy  # before any generation: the center
    es.train(5, verbose=False)
    jes.train(5, verbose=False)
    assert isinstance(es.policy, torch.nn.Module) and isinstance(es.best_policy, torch.nn.Module)
    vec = torch.nn.utils.parameters_to_vector(es.best_policy.parameters())
    torch.testing.assert_close(vec, es._best_flat, rtol=0, atol=0)
    center = es.evaluate_policy(n_episodes=2)
    best = es.evaluate_policy(n_episodes=1, use_best=True, return_details=True)
    assert best["mean"] == pytest.approx(es.best_reward, rel=1e-6)
    assert best["mean"] == pytest.approx(jes.evaluate_policy(1, use_best=True)["mean"], rel=1e-5)
    assert center["episodes"] == 2 and best["bc"] is None and best["rewards"].shape == (1,)
    vec = torch.nn.utils.parameters_to_vector(es.policy.parameters())
    torch.testing.assert_close(vec, es.state.params_flat, rtol=0, atol=0)
    for name in ("policy_variables", "best_policy_variables"):
        with pytest.raises(AttributeError, match="device-path only"):
            getattr(es, name)


DEVICE_ONLY = [("shard_params", True), ("compute_dtype", "bfloat16"),
               ("episodes_per_member", 2), ("decomposed", True), ("noise_kernel", True),
               ("streamed", True), ("low_rank", 1), ("obs_norm", True), ("scenarios", object())]


@pytest.mark.parametrize("option,value", DEVICE_ONLY, ids=[o for o, _ in DEVICE_ONLY])
def test_device_only_options_raise_on_host(option, value):
    """The JAX package's ValueErrors for device-path options on a host agent."""
    cls, kw = _kw("quadratic", 8)
    kw[option] = value
    if option != "scenarios":  # JAX type-checks scenarios before the dispatch
        with pytest.raises(ValueError, match=f"{option} is a device"):
            JES(TorchMLP, cls, torch.optim.Adam, telemetry=False, **kw)
    with pytest.raises(ValueError, match=f"{option} is a device"):
        ES(TorchMLP, cls, torch.optim.Adam, device="cpu", **kw)


def test_worker_mode_is_validated():
    """TestProcessWorkers::test_worker_mode_rejected_on_device_path, and a
    bad mode on the host path."""
    with pytest.raises(ValueError, match="worker_mode"):
        ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, device="cpu",
           population_size=16, policy_kwargs={"action_dim": 1, "discrete": False},
           optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 14,
           worker_mode="process")
    with pytest.raises(ValueError, match="worker_mode must be"):
        _make(worker_mode="fiber")


def test_es_signature_matches_jax():
    """F1: every parameter of the JAX ES.__init__ has one of the same name
    and default in the port's, and the port has none the JAX package lacks."""
    jp = inspect.signature(JES.__init__).parameters
    tp = inspect.signature(ES.__init__).parameters
    assert list(tp) == list(jp)
    for name, p in jp.items():
        assert tp[name].default == p.default, name


@pytest.mark.parametrize("option,value,item", [
    ("telemetry", True, "6"), ("model_shards", 2, "7"), ("partition_rules", [], "7"),
    ("noise_mode", "program", "7")])
def test_stub_keywords_raise_naming_their_item(option, value, item):
    """F1: a keyword whose item is not ported raises naming it; its default
    (and telemetry=False) does nothing on every backend."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, port queue item: {item}"):
        _make(**{option: value})
    with pytest.raises(NotImplementedError, match=f"item: {item}"):
        ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=5), adam, device="cpu",
           policy_kwargs={"action_dim": 1, "discrete": False}, table_size=1 << 14,
           optimizer_kwargs={"learning_rate": 1e-2}, **{option: value})
    default = inspect.signature(ES.__init__).parameters[option].default
    assert _make(**{option: default}).backend == "host"
    if option == "telemetry":
        assert _make(telemetry=False).backend == "host"


def test_host_engine_alone():
    """HostEngine without ES: an immutable state through apply_grad, and
    σ = 0 honoured (None is the sentinel for the initial σ)."""
    torch.manual_seed(0)
    eng = HostEngine(lambda: TorchMLP(hidden=4), QuadraticAgent, torch.optim.SGD,
                     {"lr": 0.1}, population_size=4, sigma=0.1, table_size=1 << 10, seed=3,
                     device="cpu")
    st = eng.init_state()
    before = st.params_flat.clone()
    new, gnorm = eng.apply_grad(st, torch.ones(eng.dim))
    torch.testing.assert_close(st.params_flat, before, rtol=0, atol=0)
    torch.testing.assert_close(new.params_flat, before + 0.1, rtol=0, atol=1e-7)
    assert gnorm == pytest.approx(eng.dim**0.5) and new.generation == 1
    zero = HostState(st.params_flat, None, 3, 0, sigma=0.0)
    torch.testing.assert_close(eng.member_params(zero, 1), st.params_flat, rtol=0, atol=0)
    eng.close()
