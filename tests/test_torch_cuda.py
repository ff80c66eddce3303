"""The port's CUDA kernels on a card, against their plain versions, and the
ES paths on the card against the same paths on the CPU.

Every test here needs a CUDA card and nvcc and skips without them.  The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the kernels sum in another order than the plain versions'
gather + matmul, in float32.
"""

import numpy as np
import pytest
import torch

import estorch_tpu_torch.ops.noise_kernels as nk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def table(cuda):
    g = torch.Generator().manual_seed(0)
    return torch.randn(1 << 20, generator=g).to(cuda)


@pytest.mark.parametrize("n,dim", [(1, 8), (7, 33), (64, 128), (65, 257), (2048, 4481)])
def test_weighted_noise_sum_matches_plain(table, cuda, n, dim):
    rng = np.random.default_rng(n + dim)
    offs = torch.from_numpy(rng.integers(0, table.numel() - dim + 1, n).astype(np.int32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    before = nk.launch_counts["weighted_noise_sum"]
    got = nk.weighted_noise_sum(table, offs, w, dim)
    torch.cuda.synchronize()
    assert nk.launch_counts["weighted_noise_sum"] == before + 1
    want = nk.weighted_noise_sum_plain(table, offs, w, dim)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_weighted_noise_sum_empty_is_zero(table, cuda):
    got = nk.weighted_noise_sum(table, torch.zeros(0, dtype=torch.int32, device=cuda),
                                torch.zeros(0, device=cuda), 16)
    assert torch.equal(got, torch.zeros(16, device=cuda))


def _matvec_offsets(rng, kind, n, size, length):
    """int32 member offsets: each its own slice ("random"), mirrored pairs
    sharing one ("mirrored"), or starts that need the clamp ("clamp":
    negative, counted from the end or past it, and past size - length)."""
    if kind == "random":
        offs = rng.integers(0, size - length - 64, n)
    elif kind == "mirrored":
        offs = np.repeat(rng.integers(0, size - length - 64, (n + 1) // 2), 2)[:n]
    else:
        offs = rng.choice(np.array([-7, -length, -size - 100, 3, size - length - 31,
                                    size - length + 5, size + 99]), n)
    return torch.from_numpy(offs.astype(np.int32))


# the first eight keep the ids they had before the offset kinds came in
MATVEC_CASES = [pytest.param(n, d, h, "random", id=f"{n}-{d}-{h}")
                for n, d, h in [(4, 8, 16), (6, 17, 5), (16, 32, 32), (3, 64, 7),
                                (4096, 3, 64), (4096, 64, 64), (4096, 64, 1), (5, 300, 200)]]
MATVEC_CASES += [pytest.param(n, d, h, kind, id=f"{n}-{d}-{h}-{kind}") for n, d, h, kind in [
    # the main path's layers (Pendulum, CartPole head) with mirrored offsets
    (4096, 3, 64, "mirrored"), (4096, 64, 64, "mirrored"), (4096, 64, 1, "mirrored"),
    (4096, 64, 2, "mirrored"),
    (7, 64, 64, "mirrored"), (7, 64, 1, "mirrored"),  # odd n: the last member is alone
    # both sides of the narrow/wide threshold, both pair paths
    (64, 16, 31, "mirrored"), (64, 16, 31, "random"), (64, 16, 32, "mirrored"),
    (64, 16, 32, "random"), (64, 16, 33, "mirrored"), (64, 16, 33, "random"),
    (4096, 256, 256, "mirrored"),
    (9, 600, 48, "random"),  # d > 256: x staged in shared memory in chunks
    (64, 64, 64, "clamp"), (64, 64, 1, "clamp"), (63, 3, 64, "clamp"),
    # the env paths' layers: Cheetah2D and Humanoid2D MLP 64x64 at pop 1024
    # (their heads take the narrow mapping), SyntheticEnv MLP 256x256
    (1024, 17, 64, "mirrored"), (1024, 64, 6, "mirrored"), (1024, 25, 64, "mirrored"),
    (1024, 64, 10, "mirrored"), (4096, 376, 256, "mirrored"), (4096, 256, 17, "mirrored"),
]]


@pytest.mark.parametrize("n,d,h,kind", MATVEC_CASES)
def test_population_noise_matvec_matches_plain(table, cuda, n, d, h, kind):
    rng = np.random.default_rng(n + 10 * d + 100 * h)
    offs = _matvec_offsets(rng, kind, n, table.numel(), d * h)
    c = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    offs, c, x = offs.to(cuda), c.to(cuda), x.to(cuda)
    got = nk.population_noise_matvec(table, offs, c, x, 32, d, h)
    torch.cuda.synchronize()
    want = nk.population_noise_matvec_plain(table, offs, c, x, 32, d, h)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,d,h,kind", [(4096, 64, 64, "mirrored"), (4096, 64, 1, "mirrored"),
                                        (33, 600, 48, "random"), (63, 16, 5, "clamp")])
def test_population_noise_matvec_is_bitwise_deterministic(table, cuda, n, d, h, kind):
    """Each output is summed in one fixed order: no atomics."""
    rng = np.random.default_rng(7 * n + d + h)
    offs = _matvec_offsets(rng, kind, n, table.numel(), d * h).to(cuda)
    c = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    first = nk.population_noise_matvec(table, offs, c, x, 32, d, h)
    second = nk.population_noise_matvec(table, offs, c, x, 32, d, h)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_wrapper_raises_when_library_is_absent(table, cuda, monkeypatch):
    """No quiet fallback to the plain version on a CUDA tensor."""
    from estorch_tpu_torch.ops import _build

    def absent():
        raise RuntimeError("kernel library absent")

    monkeypatch.setattr(_build, "load_library", absent)
    with pytest.raises(RuntimeError, match="absent"):
        nk.weighted_noise_sum(table, torch.zeros(2, dtype=torch.int32, device=cuda),
                              torch.ones(2, device=cuda), 8)
    with pytest.raises(RuntimeError, match="absent"):
        nk.population_noise_matvec(table, torch.zeros(2, dtype=torch.int32, device=cuda),
                                   torch.ones(2, device=cuda), torch.ones(2, 4, device=cuda),
                                   0, 4, 3)


def test_wrapper_checks_inputs(table, cuda):
    with pytest.raises(TypeError, match="int32"):
        nk.weighted_noise_sum(table, torch.zeros(2, dtype=torch.int64, device=cuda),
                              torch.ones(2, device=cuda), 8)
    with pytest.raises(ValueError, match="on cpu"):
        nk.population_noise_matvec(table, torch.zeros(2, dtype=torch.int32),
                                   torch.ones(2, device=cuda), torch.ones(2, 4, device=cuda),
                                   0, 4, 3)


# the ES paths of chip_smoke.py's phase 5: options, and whether they launch
# the update kernel and the matvec kernel
ES_PATHS = {
    "a_standard": ({}, False, False),
    "b_standard_kernel_update": ({"noise_kernel": True}, True, False),
    "c_decomposed_bf16_kernel_update":
        ({"decomposed": True, "compute_dtype": "bfloat16", "noise_kernel": True}, True, False),
    "d_low_rank_bf16": ({"low_rank": 1, "compute_dtype": "bfloat16"}, False, False),
    "e_obs_norm_streamed": ({"obs_norm": True, "streamed": True, "noise_kernel": True},
                            True, True),
}


@pytest.mark.parametrize("path", list(ES_PATHS))
def test_es_path_on_card_matches_cpu(cuda, path):
    """Two generations, Pendulum MLP64x64, population 64, horizon 50, on the
    card and on the CPU (plain versions).  float32: reward means within 1e-4
    relative, params within 1e-4.  bf16, at tests/test_torch_paths.py's
    tolerance: SGD, reward means within 1e-3 relative, the param changes'
    cosine >= 0.99."""
    from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, Pendulum, adam, sgd

    opts, update_kernel, matvec_kernel = ES_PATHS[path]
    bf16 = opts.get("compute_dtype") == "bfloat16"
    kw = dict(population_size=64, sigma=0.05, table_size=1 << 22,
              policy_kwargs={"action_dim": 1, "hidden": (64, 64), "discrete": False,
                             "action_scale": 2.0},
              optimizer_kwargs={"learning_rate": 1e-2}, **opts)
    card = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=50), sgd if bf16 else adam,
              device=cuda, **kw)
    cpu = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=50), sgd if bf16 else adam,
             device="cpu", **kw)
    p0 = cpu.state.params_flat.clone()
    nk.reset_launch_counts()
    card.train(2, verbose=False)
    assert nk.launch_counts == {"weighted_noise_sum": 2 if update_kernel else 0,
                                "population_noise_matvec": 300 if matvec_kernel else 0}
    cpu.train(2, verbose=False)
    want = np.array([r["reward_mean"] for r in cpu.history])
    got = np.array([r["reward_mean"] for r in card.history])
    np.testing.assert_allclose(got, want, rtol=1e-3 if bf16 else 1e-4)
    p_card = card.state.params_flat.cpu()
    if bf16:
        dg, dc = p_card - p0, cpu.state.params_flat - p0
        assert float(dg @ dc / (dg.norm() * dc.norm())) >= 0.99
    else:
        torch.testing.assert_close(p_card, cpu.state.params_flat, rtol=0, atol=1e-4)


@pytest.mark.parametrize("path", ["a_standard", "c_decomposed_bf16_kernel_update",
                                  "d_low_rank_bf16", "e_obs_norm_streamed"])
def test_eval_chunk_matches_whole_population_on_card(cuda, path):
    """At the main path's width, chunks of 1024 members against the whole
    population, one generation at horizon 20.  Not bit for bit, as on the
    CPU: cuBLAS picks its batched-GEMV kernel by the batch count and its
    GEMV kernel by the row count, so a member's sums can run in another
    order (chip_smoke.py phase 6 shows which).  Tolerance: float32
    rounding, grown over 20 env steps — fitness within 1e-3 relative,
    params within 1e-5 after the first Adam step."""
    from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, Pendulum, adam

    kw = dict(population_size=4096, sigma=0.05, table_size=1 << 22, device=cuda,
              policy_kwargs={"action_dim": 1, "hidden": (64, 64), "discrete": False,
                             "action_scale": 2.0},
              optimizer_kwargs={"learning_rate": 1e-2}, **ES_PATHS[path][0])
    whole = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, **kw)
    chunked = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, eval_chunk=1024, **kw)
    assert chunked.engine.eval_chunk == 1024
    new_w, mw = whole.engine.generation_step(whole.state)
    new_c, mc = chunked.engine.generation_step(chunked.state)
    torch.testing.assert_close(mc["fitness"], mw["fitness"], rtol=1e-3, atol=0)
    torch.testing.assert_close(new_c.params_flat, new_w.params_flat, rtol=0, atol=1e-5)


# ------------------------------------------------------------------ the envs

ENVS = ["Acrobot", "MountainCar", "MountainCarContinuous", "SyntheticEnv", "RecallEnv",
        "Swimmer2D", "Hopper2D", "Walker2D", "Humanoid2D", "Cheetah2D", "PositionOnly",
        "DeceptiveValley"]


def _env(name):
    import estorch_tpu_torch.envs as tenvs

    if name == "PositionOnly":
        return tenvs.PositionOnly(tenvs.Walker2D())
    if name == "DeceptiveValley":
        return tenvs.DeceptiveValley(tenvs.Hopper2D(), x_bait=0.002, x_valley=0.01)
    return getattr(tenvs, name)()


def _actions(env, rng, n):
    if env.discrete:
        return torch.from_numpy(rng.integers(0, env.action_dim, n))
    return torch.from_numpy(rng.uniform(-1, 1, (n, env.action_dim)).astype(np.float32))


# atol of the 20-step comparison at rtol 1e-5: the card's roundings of
# sin, cos, tanh and of its sums, grown by the planar physics' chaos
TWENTY_STEP_ATOL = {"Acrobot": 1e-5, "MountainCar": 1e-6, "MountainCarContinuous": 1e-6,
                    "SyntheticEnv": 1e-6, "RecallEnv": 1e-6}
PLANAR_TWENTY_STEP_ATOL = 5e-2


@pytest.mark.parametrize("name", ENVS)
def test_env_on_card_matches_cpu(cuda, name):
    """One step and 20 steps of 64 members, on the card and on the CPU, from
    the same reset states and actions, each side on its own trajectory
    (members that terminate are frozen, as the rollout freezes them).  The
    first step within rtol 1e-5 and atol 5e-5 on the state, 1e-5 on obs and
    reward; the next 19 within rtol 1e-5 and the atol above; the done flags
    equal.  Prints the largest error of each."""
    env = _env(name)
    n = 64
    states, obs = env.reset(torch.Generator().manual_seed(3), n)
    torch.testing.assert_close(env.observe(states.to(cuda)).cpu(), obs, rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(3)
    st_cpu, st_card = states, states.to(cuda)
    done = torch.zeros(n, dtype=torch.bool)
    excess = {0: 0.0, 1: 0.0}  # the largest |err| − 1e-5·|want|, first step and the rest
    atol20 = TWENTY_STEP_ATOL.get(name, PLANAR_TWENTY_STEP_ATOL)
    faults = []
    for i in range(20):
        a = _actions(env, rng, n)
        out_cpu = env.step(st_cpu, a)
        out_card = [t.cpu() for t in env.step(st_card, a.to(cuda))]
        alive = ~done
        for k, (got, want) in enumerate(zip(out_card[:3], out_cpu[:3])):
            err = float(((got - want).abs() - 1e-5 * want.abs())[alive].max())
            bound = (5e-5 if k == 0 else 1e-5) if i == 0 else atol20
            excess[min(i, 1)] = max(excess[min(i, 1)], err)
            if err > bound:
                faults.append(f"step {i}, {('state', 'obs', 'reward')[k]} {err:g}")
        if not torch.equal(out_card[3][alive], out_cpu[3][alive]):
            faults.append(f"step {i}, done flags differ")
        keep = alive[:, None]
        st_cpu = torch.where(keep, out_cpu[0], st_cpu)
        st_card = torch.where(keep.to(cuda), out_card[0].to(cuda), st_card)
        done |= out_cpu[3]
    print(f"{name}: card vs CPU, |err| - 1e-5|want| at most {excess[0]:.3g} after one step, "
          f"{excess[1]:.3g} over 20 (atol {atol20:g}); {int(done.sum())} of {n} terminated")
    assert not faults, f"{name}: {faults}"


def test_humanoid_generation_is_bitwise_repeatable_on_card(cuda):
    """The physics adds its joint forces in a fixed order with no atomics,
    so a re-run of a Humanoid2D generation gives the same bits, as
    ``ES.train``'s re-run of a rejected generation promises."""
    from estorch_tpu_torch import ES, DeviceAgent, Humanoid2D, MLPPolicy, adam

    es = ES(MLPPolicy, DeviceAgent(Humanoid2D(), horizon=50), adam, population_size=512,
            sigma=0.08, device=cuda, table_size=1 << 22, obs_norm=True,
            policy_kwargs={"action_dim": 10, "hidden": (64, 64), "discrete": False},
            optimizer_kwargs={"learning_rate": 2e-2})
    s0 = es.state
    s1, m1 = es.engine.generation_step(s0)
    s2, m2 = es.engine.generation_step(s0)
    assert torch.equal(m1["fitness"], m2["fitness"])
    assert torch.equal(s1.params_flat, s2.params_flat)
    assert all(torch.equal(a, b) for a, b in zip(s1.obs_stats, s2.obs_stats))
    assert int(m1["steps"]) < 512 * 50  # members fell: the done mask ran


# ------------------------------------------------------------ the pooled path


@pytest.mark.parametrize("double_buffer", [False, True], ids=["sync", "double_buffer"])
def test_pooled_pendulum_on_card_matches_cpu(cuda, double_buffer):
    """Pooled Pendulum, population 32, horizon 60, two generations with the
    kernel update, on the card and on the CPU from the same pools: reward
    means within 1e-4 relative, the update direction's cosine >= 0.999
    (SGD).  With ``double_buffer`` the actions come back through the
    pinned buffers and CUDA events."""
    from estorch_tpu_torch import ES, MLPPolicy, PooledAgent, sgd

    kw = dict(population_size=32, sigma=0.05, table_size=1 << 20, noise_kernel=True,
              policy_kwargs={"action_dim": 1, "hidden": (64, 64), "discrete": False,
                             "action_scale": 2.0},
              optimizer_kwargs={"learning_rate": 1e-2})
    agent = PooledAgent("pendulum", horizon=60, double_buffer=double_buffer)
    card = ES(MLPPolicy, agent, sgd, device=cuda, **kw)
    cpu = ES(MLPPolicy, agent, sgd, device="cpu", **kw)
    p0 = cpu.state.params_flat.clone()
    nk.reset_launch_counts()
    card.train(2, verbose=False)
    assert nk.launch_counts == {"weighted_noise_sum": 2, "population_noise_matvec": 0}
    cpu.train(2, verbose=False)
    np.testing.assert_allclose([r["reward_mean"] for r in card.history],
                               [r["reward_mean"] for r in cpu.history], rtol=1e-4)
    dg, dc = card.state.params_flat.cpu() - p0, cpu.state.params_flat - p0
    assert float(dg @ dc / (dg.norm() * dc.norm())) >= 0.999


def test_naturecnn_population_forward_on_card_matches_cpu(cuda):
    """The grouped-conv NatureCNN forward with VBN, population 4, on the
    card (TF32 off, as ``resolve_device`` sets it) and on the CPU: logits
    within 1e-4 of their scale."""
    from estorch_tpu_torch import NatureCNN, resolve_device
    from estorch_tpu_torch.envs.rollout import population_forward
    from estorch_tpu_torch.models import capture_reference_stats
    from estorch_tpu_torch.ops.params import make_param_spec

    resolve_device(cuda)
    g = torch.Generator().manual_seed(0)
    module = NatureCNN(3)
    params = module.init_params((84, 84, 4), g)
    flat, spec = make_param_spec(params)
    ref = (torch.rand((32, 84, 84, 4), generator=g) < 0.05).float()
    module.vbn_stats = capture_reference_stats(module, params, ref)
    thetas = flat + 0.02 * torch.randn((4, spec.dim), generator=g)
    obs = (torch.rand((4, 84 * 84 * 4), generator=g) < 0.05).float()
    want = population_forward(module, spec.unravel(thetas))(obs)
    module.vbn_stats = {k: {n: v.to(cuda) for n, v in s.items()}
                        for k, s in module.vbn_stats.items()}
    got = population_forward(module, spec.unravel(thetas.to(cuda)))(obs.to(cuda)).cpu()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


# -------------------------------------------------------------- the host path


def test_weighted_noise_sum_at_the_host_shape(cuda):
    """The host path's update: 500 pair rows of dim 4737 (the 64x64 VBN
    policy on Pendulum) from its NumPy-built 2^25-float table, at the
    SeedSequence offsets the engine draws."""
    size, n, dim = 1 << 25, 500, 4737
    table = torch.from_numpy(np.random.default_rng(0).standard_normal(size, dtype=np.float32))
    rng = np.random.default_rng(np.random.SeedSequence(entropy=0, spawn_key=(0,)))
    offs = torch.from_numpy(rng.integers(0, size - dim + 1, n).astype(np.int32))
    w = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
    want = nk.weighted_noise_sum_plain(table, offs, w, dim)
    before = nk.launch_counts["weighted_noise_sum"]
    got = nk.weighted_noise_sum(table.to(cuda), offs.to(cuda), w.to(cuda), dim)
    assert nk.launch_counts["weighted_noise_sum"] == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)


class _VBNMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        from estorch_tpu_torch.models import TorchVirtualBatchNorm

        self.net = torch.nn.Sequential(
            torch.nn.Linear(3, 32), TorchVirtualBatchNorm(32), torch.nn.Tanh(),
            torch.nn.Linear(32, 1))

    def forward(self, x):
        return self.net(x)


class _PendulumAgent:
    """A NumPy Pendulum episode of 40 steps; observations go to the
    policy's device, the torque 2·tanh(output) comes back as a float."""

    def __init__(self):
        self.rng = np.random.default_rng(0)

    def rollout(self, policy):
        device = next(policy.parameters()).device
        th, thdot = self.rng.uniform(-np.pi, np.pi), self.rng.uniform(-1.0, 1.0)
        total = 0.0
        with torch.no_grad():
            for _ in range(40):
                obs = np.array([np.cos(th), np.sin(th), thdot], np.float32)
                u = float(2.0 * torch.tanh(policy(torch.from_numpy(obs).to(device)))[0])
                total -= ((th + np.pi) % (2 * np.pi) - np.pi) ** 2 + 0.1 * thdot**2 \
                    + 0.001 * u**2
                thdot = np.clip(thdot + (15.0 * np.sin(th) + 3.0 * u) * 0.05, -8.0, 8.0)
                th = th + thdot * 0.05
        self.last_episode_steps = 40
        return total


def _host_es(device, **over):
    from estorch_tpu_torch import ES

    kw = dict(population_size=16, sigma=0.05, seed=0, table_size=1 << 20,
              optimizer_kwargs={"lr": 1e-2})
    kw.update(over)
    es = ES(_VBNMLP, _PendulumAgent, torch.optim.Adam, device=device, **kw)
    es.engine.freeze_vbn(np.random.default_rng(1).standard_normal((64, 3)).astype(np.float32))
    return es


def test_host_generation_on_card_matches_cpu(cuda):
    """Two host-path generations (4 threads) with the table, center,
    policies, optimizer and the reduction kernel on the card, against the
    CPU: fitness within 1e-4 relative, the update's cosine >= 0.999, one
    kernel launch a generation."""
    card, cpu = _host_es(cuda), _host_es("cpu")
    assert card.engine.table.device.type == "cuda"
    assert next(card.engine.master.parameters()).device.type == "cuda"
    p0 = cpu.state.params_flat.clone()
    nk.reset_launch_counts()
    card.train(2, n_proc=4, verbose=False)
    assert nk.launch_counts == {"weighted_noise_sum": 2, "population_noise_matvec": 0}
    cpu.train(2, n_proc=4, verbose=False)
    np.testing.assert_allclose([r["reward_mean"] for r in card.history],
                               [r["reward_mean"] for r in cpu.history], rtol=1e-4)
    dg, dc = card.state.params_flat.cpu() - p0, cpu.state.params_flat - p0
    assert float(dg @ dc / (dg.norm() * dc.norm())) >= 0.999
    card.engine.close()
    cpu.engine.close()


def test_host_process_mode_after_cuda_init(cuda):
    """Forked workers beside a live CUDA context: they roll out on the CPU
    from CPU copies of the table, center and VBN buffers, and give the CPU
    thread workers' fitness; the update then runs on the card."""
    proc, thr = _host_es(cuda, worker_mode="process"), _host_es("cpu")
    torch.cuda.synchronize()
    try:
        proc.engine.set_n_proc(2)
        thr.engine.set_n_proc(2)
        got = proc.engine.evaluate(proc.state).fitness
        want = thr.engine.evaluate(thr.state).fitness
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        proc.train(1, n_proc=2, verbose=False)
        assert proc.history[0]["n_failed"] == 0
        assert proc.state.params_flat.device.type == "cuda"
    finally:
        proc.engine.close()
        thr.engine.close()


@pytest.mark.parametrize("name", ["CartPole", "Pendulum"])
def test_gym_adapter_on_card_matches_cpu(cuda, name):
    """``GymFromDeviceEnv`` steps on the card by default; from the same
    injected state and actions it gives the CPU adapter's observations,
    rewards and flags (30 steps, truncation at 25)."""
    pytest.importorskip("gymnasium")
    import estorch_tpu_torch.envs as tenvs
    from estorch_tpu_torch.envs.gym_adapter import GymFromDeviceEnv

    env = getattr(tenvs, name)()
    card, cpu = GymFromDeviceEnv(env, max_steps=25), GymFromDeviceEnv(env, max_steps=25,
                                                                      device="cpu")
    obs, _ = card.reset(seed=3)
    assert card._state.device.type == "cuda" and obs.dtype == np.float32
    states, _ = env.reset(torch.Generator().manual_seed(3), 1)
    card._state, cpu._state = states.to(cuda), states
    rng = np.random.default_rng(0)
    for t in range(30):
        a = (int(rng.integers(0, 2)) if env.discrete
             else rng.uniform(-1, 1, env.action_dim).astype(np.float32))
        go, gr, gd, gt, _ = card.step(a)
        wo, wr, wd, wt, _ = cpu.step(a)
        np.testing.assert_allclose(go, wo, rtol=1e-5, atol=1e-5, err_msg=f"{name} step {t}")
        assert gr == pytest.approx(wr, rel=1e-5, abs=1e-5)
        assert (gd, gt) == (wd, wt) and gt == (t + 1 >= 25)


# ------------------------------------------- recurrent policies and device VBN

# chip_smoke.py phase 10's device paths at a small size: policy, policy
# kwargs, ES options (each runs the update kernel but (o), the tree form)
RECURRENT_PATHS = {
    "n_gru_kernel_update": ("RecurrentPolicy", {}, {"noise_kernel": True}),
    "o_gru_low_rank_tree": ("RecurrentPolicy", {}, {"low_rank": 1}),
    "p_lstm_stacked_learned_bf16": ("RecurrentPolicy",
                                    {"cell": "lstm", "n_layers": 2, "learned_carry": True},
                                    {"noise_kernel": True, "compute_dtype": "bfloat16"}),
    "q_mlp_vbn_kernel_update": ("MLPPolicy", {"hidden": (64, 64), "use_vbn": True},
                                {"noise_kernel": True}),
}


@pytest.mark.parametrize("path", list(RECURRENT_PATHS))
def test_recurrent_path_on_card_matches_cpu(cuda, path):
    """Two generations on Pendulum, population 64, horizon 50, on the card
    and on the CPU, with the update kernel's launches exact.  float32:
    reward means within 1e-4 relative, params within 1e-4 (as the MLP
    paths); bf16: SGD, reward means within 1e-3 relative, the param
    changes' cosine >= 0.99.  The VBN statistics come from the same
    reference batch (a CPU generator) on both."""
    import estorch_tpu_torch as tt

    name, pk, opts = RECURRENT_PATHS[path]
    bf16 = opts.get("compute_dtype") == "bfloat16"
    kw = dict(population_size=64, sigma=0.05, table_size=1 << 22,
              policy_kwargs={"action_dim": 1, "discrete": False, "action_scale": 2.0, **pk},
              optimizer_kwargs={"learning_rate": 1e-2}, **opts)
    opt = tt.sgd if bf16 else tt.adam
    card = tt.ES(getattr(tt, name), tt.DeviceAgent(tt.Pendulum(), horizon=50), opt, device=cuda,
                 **kw)
    cpu = tt.ES(getattr(tt, name), tt.DeviceAgent(tt.Pendulum(), horizon=50), opt, device="cpu",
                **kw)
    p0 = cpu.state.params_flat.clone()
    nk.reset_launch_counts()
    card.train(2, verbose=False)
    assert nk.launch_counts == {"weighted_noise_sum": 2 if opts.get("noise_kernel") else 0,
                                "population_noise_matvec": 0}
    cpu.train(2, verbose=False)
    np.testing.assert_allclose([r["reward_mean"] for r in card.history],
                               [r["reward_mean"] for r in cpu.history],
                               rtol=1e-3 if bf16 else 1e-4)
    p_card = card.state.params_flat.cpu()
    if bf16:
        dg, dc = p_card - p0, cpu.state.params_flat - p0
        assert float(dg @ dc / (dg.norm() * dc.norm())) >= 0.99
    else:
        torch.testing.assert_close(p_card, cpu.state.params_flat, rtol=0, atol=1e-4)


def test_pooled_recurrent_on_card_matches_cpu(cuda):
    """(r) at a small size: RecurrentPolicy (GRU 64) on pooled Pendulum,
    population 32, horizon 60, two generations with the kernel update, the
    stacked carry on the card: reward means within 1e-4 relative, the
    update's cosine >= 0.999 (SGD)."""
    from estorch_tpu_torch import ES, PooledAgent, RecurrentPolicy, sgd

    kw = dict(population_size=32, sigma=0.05, table_size=1 << 20, noise_kernel=True,
              policy_kwargs={"action_dim": 1, "discrete": False, "action_scale": 2.0},
              optimizer_kwargs={"learning_rate": 1e-2})
    agent = PooledAgent("pendulum", horizon=60)
    card = ES(RecurrentPolicy, agent, sgd, device=cuda, **kw)
    cpu = ES(RecurrentPolicy, agent, sgd, device="cpu", **kw)
    p0 = cpu.state.params_flat.clone()
    nk.reset_launch_counts()
    card.train(2, verbose=False)
    assert nk.launch_counts == {"weighted_noise_sum": 2, "population_noise_matvec": 0}
    cpu.train(2, verbose=False)
    np.testing.assert_allclose([r["reward_mean"] for r in card.history],
                               [r["reward_mean"] for r in cpu.history], rtol=1e-4)
    dg, dc = card.state.params_flat.cpu() - p0, cpu.state.params_flat - p0
    assert float(dg @ dc / (dg.norm() * dc.norm())) >= 0.999
    card.engine.close()
    cpu.engine.close()


def test_recurrent_nature_cnn_forward_on_card_matches_cpu(cuda):
    """RecurrentNatureCNN (GRU 256) population forward, population 4, two
    steps with the carry, card (TF32 off) against CPU: logits within 1e-4
    of their scale, carries within 1e-4."""
    from estorch_tpu_torch import RecurrentNatureCNN, resolve_device
    from estorch_tpu_torch.envs.rollout import population_forward
    from estorch_tpu_torch.ops.params import make_param_spec

    resolve_device(cuda)
    g = torch.Generator().manual_seed(0)
    module = RecurrentNatureCNN(3)
    flat, spec = make_param_spec(module.init_params((84, 84, 4), g))
    thetas = flat + 0.02 * torch.randn((4, spec.dim), generator=g)
    obs = [(torch.rand((4, 84 * 84 * 4), generator=g) < 0.05).float() for _ in range(2)]
    fwd_cpu = population_forward(module, spec.unravel(thetas))
    fwd_card = population_forward(module, spec.unravel(thetas.to(cuda)))
    h_cpu, h_card = torch.zeros(4, 256), torch.zeros(4, 256, device=cuda)
    for x in obs:
        want, h_cpu = fwd_cpu(x, h_cpu)
        got, h_card = fwd_card(x.to(cuda), h_card)
        assert float((got.cpu() - want).abs().max() / want.abs().max()) <= 1e-4
        torch.testing.assert_close(h_card.cpu(), h_cpu, rtol=0, atol=1e-4)


def test_weighted_noise_sum_at_the_recurrent_shape(cuda):
    """The recurrent paths' update: 2048 pair rows of dim 25,153
    (RecurrentPolicy's defaults on Pendulum), a 2^25-float table."""
    g = torch.Generator().manual_seed(7)
    big = torch.randn(1 << 25, generator=g)
    n, dim = 2048, 25_153
    offs = torch.randint(0, big.numel() - dim + 1, (n,), generator=g, dtype=torch.int32)
    w = torch.rand(n, generator=g) * 2 - 1
    want = nk.weighted_noise_sum_plain(big, offs, w, dim)
    before = nk.launch_counts["weighted_noise_sum"]
    got = nk.weighted_noise_sum(big.to(cuda), offs.to(cuda), w.to(cuda), dim)
    assert nk.launch_counts["weighted_noise_sum"] == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)
