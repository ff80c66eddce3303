"""The port's CUDA kernels on a card, against their plain versions, and the
ES paths on the card against the same paths on the CPU.

Every test here needs a CUDA card and nvcc and skips without them.  The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the kernels sum in another order than the plain versions'
gather + matmul, in float32.
"""

import json
import os

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


@pytest.mark.parametrize("n,dim", [(64, 128), (2048, 4481), (1000, 4737)])
def test_weighted_noise_sum_equals_plain_bit_for_bit(table, cuda, n, dim):
    # both sum in float64 and round once: the same float32 vector
    rng = np.random.default_rng(7 * n + dim)
    offs = torch.from_numpy(rng.integers(0, table.numel() - dim + 1, n).astype(np.int32)).to(cuda)
    w = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(cuda)
    got = nk.weighted_noise_sum(table, offs, w, dim)
    assert torch.equal(got.cpu(), nk.weighted_noise_sum_plain(table.cpu(), offs.cpu(), w.cpu(), dim))


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


# ------------------------------------------------- novelty family and IW-ES


def _pendulum_es(cls, device, **over):
    from estorch_tpu_torch import DeviceAgent, MLPPolicy, Pendulum, adam

    kw = dict(population_size=64, sigma=0.05, table_size=1 << 22,
              policy_kwargs={"action_dim": 1, "hidden": (64, 64), "discrete": False,
                             "action_scale": 2.0},
              optimizer_kwargs={"learning_rate": 1e-2})
    kw.update(over)
    return cls(MLPPolicy, DeviceAgent(Pendulum(), horizon=50), adam, device=device, **kw)


def test_split_path_on_card_matches_cpu(cuda):
    """``evaluate`` then ``apply_weights`` with host-made weights, streamed
    forward and kernel update (both kernels: 3 matvec launches an env step,
    1 reduction), Pendulum MLP64x64, population 64, horizon 50: fitness and
    BC within 1e-4 relative, params within 1e-5, on the card against the
    CPU's plain versions."""
    from estorch_tpu_torch import ES

    card = _pendulum_es(ES, cuda, streamed=True, noise_kernel=True)
    cpu = _pendulum_es(ES, "cpu", streamed=True, noise_kernel=True)
    nk.reset_launch_counts()
    ev_card = card.engine.evaluate(card.state)
    ev_cpu = cpu.engine.evaluate(cpu.state)
    torch.testing.assert_close(ev_card.fitness.cpu(), ev_cpu.fitness, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ev_card.bc.cpu(), ev_cpu.bc, rtol=1e-4, atol=1e-4)
    assert int(ev_card.steps) == int(ev_cpu.steps)
    w = torch.from_numpy(np.random.default_rng(0).uniform(-0.5, 0.5, 64).astype(np.float32))
    new_card, g_card = card.engine.apply_weights(card.state, w.to(cuda))
    new_cpu, g_cpu = cpu.engine.apply_weights(cpu.state, w)
    assert nk.launch_counts == {"weighted_noise_sum": 1, "population_noise_matvec": 150}
    torch.testing.assert_close(new_card.params_flat.cpu(), new_cpu.params_flat, rtol=0,
                               atol=1e-5)
    assert abs(float(g_card) - float(g_cpu)) <= 1e-4 * float(g_cpu)


def test_apply_weights_reuse_on_card_matches_cpu(cuda):
    """IW-ES's reductions on the card: ``noise_stats`` (within 1e-5
    relative) and ``apply_weights_reuse`` over two old generations (params
    within 1e-6 after one Adam step, the update norm within 1e-5)."""
    from estorch_tpu_torch import ES

    card, cpu = _pendulum_es(ES, cuda), _pendulum_es(ES, "cpu")
    rng = np.random.default_rng(1)
    dim = cpu.spec.dim
    offs = torch.from_numpy(rng.integers(0, (1 << 22) - dim, 64).astype(np.int32))
    d = torch.from_numpy((rng.normal(size=(2, dim)) * 0.1).astype(np.float32))
    for got, want in zip(card.engine.noise_stats(offs.to(cuda), d[0].to(cuda)),
                         cpu.engine.noise_stats(offs, d[0])):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    w = torch.from_numpy(rng.uniform(-0.5, 0.5, 64).astype(np.float32))
    old_w = torch.from_numpy((rng.random(64) * 0.01).astype(np.float32))
    coeff = torch.tensor([0.003, 0.001])
    new_card, g_card = card.engine.apply_weights_reuse(
        card.state, w.to(cuda), offs.to(cuda), old_w.to(cuda), d.to(cuda), coeff.to(cuda))
    new_cpu, g_cpu = cpu.engine.apply_weights_reuse(cpu.state, w, offs, old_w, d, coeff)
    torch.testing.assert_close(new_card.params_flat.cpu(), new_cpu.params_flat, rtol=0,
                               atol=1e-6)
    assert abs(float(g_card) - float(g_cpu)) <= 1e-5 * float(g_cpu)


def test_nsr_es_on_card_matches_cpu(cuda):
    """NSR-ES (M 3, k 10) streamed with the kernel update, population 64,
    horizon 50, 3 generations on the card and on the CPU: the meta indices
    equal, reward means within 1e-4 relative, every center's params within
    1e-4, the archive within 1e-3."""
    from estorch_tpu_torch import NSR_ES

    card = _pendulum_es(NSR_ES, cuda, streamed=True, noise_kernel=True, meta_population_size=3)
    cpu = _pendulum_es(NSR_ES, "cpu", streamed=True, noise_kernel=True, meta_population_size=3)
    card.train(3, verbose=False)
    cpu.train(3, verbose=False)
    assert [r["meta_index"] for r in card.history] == [r["meta_index"] for r in cpu.history]
    np.testing.assert_allclose([r["reward_mean"] for r in card.history],
                               [r["reward_mean"] for r in cpu.history], rtol=1e-4)
    for a, b in zip(card.meta_states, cpu.meta_states):
        torch.testing.assert_close(a.params_flat.cpu(), b.params_flat, rtol=0, atol=1e-4)
    np.testing.assert_allclose(card.archive.bcs, cpu.archive.bcs, rtol=1e-3, atol=1e-3)


# ------------------------------------------------------- barrier-free generations


def test_fold_on_card_matches_cpu(cuda):
    """A fold run's event log (4 thread workers on the CPU, a straggler
    folded late) replayed on the card and on the CPU: each update one
    reduction launch on the card, the params within 1e-6 of their largest
    entry, the async blocks equal."""
    import json
    import os

    from estorch_tpu_torch.resilience import chaos

    os.environ[chaos.CHAOS_ENV] = json.dumps({"events": [
        {"kind": "straggler", "gen": 1, "member": 5, "sleep_s": 0.3}]})
    chaos.reset_cache()
    try:
        live = _host_es("cpu")
        live.train_async(4, n_proc=4, verbose=False)
    finally:
        os.environ.pop(chaos.CHAOS_ENV)
        chaos.reset_cache()
    log = json.loads(json.dumps(live.async_event_log.to_dict()))
    assert sum(r["async"]["folded"] for r in live.history) > 0
    card, cpu = _host_es(cuda), _host_es("cpu")
    nk.reset_launch_counts()
    card.train_async(4, replay=log, verbose=False)
    assert nk.launch_counts == {"weighted_noise_sum": 4, "population_noise_matvec": 0}
    cpu.train_async(4, replay=log, verbose=False)
    got, want = card.state.params_flat.cpu(), cpu.state.params_flat
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    for a, b in zip(card.history, cpu.history):
        assert {k: v for k, v in a["async"].items() if k != "mean_lambda"} == \
            {k: v for k, v in b["async"].items() if k != "mean_lambda"}
        assert a["async"]["mean_lambda"] == pytest.approx(b["async"]["mean_lambda"], abs=1e-4)


def test_fold_replay_is_bitwise_its_live_run_on_card(cuda):
    """A live fold run on the card (4 thread workers, their policies on the
    card) and two replays of its log on the card: the same params bit for
    bit."""
    live = _host_es(cuda)
    live.train_async(4, n_proc=4, verbose=False)
    log = live.async_event_log.to_dict()
    for _ in range(2):
        again = _host_es(cuda)
        again.train_async(4, replay=log, verbose=False)
        assert torch.equal(again.state.params_flat, live.state.params_flat)


def test_overlap_is_bitwise_train_on_card(cuda):
    """The streamed Pendulum path with the kernel update: 3 generations of
    train and of the overlap scheduler give the same params bit for bit,
    with the same kernel launches."""
    from estorch_tpu_torch import ES

    def make():
        return _pendulum_es(ES, cuda, streamed=True, noise_kernel=True)

    sync, ov = make(), make()
    nk.reset_launch_counts()
    sync.train(3, verbose=False)
    want = dict(nk.launch_counts)
    nk.reset_launch_counts()
    ov.train_async(3, verbose=False)
    assert nk.launch_counts == want == {"weighted_noise_sum": 3, "population_noise_matvec": 450}
    assert torch.equal(sync.state.params_flat, ov.state.params_flat)
    assert [r["reward_mean"] for r in sync.history] == [r["reward_mean"] for r in ov.history]


def _streamed_cartpole(device):
    from estorch_tpu_torch import ES, CartPole, DeviceAgent, MLPPolicy, adam

    return ES(MLPPolicy, DeviceAgent(CartPole(), horizon=100), adam, device=device,
              population_size=256, sigma=0.1, seed=3, table_size=1 << 20,
              policy_kwargs={"action_dim": 2, "hidden": (32, 32)},
              optimizer_kwargs={"learning_rate": 1e-2}, streamed=True, noise_kernel=True)


def _states_equal_on_cpu(a, b) -> bool:
    return (torch.equal(a.params_flat.cpu(), b.params_flat.cpu())
            and torch.equal(a.opt_state.mu.cpu(), b.opt_state.mu.cpu())
            and torch.equal(a.opt_state.nu.cpu(), b.opt_state.nu.cpu())
            and a.opt_state.count == b.opt_state.count and a.generation == b.generation
            and torch.equal(a.sigma.cpu(), b.sigma.cpu()))


def test_checkpoint_resume_is_bitwise_on_card(cuda, tmp_path):
    """A streamed CartPole run (both kernels) checkpointed at generation 2,
    restored into a fresh object on the card and continued 2 generations:
    the uninterrupted run's params bit for bit, through the kernels (3
    matvec launches an env step, 1 reduction a generation)."""
    from estorch_tpu_torch.utils import restore_checkpoint, save_checkpoint

    ref = _streamed_cartpole(cuda)
    ref.train(4, verbose=False)
    a = _streamed_cartpole(cuda)
    a.train(2, verbose=False)
    save_checkpoint(a, str(tmp_path / "ck"))
    b = _streamed_cartpole(cuda)
    restore_checkpoint(b, str(tmp_path / "ck"))
    assert b.state.params_flat.device.type == "cuda" and _states_equal_on_cpu(b.state, a.state)
    nk.reset_launch_counts()
    b.train(2, verbose=False)
    assert nk.launch_counts["weighted_noise_sum"] == 2
    assert nk.launch_counts["population_noise_matvec"] % 3 == 0
    assert nk.launch_counts["population_noise_matvec"] > 0
    assert torch.equal(b.state.params_flat, ref.state.params_flat)
    assert [r["reward_mean"] for r in b.history] == [r["reward_mean"] for r in ref.history]


def test_async_save_on_card_holds_the_state_at_the_call(cuda, tmp_path):
    """An async save taken between generations, with training going on
    before it is waited for: the checkpoint holds the state at the call."""
    from estorch_tpu_torch.utils import restore_checkpoint, save_checkpoint

    es = _streamed_cartpole(cuda)
    es.train(2, verbose=False)
    at_call = es.state
    handle = save_checkpoint(es, str(tmp_path / "ck"), asynchronous=True)
    es.train(3, verbose=False)
    handle.wait()
    b = _streamed_cartpole(cuda)
    restore_checkpoint(b, str(tmp_path / "ck"))
    assert b.generation == 2 and _states_equal_on_cpu(b.state, at_call)
    assert not torch.equal(es.state.params_flat, at_call.params_flat)


@pytest.mark.parametrize("src,dst", [("cpu", "cuda"), ("cuda", "cpu")])
def test_checkpoint_crosses_devices(cuda, tmp_path, src, dst):
    """A checkpoint from the CPU restores on the card and one from the card
    on the CPU: the same state bit for bit, on the restoring ES's device."""
    from estorch_tpu_torch.utils import restore_checkpoint, save_checkpoint

    a = _streamed_cartpole(src)
    a.train(2, verbose=False)
    save_checkpoint(a, str(tmp_path / "ck"))
    b = _streamed_cartpole(dst)
    restore_checkpoint(b, str(tmp_path / "ck"))
    assert b.state.params_flat.device.type == dst and b.state.opt_state.mu.device.type == dst
    assert _states_equal_on_cpu(b.state, a.state)
    b.train(1, verbose=False)
    assert b.generation == 3


def test_noise_kernels_load_is_the_first_records_compile_event(cuda, tmp_path):
    """In a fresh process the streamed ES's first generation loads the
    kernels' library: that record carries the ``noise_kernels`` compile
    event (``cached`` set, the library's name), ``compile_time_s`` is its
    seconds, and the first record carries the cost model."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {repo!r})\n"
        "from estorch_tpu_torch import ES, CartPole, DeviceAgent, MLPPolicy, adam\n"
        "es = ES(MLPPolicy, DeviceAgent(CartPole(), horizon=20), adam, device='cuda',\n"
        "        population_size=64, table_size=1 << 20, telemetry=True, streamed=True,\n"
        "        noise_kernel=True, policy_kwargs={'action_dim': 2, 'hidden': (32, 32)},\n"
        "        optimizer_kwargs={'learning_rate': 1e-2})\n"
        "es.train(2, verbose=False)\n"
        "print(json.dumps({'ev': [r.get('compile_events') for r in es.history],\n"
        "                  'cm': 'cost_model' in es.history[0], 'cs': es.compile_time_s}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path, env=dict(os.environ, ESTORCH_OBS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    (ev,), second = got["ev"]
    assert second is None and got["cm"]
    assert ev["program"] == "noise_kernels" and isinstance(ev["cached"], bool)
    assert ev["library"].startswith("libestorch_noise_kernels-") and ev["generation"] == 0
    assert abs(got["cs"] - ev["compile_s"]) < 1e-6


def test_trace_names_both_kernels(cuda, tmp_path):
    """One streamed generation with the kernel update under
    ``obs.trace.trace``: the Chrome trace holds 3 matvec launches an env
    step and one reduction, by the kernels' names."""
    import json

    from estorch_tpu_torch.obs.trace import trace

    es = _streamed_cartpole(cuda)
    es.train(1, verbose=False)
    nk.reset_launch_counts()
    with trace(str(tmp_path / "tr")):
        es.train(1, verbose=False)
    (path,) = list((tmp_path / "tr").glob("*.pt.trace.json"))
    kernels = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    assert sum("weighted_sum_partials" in k for k in kernels) == 1
    assert sum("noise_matvec" in k for k in kernels) == nk.launch_counts[
        "population_noise_matvec"] > 0
    assert nk.launch_counts["weighted_noise_sum"] == 1


def _serving_es(cuda):
    from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, Pendulum, adam

    es = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), adam, population_size=16,
            sigma=0.05, table_size=1 << 14, obs_norm=True, telemetry=False,
            policy_kwargs={"action_dim": 1, "hidden": (24, 24), "discrete": False,
                           "action_scale": 2.0},
            optimizer_kwargs={"learning_rate": 1e-2})
    assert es.device.type == "cuda"
    es.train(1, verbose=False)
    return es


def test_load_bundle_defaults_to_the_card(cuda, tmp_path):
    """``load_bundle`` with no device puts every tensor on the card, and
    its predict is ES.predict's bits, one observation and a batch."""
    from estorch_tpu_torch.serve import load_bundle

    es = _serving_es(cuda)
    b = load_bundle(es.export_bundle(str(tmp_path / "b")))
    assert b.device.type == "cuda"
    assert all(t.device.type == "cuda" for t in b.obs_stats)
    assert b.params["head"]["kernel"].device.type == "cuda"
    rng = np.random.default_rng(0)
    for obs in (rng.standard_normal(3), rng.standard_normal((16, 3))):
        obs = obs.astype(np.float32)
        got = b.predict(obs)
        assert got.device.type == "cuda"
        assert got.cpu().numpy().tobytes() == es.predict(obs).cpu().numpy().tobytes()


def test_server_on_the_card_answers_as_es_predict(cuda, tmp_path):
    """A server on the card (the default device) answers 16 distinct
    observations, coalesced into mixed buckets, with ES.predict's bits on
    the anchor batch, and a lone request as row 0 of a padded anchor."""
    from estorch_tpu_torch.obs.spans import Telemetry
    from estorch_tpu_torch.serve import PolicyServer, ServeClient
    from estorch_tpu_torch.serve.loadgen import run_load

    es = _serving_es(cuda)
    srv = PolicyServer(es.export_bundle(str(tmp_path / "b")), port=0, max_batch=16,
                       max_wait_ms=2.0, telemetry=Telemetry(enabled=True))
    srv.start_background()
    try:
        rng = np.random.default_rng(1)
        anchor = rng.standard_normal((16, 3)).astype(np.float32)
        ref = es.predict(anchor).cpu().numpy()
        res = run_load(f"{srv.host}:{srv.port}", conns=4, total=16, duration_s=60.0,
                       obs_list=[o.tolist() for o in anchor], collect_responses=True)
        assert res["errors"] == 0 and res["shed"] == 0
        got = np.asarray([r["action"] for r in res["responses"]], np.float32)
        assert got.tobytes() == ref.tobytes()
        with ServeClient(f"{srv.host}:{srv.port}") as c:
            one = np.asarray(c.predict(anchor[3]), np.float32)
            stats = c.stats()
        pad = np.zeros((max(stats["buckets"]), 3), np.float32)
        pad[0] = anchor[3]
        assert one.tobytes() == es.predict(pad).cpu().numpy()[0].tobytes()
        assert stats["device"]["platform"] == "gpu"
        assert stats["cold_start"]["compiles_at_load"] == 0
    finally:
        srv.shutdown(drain=True)


def test_fleet_replicas_on_the_card_answer_bit_equal(cuda, tmp_path):
    """Two replica processes on the card (``serve.device`` defaults to
    ``cuda``), each with its own CUDA context, behind the router: 16
    distinct observations through the router and through each replica
    alone answer with ES.predict's bits on the anchor batch."""
    from estorch_tpu_torch.serve.fleet import Fleet
    from estorch_tpu_torch.serve.loadgen import run_load

    es = _serving_es(cuda)
    fleet = Fleet({"schema": 1, "bundle": es.export_bundle(str(tmp_path / "b")),
                   "replicas": 2, "serve": {"max_batch": 16}}, str(tmp_path / "run"), port=0)
    fleet.start()
    try:
        assert fleet.wait_ready(300), fleet.status()
        rng = np.random.default_rng(2)
        anchor = rng.standard_normal((16, 3)).astype(np.float32)
        ref = es.predict(anchor).cpu().numpy()
        addrs = [f"{fleet.router.host}:{fleet.router.port}"] + [s.address for s in fleet.slots]
        for addr in addrs:
            res = run_load(addr, conns=4, total=16, duration_s=60.0,
                           obs_list=[o.tolist() for o in anchor], collect_responses=True)
            assert res["errors"] == 0 and res["shed"] == 0
            got = np.asarray([r["action"] for r in res["responses"]], np.float32)
            assert got.tobytes() == ref.tobytes(), addr
        for slot in fleet.slots:
            assert slot.cold_start["compiles_at_load"] == 0
            with open(slot.log_path) as f:
                ready = json.loads(f.readline())
            assert ready["device"]["platform"] == "gpu" and ready["memory"]["reserved_mib"] > 0
    finally:
        final = fleet.shutdown()
    assert final["clean"], final


def test_fleet_start_fails_without_a_card(tmp_path):
    """Where there is no card, a fleet whose replicas serve on ``cuda`` (the
    default) fails its start with exit 2: each replica refuses once, none
    is respawned, and none comes back on the CPU."""
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, Pendulum, adam

    es = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=10), adam, population_size=8,
            policy_kwargs={"action_dim": 1, "hidden": (8,), "discrete": False},
            optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 12, seed=0,
            device="cpu", telemetry=False)
    cfg = tmp_path / "fleet.json"
    cfg.write_text(json.dumps({"schema": 1, "bundle": es.export_bundle(str(tmp_path / "b")),
                               "replicas": 2, "respawn": {"backoff_s": 0.1}}))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "estorch_tpu_torch.serve", "route", "--fleet",
                        str(cfg), "--port", "0", "--workdir", str(tmp_path / "run")],
                       capture_output=True, text=True, timeout=180, cwd=repo)
    assert r.returncode == 2, (r.stdout[-2000:], r.stderr[-2000:])
    assert "refused to start (exit 2)" in r.stderr and "cuda" in r.stderr
    for i in range(2):
        log = (tmp_path / "run" / f"r{i}.log").read_text()
        assert '"ready"' not in log and log.count("serve:") <= 1, log


# --------------------------------------------------------------- scenarios

SCENARIO_FAMILIES = ["Pendulum", "CartPole", "Acrobot", "MountainCar", "MountainCarContinuous",
                     "Hopper2D", "Walker2D", "Humanoid2D", "Cheetah2D", "Swimmer2D"]


@pytest.mark.parametrize("name", SCENARIO_FAMILIES)
def test_step_p_on_card_matches_cpu(cuda, name):
    """One env step of 64 members, each under its own draw in ±30 % of every
    declared constant, on the card and on the CPU from the same states and
    actions: within rtol 1e-5 and the first step's atol of
    ``test_env_on_card_matches_cpu`` (5e-5 on the state, 1e-5 on obs and
    reward); done flags equal."""
    from estorch_tpu_torch.scenarios import ScenarioParams

    env = _env(name)
    n = 64
    states, _ = env.reset(torch.Generator().manual_seed(5), n)
    rng = np.random.default_rng(5)
    draw = {k: torch.from_numpy(rng.uniform(0.7 * v, 1.3 * v, n).astype(np.float32))
            for k, v in env.scenario_defaults().items()}
    a = _actions(env, rng, n)
    out_cpu = env.step_p(ScenarioParams(draw), states, a)
    out_card = [t.cpu() for t in env.step_p(ScenarioParams({k: v.to(cuda) for k, v in
                                                            draw.items()}),
                                            states.to(cuda), a.to(cuda))]
    for k, (got, want) in enumerate(zip(out_card[:3], out_cpu[:3])):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=5e-5 if k == 0 else 1e-5)
    assert torch.equal(out_card[3], out_cpu[3])


def _scenario_es(device, n_variants=10, obs_noise=0.05, optimizer=None, **over):
    from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, Pendulum, adam
    from estorch_tpu_torch.scenarios import default_distribution

    kw = dict(population_size=64, sigma=0.05, table_size=1 << 16, telemetry=False,
              streamed=True, noise_kernel=True,
              scenarios=default_distribution(Pendulum(), n_variants=n_variants, spread=0.3,
                                             obs_noise=obs_noise, seed=1),
              policy_kwargs={"action_dim": 1, "hidden": (16, 16), "discrete": False,
                             "action_scale": 2.0})
    kw.update(over)
    if optimizer is None:
        optimizer, kw["optimizer_kwargs"] = adam, {"learning_rate": 1e-2}
    return ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), optimizer, device=device, **kw)


def _card_kernel_launches(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA")
               and not e.name().startswith(("Memcpy", "Memset")))


def test_scenario_launches_do_not_depend_on_the_variant_count(cuda):
    """One engine generation's kernel launches on the card at n_variants 1,
    10 and 1000: equal, with 3 matvec launches an env step and 1 reduction."""
    counts = []
    for nv in (1, 10, 1000):
        es = _scenario_es(cuda, n_variants=nv)
        es.train(1, verbose=False)
        nk.reset_launch_counts()
        counts.append(_card_kernel_launches(lambda es=es: es.engine.generation_step(es.state)))
        assert dict(nk.launch_counts) == {"population_noise_matvec": 60, "weighted_noise_sum": 1}
    assert counts[0] == counts[1] == counts[2] > 0


def test_scenario_generation_on_card_matches_cpu(cuda):
    """Two randomized generations with observation noise (streamed + kernel
    update) on the card and on the CPU: the same variants, reward means
    within 1e-4 relative and params within 1e-4 (phase 4's float32 bound)."""
    es_card, es_cpu = _scenario_es(cuda), _scenario_es("cpu")
    es_card.train(2, verbose=False)
    es_cpu.train(2, verbose=False)
    for a, b in zip(es_card.history, es_cpu.history):
        assert a["scenarios"]["counts"] == b["scenarios"]["counts"]
        assert abs(a["reward_mean"] - b["reward_mean"]) <= 1e-4 * abs(b["reward_mean"])
    torch.testing.assert_close(es_card.state.params_flat.cpu(), es_cpu.state.params_flat,
                               rtol=0, atol=1e-4)


def test_pbt_replay_is_bitwise_its_live_run_on_card(cuda):
    from estorch_tpu_torch.scenarios import PBTController, tunable_optimizer

    def build():
        return _scenario_es(cuda, optimizer=tunable_optimizer(learning_rate=1e-2))

    es = build()
    log = PBTController(es, n_centers=3, explore_every=1, seed=3).run(3, verbose=False)
    es2 = build()
    PBTController(es2, n_centers=3, explore_every=1, seed=3).run(3, verbose=False, replay=log)
    for a, b in zip(es.meta_states, es2.meta_states):
        assert torch.equal(a.params_flat, b.params_flat)
        assert a.opt_state.hyperparams["learning_rate"].device.type == "cuda"
