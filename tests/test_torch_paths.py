"""Every path of the port's engine against the JAX engine, generation by
generation.

Both sides start from the JAX side's params and noise table and take the
JAX side's draws each generation — offsets, each row's reset states (all e
of them with ``episodes_per_member``), the obs-norm probe states and the
warm-up states — handed over as numpy, as ``tests/test_torch_es.py`` does
for the streamed path.  The JAX engine runs on a one-device mesh.
"""

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
from estorch_tpu.parallel import population_mesh
from estorch_tpu.parallel.engine import _gen_keys
from estorch_tpu_torch import ES, CartPole, DeviceAgent, MLPPolicy, Pendulum, adam, interop, sgd
from estorch_tpu_torch.parallel import Sample

PENDULUM_POLICY = {"action_dim": 1, "hidden": (8, 8), "discrete": False, "action_scale": 2.0}


def _pendulum_kwargs(**over):
    common = dict(population_size=16, sigma=0.05, seed=0, policy_kwargs=PENDULUM_POLICY,
                  optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16)
    common.update(over)
    return common


def _torch_pendulum(topt=adam, **over):
    return ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=20), topt, device="cpu",
              **_pendulum_kwargs(**over))


def _pendulum_pair(jopt=optax.adam, topt=adam, **over):
    jes = JES(JMLPPolicy, JaxAgent(jenvs.Pendulum(), horizon=20), jopt,
              mesh=population_mesh(jax.devices()[:1]), telemetry=False,
              **_pendulum_kwargs(**over))
    return jes, _torch_pendulum(topt, **over)


def _cartpole_pair(**over):
    """The tier-1 golden recipe (tests/test_goldens.py ``_run``)."""
    common = dict(population_size=16, sigma=0.1, seed=7,
                  policy_kwargs={"action_dim": 2, "hidden": (8,)},
                  optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 15, **over)
    jes = JES(JMLPPolicy, JaxAgent(jenvs.CartPole(), horizon=50), optax.adam,
              mesh=population_mesh(jax.devices()[:1]), telemetry=False, **common)
    tes = ES(MLPPolicy, DeviceAgent(CartPole(), horizon=50), adam, device="cpu", **common)
    return jes, tes


def _resets(env, keys):
    """Initial states of ``env.reset`` over keys of any leading shape."""
    flat = keys.reshape((-1,) + keys.shape[-1:])
    states, _ = jax.vmap(env.reset)(flat)
    return np.array(states).reshape(keys.shape[:-1] + states.shape[1:])


def _fold_keys(base, n):
    return jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(n))


def _adopt(jes, tes):
    """Hand the JAX side's table and initial params to the port, running the
    port's own obs-norm warm-up on the JAX side's warm-up states."""
    tes.engine.table = interop.table_from_numpy(np.asarray(jes.table.data))
    flat, _ = interop.params_from_jax(np.asarray(jes.state.params_flat), tes.spec)
    warm = None
    if jes.config.obs_warmup_episodes:
        base = jax.random.fold_in(jes.state.key, 2**31 - 3)
        warm = torch.from_numpy(
            _resets(jes.env, _fold_keys(base, jes.config.obs_warmup_episodes)))
    tes.state = tes.engine.init_state(flat, seed=0, warmup_states=warm)
    if jes.config.obs_norm:
        _check_obs_stats(tes.state.obs_stats, jes.state.obs_stats, "init")


def _jax_sample(jes, jstate) -> Sample:
    """This generation's draws of the JAX engine, in the port's layout."""
    cfg = jes.config
    _, rkey = _gen_keys(jstate)
    rows = cfg.population_size // 2 if cfg.mirrored else cfg.population_size
    keys = jax.random.split(rkey, rows)
    if cfg.episodes_per_member > 1:
        keys = jax.vmap(lambda k: jax.random.split(k, cfg.episodes_per_member))(keys)
    probe = None
    if cfg.obs_norm:
        base = jax.random.fold_in(rkey, 2**31 - 2)
        probe = torch.from_numpy(_resets(jes.env, _fold_keys(base, cfg.obs_probe_episodes)))
    offsets = np.array(jes.engine.all_pair_offsets(jstate))
    return Sample(torch.from_numpy(offsets), torch.from_numpy(_resets(jes.env, keys)), probe)


def _check_obs_stats(got, want, what):
    # the count sums alive steps: exact.  The moments are float32 sums of
    # observations that the two forwards reach within ~1e-6 of each other
    assert float(got[0]) == float(want[0]), what
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-5,
                               err_msg=what)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4, atol=1e-5,
                               err_msg=what)


def _step_both(jes, tes):
    jstate = jes.state
    sample = _jax_sample(jes, jstate)
    jes.state, jm = jes.engine.generation_step(jstate)
    tes.state, tm = tes.engine.generation_step(tes.state, sample)
    return jstate, jm, tm


PATH_CASES = {
    # the default forward; the plain update in chunks of 4 pair rows
    "standard_chunked": {"grad_chunk": 4},
    "standard_kernel": {"noise_kernel": True},
    "unmirrored": {"mirrored": False},
    "decomposed": {"decomposed": True},
    "low_rank_1": {"low_rank": 1},  # (3, 8) and (8, 8) factor, the head is dense
    "low_rank_4": {"low_rank": 4},  # every layer falls back to dense noise
    "obs_norm": {"obs_norm": True, "obs_warmup_episodes": 2},
    "obs_norm_streamed": {"obs_norm": True, "obs_warmup_episodes": 2, "streamed": True,
                          "noise_kernel": True},
    "episodes_2": {"episodes_per_member": 2},
    "eval_chunk_4": {"eval_chunk": 4},
}


@pytest.mark.parametrize("over", list(PATH_CASES.values()), ids=list(PATH_CASES))
def test_three_generation_trajectory_matches_jax(over):
    """Pendulum, MLP (8, 8), pop 16, horizon 20, 3 generations.

    Tolerance: float32 products and sums taken in another order by XLA and
    torch, compounded over 20 env steps and 3 Adam steps — rtol 1e-4 on
    fitness, atol 2e-5 on params (Adam moves each param ≈ lr = 1e-2 a step),
    rtol 1e-4 on the update norm.
    """
    jes, tes = _pendulum_pair(**over)
    _adopt(jes, tes)
    for gen in range(3):
        _, jm, tm = _step_both(jes, tes)
        np.testing.assert_allclose(tm["fitness"].numpy(), np.asarray(jm["fitness"]),
                                   rtol=1e-4, atol=1e-3, err_msg=f"gen {gen}")
        np.testing.assert_allclose(tm["bc"].numpy(), np.asarray(jm["bc"]), rtol=1e-4,
                                   atol=1e-4, err_msg=f"gen {gen}")
        assert int(tm["n_valid"]) == int(jm["n_valid"]) == 16
        assert int(tm["steps"]) == int(jm["steps"])
        np.testing.assert_allclose(tes.state.params_flat.numpy(),
                                   np.asarray(jes.state.params_flat),
                                   rtol=0, atol=2e-5, err_msg=f"gen {gen}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        if over.get("obs_norm"):
            _check_obs_stats(tes.state.obs_stats, jes.state.obs_stats, f"gen {gen}")
    assert tes.state.generation == 3


@pytest.mark.parametrize("over", [
    {"episodes_per_member": 2}, {"decomposed": True, "compute_dtype": "bfloat16"},
    {"low_rank": 1}, {"obs_norm": True, "streamed": True, "noise_kernel": True},
], ids=["standard_episodes_2", "decomposed_bf16", "low_rank_1", "obs_norm_streamed"])
def test_eval_chunk_is_bit_identical_to_the_whole_population(over):
    """Chunks change how many members one product covers, not what each
    member computes."""
    whole = _torch_pendulum(**over)
    chunked = _torch_pendulum(eval_chunk=6, **over)  # → chunks of 4
    assert chunked.engine.eval_chunk == 4
    for _ in range(2):
        whole.state, mw = whole.engine.generation_step(whole.state)
        chunked.state, mc = chunked.engine.generation_step(chunked.state)
        assert torch.equal(mw["fitness"], mc["fitness"])
        assert torch.equal(whole.state.params_flat, chunked.state.params_flat)


GOLDEN_CASES = {
    "ES": {},
    "ES_decomposed": {"decomposed": True},
    "ES_obsnorm": {"obs_norm": True},
    "ES_lowrank": {"low_rank": 1},
}


@pytest.mark.parametrize("over", list(GOLDEN_CASES.values()), ids=list(GOLDEN_CASES))
def test_cartpole_golden_recipe_matches_jax(over):
    """The tier-1 golden recipes (CartPole, MLP (8,), pop 16, σ 0.1, seed 7,
    horizon 50, 3 generations) against the JAX run of the same recipe.
    CartPole's returns count alive steps, so equal actions give equal
    returns: the reward means and the obs-norm count must be equal exactly.
    """
    jes, tes = _cartpole_pair(**over)
    _adopt(jes, tes)
    for gen in range(3):
        _, jm, tm = _step_both(jes, tes)
        np.testing.assert_array_equal(tm["fitness"].numpy(), np.asarray(jm["fitness"]),
                                      err_msg=f"gen {gen}")
        assert float(tm["fitness"].mean()) == float(np.mean(np.asarray(jm["fitness"])))
        np.testing.assert_allclose(tes.state.params_flat.numpy(),
                                   np.asarray(jes.state.params_flat), rtol=0, atol=2e-5)
    if over.get("obs_norm"):
        _check_obs_stats(tes.state.obs_stats, jes.state.obs_stats, "final")


@pytest.mark.parametrize("over", [{}, {"decomposed": True}, {"low_rank": 1}],
                         ids=["standard", "decomposed", "low_rank_1"])
def test_bf16_generation_matches_jax(over):
    """compute_dtype="bfloat16": the member params, the shared tree, the
    noise, c = σ·s and the (normalized) obs are cast to bf16 where the JAX
    engine casts them, and the output returns to float32.  Cast anywhere
    else, a member's return moves by a bf16 ulp (≈ 0.4 %).  One generation
    with SGD, so the param change is the ascent direction itself.

    Tolerance, set from measurement (``-s`` prints it): the three paths
    agree with JAX to under 1e-6 relative on fitness and a cosine of
    1.00000; rtol 1e-3 leaves room for a few bf16 roundings that land the
    other way after a float32 sum in another order, each of which moves one
    member's return by 1e-4 to 1e-3.  The ascent directions' cosine must be
    ≥ 0.99.
    """
    jes, tes = _pendulum_pair(jopt=optax.sgd, topt=sgd, compute_dtype="bfloat16", **over)
    _adopt(jes, tes)
    jstate, jm, tm = _step_both(jes, tes)
    jf, tf = np.asarray(jm["fitness"]), tm["fitness"].numpy()
    jd = np.asarray(jes.state.params_flat) - np.asarray(jstate.params_flat)
    td = tes.state.params_flat.numpy() - np.asarray(jstate.params_flat)
    cos = float(jd @ td / (np.linalg.norm(jd) * np.linalg.norm(td)))
    print(f"bf16 {over}: fitness max rel err {np.max(np.abs(tf - jf) / np.abs(jf)):.3g}, "
          f"ascent cosine {cos:.6f}")
    np.testing.assert_allclose(tf, jf, rtol=1e-3)
    assert cos >= 0.99, cos
