"""The port's NatureCNN and VirtualBatchNorm against flax, and the pooled
``pong84`` path against the JAX package's.

Params cross from flax through ``interop`` (conv kernels in HWIO, the
tree in ``ravel_pytree``'s order), the frozen statistics through
``interop.vbn_stats_from_jax``.  Tolerances: logits 1e-5 (float32
convolutions summed in another order: oneDNN here, XLA's Eigen there;
measured under 1e-6); VBN statistics as stated in their test (JAX's
float32 variance over 51,200 positions is itself 1e-4 of its scale off
float64, the port's 3e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from estorch_tpu import ES as JES
from estorch_tpu import NatureCNN as JNatureCNN
from estorch_tpu import PooledAgent as JPooledAgent
from estorch_tpu.models import capture_reference_stats as jcapture
from estorch_tpu.parallel import population_mesh
from estorch_tpu_torch import ES, DeviceAgent, NatureCNN, PooledAgent, adam, interop
from estorch_tpu_torch.envs.rollout import population_forward
from estorch_tpu_torch.models import capture_reference_stats
from estorch_tpu_torch.ops.params import make_param_spec

PONG = {"env_name": "pong84", "horizon": 20, "frame_stack": 4, "action_repeat": 2,
        "sticky_prob": 0.25}
DIM = 1_685_987  # ravel_pytree of NatureCNN(3, use_vbn=True) on (84, 84, 4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pixels(rng, n, density=0.05):
    return (rng.random((n, 84, 84, 4)) < density).astype(np.float32)


def _flax(use_vbn, ref=None, seed=1):
    """A flax NatureCNN's variables, its VBN statistics captured on ``ref``."""
    jm = JNatureCNN(3, use_vbn=use_vbn)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((84, 84, 4)))
    if use_vbn:
        v = {"params": v["params"], "vbn_stats": jcapture(jm, v, jnp.asarray(ref))}
    return jm, v


def _port(v, use_vbn):
    tm = NatureCNN(3, use_vbn=use_vbn)
    flat, params = interop.params_from_jax(_np_tree(v["params"]))
    if use_vbn:
        tm.vbn_stats = interop.vbn_stats_from_jax(_np_tree(v["vbn_stats"]))
    return tm, flat, params


def test_layout_is_ravel_pytree_order():
    """The port's init gives flax's tree: keys, shapes and the flat size."""
    tm = NatureCNN(3)
    params = tm.init_params((84, 84, 4), torch.Generator().manual_seed(0))
    flat, spec = make_param_spec(params)
    jm, v = _flax(False)
    jflat, _ = ravel_pytree(JNatureCNN(3, use_vbn=True).init(
        jax.random.PRNGKey(0), jnp.zeros((84, 84, 4)))["params"])
    assert spec.dim == jflat.shape[0] == DIM
    assert [p[0] for p in spec.paths][::2] == ["conv_0", "conv_1", "conv_2", "fc", "head",
                                               "vbn_0", "vbn_1", "vbn_2"]
    assert spec.paths[-2:] == (("vbn_2", "bias"), ("vbn_2", "scale"))
    want = jax.tree_util.tree_map(lambda x: tuple(x.shape), v["params"])
    for path, shape in zip(spec.paths, spec.shapes):
        if not path[0].startswith("vbn"):
            assert want[path[0]][path[1]] == shape, path
    assert params["fc"]["kernel"].shape == (3136, 512)
    assert params["conv_0"]["kernel"].shape == (8, 8, 4, 32)  # HWIO


@pytest.mark.parametrize("use_vbn", [False, True], ids=["plain", "vbn"])
def test_logits_match_flax(use_vbn):
    """A batch of 6 and a single observation, within 1e-5; integer pixels
    are divided by 255 on both sides."""
    rng = np.random.default_rng(0)
    jm, v = _flax(use_vbn, _pixels(rng, 16, 0.1))
    tm, _, params = _port(v, use_vbn)
    x = _pixels(rng, 6)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(tm.apply_params(params, torch.from_numpy(x)).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.apply_params(params, torch.from_numpy(x[2])).numpy(),
                               want[2], rtol=1e-5, atol=1e-5)
    raw = (rng.random((2, 84, 84, 4)) * 255).astype(np.uint8)
    np.testing.assert_allclose(tm.apply_params(params, torch.from_numpy(raw)).numpy(),
                               np.asarray(jm.apply(v, jnp.asarray(raw))), rtol=1e-5, atol=1e-5)


def test_population_forward_matches_loop_and_jax_vmap():
    """Population 4, one observation each: the grouped-conv forward against
    a loop of the port's single forward and against JAX's ``jax.vmap``,
    within 1e-5."""
    rng = np.random.default_rng(1)
    jm, v = _flax(True, _pixels(rng, 16, 0.1))
    tm, flat, params = _port(v, True)
    tm.obs_shape = (84, 84, 4)
    _, spec = make_param_spec(params)
    g = torch.Generator().manual_seed(0)
    thetas = flat + 0.02 * torch.randn((4, flat.shape[0]), generator=g)
    obs = _pixels(rng, 4)
    got = population_forward(tm, spec.unravel(thetas))(torch.from_numpy(obs.reshape(4, -1)))
    loop = torch.stack([tm.apply_params(spec.unravel(thetas[i]), torch.from_numpy(obs[i]))
                        for i in range(4)])
    np.testing.assert_allclose(got.numpy(), loop.numpy(), rtol=1e-5, atol=1e-5)
    _, unravel = ravel_pytree(v["params"])
    want = jax.vmap(lambda th, o: jm.apply({**v, "params": unravel(th)}, o))(
        jnp.asarray(thetas.numpy()), jnp.asarray(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------- pooled pong84 vs JAX


@pytest.fixture(scope="module")
def pong_pair():
    """The JAX and the port's pooled ES on pong84 (NatureCNN with VBN,
    population 4), each as it comes from its constructor."""
    kw = dict(population_size=4, sigma=0.02, seed=0, policy_kwargs={"action_dim": 3},
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 21)
    jes = JES(JNatureCNN, JPooledAgent(**PONG), optax.adam,
              mesh=population_mesh(jax.devices()[:1]), telemetry=False, **kw)
    tes = ES(NatureCNN, PooledAgent(**PONG), adam, device="cpu", **kw)
    return jes, tes


def test_reference_batch_and_vbn_stats_match_jax(pong_pair):
    """The VBN reference batch (pool of 32 envs, default_rng(seed), the
    reset frame and 4 random-action steps, stacked frames) is bit-equal to
    the JAX package's; the statistics captured on it with JAX's initial
    params agree with a float64 capture of the first layer to 1e-6, and
    with JAX's frozen ones to the error of JAX's float32 reductions."""
    jes, tes = pong_pair
    batch = tes._pooled_reference_batch(128)
    np.testing.assert_array_equal(batch.numpy(), np.asarray(jes._pooled_reference_batch(128)))
    assert batch.shape == (128, 84, 84, 4)
    _, params = interop.params_from_jax(np.asarray(jes.state.params_flat), tes.spec)
    got = capture_reference_stats(tes.module, params, batch)
    want = _np_tree(jes._frozen["vbn_stats"])
    assert set(got) == set(want) == {"vbn_0", "vbn_1", "vbn_2"}

    def err(a, b):  # relative to the layer's scale
        return np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max()

    # the first layer's statistics in float64: the port's are within 1e-6;
    # JAX's float32 variance is off by up to 1e-4 of its scale (measured 9.6e-5)
    x = batch.permute(0, 3, 1, 2).double()
    k = params["conv_0"]["kernel"].permute(3, 2, 0, 1).double()
    y = torch.nn.functional.conv2d(x, k, params["conv_0"]["bias"].double(), stride=4)
    exact = {"mean": y.mean(dim=(0, 2, 3)).numpy(), "var": y.var(dim=(0, 2, 3), correction=0).numpy()}
    for stat in ("mean", "var"):
        assert err(got["vbn_0"][stat].numpy(), exact[stat]) < 1e-6, stat
        assert err(want["vbn_0"][stat], exact[stat]) < 2e-4, stat
    # later layers normalize with the first's statistics, so JAX's error
    # carries on: measured 2.9e-5 (vbn_1) and 1.3e-5 (vbn_2)
    for name in ("vbn_1", "vbn_2"):
        for stat in ("mean", "var"):
            assert err(got[name][stat].numpy(), want[name][stat]) < 1e-4, (name, stat)
    assert set(tes.module.vbn_stats) == set(want)  # the port's own, from its own params


def test_pong84_pooled_trajectory_matches_jax(pong_pair):
    """Two pooled generations of NatureCNN with VBN on pong84 (frame stack
    4, action repeat 2, sticky 0.25), horizon 20, from JAX's params, VBN
    statistics, table and offsets: fitness and final frames equal (the same
    actions), params within 1e-6."""
    from test_torch_pooled import check_pooled, pooled_step

    jes, tes = pong_pair
    assert tes.spec.dim == DIM and tes.backend == "pooled"
    assert tes.engine.pool.is_native and tes.engine.pool.obs_shape == (84, 84, 4)
    tes.table = tes.engine.core.table = interop.table_from_numpy(np.asarray(jes.table.data))
    tes.module.vbn_stats = interop.vbn_stats_from_jax(_np_tree(jes._frozen["vbn_stats"]))
    flat, _ = interop.params_from_jax(np.asarray(jes.state.params_flat), tes.spec)
    tes.state = tes.engine.init_state(flat, seed=0)
    for g in range(2):
        jm, tm = pooled_step(jes, tes)
        check_pooled(jes, tes, jm, tm, f"generation {g}", norm_rtol=1e-4)
    assert tes.evaluate_policy(2, seed=1)["episodes"] == 2


# ------------------------------------- a pixel device env (ROADMAP F25)


def _pixel_reference_batch(jes, jenv, tenv, n_steps=128):
    """JAX's VBN reference batch of ``jes`` and the port's from the same
    reset state and random actions (the draws of JAX's key, handed over)."""
    from test_torch_envs import jax_resets

    from estorch_tpu.envs.agent import collect_reference_batch as j_collect
    from estorch_tpu_torch.envs import collect_reference_batch

    vbn_key = jax.random.split(jax.random.PRNGKey(jes.seed), 3)[2]
    want = np.asarray(j_collect(jenv, vbn_key, n_steps=n_steps))
    key, rkey = jax.random.split(vbn_key)
    acts = jax.vmap(lambda k: jax.random.randint(k, (), 0, jenv.action_dim))(
        jax.random.split(key, n_steps))
    got = collect_reference_batch(tenv, n_steps, actions=torch.from_numpy(np.array(acts)),
                                  state0=jax_resets(jenv, tenv, rkey[None]))
    return want, got


@pytest.mark.parametrize("use_vbn", [False, True], ids=["plain", "vbn"])
def test_device_pixel_env_trains_as_jax(use_vbn):
    """ROADMAP F25: the device path takes the policy's input shape from
    the observation the env's reset returns, as JAX inits from ``obs0``.
    ``NatureCNN`` on :class:`PixelShift` ((36, 36, 4) float pixels): the
    VBN reference batch from JAX's reset state and actions bit-equal to
    JAX's, its statistics as JAX's within 1e-4 of their scale (JAX's
    float32 variance, as for pong84), then 2 generations from JAX's params,
    VBN statistics, table, offsets and reset states: fitness within 1e-6
    (the returns' float32 sums; the same actions), alive steps equal,
    params within 1e-6.  ``obs_norm`` keeps (obs_dim,) statistics and is
    refused on pixels (JAX's fails to broadcast them at its first
    generation)."""
    from test_torch_recurrent import rec_pair, rec_sample
    from test_torch_sharded_conv import PixelShift, jax_pixel_env

    jenv, tenv = jax_pixel_env(), PixelShift()
    pk = {"action_dim": 2, "use_vbn": use_vbn}
    jes, tes = rec_pair(jenv, tenv, JNatureCNN, NatureCNN, pk, 4, population_size=8,
                        sigma=0.05, table_size=1 << 18)
    assert tes.spec.dim == (112_610 if use_vbn else 112_290)
    assert tes._obs_shape == (36, 36, 4) and tes.module.obs_shape == (36, 36, 4)
    if use_vbn:
        want, got = _pixel_reference_batch(jes, jenv, tenv)
        assert got.shape == (128, 36, 36, 4)
        np.testing.assert_array_equal(got.numpy(), want)
        _, params = interop.params_from_jax(np.asarray(jes.state.params_flat), tes.spec)
        stats = capture_reference_stats(tes.module, params, got)
        jstats = _np_tree(jes._frozen["vbn_stats"])
        for name, s in jstats.items():
            for stat in ("mean", "var"):
                err = np.abs(stats[name][stat].numpy() - s[stat]).max() / np.abs(s[stat]).max()
                assert err < 1e-4, (name, stat, err)
    for g in range(2):
        jstate = jes.state
        sample = rec_sample(jes, tenv, jstate)
        jes.state, jm = jes.engine.generation_step(jstate)
        tes.state, tm = tes.engine.generation_step(tes.state, sample)
        np.testing.assert_allclose(tm["fitness"].numpy(), np.asarray(jm["fitness"]), rtol=1e-6,
                                   atol=1e-6, err_msg=f"generation {g}")
        assert int(tm["steps"]) == int(jm["steps"]) == 8 * 4
        np.testing.assert_allclose(tes.state.params_flat.numpy(),
                                   np.asarray(jes.state.params_flat), rtol=0, atol=1e-6)
    assert tes.evaluate_policy(2, seed=1)["episodes"] == 2
    with pytest.raises(ValueError, match="obs_norm keeps"):
        ES(NatureCNN, DeviceAgent(tenv, horizon=4), adam, device="cpu", obs_norm=True,
           policy_kwargs=pk, table_size=1 << 18, optimizer_kwargs={"learning_rate": 1e-2})
