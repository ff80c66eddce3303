"""The port's recurrent policies, carry-threaded rollouts, low-rank tree
form, device-path VBN and pooled carries against the JAX package's.

Both sides start from the JAX side's params (flax's own init, handed over
through ``interop.params_from_jax``), noise table, offsets and reset
states, as numpy.  Tolerances are stated on each test; the trajectory
tests print the largest difference they saw (``-s``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

import estorch_tpu.envs as jenvs
import estorch_tpu_torch.envs as tenvs
from estorch_tpu import ES as JES
from estorch_tpu import JaxAgent
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu import RecurrentNatureCNN as JRecurrentNatureCNN
from estorch_tpu import RecurrentPolicy as JRecurrentPolicy
from estorch_tpu.envs.agent import collect_reference_batch as j_collect_reference_batch
from estorch_tpu.envs.rollout import make_rollout as j_make_rollout
from estorch_tpu.ops import lowrank as jlr
from estorch_tpu.parallel import population_mesh
from estorch_tpu.parallel.engine import _gen_keys
from estorch_tpu_torch import (ES, DeviceAgent, MLPPolicy, RecurrentNatureCNN, RecurrentPolicy,
                               adam, collect_reference_batch, interop, sgd)
from estorch_tpu_torch.envs.rollout import (carry_init_takes_params, make_batched_rollout,
                                            map_carry, member_params_apply, population_forward)
from estorch_tpu_torch.models import capture_reference_stats
from estorch_tpu_torch.ops import lowrank as tlr
from estorch_tpu_torch.ops.params import make_param_spec
from estorch_tpu_torch.parallel import ESEngine, EngineConfig, Sample

from test_torch_envs import fold_keys, jax_resets
from test_torch_pooled import check_pooled, pooled_pair, pooled_step

# (name, RecurrentPolicy kwargs): the cells, a stack and the learned carry
CELLS = {
    "gru": {},
    "lstm": {"cell": "lstm"},
    "gru_stacked": {"n_layers": 2},
    "gru_learned": {"learned_carry": True},
    "lstm_stacked_learned": {"cell": "lstm", "n_layers": 2, "learned_carry": True},
}
SMALL = {"action_dim": 2, "hidden": (8,), "gru_size": 8, "discrete": False, "action_scale": 2.0}


def _to_torch(tree):
    """A JAX carry (an array or nested tuples) as torch tensors."""
    return map_carry(lambda x: torch.from_numpy(np.array(x, np.float32)),
                     jax.tree_util.tree_map(np.asarray, tree))


def _jax_module(kw, obs_dim, seed=0):
    mod = JRecurrentPolicy(**kw)
    variables = mod.init(jax.random.PRNGKey(seed), jnp.zeros((obs_dim,)), mod.carry_init())
    return mod, variables


def _np_params(variables):
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _random_carry(mod, rng, batch):
    """A carry of ``mod``'s structure with random values, (batch, size) leaves."""
    return jax.tree_util.tree_map(
        lambda z: jnp.asarray(rng.standard_normal((batch,) + z.shape).astype(np.float32) * 0.5),
        mod.carry_init())


# ----------------------------------------------------------------- the cells


@pytest.mark.parametrize("over", list(CELLS.values()), ids=list(CELLS))
def test_cell_steps_match_flax(over):
    """Two steps of RecurrentPolicy (obs 3 → 8 → cell 8 → 2) on 5 rows from
    random carries, against flax's ``apply`` from the same params: outputs
    and carries within 1e-6 abs (float32 products in another order; the
    gates of a cell are one product a side here, a product a gate in
    flax's GRUCell)."""
    kw = dict(SMALL, **over)
    jmod, variables = _jax_module(kw, 3)
    _, params = interop.params_from_jax(_np_params(variables))
    tmod = RecurrentPolicy(**kw)
    rng = np.random.default_rng(1)
    jcarry = _random_carry(jmod, rng, 5)
    tcarry = _to_torch(jcarry)
    japply = jax.vmap(lambda o, h: jmod.apply(variables, o, h))
    for _ in range(2):
        obs = rng.standard_normal((5, 3)).astype(np.float32)
        jout, jcarry = japply(jnp.asarray(obs), jcarry)
        tout, tcarry = tmod.apply_params(params, torch.from_numpy(obs), tcarry)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-6)
        jflat = [np.asarray(x) for x in jax.tree_util.tree_leaves(jcarry)]
        tflat = jax.tree_util.tree_leaves(map_carry(lambda t: t.numpy(), tcarry))
        assert len(jflat) == len(tflat)
        for j, t in zip(jflat, tflat):
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    # a single observation with an unbatched carry, and the episode start
    single = rng.standard_normal(3).astype(np.float32)
    jout, _ = jmod.apply(variables, jnp.asarray(single), jmod.carry_init(variables["params"]))
    tout, _ = tmod.apply_params(params, torch.from_numpy(single), tmod.carry_init(params))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-6)


def test_carry_init_follows_jax():
    """Zeros, or the member's carry0 leaves with learned_carry (a variables
    dict works too); a tensor for the GRU, (c, h) for the LSTM, a tuple of
    per-layer carries when stacked; ValueError for another cell."""
    gru = RecurrentPolicy(**dict(SMALL, learned_carry=True))
    p = {"carry0_0": torch.full((8,), 0.5)}
    assert torch.equal(gru.carry_init(p), torch.full((8,), 0.5))
    assert torch.equal(gru.carry_init({"params": p}), torch.full((8,), 0.5))
    assert torch.equal(gru.carry_init(), torch.zeros(8))
    lstm2 = RecurrentPolicy(**dict(SMALL, cell="lstm", n_layers=2))
    c = lstm2.carry_init()
    assert isinstance(c, tuple) and len(c) == 2 and all(len(layer) == 2 for layer in c)
    assert carry_init_takes_params(gru.carry_init)
    assert not carry_init_takes_params(lambda: torch.zeros(2))
    with pytest.raises(ValueError, match="cell"):
        RecurrentPolicy(**dict(SMALL, cell="rnn"))


def test_recurrent_nature_cnn_matches_flax():
    """RecurrentNatureCNN (gru 16, 3 actions) on 2 sparse 44x44x4
    observations (the trunk's output 2x2x64, so the NHWC flatten and the
    fc are exercised at a quarter of pong84's cost) from random carries,
    against flax: logits and carries within 1e-5 of their scale."""
    jmod = JRecurrentNatureCNN(action_dim=3, gru_size=16)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.zeros((44, 44, 4)), jmod.carry_init())
    _, params = interop.params_from_jax(_np_params(variables))
    tmod = RecurrentNatureCNN(action_dim=3, gru_size=16)
    tmod.obs_shape = (44, 44, 4)
    rng = np.random.default_rng(0)
    obs = (rng.random((2, 44, 44, 4)) < 0.05).astype(np.float32)
    h = rng.standard_normal((2, 16)).astype(np.float32)
    jout, jh = jax.vmap(lambda o, c: jmod.apply(variables, o, c))(jnp.asarray(obs), jnp.asarray(h))
    tout, th = tmod.apply_params(params, torch.from_numpy(obs), torch.from_numpy(h))
    scale = float(np.abs(np.asarray(jout)).max())
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)


# ------------------------------------------------------------------- interop


@pytest.mark.parametrize("kw,obs_dim,dim,order", [
    ({"action_dim": 1, "discrete": False}, 3, 25_153, ["dense_0", "gru", "head"]),
    ({"action_dim": 1, "discrete": False, "cell": "lstm", "n_layers": 2, "learned_carry": True},
     3, 66_625, ["carry0_c_0", "carry0_c_1", "carry0_h_0", "carry0_h_1", "dense_0", "head",
                 "lstm", "lstm_1"]),
], ids=["gru_default_pendulum", "lstm_stacked_learned_pendulum"])
def test_params_round_trip_in_ravel_pytree_order(kw, obs_dim, dim, order):
    """The port's init and a JAX tree through ``params_from_jax`` give the
    layout of ``ravel_pytree``: the same size, the same flat vector and the
    same leaf paths in the same order (keys sorted: the LSTM's head comes
    before its cells; inside a GRU cell hn, hr, hz, in, ir, iz)."""
    _, variables = _jax_module(kw, obs_dim)
    jflat, _ = ravel_pytree(variables["params"])
    tflat, _ = interop.params_from_jax(_np_params(variables))
    assert jflat.shape == (dim,)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    own, spec = make_param_spec(RecurrentPolicy(**kw).init_params(obs_dim, torch.Generator()))
    assert spec.dim == dim
    jpaths = [tuple(k.key for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(variables["params"])[0]]
    assert list(spec.paths) == jpaths
    assert list(dict.fromkeys(p[0] for p in spec.paths)) == order
    if "gru" in order:
        assert [p[1] for p in spec.paths if p[0] == "gru"] == [
            "hn", "hn", "hr", "hz", "in", "in", "ir", "ir", "iz", "iz"]


def test_recurrent_nature_cnn_size_at_full_width():
    """RecurrentNatureCNN(gru_size=256) on 84x84x4 counts 2,275,747 floats
    in both packages."""
    jmod = JRecurrentNatureCNN(action_dim=3)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((84, 84, 4)),
                            jmod.carry_init())
    jdim = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    _, spec = make_param_spec(RecurrentNatureCNN(3).init_params((84, 84, 4), torch.Generator()))
    assert jdim == spec.dim == 2_275_747


# ------------------------------------------------------------------ rollouts


@pytest.mark.parametrize("env_name,kw,horizon", [
    ("RecallEnv", dict(SMALL, action_dim=1, learned_carry=True), 16),
    ("Pendulum", dict(SMALL, action_dim=1, cell="lstm", n_layers=2), 30),
    ("CartPole", dict(SMALL, discrete=True), 120),
], ids=["recall_gru_learned", "pendulum_lstm_stacked", "cartpole_gru_done_freezing"])
def test_carry_threaded_rollout_matches_jax(env_name, kw, horizon):
    """8 perturbed members' episodes through the batched rollout, the carry
    threaded and starting at each member's carry_init, against JAX's
    ``make_rollout`` vmapped over the members, from the same reset states.
    Returns within 1e-5 relative (float32 over the horizon); alive steps
    and, on CartPole, the returns equal (episodes end early there)."""
    jenv, tenv = getattr(jenvs, env_name)(), getattr(tenvs, env_name)()
    jmod, variables = _jax_module(kw, jenv.obs_dim)
    jflat, unravel = ravel_pytree(variables["params"])
    rng = np.random.default_rng(3)
    sigma = 0.5 if env_name == "CartPole" else 0.2
    thetas = np.asarray(jflat)[None] + sigma * rng.standard_normal((8, jflat.shape[0])).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), 8)

    def japply(p, obs, h):
        return jmod.apply({"params": p}, obs, h)

    jrollout = jax.vmap(j_make_rollout(jenv, japply, horizon, carry_init=jmod.carry_init))
    jres = jrollout(jax.vmap(unravel)(jnp.asarray(thetas)), keys)

    tmod = RecurrentPolicy(**kw)
    _, spec = make_param_spec(interop.params_from_jax(_np_params(variables))[1])
    members = spec.unravel(torch.from_numpy(thetas))
    carry0 = map_carry(lambda x: x.expand(8, x.shape[-1]).clone(), tmod.carry_init(members))
    states0 = jax_resets(jenv, tenv, keys)
    fwd = population_forward(tmod, members)
    # the recurrent member_params_apply is the same forward on (n, e, ...) rows
    obs0 = tenv.observe(states0)
    out, carry = fwd(obs0, carry0)
    out_e, carry_e = member_params_apply(tmod, members, obs0[:, None],
                                         map_carry(lambda t: t[:, None], carry0))
    assert torch.equal(out_e[:, 0], out)
    assert all(torch.equal(a[:, 0], b) for a, b in zip(jax.tree_util.tree_leaves(carry_e),
                                                          jax.tree_util.tree_leaves(carry)))
    tres = make_batched_rollout(tenv, horizon)(fwd, states0, obs0, carry0)
    np.testing.assert_array_equal(tres.steps.numpy(), np.asarray(jres.steps))
    if env_name == "CartPole":
        assert int(tres.steps.min()) < horizon  # episodes ended and froze
        np.testing.assert_array_equal(tres.total_reward.numpy(), np.asarray(jres.total_reward))
    else:
        np.testing.assert_allclose(tres.total_reward.numpy(), np.asarray(jres.total_reward),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tres.bc.numpy(), np.asarray(jres.bc), rtol=1e-5, atol=1e-5)


def test_rollout_threads_resets_and_freezes_the_carry():
    """A 'policy' whose carry counts its alive calls (the JAX package's
    emit-h test, batched): on RecallEnv the carry is the action, so the
    return is 0 + 1·4 times the sign over 5 steps; on CartPole the carry
    seen at the last step is min(alive steps, horizon − 1): it froze."""
    env = tenvs.RecallEnv()
    states0, obs0 = env.reset(torch.Generator().manual_seed(0), 6)

    def emit_h(obs, h):
        return h.clone(), torch.clamp(h + 1.0, max=1.0)

    res = make_batched_rollout(env, 5)(emit_h, states0, obs0, torch.zeros(6, 1))
    torch.testing.assert_close(res.total_reward, 4.0 * states0[:, 0])

    env = tenvs.CartPole()
    horizon = 200
    states0, obs0 = env.reset(torch.Generator().manual_seed(0), 16)
    seen = {}

    def count(obs, h):
        seen["h"] = h
        return torch.stack([obs[:, 2] < 0, obs[:, 2] >= 0], 1).float(), h + 1.0

    res = make_batched_rollout(env, horizon)(count, states0, obs0, torch.zeros(16, 1))
    assert int(res.steps.min()) < horizon - 1
    want = torch.clamp(res.steps.to(torch.float32), max=horizon - 1)
    torch.testing.assert_close(seen["h"][:, 0], want)


# ----------------------------------------------------------------- low rank


@pytest.mark.parametrize("kw,rank", [
    ({"action_dim": 1, "discrete": False}, 1),
    ({"action_dim": 1, "discrete": False, "cell": "lstm", "n_layers": 2, "learned_carry": True},
     2),
    (dict(SMALL, learned_carry=True), 4),
], ids=["gru_default_r1", "lstm_stacked_learned_r2", "gru_small_learned_r4"])
def test_lowrank_tree_form_matches_jax(kw, rank):
    """``make_lowrank_tree_spec``: the same factored and dense leaves at the
    same offsets (carry0_* and biases dense); ``lowrank_tree_noise``,
    ``lowrank_tree_perturb`` (one member, and 6 members at once) and
    ``lowrank_tree_weighted_sum`` over 6 rows within 1e-6 of JAX's."""
    _, variables = _jax_module(kw, 3)
    jparams = variables["params"]
    jspec = jlr.make_lowrank_tree_spec(jparams, rank)
    _, tparams = interop.params_from_jax(_np_params(variables))
    tspec = tlr.make_lowrank_tree_spec(tparams, rank)
    assert tspec.noise_dim == jspec.noise_dim
    assert tspec.lr_leaves == jspec.lr_leaves
    assert tspec.dense_leaves == jspec.dense_leaves
    carry_leaves = {i for i, path in enumerate(tspec.paths) if path[0].startswith("carry0")}
    assert carry_leaves <= {i for i, *_ in tspec.dense_leaves}
    rng = np.random.default_rng(rank)
    noise = rng.standard_normal((6, jspec.noise_dim)).astype(np.float32)
    w = rng.uniform(-1, 1, 6).astype(np.float32)
    flat = lambda tree: np.asarray(ravel_pytree(tree)[0])  # noqa: E731
    _, spec = make_param_spec(tparams)

    def close(got_tree, want):
        np.testing.assert_allclose(spec.flatten(got_tree).numpy(), want, rtol=0, atol=1e-6)

    close(tlr.lowrank_tree_noise(tspec, torch.from_numpy(noise[0])),
          flat(jlr.lowrank_tree_noise(jspec, jnp.asarray(noise[0]))))
    jtheta = jax.vmap(lambda v, c: flat_j(jlr.lowrank_tree_perturb(jspec, jparams, v, c)))(
        jnp.asarray(noise), jnp.asarray(0.1 * w))
    ttheta = tlr.lowrank_tree_perturb(tspec, tparams, torch.from_numpy(noise),
                                      torch.from_numpy(0.1 * w))
    got = torch.cat([ttheta_leaf.reshape(6, -1) for ttheta_leaf in _leaves(ttheta, spec)], 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jtheta), rtol=0, atol=1e-6)
    close(tlr.lowrank_tree_perturb(tspec, tparams, torch.from_numpy(noise[1]),
                                   torch.tensor(-0.05)),
          flat(jlr.lowrank_tree_perturb(jspec, jparams, jnp.asarray(noise[1]), -0.05)))
    close(tlr.lowrank_tree_weighted_sum(tspec, torch.from_numpy(noise), torch.from_numpy(w)),
          flat(jlr.lowrank_tree_weighted_sum(jspec, jnp.asarray(noise), jnp.asarray(w))))


def flat_j(tree):
    return ravel_pytree(tree)[0]


def _leaves(tree, spec):
    out = []
    for path in spec.paths:
        node = tree
        for k in path:
            node = node[k]
        out.append(node)
    return out


# ----------------------------------------------------- the VBN reference batch


@pytest.mark.parametrize("env_name", ["CartPole", "Pendulum"])
def test_collect_reference_batch_matches_jax(env_name):
    """128 random-action steps from JAX's reset state and JAX's actions
    (the draws of its key, handed over): the reset frame first and the old
    frame kept where an episode ended (CartPole ends within 128 random
    steps), at the same rows.  The frames agree within 1e-5 abs: XLA fuses
    the physics' multiply-adds, so each step differs from torch's by up to
    a float32 ulp, and Pendulum's 128 steps carry that to 4.3e-6 (CartPole
    1.2e-7, measured here)."""
    jenv, tenv = getattr(jenvs, env_name)(), getattr(tenvs, env_name)()
    key = jax.random.PRNGKey(5)
    want = np.asarray(j_collect_reference_batch(jenv, key, n_steps=128))
    # the JAX function's own draws: the reset key, then one key a step
    key, rkey = jax.random.split(key)
    keys = jax.random.split(key, 128)
    if jenv.discrete:
        acts = jax.vmap(lambda k: jax.random.randint(k, (), 0, jenv.action_dim))(keys)
    else:
        acts = jax.vmap(lambda k: jax.random.uniform(k, (jenv.action_dim,), minval=-1.0,
                                                     maxval=1.0))(keys)
    state0 = jax_resets(jenv, tenv, rkey[None])
    got = collect_reference_batch(tenv, 128, actions=torch.from_numpy(np.array(acts)),
                                  state0=state0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    kept = (np.diff(want, axis=0) == 0).all(axis=1)
    np.testing.assert_array_equal((np.diff(got, axis=0) == 0).all(axis=1), kept)
    assert kept.any() == (env_name == "CartPole")  # an episode ended: its frame stays
    own = collect_reference_batch(tenv, 16, torch.Generator().manual_seed(0))
    assert own.shape == (16, tenv.obs_dim) and torch.isfinite(own).all()


# ------------------------------------------------------- ES trajectories


def rec_pair(jenv, tenv, jpolicy, tpolicy, policy_kwargs, horizon, **over):
    """The JAX ES on a one-device mesh and the port's on the CPU with the
    same options, then the JAX side's table, initial params and VBN
    statistics handed over."""
    kw = dict(population_size=16, sigma=0.1, seed=0, policy_kwargs=policy_kwargs,
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16)
    kw.update(over)
    jopt = optax.sgd if kw.pop("sgd", False) else optax.adam
    topt = sgd if jopt is optax.sgd else adam
    jes = JES(jpolicy, JaxAgent(jenv, horizon=horizon), jopt,
              mesh=population_mesh(jax.devices()[:1]), telemetry=False, **kw)
    tes = ES(tpolicy, DeviceAgent(tenv, horizon=horizon), topt, device="cpu", **kw)
    tes.engine.table = interop.table_from_numpy(np.asarray(jes.table.data))
    flat, _ = interop.params_from_jax(np.asarray(jes.state.params_flat), tes.spec)
    if "vbn_stats" in jes._frozen:
        stats = jax.tree_util.tree_map(np.asarray, jes._frozen["vbn_stats"])
        tes.module.vbn_stats = interop.vbn_stats_from_jax(stats)
    tes.state = tes.engine.init_state(flat, seed=0)
    return jes, tes


def rec_sample(jes, tenv, jstate) -> Sample:
    """This generation's draws of the JAX engine (offsets, each row's reset
    states, all e of them, and the obs-norm probe's), in the port's layout."""
    cfg = jes.config
    _, rkey = _gen_keys(jstate)
    rows = cfg.population_size // 2 if cfg.mirrored else cfg.population_size
    keys = jax.random.split(rkey, rows)
    if cfg.episodes_per_member > 1:
        keys = jax.vmap(lambda k: jax.random.split(k, cfg.episodes_per_member))(keys)
    probe = None
    if cfg.obs_norm:
        base = jax.random.fold_in(rkey, 2**31 - 2)
        probe = jax_resets(jes.env, tenv, fold_keys(base, cfg.obs_probe_episodes))
    offsets = np.array(jes.engine.all_pair_offsets(jstate))
    return Sample(torch.from_numpy(offsets), jax_resets(jes.env, tenv, keys), probe)


GOLDEN = dict(population_size=16, sigma=0.1, seed=7, table_size=1 << 15)
GOLDEN_PK = {"action_dim": 2, "hidden": (8,), "gru_size": 8}
RECALL_PK = {"action_dim": 1, "hidden": (8,), "gru_size": 8, "discrete": False}

# name: (env, JAX policy, port policy, policy kwargs, horizon, options,
# generations, fitness rule).  Fitness rule "equal": CartPole's returns count
# alive steps, so equal actions give equal returns; a float: rtol on the
# RecallEnv returns (float32 over 16 steps).
TRAJECTORIES = {
    # the tier-1 golden recipes (tests/test_goldens.py:136-160)
    "ES_recurrent": ("CartPole", JRecurrentPolicy, RecurrentPolicy, GOLDEN_PK, 50, GOLDEN, 3,
                     "equal"),
    "ES_recurrent_lowrank": ("CartPole", JRecurrentPolicy, RecurrentPolicy, GOLDEN_PK, 50,
                             dict(GOLDEN, low_rank=1), 3, "equal"),
    # the golden recipe's MLP with VBN on the device path
    "device_vbn": ("CartPole", JMLPPolicy, MLPPolicy,
                   {"action_dim": 2, "hidden": (8,), "use_vbn": True}, 50, GOLDEN, 3, "equal"),
    "lstm_stacked_learned_kernel": ("RecallEnv", JRecurrentPolicy, RecurrentPolicy,
                                    dict(RECALL_PK, cell="lstm", n_layers=2, learned_carry=True),
                                    16, {"noise_kernel": True}, 2, 1e-5),
    "gru_learned_obs_norm": ("RecallEnv", JRecurrentPolicy, RecurrentPolicy,
                             dict(RECALL_PK, learned_carry=True), 16,
                             {"obs_norm": True, "obs_probe_episodes": 2}, 2, 1e-5),
    "gru_unmirrored_episodes_2_chunked": ("RecallEnv", JRecurrentPolicy, RecurrentPolicy,
                                          RECALL_PK, 16, {"mirrored": False,
                                                          "episodes_per_member": 2,
                                                          "eval_chunk": 4}, 2, 1e-5),
    "lstm_learned_lowrank": ("RecallEnv", JRecurrentPolicy, RecurrentPolicy,
                             dict(RECALL_PK, cell="lstm", learned_carry=True), 16,
                             {"low_rank": 1}, 2, 1e-5),
}


@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_trajectory_matches_jax(name):
    """Generation by generation from JAX's draws: fitness (rule above),
    alive steps, BC within 1e-4, the update norm within 1e-4 relative,
    params within 1e-5 (Adam moves each ≈ lr = 1e-2 a step; float32 sums
    of the update in another order).  With obs_norm the stats' count equal
    and its moments within 1e-5.  On ES_recurrent and ES_recurrent_lowrank
    the reward means are equal, as the golden test holds them.  No argmax
    near-tie needed pinning on these seeds: every CartPole member's return
    is equal."""
    env, jpolicy, tpolicy, pk, horizon, over, gens, rule = TRAJECTORIES[name]
    jenv, tenv = getattr(jenvs, env)(), getattr(tenvs, env)()
    jes, tes = rec_pair(jenv, tenv, jpolicy, tpolicy, pk, horizon, **over)
    worst = 0.0
    means = []
    for gen in range(gens):
        jstate = jes.state
        sample = rec_sample(jes, tenv, jstate)
        jes.state, jm = jes.engine.generation_step(jstate)
        tes.state, tm = tes.engine.generation_step(tes.state, sample)
        what = f"{name} gen {gen}"
        jf, tf = np.asarray(jm["fitness"]), tm["fitness"].numpy()
        means.append(round(float(tf.mean()), 4))
        if rule == "equal":
            np.testing.assert_array_equal(tf, jf, err_msg=what)
            assert float(tf.mean()) == float(jf.mean()), what
        else:
            np.testing.assert_allclose(tf, jf, rtol=rule, atol=rule, err_msg=what)
        assert int(tm["steps"]) == int(jm["steps"]), what
        np.testing.assert_allclose(tm["bc"].numpy(), np.asarray(jm["bc"]), rtol=1e-4, atol=1e-4,
                                   err_msg=what)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=what)
        diff = np.abs(tes.state.params_flat.numpy() - np.asarray(jes.state.params_flat)).max()
        worst = max(worst, float(diff))
        assert diff <= 1e-5, (what, diff)
        if over.get("obs_norm"):
            assert float(tes.state.obs_stats[0]) == float(jes.state.obs_stats[0]), what
            for i in (1, 2):
                np.testing.assert_allclose(tes.state.obs_stats[i].numpy(),
                                           np.asarray(jes.state.obs_stats[i]), rtol=1e-5,
                                           atol=1e-5, err_msg=what)
    print(f"{name}: params max |port - JAX| {worst:.3g} over {gens} generations; reward "
          f"means {means}")
    if name.startswith("ES_recurrent"):
        from test_goldens import GOLDENS

        assert means == GOLDENS[name]["reward_means"]


def test_lowrank_member_params_match_jax():
    """``member_params`` of the recurrent low-rank tree form rebuilds the
    member JAX rebuilds (a mirrored pair's minus member, and the plus)."""
    jes, tes = rec_pair(jenvs.CartPole(), tenvs.CartPole(), JRecurrentPolicy, RecurrentPolicy,
                        GOLDEN_PK, 50, **dict(GOLDEN, low_rank=1))
    sample = rec_sample(jes, tes.env, jes.state)
    for i in (0, 5):
        want = np.asarray(jes.engine.member_params(jes.state, i))
        got = tes.engine.member_params(tes.state, i, sample).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_device_vbn_statistics_match_jax():
    """The port's capture of VBN statistics from JAX's reference batch (128
    CartPole observations) equals JAX's frozen statistics within 1e-5 (the
    float32 variance over 128 rows), and ES on a DeviceAgent captures its
    own from its env."""
    jes = JES(JMLPPolicy, JaxAgent(jenvs.CartPole(), horizon=50), optax.adam,
              mesh=population_mesh(jax.devices()[:1]), telemetry=False,
              policy_kwargs={"action_dim": 2, "hidden": (8, 8), "use_vbn": True},
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 15, seed=7)
    _, vbn_key = jax.random.split(jax.random.PRNGKey(7), 3)[1:]
    batch = np.asarray(j_collect_reference_batch(jes.env, vbn_key, n_steps=128))
    module = MLPPolicy(action_dim=2, hidden=(8, 8), use_vbn=True)
    _, spec = make_param_spec(module.init_params(4, torch.Generator()))
    _, params = interop.params_from_jax(np.asarray(jes.state.params_flat), spec)
    got = capture_reference_stats(module, params, torch.from_numpy(batch))
    for layer, stats in jes._frozen["vbn_stats"].items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[layer][k].numpy(), np.asarray(stats[k]), rtol=1e-5,
                                       atol=1e-5)
    tes = ES(MLPPolicy, DeviceAgent(tenvs.CartPole(), horizon=50), adam, device="cpu",
             policy_kwargs={"action_dim": 2, "hidden": (8, 8), "use_vbn": True},
             optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 15, population_size=8)
    assert set(tes.module.vbn_stats) == {"vbn_0", "vbn_1"}
    tes.train(1, verbose=False)
    assert np.isfinite(tes.history[-1]["reward_mean"])


def test_bf16_recurrent_generation_matches_jax():
    """compute_dtype="bfloat16" with a stacked LSTM and a learned carry:
    member params, the learned carry (read from the bf16 members), obs and
    the gate math in bf16, the output back in float32.  One generation
    with SGD, so the param change is the ascent direction.

    Tolerance, from measurement (``-s`` prints it): the products, adds,
    tanh and casts round as XLA's do, but XLA on the CPU expands a bf16
    sigmoid into exp, add and divide, each rounded to bf16, where torch
    rounds σ once; about 29 % of the gates then differ by one bf16 ulp
    (0.4 %), and over 16 steps a member's return moved by up to 0.0073
    (0.84 % relative).  Held: fitness within 2e-2 relative and 1e-2
    absolute, the ascent directions' cosine >= 0.99 (measured 1.000000)."""
    pk = dict(RECALL_PK, cell="lstm", n_layers=2, learned_carry=True)
    jes, tes = rec_pair(jenvs.RecallEnv(), tenvs.RecallEnv(), JRecurrentPolicy, RecurrentPolicy,
                        pk, 16, compute_dtype="bfloat16", sgd=True)
    jstate = jes.state
    sample = rec_sample(jes, tes.env, jstate)
    jes.state, jm = jes.engine.generation_step(jstate)
    tes.state, tm = tes.engine.generation_step(tes.state, sample)
    jf, tf = np.asarray(jm["fitness"]), tm["fitness"].numpy()
    jd = np.asarray(jes.state.params_flat) - np.asarray(jstate.params_flat)
    td = tes.state.params_flat.numpy() - np.asarray(jstate.params_flat)
    cos = float(jd @ td / (np.linalg.norm(jd) * np.linalg.norm(td)))
    print(f"bf16 lstm stacked learned: fitness max |err| {np.max(np.abs(tf - jf)):.3g}, "
          f"ascent cosine {cos:.6f}")
    np.testing.assert_allclose(tf, jf, rtol=2e-2, atol=1e-2)
    assert cos >= 0.99, cos


class _LegacyCarry:
    """A recurrent module of its own with the zero-argument ``carry_init()``:
    h' = tanh(obs @ w + h), out = h' @ wo (the JAX package's legacy test)."""

    is_recurrent = True

    def carry_init(self):
        return torch.zeros(8)

    def population_layout(self, members):
        return members

    def population_apply(self, layout, obs, h):
        h = torch.tanh(obs @ layout["w"] + h)
        return h @ layout["wo"], h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_legacy_zero_arg_carry_init(dtype):
    """The zero-argument ``carry_init`` works in float32 and in bf16 (cast
    once to the compute dtype), on an engine of the port, as in JAX's
    ``test_bf16_legacy_zero_arg_carry_init``; and a RecurrentPolicy
    subclass with it trains through ES."""
    g = torch.Generator().manual_seed(0)
    flat, spec = make_param_spec({"w": torch.randn(4, 8, generator=g) * 0.5,
                                  "wo": torch.zeros(8, 2)})
    module = _LegacyCarry()
    eng = ESEngine(tenvs.CartPole(), module, spec, interop.table_from_numpy(
        np.random.default_rng(0).standard_normal(1 << 16).astype(np.float32)),
        sgd(learning_rate=1e-2),
        EngineConfig(population_size=8, sigma=0.1, horizon=10, compute_dtype=dtype),
        torch.device("cpu"), carry_init=module.carry_init)
    state = eng.init_state(flat, seed=1)
    state, metrics = eng.generation_step(state)
    assert torch.isfinite(metrics["fitness"]).all()

    class LegacyCarryPolicy(RecurrentPolicy):
        def carry_init(self):
            return super().carry_init(None)

    es = ES(LegacyCarryPolicy, DeviceAgent(tenvs.RecallEnv(), horizon=16), adam, device="cpu",
            population_size=16, sigma=0.1, policy_kwargs=RECALL_PK, compute_dtype=dtype,
            optimizer_kwargs={"learning_rate": 5e-2}, table_size=1 << 16)
    es.train(1, verbose=False)
    assert np.isfinite(es.history[-1]["reward_mean"])
    assert np.isfinite(es.evaluate_policy(4)["mean"])


# ----------------------------------------------------------- the pooled path


@pytest.mark.parametrize("double_buffer", [False, True], ids=["sync", "double_buffer"])
def test_pooled_recurrent_cartpole_matches_jax(double_buffer):
    """RecurrentPolicy (hidden (8,), GRU 8) on the pooled CartPole, 2
    generations from JAX's offsets: the stacked carry lives across the step
    loop (one a half with double_buffer).  Fitness and BC equal (same
    actions step the same C++ envs), params within 1e-6; then the center's
    pooled evaluations (carries of their own) equal."""
    agent_kw = {"env_name": "cartpole", "horizon": 40, "double_buffer": double_buffer}
    jes, tes = pooled_pair(agent_kw, {"action_dim": 2, "hidden": (8,), "gru_size": 8},
                           jpolicy=JRecurrentPolicy, tpolicy=RecurrentPolicy, population_size=16)
    assert jes.engine.recurrent and tes.engine.recurrent
    for gen in range(2):
        jm, tm = pooled_step(jes, tes)
        check_pooled(jes, tes, jm, tm, f"gen {gen}")
    jr = jes.engine.evaluate_center_batch(jes.state, 3, seed=2)
    tr = tes.engine.evaluate_center_batch(tes.state, 3, seed=2)
    np.testing.assert_array_equal(tr.fitness, np.asarray(jr.fitness))
    jc = jes.engine.evaluate_center(jes.state)
    tc = tes.engine.evaluate_center(tes.state)
    assert float(tc.total_reward) == float(jc.total_reward)
    assert int(tc.steps) == int(jc.steps)
    tes.engine.close()


def test_pooled_recurrent_bf16_matches_jax():
    """The pooled path in bf16 (GRU 8 on Pendulum, horizon 40, one
    generation): the members' params, the carry and the obs in bf16.  As in
    :func:`test_bf16_recurrent_generation_matches_jax`, XLA's expanded bf16
    sigmoid rounds otherwise than torch's, so the returns are held within
    1e-2 relative (measured 1.4e-3) and the update direction's cosine >=
    0.99 (on CartPole a flipped argmax would change an episode outright)."""
    jes, tes = pooled_pair({"env_name": "pendulum", "horizon": 40},
                           dict(RECALL_PK, action_scale=2.0), jpolicy=JRecurrentPolicy,
                           tpolicy=RecurrentPolicy, population_size=16,
                           compute_dtype="bfloat16")
    p0 = np.asarray(jes.state.params_flat)
    jm, tm = pooled_step(jes, tes)
    jf = np.asarray(jm["fitness"])
    print(f"pooled bf16: fitness max rel err {np.max(np.abs(tm['fitness'] - jf) / np.abs(jf)):.3g}")
    np.testing.assert_allclose(tm["fitness"], jf, rtol=1e-2)
    jd, td = np.asarray(jes.state.params_flat) - p0, tes.state.params_flat.numpy() - p0
    assert float(jd @ td / (np.linalg.norm(jd) * np.linalg.norm(td))) >= 0.99
    tes.engine.close()


def test_recurrent_guards_raise_as_in_jax():
    """decomposed and streamed have no recurrent form (JAX's ValueError on
    both sides); the learned carry has no pooled form (kept in
    tests/test_torch_pooled.py); a NatureCNN on a device env's flat
    observation raises ValueError as flax's convolution does."""
    base = dict(population_size=16, sigma=0.1, seed=0, policy_kwargs=RECALL_PK,
                optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16)
    for option, message in (({"decomposed": True}, "decomposed"),
                            ({"streamed": True}, "streamed|recurrent")):
        with pytest.raises(ValueError, match=message):
            JES(JRecurrentPolicy, JaxAgent(jenvs.RecallEnv(), horizon=16), optax.adam,
                mesh=population_mesh(jax.devices()[:1]), telemetry=False, **base, **option)
        with pytest.raises(ValueError, match=message):
            ES(RecurrentPolicy, DeviceAgent(tenvs.RecallEnv(), horizon=16), adam, device="cpu",
               **base, **option)
    from estorch_tpu_torch import NatureCNN

    with pytest.raises(ValueError, match="H, W, C"):
        ES(NatureCNN, DeviceAgent(tenvs.CartPole(), horizon=10), adam, device="cpu",
           policy_kwargs={"action_dim": 2}, optimizer_kwargs={"learning_rate": 1e-2},
           table_size=1 << 20)
    config = EngineConfig(population_size=8, sigma=0.1, horizon=10, decomposed=True)
    with pytest.raises(ValueError, match="recurrent policies run the standard forward"):
        ESEngine(tenvs.RecallEnv(), RecurrentPolicy(**RECALL_PK), None, None, None, config,
                 torch.device("cpu"), carry_init=lambda: torch.zeros(8))


# ------------------------------------------------------- every option trains

OPTIONS = {"f32": {}, "bf16": {"compute_dtype": "bfloat16"}, "low_rank_1": {"low_rank": 1},
           "obs_norm": {"obs_norm": True, "obs_warmup_episodes": 1},
           "kernel_unmirrored_episodes_2": {"noise_kernel": True, "mirrored": False,
                                            "episodes_per_member": 2, "eval_chunk": 4}}


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("cell", list(CELLS))
def test_es_trains_every_recurrent_option(cell, option):
    """``ES(RecurrentPolicy, DeviceAgent, adam, device="cpu")`` with every
    cell, a stack and a learned carry, in each option: two generations with
    finite results that move the params (the learned carry too), then
    ``evaluate_policy`` and ``best_policy`` (whose forward starts its own
    episode's carry)."""
    es = ES(RecurrentPolicy, DeviceAgent(tenvs.RecallEnv(), horizon=8), adam, device="cpu",
            population_size=8, sigma=0.1, policy_kwargs=dict(RECALL_PK, **CELLS[cell]),
            optimizer_kwargs={"learning_rate": 5e-2}, table_size=1 << 14, **OPTIONS[option])
    p0 = es.state.params_flat.clone()
    es.train(2, verbose=False)
    assert all(np.isfinite(r["reward_mean"]) for r in es.history)
    moved = es.spec.unravel(es.state.params_flat - p0)
    assert float(torch.linalg.vector_norm(es.state.params_flat - p0)) > 0
    if CELLS[cell].get("learned_carry"):
        assert float(moved["carry0_c_0" if "lstm" in cell else "carry0_0"].abs().max()) > 0
    assert np.isfinite(es.evaluate_policy(3, use_best=True)["mean"])
    out, carry = es.best_policy(torch.ones(1))
    assert out.shape == (1,) and torch.isfinite(out).all()


@pytest.mark.parametrize("over,options", [
    ({"cell": "lstm"}, {}), ({"n_layers": 2}, {}),
    ({"cell": "lstm", "n_layers": 2}, {"obs_norm": True, "compute_dtype": "bfloat16"}),
], ids=["lstm", "stacked", "lstm_stacked_obs_norm_bf16"])
def test_pooled_trains_lstm_and_stacked(over, options):
    """The pooled path with an LSTM and a stack of cells (tuple carries),
    also with obs-norm in bf16."""
    es = ES(RecurrentPolicy, tenvs.PooledAgent("cartpole", horizon=20), adam, device="cpu",
            population_size=8, sigma=0.1, optimizer_kwargs={"learning_rate": 1e-2},
            policy_kwargs=dict({"action_dim": 2, "hidden": (8,), "gru_size": 8}, **over),
            table_size=1 << 14, **options)
    es.train(2, verbose=False)
    assert np.isfinite(es.history[-1]["reward_mean"])
    assert np.isfinite(es.evaluate_policy(2)["mean"])
    es.engine.close()


@pytest.mark.slow
def test_learns_memory_task_where_memoryless_cannot():
    """The JAX package's memory recipe (tests/test_recurrent.py:104-119) on
    the port: RecallEnv, GRU 8, pop 256, 80 generations,
    ``evaluate_policy(64, seed=9)``.  The port's random streams are not
    JAX's, so its seeds 0, 1 and 2 are three other draws; ES here can
    settle on one sign of the signal (a mean near 6), so two of the three
    must pass 8.0, as chip_smoke.py's phase 10 holds it on the card.  A
    memoryless MLP (8, 8) stays under 4.0 (its return caps near 1)."""
    means = []
    for seed in (0, 1, 2):
        es = ES(RecurrentPolicy, DeviceAgent(tenvs.RecallEnv(), horizon=16), adam, device="cpu",
                seed=seed, population_size=256, sigma=0.1, policy_kwargs=RECALL_PK,
                optimizer_kwargs={"learning_rate": 5e-2})
        es.train(80, verbose=False)
        means.append(es.evaluate_policy(64, seed=9)["mean"])
    print(f"memory task, seeds 0, 1, 2: evaluate_policy means {means}")
    assert sum(m > 8.0 for m in means) >= 2, means
    base = ES(MLPPolicy, DeviceAgent(tenvs.RecallEnv(), horizon=16), adam, device="cpu",
              population_size=128, sigma=0.1, optimizer_kwargs={"learning_rate": 5e-2},
              policy_kwargs={"action_dim": 1, "hidden": (8, 8), "discrete": False})
    base.train(60, verbose=False)
    assert base.evaluate_policy(64, seed=9)["mean"] < 4.0
