"""The port's low-rank noise and population forwards against the JAX package.

The same numpy noise, params and observations go through
``estorch_tpu/ops/lowrank.py`` / ``models/decomposed.py`` and their
counterparts in the port.  The JAX package vmaps its per-member forms over
the population; the port's population-batched forms are held against that
vmap.  Tolerances: float32 sums of at most a few hundred terms taken in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from estorch_tpu.models import MLPPolicy as JMLPPolicy
from estorch_tpu.models import decomposed as jdec
from estorch_tpu.ops import lowrank as jlr
from estorch_tpu_torch import MLPPolicy
from estorch_tpu_torch.models import decomposed as tdec
from estorch_tpu_torch.ops import lowrank as tlr


def _shapes_tree(sizes, make):
    """An MLP param dict of the given layer sizes: dense_i ... head."""
    names = [f"dense_{i}" for i in range(len(sizes) - 2)] + ["head"]
    return {name: {"kernel": make((m, n)), "bias": make((n,))}
            for name, m, n in zip(names, sizes[:-1], sizes[1:])}


# (layer sizes, rank): factored layers, dense fallbacks, and mixes of both
SPEC_CASES = [
    ((3, 64, 64, 1), 1),  # Pendulum MLP64x64: the head falls back to dense
    ((3, 64, 64, 1), 16),  # only (64, 64) factors
    ((4, 8, 2), 1),  # every layer factors
    ((4, 8, 2), 3),  # no layer factors: all dense
    ((3, 8, 8, 1), 4),  # the parity tests' Pendulum MLP (8, 8) at rank 4: all dense
]


def _specs(sizes, rank):
    jspec = jlr.make_lowrank_spec(_shapes_tree(sizes, np.zeros), rank)
    tspec = tlr.make_lowrank_spec(_shapes_tree(sizes, torch.zeros), rank)
    return jspec, tspec


@pytest.mark.parametrize("sizes,rank", SPEC_CASES)
def test_spec_layout_matches_jax(sizes, rank):
    jspec, tspec = _specs(sizes, rank)
    assert tspec.noise_dim == jspec.noise_dim
    assert tspec.lr_layers == jspec.lr_layers
    assert tspec.dense_layers == jspec.dense_layers
    assert tspec.biases == jspec.biases
    assert tspec.lr_layers or tspec.dense_layers


def test_rank_below_one_raises():
    with pytest.raises(ValueError, match="low_rank must be >= 1"):
        tlr.make_lowrank_spec(_shapes_tree((4, 8, 2), torch.zeros), 0)


@pytest.mark.parametrize("sizes,rank", SPEC_CASES)
def test_unpack_tree_and_weighted_sum_match_jax(sizes, rank):
    jspec, tspec = _specs(sizes, rank)
    k = 6
    rng = np.random.default_rng(rank * 100 + sizes[1])
    mat = rng.standard_normal((k, jspec.noise_dim)).astype(np.float32)
    w = rng.uniform(-1, 1, k).astype(np.float32)
    tmat = torch.from_numpy(mat)

    # unpack: slicing only, exact; the port also unpacks a stack at once
    stacked = tspec.unpack(tmat)
    for i in range(k):
        jun = jspec.unpack(jnp.asarray(mat[i]))
        tun = tspec.unpack(tmat[i])
        assert jun.keys() == tun.keys()
        for name in jun:
            for jpart, tpart, spart in zip(jun[name], tun[name], stacked[name]):
                assert (jpart is None) == (tpart is None) == (spart is None)
                if jpart is not None:
                    np.testing.assert_array_equal(tpart.numpy(), np.asarray(jpart))
                    np.testing.assert_array_equal(spart[i].numpy(), np.asarray(jpart))

    # the dense tree one slice stands for: A Bᵀ/√r over r terms
    jtree = jlr.lowrank_noise_tree(jspec, jnp.asarray(mat[0]))
    ttree = tlr.lowrank_noise_tree(tspec, tmat[0])
    for name in jtree:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(ttree[name][leaf].numpy(), np.asarray(jtree[name][leaf]),
                                       rtol=1e-6, atol=1e-6)

    # the update's per-layer einsum over k rows
    jsum = jlr.lowrank_weighted_sum(jspec, jnp.asarray(mat), jnp.asarray(w))
    tsum = tlr.lowrank_weighted_sum(tspec, tmat, torch.from_numpy(w))
    for name in jsum:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(tsum[name][leaf].numpy(), np.asarray(jsum[name][leaf]),
                                       rtol=1e-5, atol=1e-5)


def _policy_pair(sizes, discrete):
    kw = {"action_dim": sizes[-1], "hidden": tuple(sizes[1:-1]), "discrete": discrete,
          "action_scale": 2.0}
    return JMLPPolicy(**kw), MLPPolicy(**kw)


def _random_tree(rng, sizes):
    return _shapes_tree(sizes, lambda s: (0.5 * rng.standard_normal(s)).astype(np.float32))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return {k: {leaf: torch.from_numpy(np.asarray(v)) for leaf, v in d.items()}
            for k, d in tree.items()}


@pytest.mark.parametrize("sizes,rank,discrete", [
    ((3, 64, 64, 1), 1, False), ((4, 8, 2), 1, True), ((4, 8, 2), 3, True),
    ((3, 8, 8, 1), 4, False),
])
def test_lowrank_forwards_match_jax(sizes, rank, discrete):
    """The per-member form against JAX's, and the population form (n
    members, e episodes each) against JAX's vmap of the per-member form."""
    jmod, tmod = _policy_pair(sizes, discrete)
    jspec, tspec = _specs(sizes, rank)
    n, e = 5, 2
    rng = np.random.default_rng(sum(sizes) + rank)
    shared = _random_tree(rng, sizes)
    noise = rng.standard_normal((n, jspec.noise_dim)).astype(np.float32)
    scale = (0.05 * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    obs = rng.standard_normal((n, e, sizes[0])).astype(np.float32)

    def jmember(nvec, c, o):
        return jdec.mlp_lowrank_apply(jmod, _to_jax(shared), jspec.unpack(nvec), c, o)

    want = jax.vmap(jax.vmap(jmember, in_axes=(None, None, 0)))(
        jnp.asarray(noise), jnp.asarray(scale), jnp.asarray(obs))
    tshared = _to_torch(shared)
    got = tdec.mlp_lowrank_population_apply(
        tmod, tshared, tspec.unpack(torch.from_numpy(noise)), torch.from_numpy(scale),
        torch.from_numpy(obs))
    assert got.shape == (n, e, sizes[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    one = tdec.mlp_lowrank_apply(tmod, tshared, tspec.unpack(torch.from_numpy(noise[1])),
                                 torch.tensor(scale[1]), torch.from_numpy(obs[1]))
    np.testing.assert_allclose(one.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sizes,discrete", [((3, 64, 64, 1), False), ((4, 8, 2), True)])
def test_decomposed_population_forward_matches_jax_vmap(sizes, discrete):
    jmod, tmod = _policy_pair(sizes, discrete)
    n, e = 4, 3
    rng = np.random.default_rng(7 + sum(sizes))
    shared = _random_tree(rng, sizes)
    noises = [_random_tree(rng, sizes) for _ in range(n)]
    stacked = {k: {leaf: np.stack([t[k][leaf] for t in noises]) for leaf in ("kernel", "bias")}
               for k in shared}
    scale = (0.05 * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    obs = rng.standard_normal((n, e, sizes[0])).astype(np.float32)

    def jmember(nz, c, o):
        return jdec.mlp_decomposed_apply(jmod, _to_jax(shared), nz, c, o)

    want = jax.vmap(jax.vmap(jmember, in_axes=(None, None, 0)))(
        _to_jax(stacked), jnp.asarray(scale), jnp.asarray(obs))
    got = tdec.mlp_decomposed_population_apply(
        tmod, _to_torch(shared), _to_torch(stacked), torch.from_numpy(scale),
        torch.from_numpy(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
