"""The port's plain ops against the JAX package, on the same numpy inputs.

Layout (ParamSpec), noise-table slicing, ranking, the update reduction
and Adam.  JAX runs on the CPU (tests/conftest.py); the port on torch's
CPU.  Inputs are made from a seed with numpy and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

import estorch_tpu.ops as jops
import estorch_tpu_torch.ops as tops
from estorch_tpu_torch import interop
from estorch_tpu_torch.optim import adam

RNG_SEED = 1234


def _tree(rng, spec):
    """Nested dict of float32 numpy arrays from {name: {leaf: shape}}."""
    return {layer: {leaf: rng.standard_normal(shape).astype(np.float32)
                    for leaf, shape in leaves.items()}
            for layer, leaves in spec.items()}


TREES = {
    "mlp_8x8": {"dense_0": {"kernel": (3, 8), "bias": (8,)},
                "dense_1": {"kernel": (8, 8), "bias": (8,)},
                "head": {"kernel": (8, 1), "bias": (1,)}},
    # string order puts dense_10 before dense_2, and head last
    "dense_10_before_dense_2": {
        f"dense_{i}": {"kernel": (2, 2), "bias": (2,)} for i in range(12)
    } | {"head": {"kernel": (2, 3), "bias": (3,)}},
    "mixed_depth": {"b": {"z": (4,), "a": (2, 3)}, "a": {"k": (5,)}},
}


class TestParamLayout:
    @pytest.mark.parametrize("name", sorted(TREES))
    def test_flat_layout_matches_ravel_pytree(self, name):
        tree = _tree(np.random.default_rng(RNG_SEED), TREES[name])
        want, _ = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, tree))
        got, spec = tops.make_param_spec(
            jax.tree_util.tree_map(torch.from_numpy, tree))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert spec.dim == want.shape[0]

    def test_dense_10_sorts_before_dense_2(self):
        tree = _tree(np.random.default_rng(0), TREES["dense_10_before_dense_2"])
        _, spec = tops.make_param_spec(jax.tree_util.tree_map(torch.from_numpy, tree))
        layers = [p[0] for p in spec.paths]
        assert layers.index("dense_10") < layers.index("dense_2")
        assert spec.paths[0] == ("dense_0", "bias")  # bias before kernel

    def test_unravel_roundtrip_and_views(self):
        tree = _tree(np.random.default_rng(1), TREES["mlp_8x8"])
        flat, spec = tops.make_param_spec(jax.tree_util.tree_map(torch.from_numpy, tree))
        back = spec.unravel(flat)
        for layer in tree:
            for leaf in tree[layer]:
                np.testing.assert_array_equal(back[layer][leaf].numpy(), tree[layer][leaf])
        back["head"]["bias"].fill_(7.0)  # a view: writes reach the flat vector
        assert float(flat[spec.offsets[spec.paths.index(("head", "bias"))]]) == 7.0

    def test_params_from_jax_roundtrip(self):
        tree = _tree(np.random.default_rng(2), TREES["mlp_8x8"])
        jflat, unravel = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, tree))
        flat, params = interop.params_from_jax(tree)
        np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
        # the flat form with the spec gives the same dict
        _, spec = tops.make_param_spec(jax.tree_util.tree_map(torch.from_numpy, tree))
        flat2, params2 = interop.params_from_jax(np.asarray(jflat), spec)
        torch.testing.assert_close(flat2, flat)
        for layer, leaves in unravel(jflat).items():
            for leaf, value in leaves.items():
                np.testing.assert_array_equal(params2[layer][leaf].numpy(), np.asarray(value))
                np.testing.assert_array_equal(params[layer][leaf].numpy(), np.asarray(value))

    def test_params_from_flat_needs_spec(self):
        with pytest.raises(ValueError, match="spec"):
            interop.params_from_jax(np.zeros(4, np.float32))


SIZE = 1 << 12
TABLE_NP = np.random.default_rng(7).standard_normal(SIZE).astype(np.float32)
JTABLE = jops.NoiseTable(data=jnp.asarray(TABLE_NP), seed=0, size=SIZE)
TTABLE = interop.table_from_numpy(TABLE_NP)


class TestNoiseTable:
    @pytest.mark.parametrize("offset", [-5, 0, 17, SIZE - 40, SIZE - 33, SIZE + 100])
    def test_slice_clamps_like_dynamic_slice(self, offset):
        dim = 40
        want = np.asarray(JTABLE.slice(jnp.int32(offset), dim))
        np.testing.assert_array_equal(TTABLE.slice(offset, dim).numpy(), want)

    def test_member_noise_matches_jax(self):
        rng = np.random.default_rng(3)
        offs = rng.integers(0, SIZE - 50, 6).astype(np.int32)
        signs = np.array([1, -1, 1, -1, 1, -1], np.float32)
        want = jops.member_noise(JTABLE, jnp.asarray(offs), jnp.asarray(signs), 50)
        got = tops.member_noise(TTABLE, torch.from_numpy(offs), torch.from_numpy(signs), 50)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_signs_and_member_offsets_match_jax(self):
        np.testing.assert_array_equal(tops.pair_signs(8).numpy(), np.asarray(jops.pair_signs(8)))
        offs = np.array([3, 9, 27], np.int32)
        np.testing.assert_array_equal(
            tops.member_offsets(torch.from_numpy(offs)).numpy(),
            np.asarray(jops.member_offsets(jnp.asarray(offs))))
        with pytest.raises(ValueError, match="even"):
            tops.pair_signs(5)

    def test_sample_pair_offsets_in_range_and_seeded(self):
        g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
        a = tops.sample_pair_offsets(g1, 1000, table_size=100, dim=90)
        b = tops.sample_pair_offsets(g2, 1000, table_size=100, dim=90)
        assert a.dtype == torch.int32
        assert int(a.min()) == 0 and int(a.max()) == 10
        torch.testing.assert_close(a, b)
        with pytest.raises(ValueError, match="exceeds"):
            tops.sample_pair_offsets(g1, 2, table_size=10, dim=11)

    def test_make_noise_table_deterministic(self):
        a = tops.make_noise_table(1 << 12, seed=3, device="cpu")
        b = tops.make_noise_table(1 << 12, seed=3, device="cpu")
        torch.testing.assert_close(a.data, b.data)
        assert a.size == 1 << 12 and a.data.dtype == torch.float32
        assert abs(float(a.data.mean())) < 0.1 and abs(float(a.data.std()) - 1) < 0.1


RANK_CASES = {
    "random": np.random.default_rng(11).standard_normal(33).astype(np.float32),
    "ties": np.array([1, 3, 3, 0, 1, 1, 2, 3], np.float32),
    "nan_inf_ties": np.array([2, np.nan, -np.inf, 2, 5, np.inf, -1, 2], np.float32),
    "one_valid": np.array([np.nan, 1.0, np.inf, np.nan], np.float32),
    "all_invalid": np.array([np.nan, np.nan, np.inf], np.float32),
    "single": np.array([3.0], np.float32),
    "all_equal": np.full(6, 4.0, np.float32),
}


class TestRanks:
    @pytest.mark.parametrize("case", sorted(RANK_CASES))
    def test_centered_rank_safe_matches_jax(self, case):
        x = RANK_CASES[case]
        jw, jn = jops.centered_rank_safe(jnp.asarray(x))
        tw, tn = tops.centered_rank_safe(torch.from_numpy(x))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert int(tn) == int(jn)

    @pytest.mark.parametrize("case", ["random", "ties", "all_equal"])
    def test_centered_rank_and_compute_ranks_match_jax(self, case):
        x = RANK_CASES[case]
        np.testing.assert_array_equal(
            tops.compute_ranks(torch.from_numpy(x)).numpy(),
            np.asarray(jops.compute_ranks(jnp.asarray(x))))
        np.testing.assert_array_equal(
            tops.centered_rank(torch.from_numpy(x)).numpy(),
            np.asarray(jops.centered_rank(jnp.asarray(x))))


class TestGradient:
    # n > 256 crosses the chunked path of both packages
    @pytest.mark.parametrize("n,dim", [(1, 8), (5, 33), (300, 64), (513, 17)])
    def test_rank_weighted_noise_sum_matches_jax(self, n, dim):
        rng = np.random.default_rng(n * 7 + dim)
        offs = rng.integers(0, SIZE - dim + 1, n).astype(np.int32)
        w = rng.standard_normal(n).astype(np.float32)
        want = jops.rank_weighted_noise_sum(JTABLE, jnp.asarray(offs), jnp.asarray(w), dim=dim)
        got = tops.rank_weighted_noise_sum(TTABLE, torch.from_numpy(offs), torch.from_numpy(w),
                                           dim=dim)
        # f32 sums taken in another order
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_fold_mirrored_weights_matches_jax(self):
        w = np.random.default_rng(4).standard_normal(10).astype(np.float32)
        np.testing.assert_array_equal(
            tops.fold_mirrored_weights(torch.from_numpy(w)).numpy(),
            np.asarray(jops.fold_mirrored_weights(jnp.asarray(w))))

    def test_es_gradient_matches_jax(self):
        rng = np.random.default_rng(5)
        n_pairs, dim = 12, 29
        offs = rng.integers(0, SIZE - dim + 1, n_pairs).astype(np.int32)
        w = rng.standard_normal(2 * n_pairs).astype(np.float32)
        want = jops.es_gradient(JTABLE, jnp.asarray(offs), jnp.asarray(w), sigma=0.05,
                                population_size=2 * n_pairs, dim=dim)
        got = tops.es_gradient(TTABLE, torch.from_numpy(offs), torch.from_numpy(w),
                               sigma=0.05, population_size=2 * n_pairs, dim=dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_adam_matches_optax():
    """Five steps of the port's Adam against optax.adam (eps outside the
    sqrt, bias-corrected), float32."""
    rng = np.random.default_rng(6)
    p0 = rng.standard_normal(50).astype(np.float32)
    grads = [rng.standard_normal(50).astype(np.float32) * s for s in (1, 1e-3, 10, 0, 1)]
    jopt = optax.adam(1e-2)
    jp, js = jnp.asarray(p0), jopt.init(jnp.asarray(p0))
    topt = adam(1e-2)
    tp = torch.from_numpy(p0.copy())
    ts = topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(torch.from_numpy(g), ts)
        tp = tp + tu
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
