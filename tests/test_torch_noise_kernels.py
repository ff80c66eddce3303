"""The port's streamed-noise functions against the JAX Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels run only on a card: tests/test_torch_cuda.py and chip_smoke.py);
the JAX kernels run in interpret mode, as tests/test_pallas_noise.py runs
them.  Shapes are the ones that file uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import estorch_tpu_torch.ops.noise_kernels as nk
from estorch_tpu.models import MLPPolicy as JMLPPolicy
from estorch_tpu.ops import make_param_spec as jmake_param_spec
from estorch_tpu.ops import pallas_noise as jpn
from estorch_tpu_torch import MLPPolicy, interop
from estorch_tpu_torch.models.decomposed import mlp_decomposed_apply
from estorch_tpu_torch.ops.params import make_param_spec

SIZE = 1 << 16
TABLE_NP = np.random.default_rng(3).standard_normal(SIZE).astype(np.float32)
JDATA = jnp.asarray(TABLE_NP)
TDATA = torch.from_numpy(TABLE_NP)


class TestWeightedNoiseSum:
    @pytest.mark.parametrize("n,dim", [(1, 8), (7, 33), (64, 128), (33, 257)])
    def test_plain_matches_pallas_interpret(self, n, dim):
        rng = np.random.default_rng(n * 1000 + dim)
        offs = rng.integers(0, SIZE - dim, n).astype(np.int32)
        w = rng.standard_normal(n).astype(np.float32)
        want = jpn.weighted_noise_sum(JDATA, jnp.asarray(offs), jnp.asarray(w), dim=dim,
                                      interpret=True)
        got = nk.weighted_noise_sum(TDATA, torch.from_numpy(offs), torch.from_numpy(w), dim)
        # a float64 sum rounded once against the Pallas kernel's float32 sum
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("n,dim", [(33, 257), (64, 4481), (500, 4737)])
    def test_sum_does_not_depend_on_row_order(self, n, dim):
        # the sum is carried in float64 and rounded once, so the card's
        # kernel (another order) and the CPU give the same float32 vector;
        # a float32 accumulator fails this at every shape here
        rng = np.random.default_rng(n * 1000 + dim)
        offs = torch.from_numpy(rng.integers(0, SIZE - dim, n).astype(np.int32))
        w = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        perm = torch.from_numpy(rng.permutation(n))
        got = nk.weighted_noise_sum(TDATA, offs[perm], w[perm], dim)
        assert torch.equal(got, nk.weighted_noise_sum(TDATA, offs, w, dim))

    def test_zero_weights_zero_sum(self):
        got = nk.weighted_noise_sum(TDATA, torch.tensor([5, 10, 15], dtype=torch.int32),
                                    torch.zeros(3), 16)
        np.testing.assert_array_equal(got.numpy(), np.zeros(16, np.float32))

    def test_single_row_is_scaled_slice(self):
        got = nk.weighted_noise_sum(TDATA, torch.tensor([42], dtype=torch.int32),
                                    torch.tensor([2.5]), 64)
        np.testing.assert_allclose(got.numpy(), 2.5 * TABLE_NP[42:106], rtol=1e-6)

    def test_empty_input(self):
        want = jpn.weighted_noise_sum(JDATA, jnp.zeros((0,), jnp.int32), jnp.zeros((0,)),
                                      dim=8, interpret=True)
        got = nk.weighted_noise_sum(TDATA, torch.zeros(0, dtype=torch.int32),
                                    torch.zeros(0), 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestPopulationNoiseMatvec:
    @pytest.mark.parametrize("n,d,h,mirrored", [
        *(pytest.param(n, d, h, False, id=f"{n}-{d}-{h}")
          for n, d, h in [(4, 8, 16), (6, 17, 5), (16, 32, 32), (3, 64, 7)]),
        # the main path's layers (Pendulum MLP64x64, the CartPole head) as the
        # engine feeds them: mirrored pairs share an offset, c = σ·(+1, −1, …);
        # and an odd n, whose last member is alone
        *(pytest.param(n, d, h, True, id=f"{n}-{d}-{h}-mirrored")
          for n, d, h in [(6, 3, 64), (6, 64, 64), (6, 64, 1), (6, 64, 2), (7, 64, 64)]),
    ])
    def test_plain_matches_pallas_interpret(self, n, d, h, mirrored):
        rng = np.random.default_rng(n + 10 * d + 100 * h)
        if mirrored:
            offs = np.repeat(rng.integers(0, SIZE - d * h - 64, (n + 1) // 2), 2)[:n]
            offs = offs.astype(np.int32)
            c = (0.05 * np.resize([1.0, -1.0], n)).astype(np.float32)
        else:
            offs = rng.integers(0, SIZE - d * h - 64, n).astype(np.int32)
            c = rng.standard_normal(n).astype(np.float32)
        x = rng.standard_normal((n, d)).astype(np.float32)
        want = jpn.population_noise_matvec(JDATA, jnp.asarray(offs), jnp.asarray(c),
                                           jnp.asarray(x), layer_offset=32, d=d, h=h,
                                           interpret=True)
        got = nk.population_noise_matvec(TDATA, torch.from_numpy(offs), torch.from_numpy(c),
                                         torch.from_numpy(x), 32, d, h)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    def test_cpu_wrapper_launches_no_kernel(self):
        nk.reset_launch_counts()
        x = torch.ones(2, 4)
        nk.population_noise_matvec(TDATA, torch.zeros(2, dtype=torch.int32), torch.ones(2),
                                   x, 0, 4, 3)
        nk.weighted_noise_sum(TDATA, torch.zeros(2, dtype=torch.int32), torch.ones(2), 4)
        assert nk.launch_counts == {"weighted_noise_sum": 0, "population_noise_matvec": 0}


def _mlp_setup(n=6, obs_dim=5, hidden=(8, 8), act=3):
    """The JAX MLP's params (flax init) and numpy member inputs."""
    jmodule = JMLPPolicy(action_dim=act, hidden=hidden, discrete=False)
    jparams = jmodule.init(jax.random.PRNGKey(0), jnp.zeros(obs_dim))["params"]
    _, jspec = jmake_param_spec(jparams)
    rng = np.random.default_rng(9)
    offs = rng.integers(0, SIZE - jspec.dim, n).astype(np.int32)
    c = (0.1 * rng.standard_normal(n)).astype(np.float32)
    obs = rng.standard_normal((n, obs_dim)).astype(np.float32)
    tmodule = MLPPolicy(action_dim=act, hidden=hidden, discrete=False)
    return jmodule, jparams, jspec, tmodule, offs, c, obs


class TestStreamedMLPForward:
    @pytest.mark.parametrize("hidden", [(8, 8), (16,)])
    def test_matches_jax_streamed_apply(self, hidden):
        jmodule, jparams, _, tmodule, offs, c, obs = _mlp_setup(hidden=hidden)
        want = jpn.mlp_streamed_apply(jmodule, jparams, JDATA, jnp.asarray(offs),
                                      jnp.asarray(c), jnp.asarray(obs),
                                      jpn.flat_layer_offsets(jparams), interpret=True)
        _, tparams = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
        got = nk.mlp_streamed_apply(tmodule, tparams, TDATA, torch.from_numpy(offs),
                                    torch.from_numpy(c), torch.from_numpy(obs),
                                    nk.flat_layer_offsets(tparams))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    def test_matches_port_decomposed_apply(self):
        _, jparams, _, tmodule, offs, c, obs = _mlp_setup()
        tflat, tparams = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
        _, spec = make_param_spec(tparams)
        got = nk.mlp_streamed_apply(tmodule, tparams, TDATA, torch.from_numpy(offs),
                                    torch.from_numpy(c), torch.from_numpy(obs),
                                    nk.flat_layer_offsets(tparams))
        for i in range(obs.shape[0]):
            eps = spec.unravel(TDATA[offs[i]:offs[i] + spec.dim])
            want_i = mlp_decomposed_apply(tmodule, tparams, eps, float(c[i]),
                                          torch.from_numpy(obs[i]))
            torch.testing.assert_close(got[i], want_i, rtol=1e-4, atol=1e-5,
                                       msg=f"member {i}")

    def test_matches_perturbed_forward(self):
        """…and the module's own forward with θ + c·ε materialized."""
        _, jparams, _, tmodule, offs, c, obs = _mlp_setup(hidden=(16,))
        tflat, tparams = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
        _, spec = make_param_spec(tparams)
        got = nk.mlp_streamed_apply(tmodule, tparams, TDATA, torch.from_numpy(offs),
                                    torch.from_numpy(c), torch.from_numpy(obs),
                                    nk.flat_layer_offsets(tparams))
        for i in range(obs.shape[0]):
            theta = tflat + float(c[i]) * TDATA[offs[i]:offs[i] + spec.dim]
            want_i = tmodule.apply_params(spec.unravel(theta), torch.from_numpy(obs[i]))
            torch.testing.assert_close(got[i], want_i, rtol=1e-4, atol=1e-5)

    def test_layer_offsets_match_jax(self):
        _, jparams, _, _, _, _, _ = _mlp_setup()
        _, tparams = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
        assert nk.flat_layer_offsets(tparams) == jpn.flat_layer_offsets(jparams)

    def test_module_forward_matches_flax(self):
        jmodule, jparams, _, tmodule, _, _, obs = _mlp_setup()
        tflat, tparams = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
        tmodule.set_params(tflat, make_param_spec(tparams)[1])
        want = jmodule.apply({"params": jparams}, jnp.asarray(obs))
        np.testing.assert_allclose(tmodule(torch.from_numpy(obs)).detach().numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-6)
