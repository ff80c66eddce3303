"""The port's CUDA kernels on a card, against their plain versions.

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


@pytest.mark.parametrize("n,d,h", [(4, 8, 16), (6, 17, 5), (16, 32, 32), (3, 64, 7),
                                   (4096, 3, 64), (4096, 64, 64), (4096, 64, 1), (5, 300, 200)])
def test_population_noise_matvec_matches_plain(table, cuda, n, d, h):
    rng = np.random.default_rng(n + 10 * d + 100 * h)
    offs = torch.from_numpy(rng.integers(0, table.numel() - d * h - 64, n).astype(np.int32))
    c = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    offs, c, x = offs.to(cuda), c.to(cuda), x.to(cuda)
    got = nk.population_noise_matvec(table, offs, c, x, 32, d, h)
    torch.cuda.synchronize()
    want = nk.population_noise_matvec_plain(table, offs, c, x, 32, d, h)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


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
