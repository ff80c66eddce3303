"""The arithmetic the port's update-reduction kernel rests on, on the CPU.

``weighted_noise_sum``'s CUDA kernel (``estorch_tpu_torch/ops/csrc/
noise_kernels.cu``) sums Σ_k w_k·table[s_k + j] in float64 in its own
order: the rows sorted by clamped start (ties by row index) where they
overlap, else by index; split over the P = R·G row groups of a cluster (R a
block, G blocks; group q takes visiting positions q, q + P, ...); each
block's groups added in order, then the cluster's blocks in rank order.  :func:`emulate_kernel_sum`
repeats that order in float64 here, with :func:`kernel_mapping` the
launcher's rule for R, G and the order.  Its float32 rounding must equal the
plain version's bit for bit (a float32 product is exact in float64, so any
order rounds alike but at a tie), and JAX's Pallas kernel's in interpret
mode wherever float32 itself sums exactly (dyadic inputs with few bits; on
Gaussian inputs JAX's float32 accumulator is held within its tolerance).

``tests/test_torch_cuda.py`` holds the card's kernel to this emulation bit
for bit in float64, so what is shown here is what the card computes.  This
module imports JAX only inside the tests that compare with it.
"""

import numpy as np
import pytest
import torch

import estorch_tpu_torch.ops.noise_kernels as nk

# the launcher's constants (noise_kernels.cu: kSumWarps, kSumCols,
# kTargetBlocks, kMaxCluster, kSortRows, kL2Floats, kSortOverlap, and
# kNominalSMs * kSumBlocksPerSM)
WARPS, COLS, TARGET_BLOCKS, MAX_CLUSTER, SORT_ROWS = 8, 4, 264, 8, 8192
L2_FLOATS, SORT_OVERLAP, RESIDENT_BLOCKS = (50 << 20) // 4, 4, 132 * 4


def kernel_mapping(n: int, dim: int, table_size: int) -> tuple[int, int, int, bool]:
    """(C columns a lane, R row groups a block, G blocks a window, rows
    sorted): the launcher's ``sum_mapping``."""
    def windows(c, r):
        return -(-dim // (32 * c * (WARPS // r)))

    sorted_rows = (2 <= n <= SORT_ROWS and table_size > L2_FLOATS
                   and n * dim >= SORT_OVERLAP * table_size)
    c, r, g = COLS, WARPS, 1
    while c > 1 and 32 * c > dim:
        c //= 2
    while g < MAX_CLUSTER and windows(c, r) * g < TARGET_BLOCKS and g * r < n:
        g *= 2
    if g > 1:
        return c, r, g, sorted_rows
    for r1 in (8, 4, 2, 1):  # the largest R whose windows take one round
        if windows(c, r1) <= RESIDENT_BLOCKS:
            return c, r1, g, sorted_rows
    while r > 1 and n // r < 32 and windows(c, r // 2) >= TARGET_BLOCKS:
        r //= 2
    return c, r, g, sorted_rows


def clamped_starts(offsets: np.ndarray, table_size: int, dim: int) -> np.ndarray:
    """``jax.lax.dynamic_slice``'s start: negative counts from the end, then
    clamped to [0, table_size - dim]."""
    s = offsets.astype(np.int64)
    s = np.where(s < 0, s + table_size, s)
    return np.clip(s, 0, table_size - dim)


def visiting_order(starts: np.ndarray, sorted_rows: bool) -> np.ndarray:
    n = starts.shape[0]
    return np.lexsort((np.arange(n), starts)) if sorted_rows else np.arange(n)


def emulate_kernel_sum(table: np.ndarray, offsets: np.ndarray, weights: np.ndarray,
                       dim: int) -> torch.Tensor:
    """The kernel's float64 sum, in its order, as a (dim,) float64 tensor
    (a few columns at a time: each column's sum is its own)."""
    n = offsets.shape[0]
    _, r, g, sorted_rows = kernel_mapping(n, dim, table.shape[0])
    starts = clamped_starts(offsets, table.shape[0], dim)
    order = visiting_order(starts, sorted_rows)
    t = torch.from_numpy(table)
    w = torch.from_numpy(weights[order]).double()[:, None]
    row0 = torch.from_numpy(starts[order])[:, None]
    p = r * g  # row groups of a cluster: group q takes positions q, q + p, ...
    out = torch.empty(dim, dtype=torch.float64)
    chunk = max(1, (1 << 21) // n)
    for c0 in range(0, dim, chunk):
        cols = torch.arange(c0, min(c0 + chunk, dim))
        terms = w * t[row0 + cols[None, :]].double()  # exact products
        acc = torch.zeros((p, cols.shape[0]), dtype=torch.float64)
        for first in range(0, n, p):  # each group adds its next row, in turn
            rows = terms[first:first + p]
            acc[:rows.shape[0]] += rows
        blocks = []
        for b in range(g):  # a block's row groups in order
            v = acc[b * r].clone()
            for k in range(1, r):
                v += acc[b * r + k]
            blocks.append(v)
        total = blocks[0]
        for v in blocks[1:]:  # the cluster's blocks in rank order
            total = total + v
        out[c0:c0 + cols.shape[0]] = total
    return out


def edge_offsets(rng, n: int, size: int, dim: int) -> np.ndarray:
    """Starts at and past the table's edges: counted from the end, clamped
    to 0 or to size - dim, or in range."""
    edges = np.array([-7, -dim, -size - 100, 0, 3, size - dim, size - dim + 5, size + 99])
    return rng.choice(edges, n)


# kind: (table size, n, dim), and the mapping each takes (C, R, G, sorted).
# The kernel sorts only where the table is larger than L2 and each of its
# floats meets 4 rows on average, so the sorted kinds read a 2^24 table.
BIG = 1 << 24
CASES = {
    "overlap, G 8": ((BIG, 8100, 8300), (4, 8, 8, True)),
    "overlap, G 2": ((BIG, 2048, 33_000), (4, 8, 2, True)),
    "overlap, G 1": ((BIG, 1000, 67_500), (4, 8, 1, True)),
    "one round, R 2": ((BIG, 300, 230_000), (4, 2, 1, True)),
    "few rows, R 4": ((BIG, 128, 600_000), (4, 4, 1, True)),
    "few rows, R 2": ((BIG, 100, 680_000), (4, 2, 1, True)),
    "few rows, R 1": ((BIG, 20, 3_400_000), (4, 1, 1, True)),
    "equal starts": ((BIG, 4096, 16_400), (4, 8, 4, True)),
    "clamped, sorted": ((BIG, 2048, 33_000), (4, 8, 2, True)),
    "by index, R 4": ((1 << 17, 40, 68_000), (4, 4, 1, False)),
    "no overlap": ((1 << 16, 30, 64), (2, 8, 4, False)),
    "no overlap, G 4": ((1 << 23, 600, 12_800), (4, 8, 4, False)),
    "clamped, by index": ((1 << 16, 50, 129), (4, 8, 8, False)),
    "n = 1": ((1 << 16, 1, 64), (2, 8, 1, False)),
    "n = 65": ((1 << 16, 65, 257), (4, 8, 8, False)),
    "dim = table size": ((4096, 5, 4096), (4, 8, 1, False)),
    "dim under a warp": ((1 << 16, 50, 20), (1, 8, 8, False)),
    "rows over a batch": ((1 << 18, 2100, 64), (2, 8, 8, False)),
    "over the sort limit": ((BIG, 8200, 8300), (4, 8, 8, False)),
}
KINDS = list(CASES)


def make_case(kind: str, seed: int):
    """(table, offsets int32, weights float32, dim) of one kind, from a seed."""
    rng = np.random.default_rng(1000 * seed + sum(map(ord, kind)))
    (size, n, dim), _ = CASES[kind]
    table = rng.standard_normal(size).astype(np.float32)
    if kind.startswith("clamped"):
        offs = edge_offsets(rng, n, size, dim)
    elif kind == "equal starts":  # a mirrored pair's two member rows share their offset
        offs = np.repeat(rng.integers(0, size - dim + 1, n // 2), 2)
    else:
        offs = rng.integers(0, size - dim + 1, n)
    w = rng.uniform(-1, 1, n).astype(np.float32)
    return table, offs.astype(np.int32), w, dim


@pytest.mark.parametrize("kind", KINDS)
def test_case_takes_its_mapping(kind):
    (size, n, dim), want = CASES[kind]
    assert kernel_mapping(n, dim, size) == want


def test_cases_take_every_path():
    maps = [want for _, want in CASES.values()]
    assert {c for c, _, _, _ in maps} == {1, 2, 4}
    assert {r for _, r, _, _ in maps} == {1, 2, 4, 8}
    assert {g for _, _, g, _ in maps} == {1, 2, 4, 8}
    assert {s for _, _, _, s in maps} == {True, False}


@pytest.mark.parametrize("n,dim,table_size,want", [
    # chip_smoke.py phase 2's shapes: the cell, (g), (i), pong84, (m), (z), (n)
    (2048, 4481, 1 << 25, (4, 8, 8, False)),
    (512, 5702, 1 << 25, (4, 8, 8, False)),
    (2048, 166_673, 1 << 25, (4, 2, 1, True)),
    (128, 1_685_987, 1 << 23, (4, 4, 1, False)),
    (500, 4737, 1 << 25, (4, 8, 8, False)),
    (1000, 4737, 1 << 25, (4, 8, 8, False)),
    (2048, 25_153, 1 << 25, (4, 8, 2, False)),
    (1, 8, 1 << 20, (1, 8, 1, False)),
])
def test_mapping_at_the_port_shapes(n, dim, table_size, want):
    assert kernel_mapping(n, dim, table_size) == want


def test_visiting_order_is_by_clamped_start_then_index():
    starts = np.array([5, 3, 5, 0, 3, 9, 5])
    assert visiting_order(starts, True).tolist() == [3, 1, 4, 0, 2, 6, 5]
    assert visiting_order(starts, False).tolist() == list(range(7))


def seeded(kinds):
    """Three seeds a kind, one for the kinds of over 10^7 products."""
    return [pytest.param(k, seed, id=f"{k}-{seed}") for k in kinds
            for seed in ((0,) if CASES[k][0][1] * CASES[k][0][2] > 10**7 else (0, 1, 2))]


@pytest.mark.parametrize("kind,seed", seeded(KINDS))
def test_emulation_rounds_to_the_plain_version_bit_for_bit(kind, seed):
    table, offs, w, dim = make_case(kind, seed)
    got64 = emulate_kernel_sum(table, offs, w, dim)
    args = (torch.from_numpy(table), torch.from_numpy(offs), torch.from_numpy(w), dim)
    want = nk.weighted_noise_sum_plain(*args)
    want64 = nk.weighted_noise_sum_plain(*args, out_dtype=torch.float64)
    assert torch.equal(got64.float().view(torch.int32), want.view(torch.int32))
    # float64 sums of exact products in two orders: a few float64 ulps apart
    scale = float(want64.abs().max()) + 1.0
    assert float((got64 - want64).abs().max()) <= 1e-12 * scale


def exact_case(kind: str, seed: int):
    """``make_case``'s offsets with dyadic values of few bits: table k/8,
    |k| <= 64, weights k/4, |k| <= 4.  Every product and partial sum (at
    most 65 rows of magnitude <= 8, in steps of 2^-5) is then a float32, so
    float32 sums (JAX's) are exact in any order."""
    table, offs, w, dim = make_case(kind, seed)
    rng = np.random.default_rng(seed)
    table = (rng.integers(-64, 65, table.shape[0]) / 8).astype(np.float32)
    w = (rng.integers(-4, 5, w.shape[0]) / 4).astype(np.float32)
    return table, offs, w, dim


JAX_KINDS = ["few rows, R 1", "by index, R 4", "no overlap", "clamped, by index", "n = 1",
             "n = 65", "dim = table size", "dim under a warp"]


def jax_sum(table, offs, w, dim) -> np.ndarray:
    import jax.numpy as jnp

    from estorch_tpu.ops import pallas_noise as jpn

    return np.asarray(jpn.weighted_noise_sum(jnp.asarray(table), jnp.asarray(offs),
                                             jnp.asarray(w), dim=dim, interpret=True))


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_emulation_equals_jax_interpret_bit_for_bit_on_exact_inputs(kind):
    table, offs, w, dim = exact_case(kind, 0)
    got = emulate_kernel_sum(table, offs, w, dim).float().numpy()
    want = jax_sum(table, offs, w, dim)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("kind", ["few rows, R 1", "no overlap", "clamped, by index", "n = 1"])
def test_emulation_within_float32_tolerance_of_jax_interpret(kind):
    # JAX's kernel carries a float32 accumulator (over up to 50 rows here):
    # a float64 sum rounded once is held to it as
    # tests/test_torch_noise_kernels.py holds the plain version
    table, offs, w, dim = make_case(kind, 1)
    got = emulate_kernel_sum(table, offs, w, dim).float().numpy()
    np.testing.assert_allclose(got, jax_sum(table, offs, w, dim), rtol=1e-5, atol=1e-5)
