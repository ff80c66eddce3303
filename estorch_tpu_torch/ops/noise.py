"""Shared noise table and antithetic (mirrored) perturbation sampling.

Counterpart of ``estorch_tpu/ops/noise.py``.  One float32 Gaussian table
lives on the device and every member's noise is a slice of it, addressed
by an integer offset.  Random draws come from explicit
``torch.Generator``s: the port's table and offsets are a different stream
from JAX's threefry ones, so tests hand both packages the same numbers
(``NoiseTable.from_numpy``) instead of expecting equal draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_TABLE_SIZE = 1 << 25  # 32M floats = 128 MiB of device memory


@dataclasses.dataclass(frozen=True)
class NoiseTable:
    """An immutable shared Gaussian noise table."""

    data: torch.Tensor  # (size,) float32, ~N(0, 1)
    seed: int | None
    size: int

    def slice(self, offset: int, dim: int) -> torch.Tensor:
        """Noise vector of length ``dim`` starting at ``offset``.

        Out-of-range offsets follow ``jax.lax.dynamic_slice``, which the JAX
        package slices with: a negative offset counts from the end, then
        the start is clamped to ``[0, size - dim]``.  Offsets are kept in
        range where they are sampled.
        """
        start = int(offset)
        start = start + self.size if start < 0 else start
        start = min(max(start, 0), self.size - dim)
        return self.data[start:start + dim]

    @classmethod
    def from_numpy(cls, array, seed: int | None = None,
                   device: str | torch.device = "cpu") -> "NoiseTable":
        """A table holding a copy of a (size,) array, e.g. the JAX package's."""
        data = torch.from_numpy(np.array(array, np.float32)).to(device)
        if data.ndim != 1:
            raise ValueError(f"noise table must be 1-D, got shape {tuple(data.shape)}")
        return cls(data=data.contiguous(), seed=seed, size=int(data.shape[0]))


def make_noise_table(size: int = DEFAULT_TABLE_SIZE, seed: int = 0,
                     device: str | torch.device | None = None) -> NoiseTable:
    """Build the shared table once, deterministically from ``seed``.

    Drawn on the CPU from ``torch.Generator().manual_seed(seed)`` and then
    moved, so every device holds the same table for one ``(size, seed)``.
    This is not the JAX package's table: the two generators differ.
    """
    from ..utils.backend import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    data = torch.randn((size,), generator=gen, dtype=torch.float32)
    return NoiseTable(data=data.to(dev), seed=seed, size=size)


# scenario parameter streams (``scenarios/distribution.py``): a seed of
# their own, salted as the JAX package salts its scenario key, so a user who
# gives ES and the distribution one seed integer still gets disjoint streams
SCENARIO_STREAM_SALT = 0x5CE7A2


def scenario_variant_seed(seed: int, variant: int) -> int:
    """The generator seed of variant ``variant``'s scenario draws: a hash
    of ``(seed, salt, variant)`` (``np.random.SeedSequence``, as the
    engine's ``_seed_of`` derives its streams), deterministic in ``(seed,
    variant)`` alone."""
    return int(np.random.SeedSequence(
        [int(seed), SCENARIO_STREAM_SALT, int(variant)]).generate_state(
            1, np.uint64)[0] >> np.uint64(1))


def scenario_variant_generator(seed: int, variant: int) -> torch.Generator:
    """THE ``(seed, variant)`` stream of scenario-parameter draws: a CPU
    generator, so every device draws the same constants."""
    return torch.Generator().manual_seed(scenario_variant_seed(seed, variant))


def sample_pair_offsets(generator: torch.Generator, n_pairs: int,
                        table_size: int, dim: int) -> torch.Tensor:
    """Uniform int32 offsets for ``n_pairs`` rows, each in [0, size - dim]."""
    if dim > table_size:
        raise ValueError(
            f"parameter dim {dim} exceeds noise table size {table_size}; "
            "grow the table (table_size) to at least a few times dim"
        )
    return torch.randint(0, table_size - dim + 1, (n_pairs,),
                         generator=generator, dtype=torch.int32,
                         device=generator.device)


def pair_signs(population_size: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Signs (+1, -1, +1, -1, ...): member 2k is θ + σε_k, member 2k+1 is θ − σε_k."""
    if population_size % 2 != 0:
        raise ValueError(f"mirrored sampling needs an even population, got {population_size}")
    signs = torch.ones((population_size,), dtype=torch.float32, device=device)
    signs[1::2] = -1.0
    return signs


def member_offsets(pair_offsets: torch.Tensor) -> torch.Tensor:
    """Expand per-pair offsets to per-member offsets: (n_pairs,) → (2·n_pairs,)."""
    return torch.repeat_interleave(pair_offsets, 2)


def gather_rows(table_data: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """(n, length) rows ``table[s : s + length]``, out-of-range starts
    handled as in :meth:`NoiseTable.slice`.  The rows are indexed out of
    the table's overlapping window view, so no (n, length) index is built."""
    size = table_data.shape[0]
    starts = starts.to(torch.int64)
    starts = torch.where(starts < 0, starts + size, starts).clamp(0, size - length)
    return table_data.unfold(0, length, 1)[starts]


def member_noise(table: NoiseTable, offsets: torch.Tensor, signs: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """Materialize signed noise rows for a batch of members: (n, dim).

    For small batches (tests); the engine never materializes the
    population's noise.
    """
    return gather_rows(table.data, offsets, dim) * signs[:, None]


# ---------------------------------------------------------------------------
# program noise (the param-sharded engine, parallel/sharded.py)
# ---------------------------------------------------------------------------
#
# ε generated where it is used, keyed on (seed, generation, leaf, row) and
# addressed by element: the value of element e of leaf i in noise row r
# depends on (seed, generation, i, r, e) alone, so a rank generates exactly
# its shard and every mesh shape gets the same bits.  The generator is
# Threefry-2x32 with 20 rounds (Salmon et al. 2011, the counter-based
# generator JAX uses) in int64 torch ops on 32-bit words: the key is the
# leaf's, the counter (row, element); its two output words give the two
# uniforms of one Box–Muller normal, formed in float64 and rounded once.
# The stream is the port's own (ROADMAP F24): JAX's program noise comes from
# jax.random.normal, whose bits the tests hand over instead.

_MASK32 = 0xFFFFFFFF
_THREEFRY_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_THREEFRY_PARITY = 0x1BD11BDA
PROGRAM_STREAM_SALT = 0x9E3779B9  # the generation key's second counter word
_LEAF_SALT = 0x7F4A7C15
_FACTOR_SALT = 0x94D049BB


def threefry2x32_(key: tuple, x0: torch.Tensor, x1: torch.Tensor) -> None:
    """Threefry-2x32-20 of the counter words ``(x0, x1)`` under ``key``
    ``(k0, k1)``, in place on two int64 tensors of 32-bit words (one
    temporary), so a block's generator holds three word tensors at a time."""
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0.add_(ks[0]).bitwise_and_(_MASK32)
    x1.add_(ks[1]).bitwise_and_(_MASK32)
    t = torch.empty_like(x1)
    for i in range(20):
        r = _THREEFRY_ROT[i % 8]
        x0.add_(x1).bitwise_and_(_MASK32)
        torch.bitwise_left_shift(x1, r, out=t)
        x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_and_(_MASK32)
        x1.bitwise_xor_(x0)
        if i % 4 == 3:
            j = i // 4 + 1
            x0.add_(ks[j % 3]).bitwise_and_(_MASK32)
            x1.add_(ks[(j + 1) % 3] + j).bitwise_and_(_MASK32)


def threefry2x32(key: tuple, x0: int, x1: int) -> tuple[int, int]:
    """:func:`threefry2x32_` of one counter ``(x0, x1)``, as Python ints
    (the host-side key derivation)."""
    w0 = torch.tensor([int(x0) & _MASK32], dtype=torch.int64)
    w1 = torch.tensor([int(x1) & _MASK32], dtype=torch.int64)
    threefry2x32_(key, w0, w1)
    return int(w0), int(w1)


def leaf_noise_keys(seed: int, generation: int, n_leaves: int) -> list[tuple[int, int]]:
    """Per-leaf keys of one generation's program noise: leaf ``i`` of the
    param tree (ravel order) draws under key ``i`` of this list."""
    seed = int(seed)
    gen_key = threefry2x32((seed & _MASK32, (seed >> 32) & _MASK32),
                           int(generation) & _MASK32, PROGRAM_STREAM_SALT)
    return [threefry2x32(gen_key, i, _LEAF_SALT) for i in range(int(n_leaves))]


def program_noise(leaf_key: tuple, rows: torch.Tensor, elements: torch.Tensor) -> torch.Tensor:
    """``(len(rows), len(elements))`` float32 standard normals: element
    ``elements[j]`` (a row-major index into the leaf) of noise row
    ``rows[i]`` under ``leaf_key``, on the elements' device."""
    dev = elements.device
    rows = rows.to(dev, torch.int64).reshape(-1, 1)
    elements = elements.to(torch.int64).reshape(1, -1)
    shape = (rows.shape[0], elements.shape[1])
    w0, w1 = rows.expand(shape).clone(), elements.expand(shape).clone()
    threefry2x32_(leaf_key, w0, w1)
    # two uniforms in (0, 1) from the 32-bit words, centred in their cells,
    # then sqrt(-2 ln u1)·cos(2π u2), each step in place
    z = w0.to(torch.float64).add_(0.5).mul_(2.0 ** -32).log_().mul_(-2.0).sqrt_()
    del w0
    z.mul_(w1.to(torch.float64).add_(0.5).mul_(2.0 ** -32).mul_(2.0 * np.pi).cos_())
    return z.to(torch.float32)


def factor_keys(leaf_key: tuple) -> tuple[tuple[int, int], tuple[int, int]]:
    """The keys of a low-rank leaf's two factors (A, then B)."""
    return (threefry2x32(leaf_key, 0, _FACTOR_SALT), threefry2x32(leaf_key, 1, _FACTOR_SALT))
