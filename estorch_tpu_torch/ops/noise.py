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
