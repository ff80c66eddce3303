"""The population mesh: one rank a process, one device a rank.

Counterpart of the population half of ``estorch_tpu/parallel/mesh.py``.
The JAX package lays its population over a 1-D ``jax.sharding.Mesh`` with
the axis ``POP_AXIS``; each device evaluates its shard inside one program
and the update travels through one ``lax.psum``.  Torch has no
``shard_map``: here each rank is a process of its own with one device, and
the engine (``parallel/engine.py``) takes its shard of the population and
meets the other ranks in ``torch.distributed`` collectives.
:class:`PopulationMesh` is that layout: the axis name, the world size,
this rank, this rank's ``torch.device`` and the process group, with the
``devices.size`` count the engine reads, as a JAX mesh's.

The layout is device-major, as in the JAX package: rank r owns noise rows
``[r·k, (r+1)·k)`` of the padded row count (:func:`pairs_per_device`,
:func:`padded_count`), so a gather of the ranks' fitness in rank order is
the global member order.

A collective is an ``all_reduce`` with ``SUM`` and nothing else:
:meth:`PopulationMesh.all_reduce_sum` for the update's partials, and
:meth:`PopulationMesh.gather_rows` for the fitness, whose rank writes its
own rows into a zero-filled global buffer before the sum (exact, since
x + 0 = x).  gloo has no ``all_gather`` of CUDA tensors; this works on gloo
and nccl alike.  A collective that fails or passes the group's timeout
raises :class:`CollectiveError` naming the timeout, never a hang.

``torch.distributed.device_mesh.init_device_mesh`` is not used: it maps
rank r to ``cuda:r % count`` and is not made for two ranks on one card.
The param-sharded layout (``hyperscale_mesh``, the partition rules) is
ROADMAP.md port item 7c and raises.  Nothing here imports torch until a
mesh is built.
"""

from __future__ import annotations

from typing import Sequence

POP_AXIS = "pop"
MODEL_AXIS = "model"

_ITEM_7C = "ROADMAP.md, port queue item: 7c, the param-sharded engine"
LAUNCH_RECIPE = (
    "the port runs one rank a process with one device each: launch N processes "
    "and call estorch_tpu_torch.parallel.multihost.initialize(...) in each, then "
    "ES(..., mesh=multihost.global_population_mesh()) (parallel/multihost.py)")


class CollectiveError(RuntimeError):
    """A population collective that failed or passed its timeout: a dead
    or wedged rank, seen by the survivors as an error, never a hang."""


class _Devices:
    """The mesh's ``devices``: ``size`` ranks along the population axis
    (the count a JAX mesh's device array gives)."""

    def __init__(self, size: int):
        self.size = int(size)


class PopulationMesh:
    """A 1-D population mesh of ``world_size`` ranks seen from ``rank``.

    ``group`` is the ``torch.distributed`` process group (None: the
    default group); a world-1 mesh needs none and runs no collective.
    """

    axis_names = (POP_AXIS,)

    def __init__(self, world_size: int, rank: int, device, group=None,
                 timeout_s: float | None = None, backend: str | None = None):
        import torch

        world_size, rank = int(world_size), int(rank)
        if world_size < 1 or not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} is outside a world of {world_size}")
        self.world_size = world_size
        self.rank = rank
        self.device = torch.device(device)
        self.group = group
        self.timeout_s = timeout_s
        self.backend = backend
        self.devices = _Devices(world_size)

    @property
    def shape(self) -> dict:
        return {POP_AXIS: self.world_size}

    def __repr__(self) -> str:
        return (f"PopulationMesh(world_size={self.world_size}, rank={self.rank}, "
                f"device={str(self.device)!r}, backend={self.backend!r})")

    # ---------------------------------------------------------- collectives

    def all_reduce_sum(self, t):
        """``t`` summed over the ranks, in place (every rank gets the same
        bits: each element is reduced once and handed out).  World 1: ``t``
        itself, no collective."""
        if self.world_size == 1:
            return t
        import torch.distributed as dist

        try:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        except Exception as e:  # noqa: BLE001 — every backend's failure becomes one error
            raise CollectiveError(
                f"population all_reduce on rank {self.rank} of {self.world_size} "
                f"({self.backend}, {t.numel()} x {t.dtype} on {t.device}) failed within the "
                f"group's timeout of {self.timeout_s} s: {e}") from e
        return t

    def gather_rows(self, local, rows_per_rank: int):
        """The ranks' ``local`` row blocks ``(rows_per_rank, ...)`` stacked in
        rank order, on every rank: each writes its block into a zero-filled
        ``(world·rows_per_rank, ...)`` buffer, then one sum.  Exact for
        finite values and NaN alike (only a -0.0 turns into +0.0)."""
        if self.world_size == 1:
            return local
        import torch

        buf = torch.zeros((self.world_size * rows_per_rank,) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        lo = self.rank * rows_per_rank
        buf[lo:lo + rows_per_rank] = local
        return self.all_reduce_sum(buf)

    def local_block(self, x, rows_per_rank: int):
        """This rank's rows ``[rank·k, (rank+1)·k)`` of a global per-row array
        (already padded to ``world·k`` rows)."""
        if self.world_size == 1:
            return x
        lo = self.rank * rows_per_rank
        return x[lo:lo + rows_per_rank]


def _as_device_list(devices) -> list:
    if devices is None:
        return []
    if isinstance(devices, (list, tuple)):
        return list(devices)
    return [devices]


def population_mesh(devices: Sequence | None = None) -> PopulationMesh:
    """The 1-D population mesh.

    Under an initialized ``torch.distributed`` group (``multihost.
    initialize``), the global mesh of every rank, as the JAX package's
    global device list gives; otherwise the world-1 mesh over ``devices``
    (one device, default ``cuda``).  Several devices in one process raise:
    the port runs one rank a process (:data:`LAUNCH_RECIPE`)."""
    devs = _as_device_list(devices)
    if len(devs) > 1:
        raise ValueError(f"population_mesh got {len(devs)} devices in one process; "
                         + LAUNCH_RECIPE)
    from . import multihost

    if multihost.is_initialized():
        return multihost.global_population_mesh(devs[0] if devs else None)
    return single_device_mesh(devs[0] if devs else None)


def single_device_mesh(device=None) -> PopulationMesh:
    """The world-1 mesh over ``device`` (default ``cuda``; a missing card
    raises, as every entry point's default does)."""
    from ..utils.backend import resolve_device

    return PopulationMesh(1, 0, resolve_device(device))


def hyperscale_mesh(pop_shards: int | None = None, model_shards: int | None = None,
                    devices: Sequence | None = None):
    """The 2-D ``(pop, model)`` mesh of the param-sharded engine: not ported."""
    raise NotImplementedError(f"hyperscale_mesh is not ported yet ({_ITEM_7C})")


def match_partition_rules(rules, tree, mesh):
    """The param-sharded engine's partition rules: not ported."""
    raise NotImplementedError(f"match_partition_rules is not ported yet ({_ITEM_7C})")


def partition_rules_to_json(rules):
    raise NotImplementedError(f"partition_rules_to_json is not ported yet ({_ITEM_7C})")


def partition_rules_from_json(data):
    raise NotImplementedError(f"partition_rules_from_json is not ported yet ({_ITEM_7C})")


def pairs_per_device(population_size: int, n_devices: int) -> int:
    """PADDED antithetic pairs each rank owns (ceil division).

    Rank d owns pairs ``[d·k, (d+1)·k)`` and members ``[2·d·k, 2·(d+1)·k)``;
    a pair count that does not divide the ranks is padded up with
    zero-weighted ghost members (``parallel/engine.py``), so any even
    population runs on any world size."""
    if population_size % 2 != 0:
        raise ValueError(f"population_size must be even (mirrored sampling), got {population_size}")
    n_pairs = population_size // 2
    return -(-n_pairs // n_devices)


def padded_count(n: int, n_shards: int) -> int:
    """``n`` rounded up to the next multiple of ``n_shards``."""
    return -(-int(n) // int(n_shards)) * int(n_shards)
