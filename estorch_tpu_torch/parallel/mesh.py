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
:meth:`PopulationMesh.all_reduce_sum` for the update's float64 partials, and
:meth:`PopulationMesh.gather_rows` for the fitness, whose rank writes its
own rows into a zero-filled global buffer before the sum (exact, since
x + 0 = x).  gloo has no ``all_gather`` of CUDA tensors; this works on gloo
and nccl alike.  A collective that fails or passes the group's timeout
raises :class:`CollectiveError` naming the timeout, never a hang.

``torch.distributed.device_mesh.init_device_mesh`` is not used: it maps
rank r to ``cuda:r % count`` and is not made for two ranks on one card.

The param-sharded half (``parallel/sharded.py``, ROADMAP.md item 7c) is the
JAX package's 2-D ``(pop, model)`` mesh: :class:`HyperscaleMesh` lays the
ranks out row-major (rank = pop_index·model + model_index, JAX's device
order) and holds two process groups, the **model group** (the ranks of its
pop index, which split each sharded leaf between them) and the **pop
group** (the ranks of its model index, which split the population), plus a
second model group for gathers (``params_flat``, the best member) so that a
gather on one thread never interleaves with a generation's collectives on
another.  The regex partition rules (:data:`DEFAULT_PARTITION_RULES`,
:func:`match_partition_rules`, the fmengine/EasyLM idiom) resolve from the
axis sizes alone, to the port's own :class:`P`, whose text is JAX's
``PartitionSpec``'s; their JSON is the JAX package's.  The sharded engine
partitions the forward of ``MLPPolicy`` and ``NatureCNN`` (conv kernels
split on their HWIO output channels) with program or table noise.
Nothing here imports torch until a mesh is built.
"""

from __future__ import annotations

import re
from typing import Any, Sequence

POP_AXIS = "pop"
MODEL_AXIS = "model"

LAUNCH_RECIPE = (
    "the port runs one rank a process with one device each: launch N processes "
    "and call estorch_tpu_torch.parallel.multihost.initialize(...) in each, then "
    "ES(..., mesh=multihost.global_population_mesh()) (parallel/multihost.py), or "
    "mesh=multihost.global_hyperscale_mesh(...) with shard_params=True")


class CollectiveError(RuntimeError):
    """A population collective that failed or passed its timeout: a dead
    or wedged rank, seen by the survivors as an error, never a hang."""


class _Devices:
    """The mesh's ``devices``: ``size`` ranks laid out as ``shape`` (the
    counts a JAX mesh's device array gives)."""

    def __init__(self, size: int, shape: tuple | None = None):
        self.size = int(size)
        self.shape = (self.size,) if shape is None else tuple(int(s) for s in shape)


def _all_reduce(t, group, what: str, rank: int, world: int, backend, timeout_s):
    """``t`` summed over ``group`` in place; a failure or a timeout raises
    :class:`CollectiveError` naming the group's timeout."""
    import torch.distributed as dist

    try:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    except Exception as e:  # noqa: BLE001 — every backend's failure becomes one error
        raise CollectiveError(
            f"{what} all_reduce on rank {rank} of {world} ({backend}, {t.numel()} x "
            f"{t.dtype} on {t.device}) failed within the group's timeout of {timeout_s} s: "
            f"{e}") from e
    return t


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
        return _all_reduce(t, self.group, "population", self.rank, self.world_size,
                           self.backend, self.timeout_s)

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


# ---------------------------------------------------------------------------
# the 2-D (pop, model) mesh of the param-sharded engine
# ---------------------------------------------------------------------------


def hyperscale_shape(pop_shards: int | None, model_shards: int | None, n: int) -> tuple:
    """``(pop, model)`` over ``n`` ranks, as the JAX package resolves it:
    ``model`` spans every rank by default (the most memory saved), ``pop``
    is the co-factor, and both given must multiply to ``n``."""
    if pop_shards is None and model_shards is None:
        pop_shards, model_shards = 1, n
    elif pop_shards is None:
        pop_shards = n // int(model_shards)
    elif model_shards is None:
        model_shards = n // int(pop_shards)
    pop_shards, model_shards = int(pop_shards), int(model_shards)
    if pop_shards * model_shards != n:
        raise ValueError(f"mesh shape ({pop_shards}, {model_shards}) needs "
                         f"{pop_shards * model_shards} devices, got {n}")
    return pop_shards, model_shards


class HyperscaleMesh:
    """A ``(pop, model)`` mesh of ``pop·model`` ranks seen from ``rank``.

    ``groups`` is ``(model_group, gather_group, pop_group)`` (None at world
    1): every rank creates every subgroup, in one order
    (:func:`new_hyperscale_groups`), or gloo hangs.  A collective over an
    axis of size 1 runs nothing."""

    axis_names = (POP_AXIS, MODEL_AXIS)

    def __init__(self, pop_shards: int, model_shards: int, rank: int, device,
                 groups: tuple | None = None, timeout_s: float | None = None,
                 backend: str | None = None):
        import torch

        pop_shards, model_shards, rank = int(pop_shards), int(model_shards), int(rank)
        world = pop_shards * model_shards
        if pop_shards < 1 or model_shards < 1 or not 0 <= rank < world:
            raise ValueError(f"rank {rank} is outside a ({pop_shards}, {model_shards}) mesh")
        if world > 1 and groups is None:
            raise ValueError("a mesh of several ranks needs its process groups")
        self.pop_shards, self.model_shards = pop_shards, model_shards
        self.world_size = world
        self.rank = rank
        self.pop_index, self.model_index = divmod(rank, model_shards)
        self.device = torch.device(device)
        self.model_group, self.gather_group, self.pop_group = groups or (None, None, None)
        self.timeout_s = timeout_s
        self.backend = backend
        self.devices = _Devices(world, (pop_shards, model_shards))

    @property
    def shape(self) -> dict:
        return {POP_AXIS: self.pop_shards, MODEL_AXIS: self.model_shards}

    def __repr__(self) -> str:
        return (f"HyperscaleMesh(pop={self.pop_shards}, model={self.model_shards}, "
                f"rank={self.rank}, device={str(self.device)!r}, backend={self.backend!r})")

    def all_reduce_model(self, t):
        """``t`` summed over this rank's model group (the shards of a leaf)."""
        if self.model_shards == 1:
            return t
        return _all_reduce(t, self.model_group, "model", self.rank, self.world_size,
                           self.backend, self.timeout_s)

    def all_reduce_gather(self, t):
        """The same sum on the model group kept for gathers (``params_flat``,
        the best member): safe beside a generation running on another
        thread."""
        if self.model_shards == 1:
            return t
        return _all_reduce(t, self.gather_group, "model gather", self.rank,
                           self.world_size, self.backend, self.timeout_s)

    def all_reduce_pop(self, t):
        """``t`` summed over this rank's pop group (the population's blocks)."""
        if self.pop_shards == 1:
            return t
        return _all_reduce(t, self.pop_group, "pop", self.rank, self.world_size,
                           self.backend, self.timeout_s)


def new_hyperscale_groups(pop_shards: int, model_shards: int, rank: int, timeout=None):
    """Create every subgroup of a ``(pop, model)`` mesh (a collective of
    the whole world: each rank makes every group, in the same order) and
    return this rank's ``(model_group, gather_group, pop_group)``."""
    import torch.distributed as dist

    mine: dict = {}
    kw = {} if timeout is None else {"timeout": timeout}
    for p in range(pop_shards):
        ranks = [p * model_shards + m for m in range(model_shards)]
        model_group = dist.new_group(ranks, **kw)
        gather_group = dist.new_group(ranks, **kw)
        if rank in ranks:
            mine["model"], mine["gather"] = model_group, gather_group
    for m in range(model_shards):
        ranks = [p * model_shards + m for p in range(pop_shards)]
        pop_group = dist.new_group(ranks, **kw)
        if rank in ranks:
            mine["pop"] = pop_group
    return mine["model"], mine["gather"], mine["pop"]


def hyperscale_mesh(pop_shards: int | None = None, model_shards: int | None = None,
                    devices: Sequence | None = None) -> HyperscaleMesh:
    """The 2-D ``(pop, model)`` mesh of the param-sharded engine.

    Under an initialized ``torch.distributed`` group it spans every rank
    (:func:`~estorch_tpu_torch.parallel.multihost.global_hyperscale_mesh`);
    otherwise it is the ``(1, 1)`` mesh over ``devices`` (one device,
    default ``cuda``).  The JAX package's defaults: ``model`` spans every
    rank and ``pop`` is the co-factor.  Several devices in one process
    raise: the port runs one rank a process (:data:`LAUNCH_RECIPE`)."""
    devs = _as_device_list(devices)
    if len(devs) > 1:
        raise ValueError(f"hyperscale_mesh got {len(devs)} devices in one process; "
                         + LAUNCH_RECIPE)
    from . import multihost

    device = devs[0] if devs else None
    if multihost.is_initialized():
        return multihost.global_hyperscale_mesh(pop_shards, model_shards, device)
    from ..utils.backend import resolve_device

    hyperscale_shape(pop_shards, model_shards, 1)
    return HyperscaleMesh(1, 1, 0, resolve_device(device))


# ---------------------------------------------------------------------------
# regex partition rules (the JAX package's, resolved from axis sizes)
# ---------------------------------------------------------------------------


class P(tuple):
    """A partition spec: one entry a leading dim of the leaf, each an axis
    name, a tuple of axis names, or None (replicated along that dim).  Its
    text is ``jax.sharding.PartitionSpec``'s, so the two packages'
    :func:`sharding_summary` read alike."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


# conv kernels shard their output-channel dim, dense kernels their output
# dim, 1-D vectors (biases, scales, learned carries) shard outright, and
# everything else replicates; the catch-all makes the defaults total over
# any tree (a strict rule set omits it and gets the unmatched-leaf error)
DEFAULT_PARTITION_RULES = (
    (r"conv[^/]*/kernel$", P(None, None, None, MODEL_AXIS)),
    (r"kernel$", P(None, MODEL_AXIS)),
    (r"(bias|scale|embedding|carry0[^/]*)$", P(MODEL_AXIS)),
    (r".*", P()),
)


def _axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a mesh, or the dict itself (rules resolve from
    the axis sizes alone, without the ranks)."""
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _leaf_path_name(path) -> str:
    return "/".join(str(k) for k in path)


def _fit_spec_to_shape(spec, shape, mesh) -> P:
    """Drop sharded dims the leaf cannot honor, toward replication: a spec
    longer than the leaf's rank keeps its first ``ndim`` entries, and a dim
    whose size does not divide its axes' extent replicates (padding a
    parameter would change the problem; :func:`sharding_summary` shows
    the fallback)."""
    sizes = _axis_sizes(mesh)
    ndim = len(shape)
    entries = list(spec)[:ndim]
    entries += [None] * (ndim - len(entries))
    out = []
    for dim, axis in zip(shape, entries):
        if axis is None:
            out.append(None)
            continue
        extent = 1
        for name in (axis if isinstance(axis, tuple) else (axis,)):
            extent *= sizes[name]
        out.append(axis if dim % extent == 0 else None)
    return P(*out)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict / list / tuple / NamedTuple, the
    structure kept; a leaf is anything else (a tensor, an array, an int)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def match_partition_rules(rules, tree: Any, mesh) -> Any:
    """The tree of :class:`P` specs the ``(regex, spec)`` rules give each
    leaf of ``tree`` on ``mesh`` (a mesh, or ``{axis: size}``).

    Each leaf's '/'-joined path is matched against the rules in order
    (``re.search``); the first hit wins.  Scalar leaves (rank 0 or one
    element) always replicate.  A leaf no rule matches raises, so a partial
    rule set never replicates a large leaf silently.  Leaves need only a
    ``shape`` (tensors, arrays, ``torch.empty(..., device="meta")``); an
    optimizer state that embeds the param tree under the same leaf names
    resolves through the same rules."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def leaf_spec(path, leaf):
        name = _leaf_path_name(path)
        shape = tuple(int(d) for d in getattr(leaf, "shape", ()))
        size = 1
        for d in shape:
            size *= d
        if len(shape) == 0 or size == 1:
            return P()
        for pat, spec in compiled:
            if pat.search(name) is not None:
                return _fit_spec_to_shape(spec, shape, mesh)
        raise ValueError(
            f"no partition rule matched param leaf '{name}' (shape {shape}); add a rule "
            "(a trailing ('.*', P()) replicates unmatched leaves explicitly)")

    return _map_with_path(leaf_spec, tree)


def sharding_summary(tree: Any, specs: Any) -> dict[str, str]:
    """``{leaf path: spec}``: what the rules resolved to, divisibility
    fallbacks included (manifests, tests)."""
    out: dict[str, str] = {}
    flat_specs: list = []
    _map_with_path(lambda path, sp: flat_specs.append(sp), specs)
    it = iter(flat_specs)
    _map_with_path(lambda path, leaf: out.__setitem__(_leaf_path_name(path), str(next(it))),
                   tree)
    return out


def partition_rules_to_json(rules) -> list:
    """A rule set as ``[[pattern, [dim entries]], ...]``, a dim entry an axis
    name, a list of axis names, or None: the JAX package's format, read
    back by :func:`partition_rules_from_json` (and by the JAX package's)."""
    return [[pat, [list(a) if isinstance(a, tuple) else a for a in spec]]
            for pat, spec in rules]


def partition_rules_from_json(data) -> tuple:
    return tuple((str(pat), P(*(tuple(e) if isinstance(e, list) else e for e in entries)))
                 for pat, entries in data)
