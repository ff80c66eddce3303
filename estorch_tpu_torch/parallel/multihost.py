"""Launch helpers for population data parallelism across processes.

Counterpart of ``estorch_tpu/parallel/multihost.py``.  The JAX package
brings up ``jax.distributed`` and lays one mesh over every chip of every
process; here each process is one rank with one device, joined by
``torch.distributed``.  Launch recipe (one command a rank):

    import estorch_tpu_torch.parallel.multihost as mh
    mh.initialize()                    # from RANK / WORLD_SIZE / MASTER_ADDR /
                                       # MASTER_PORT / LOCAL_RANK (torchrun)
    # or explicitly: mh.initialize("10.0.0.1:29500", num_processes=N, process_id=r)
    es = ES(..., mesh=mh.global_population_mesh())
    es.train(...)                      # the same code as one process
    # param-sharded: ES(..., shard_params=True,
    #                   mesh=mh.global_hyperscale_mesh(model_shards=N))

- **Device.** Rank r runs on ``cuda:{LOCAL_RANK}`` (``LOCAL_RANK`` from the
  environment, else r).  More ranks on a node than cards raises, unless the
  caller passes ``device=`` (two ranks sharing one card pass the same
  ``"cuda:0"``; CPU ranks pass ``"cpu"``).
- **Backend.** nccl for a CUDA device, gloo for the CPU; ``cpu_collectives
  =True`` selects gloo for CUDA tensors too, whose ``all_reduce`` then goes
  through host memory.  An nccl group that would put two ranks on one card
  raises here (NCCL itself refuses it, "Duplicate GPU detected", but only at
  the first collective): share a card with ``cpu_collectives=True``.  There
  is never a quiet switch of backend or device.
- **Bounds.** ``timeout_s`` bounds the rendezvous and every collective: a
  rank that never dials in, or dies, becomes an error naming the timeout
  on the others (esguard R17's rule in the JAX package).  The group is
  destroyed at exit (:func:`shutdown`).

Every rank builds the same state from the same seed and draws the whole
population's offsets and initial states itself, so the ranks stay
bit-identical with no parameter broadcast; per generation the wire carries
the update's ``dim`` floats and the population's fitness, both as sums
(``parallel/mesh.py``).  Host-side novelty state (the archive, the meta
RNG) evolves identically on every rank from the gathered arrays.

The JAX package's argless ``initialize()`` always attempts
``jax.distributed.initialize()`` and warns on a failure; here it attempts
only when ``RANK`` and ``WORLD_SIZE`` are set, and then, like explicit
arguments, never swallows a failure.  Without them it warns and returns
False: a single-process run.

Nothing here imports torch until it is called: :func:`process_index` and
:func:`leader_only` read ``torch.distributed`` only when torch is loaded
already (a process that never imported torch holds no group).
"""

from __future__ import annotations

import atexit
import functools
import os
import socket
import sys
import time
import warnings

from .mesh import LAUNCH_RECIPE, PopulationMesh

# what initialize() set up in this process: device, backend, timeout
_STATE: dict = {}


def _dist():
    """``torch.distributed`` if torch is loaded and a group is up, else None."""
    dist = sys.modules.get("torch.distributed")
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return None
    return dist


def is_initialized() -> bool:
    return _dist() is not None


def _init_url(address: str | None) -> str:
    if address is None:
        return "env://"
    if "://" in address:
        return address
    return f"tcp://{address}"


def _rank_device(device, rank: int):
    """This rank's device: ``device`` as given, else ``cuda:{LOCAL_RANK}``."""
    import torch

    from ..utils.backend import resolve_device

    if device is not None:
        return resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", rank))
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {rank} would run on cuda:{local} but torch.cuda.is_available() is False; "
            "pass device='cpu' for CPU ranks")
    count = torch.cuda.device_count()
    if local >= count:
        raise ValueError(
            f"rank {rank} (local rank {local}) would run on cuda:{local} but this node has "
            f"{count} card(s); pass device= explicitly to share a card "
            "(with cpu_collectives=True: nccl refuses two ranks on one card)")
    return resolve_device(f"cuda:{local}")


def _card_id(device) -> str:
    import torch

    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}/{uuid if uuid is not None else device.index}"


def _refuse_shared_cards(store, rank: int, world: int, device) -> None:
    """Every rank names its card in the rendezvous store and reads the
    others'; two ranks on one card raise on both, before nccl is touched."""
    store.set(f"estorch/card/{rank}", _card_id(device))
    cards = [store.get(f"estorch/card/{r}").decode() for r in range(world)]
    mine = [r for r, c in enumerate(cards) if c == cards[rank]]
    if len(mine) > 1:
        raise RuntimeError(
            f"nccl would put ranks {mine} on one card ({cards[rank]}, {device}); NCCL refuses "
            "two ranks on one card ('Duplicate GPU detected'). Give each rank its own card, "
            "or pass cpu_collectives=True for gloo through host memory")


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, telemetry=None, timeout_s: float = 300.0,
               cpu_collectives: bool = False, device=None) -> bool:
    """Join the process group; True when it did, False for a
    single-process run (no arguments and no ``RANK``/``WORLD_SIZE``).

    ``coordinator_address`` is rank 0's ``host:port`` (or a ``tcp://`` /
    ``file://`` URL; default ``env://``: ``MASTER_ADDR``/``MASTER_PORT``);
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``.  ``device`` is this rank's device (default ``cuda:{LOCAL_RANK}``).
    A failure raises, with a ``distributed_init_failed`` event on
    ``telemetry``."""
    if telemetry is None:
        from ..obs.spans import NULL_TELEMETRY as telemetry  # noqa: N811
    explicit = any(a is not None for a in (coordinator_address, num_processes, process_id))
    if not explicit and not ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        warnings.warn(
            "initialize() without arguments found no RANK/WORLD_SIZE in the environment — "
            "continuing as a single-process run. Under a launcher this means its "
            "environment was NOT picked up; each process would train alone.",
            stacklevel=2)
        telemetry.event("distributed_init_fallback", dur_s=0.0, error="no RANK/WORLD_SIZE")
        return False
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("torch.distributed is initialized already in this process")
    t0 = time.perf_counter()
    try:
        rank = int(process_id if process_id is not None else os.environ["RANK"])
        world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
        if not 0 <= rank < world:
            raise ValueError(f"process_id {rank} is outside a world of {world}")
        dev = _rank_device(device, rank)
        backend = "gloo" if cpu_collectives or dev.type == "cpu" else "nccl"
        timeout = datetime.timedelta(seconds=float(timeout_s))
        store, rank, world = next(dist.rendezvous(
            _init_url(coordinator_address), rank, world, timeout=timeout))
        store.set_timeout(timeout)
        if backend == "nccl":
            _refuse_shared_cards(store, rank, world, dev)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=timeout)
    except Exception as e:
        telemetry.event("distributed_init_failed", dur_s=time.perf_counter() - t0,
                        error=repr(e))
        raise
    _STATE.update(device=dev, backend=backend, timeout_s=float(timeout_s))
    if not _STATE.get("atexit"):
        atexit.register(shutdown)
        _STATE["atexit"] = True
    telemetry.event("distributed_init", dur_s=time.perf_counter() - t0, **process_info())
    return True


initialize_distributed = initialize  # the JAX package's export name


def shutdown() -> None:
    """Destroy the process group, if this process holds one."""
    dist = _dist()
    if dist is not None:
        dist.destroy_process_group()
    for k in ("device", "backend", "timeout_s"):
        _STATE.pop(k, None)


def global_population_mesh(device=None) -> PopulationMesh:
    """The 1-D population mesh over every rank of the group: this rank's
    device is ``device`` or the one :func:`initialize` chose.  Without a
    group, the world-1 mesh (the JAX package's single-process case)."""
    dist = _dist()
    if dist is None:
        from .mesh import single_device_mesh

        return single_device_mesh(device)
    from ..utils.backend import resolve_device

    dev = resolve_device(device) if device is not None else _STATE.get("device")
    if dev is None:
        raise RuntimeError("the process group was not set up by multihost.initialize; pass "
                           "device= (" + LAUNCH_RECIPE + ")")
    return PopulationMesh(dist.get_world_size(), dist.get_rank(), dev,
                          timeout_s=_STATE.get("timeout_s"),
                          backend=_STATE.get("backend", dist.get_backend()))


def global_hyperscale_mesh(pop_shards: int | None = None, model_shards: int | None = None,
                           device=None):
    """The 2-D ``(pop, model)`` mesh over every rank of the group (the JAX
    package's global device list), with ``hyperscale_mesh``'s defaults:
    ``model`` spans every rank.  It creates the mesh's subgroups, a
    collective: every rank calls it, with the same shape.  Without a group,
    the ``(1, 1)`` mesh on ``device``."""
    from .mesh import HyperscaleMesh, hyperscale_shape, new_hyperscale_groups

    dist = _dist()
    if dist is None:
        from ..utils.backend import resolve_device

        hyperscale_shape(pop_shards, model_shards, 1)
        return HyperscaleMesh(1, 1, 0, resolve_device(device))
    import datetime

    from ..utils.backend import resolve_device

    dev = resolve_device(device) if device is not None else _STATE.get("device")
    if dev is None:
        raise RuntimeError("the process group was not set up by multihost.initialize; pass "
                           "device= (" + LAUNCH_RECIPE + ")")
    world, rank = dist.get_world_size(), dist.get_rank()
    pop, model = hyperscale_shape(pop_shards, model_shards, world)
    timeout_s = _STATE.get("timeout_s")
    groups = None
    if world > 1:
        groups = new_hyperscale_groups(
            pop, model, rank,
            None if timeout_s is None else datetime.timedelta(seconds=float(timeout_s)))
    return HyperscaleMesh(pop, model, rank, dev, groups=groups, timeout_s=timeout_s,
                          backend=_STATE.get("backend", dist.get_backend()))


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def process_info() -> dict:
    """Who am I in the job, for logs and the leader election."""
    dist = _dist()
    rank = dist.get_rank() if dist is not None else 0
    world = dist.get_world_size() if dist is not None else 1
    return {"process_index": rank, "process_count": world, "local_devices": 1,
            "global_devices": world, "is_leader": rank == 0,
            "backend": _STATE.get("backend"),
            "device": str(_STATE["device"]) if "device" in _STATE else None}


def train_sync(es, n_steps: int, log_fn=None, verbose: bool = False):
    """The synchronous multi-rank loop: ``es.train`` a generation at a
    time with the host chaos hook at each generation's head.  A
    ``straggle_host`` stalls this rank, and with it every rank at the next
    collective; a ``kill_host`` SIGKILLs this process (the survivors' next
    collective fails within the group's timeout)."""
    from ..resilience.chaos import host_fault

    host = process_index()
    for _ in range(int(n_steps)):
        if host_fault(int(es.generation), host):
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
        es.train(1, log_fn=log_fn, verbose=verbose)
    return es


def leader_only(fn):
    """Decorator: run ``fn`` on rank 0 only (checkpoint and record writes);
    every other rank gets None.  All ranks hold the same state, so a side
    effect needs one writer."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if process_index() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped
