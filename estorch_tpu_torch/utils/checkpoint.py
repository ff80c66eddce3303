"""Checkpoint and resume: the whole algorithm state, for an exact resume.

Counterpart of ``estorch_tpu/utils/checkpoint.py``.  The sample of a
generation is keyed on ``(seed, generation)``, so restoring those with the
params, the optimizer's moments, σ, the obs stats, the best member, the
history and the novelty family's archive, weight and meta RNG continues a
run as if it had never stopped.

A checkpoint is a directory (``gen_%08d/`` under a root, the JAX
package's layout):

- ``meta.json``: the JAX package's keys (backend, algo, population, σ,
  seed, generation, history length, the obs-norm flag, the archive's and
  NSRA's scalars, the meta RNG state) with the port's own
  ``format_version``;
- ``history.json``: the per-generation records;
- ``host_opt.pt``: on the host backend, the torch optimizers' state dicts;
- ``state/payload.pt``: one ``torch.save`` of CPU tensors, ints, floats,
  lists and dicts (loadable with ``weights_only=True``).

``state/`` is the commit point: the sidecars are written first, then the
payload into a temporary directory that is fsynced and renamed to
``state/``, so a crash at any moment leaves a directory that
:func:`latest_checkpoint` skips.  Tensors are saved as CPU copies and
restored to ``es.device``: a checkpoint from the card restores on the CPU
and one from the CPU on the card.

``asynchronous=True`` on the card: an event is recorded on the compute
stream at the call, a side stream waiting on it copies each tensor into
pinned host memory (``non_blocking``), and a writer thread waits on the
copy's event, writes and renames.  The source tensors are held until the
copy has completed, so the caching allocator cannot hand their memory to
the next generation while it is read.  IW-ES's reuse window is not saved,
as in the JAX package: a resumed IW-ES starts with an empty window.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
from typing import Any, Callable

import numpy as np
import torch

from ..parallel.multihost import leader_only

CHECKPOINT_FORMAT_VERSION = 1  # the port's own payload layout
PAYLOAD = "payload.pt"


def _map_tensors(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tensors(v, fn) for v in tree]
    if isinstance(tree, tuple):  # a torch optimizer's ``betas``
        return tuple(_map_tensors(v, fn) for v in tree)
    return tree


def _all_states(es) -> list:
    return list(es.meta_states) if hasattr(es, "meta_states") else [es.state]


def _obs_norm(es) -> bool:
    return bool(getattr(getattr(es, "config", None), "obs_norm", False))


def _pack_state(es, st) -> dict:
    """One engine state (device or pooled ``ESState``, or ``HostState``) as
    plain values; tensors stay where they are until the copy."""
    d: dict = {"params_flat": st.params_flat, "generation": int(st.generation)}
    if es.backend == "host":
        # None is the engine's initial σ: persist that value
        d["sigma"] = float(es.engine.sigma if st.sigma is None else st.sigma)
        d["key"] = int(st.key)
        return d
    d["sigma"] = st.sigma
    d["seed"] = int(st.seed)
    d["opt_state"] = None if st.opt_state is None else _pack_opt(st.opt_state)
    if getattr(es, "_shard_params", False) and d["opt_state"] is not None:
        # the moments of this rank's shards, gathered as the params are (a
        # collective: every rank packs)
        local = st.params_local.shape
        d["opt_state"] = _map_tensors(
            d["opt_state"], lambda t: es.engine.layout.gather(t) if t.shape == local else t)
    if getattr(st, "obs_stats", None) is not None:
        d["obs_stats"] = list(st.obs_stats)
    return d


def _pack_opt(opt: Any) -> Any:
    """An optimizer state's named tuples (``AdamState``, a tunable
    optimizer's ``TunableState`` around one) as dicts, recursively."""
    if hasattr(opt, "_asdict"):
        return {k: _pack_opt(v) for k, v in opt._asdict().items()}
    return opt


def _unpack_opt(packed: Any, template: Any, to_dev) -> Any:
    """:func:`_pack_opt`'s inverse, the types read from ``template`` (the
    fresh object's optimizer state); tensors moved with ``to_dev``."""
    if hasattr(template, "_asdict"):
        return type(template)(**{k: _unpack_opt(packed[k], getattr(template, k), to_dev)
                                 for k in template._fields})
    return _map_tensors(packed, to_dev)


def _state_tree(es) -> dict:
    """The payload: every state, the best member and the archive's BCs."""
    tree = {
        "generation": int(es.generation),
        "best_reward": float(es.best_reward) if np.isfinite(es.best_reward) else -1e30,
        "has_best": int(es._best_flat is not None),
        "best_flat": (es._best_flat if es._best_flat is not None
                      else torch.zeros(0, dtype=torch.float32)),
        "states": [_pack_state(es, s) for s in _all_states(es)],
    }
    if hasattr(es, "archive"):
        tree["archive_bcs"] = torch.from_numpy(np.array(es.archive.bcs, np.float32))
        tree["center_bc"] = [torch.from_numpy(np.array(b, np.float32)) for b in es._center_bc]
    return tree


def _meta_dict(es) -> dict:
    meta = {
        "format_version": CHECKPOINT_FORMAT_VERSION,
        "backend": es.backend,
        "algo": type(es).__name__,
        "population_size": es.population_size,
        "sigma": es.sigma,
        "seed": es.seed,
        "generation": int(es.generation),
        "history_len": len(es.history),
        # the state schema: obs_norm adds obs_stats to every state
        "obs_norm": _obs_norm(es),
    }
    if hasattr(es, "archive"):
        meta["archive_k"] = es.archive.k
        meta["archive_bc_dim"] = es.archive.bc_dim
        meta["archive_max_size"] = es.archive.max_size
    if hasattr(es, "weight"):  # NSRA
        meta["nsra_weight"] = float(es.weight)
        meta["nsra_stagnation"] = int(es._stagnation)
    if hasattr(es, "_rng"):
        # without the meta-selection RNG's position a resumed novelty run
        # picks other meta-individuals than the uninterrupted one
        meta["meta_rng_state"] = es._rng.bit_generator.state
    return meta


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _stage(tree: dict, asynchronous: bool):
    """``(host tree, copy event or None, sources)``.  Synchronous: plain
    copies.  Asynchronous with tensors on a card: pinned copies queued on a
    side stream behind an event of the compute stream; ``sources`` keeps
    the card tensors alive until the event has completed."""
    cards = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    if not asynchronous or not cards:
        return _map_tensors(tree, _host_copy), None, []
    (device,) = cards  # one ES lives on one card
    side = torch.cuda.Stream(device)  # from torch's stream pool: no creation per save
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(device))
    sources: list[torch.Tensor] = []

    def pinned(t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cuda":
            return _host_copy(t)
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        sources.append(t)
        return buf

    with torch.cuda.stream(side):
        side.wait_event(ready)
        host = _map_tensors(tree, pinned)
        copied = torch.cuda.Event()
        copied.record(side)
    return host, copied, sources


def _tensors(tree: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map_tensors(tree, out.append)
    return out


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _commit_payload(host_tree: dict, path: str) -> None:
    """Write the payload into a temporary directory, fsync it, and rename it
    to ``state/``: the checkpoint's commit point.  A re-save of the same
    generation moves the old ``state/`` aside first (a crash in between
    leaves an older checkpoint as the latest, never a torn one)."""
    tmp = os.path.join(path, f"state.tmp-{os.getpid()}-{threading.get_ident()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, PAYLOAD), "wb") as f:
        torch.save(host_tree, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    final = os.path.join(path, "state")
    if os.path.exists(final):
        old = tmp + ".old"
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, final)
    _fsync_dir(path)


class AsyncSaveHandle:
    """Returned by ``save_checkpoint(..., asynchronous=True)``: the payload's
    copy and write go on in a writer thread.  :meth:`wait` (idempotent)
    blocks until the checkpoint is durable and re-raises the writer's
    error; call it before restoring from the path or exiting.  A writer
    that misses ``wait``'s timeout is a ``TimeoutError`` naming the
    checkpoint, never a wait without end."""

    def __init__(self, host_tree: dict, copied, sources: list, path: str):
        self._error: BaseException | None = None
        self._done = False
        self._path = path
        self._thread = threading.Thread(target=self._write,
                                        args=(host_tree, copied, sources, path),
                                        name="checkpoint-writer")
        self._thread.start()

    def _write(self, host_tree, copied, sources, path) -> None:
        try:
            if copied is not None:
                copied.synchronize()
            sources.clear()  # the card's memory may be reused from here on
            _commit_payload(host_tree, path)
        except Exception as e:  # noqa: BLE001 — re-raised by wait()
            self._error = e

    def wait(self, timeout_s: float = 600.0) -> None:
        """Block until the writer is done, at most ``timeout_s`` seconds."""
        if self._done:
            return
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():
            raise TimeoutError(f"checkpoint writer for {self._path} did not finish "
                               f"within {timeout_s} s")
        self._done = True
        if self._error is not None:
            raise self._error


def save_checkpoint(es, path: str, asynchronous: bool = False) -> AsyncSaveHandle | None:
    """Write a complete checkpoint of ``es`` to directory ``path``.

    Synchronous saves return None.  ``asynchronous=True`` returns an
    :class:`AsyncSaveHandle` once the sidecars are written and the
    payload's copy is queued: the checkpoint holds the state as it was at
    the call, whatever later generations do.  Under a multi-rank mesh
    every rank holds the same state and only rank 0 writes
    (``leader_only``; the others return None).  A param-sharded ES's
    params and moments are gathered first, on every rank (a collective:
    every rank calls this), and rank 0 writes the whole vectors.
    """
    return _save_on_leader(es, path, asynchronous, _state_tree(es))


@leader_only
def _save_on_leader(es, path: str, asynchronous: bool, tree: dict) -> AsyncSaveHandle | None:
    from ..resilience.chaos import crash_checkpoint

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    # the sidecars first, the payload last (see the module docstring)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(_meta_dict(es), f, indent=2)
    with open(os.path.join(path, "history.json"), "w") as f:
        json.dump(es.history, f)
    if es.backend == "host":
        torch.save([_map_tensors(s.opt_state, _host_copy) for s in _all_states(es)],
                   os.path.join(path, "host_opt.pt"))
    # a scheduled crash mid-write lands here: sidecars written, no payload
    crash_checkpoint(es.generation)
    host_tree, copied, sources = _stage(tree, asynchronous)
    if asynchronous:
        return AsyncSaveHandle(host_tree, copied, sources, path)
    _commit_payload(host_tree, path)
    return None


def restore_checkpoint(es, path: str) -> None:
    """Restore ``es`` in place from a checkpoint of :func:`save_checkpoint`.

    ``es`` must be built with the same configuration (policy, agent,
    optimizer, population, σ, seed); its tensors land on ``es.device``.
    """
    if getattr(es, "_shard_params", False):
        raise ValueError(
            "restore_checkpoint rebuilds replicated engine states; a param-sharded ES "
            "cannot resume from one (the JAX package's restore yields a replicated "
            "state that its sharded engine cannot run either)")
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    version = meta.get("format_version", 0)
    if version != CHECKPOINT_FORMAT_VERSION:
        raise ValueError(f"checkpoint format v{version} != supported "
                         f"v{CHECKPOINT_FORMAT_VERSION} of this package; re-save from the "
                         "run that wrote it")
    check_meta(es, meta)
    state_dir = os.path.join(path, "state")
    if not os.path.isdir(state_dir):
        raise ValueError(
            f"checkpoint at {path!r} has no finalized state/ payload — an async save is "
            "still draining (call handle.wait() / PeriodicCheckpointer.wait() first) or "
            "the write crashed mid-save; use PeriodicCheckpointer.latest() to find the "
            "newest restorable checkpoint")
    tree = torch.load(os.path.join(state_dir, PAYLOAD), map_location="cpu",
                      weights_only=True)
    device = es.device

    def to_dev(t: torch.Tensor) -> torch.Tensor:
        return t.to(device)

    with open(os.path.join(path, "history.json")) as f:
        es.history = json.load(f)
    if len(es.history) != meta.get("history_len", len(es.history)):
        warnings.warn(
            f"checkpoint history.json holds {len(es.history)} records but meta.json "
            f"recorded {meta['history_len']} — the checkpoint write was likely "
            "interrupted; records may be stale/partial (numeric state is unaffected)",
            stacklevel=2)

    host_opts = None
    if es.backend == "host":
        host_opts = torch.load(os.path.join(path, "host_opt.pt"), map_location="cpu",
                               weights_only=True)
    templates = _all_states(es)
    states = [_unpack_state(es, packed, templates[i],
                            None if host_opts is None else host_opts[i], to_dev)
              for i, packed in enumerate(tree["states"])]
    restore_run(es, tree, meta, states, to_dev)


def check_meta(es, meta: dict) -> None:
    """The JAX package's ``ValueError``s for a checkpoint of another
    backend, algorithm or obs-norm schema than ``es``."""
    if meta["backend"] != es.backend:
        raise ValueError(f"checkpoint backend {meta['backend']!r} != this object's "
                         f"{es.backend!r}")
    if meta["algo"] != type(es).__name__:
        raise ValueError(f"checkpoint algo {meta['algo']!r} != this object's "
                         f"{type(es).__name__!r}")
    ck_obs_norm, es_obs_norm = bool(meta.get("obs_norm", False)), _obs_norm(es)
    if ck_obs_norm != es_obs_norm:
        raise ValueError(
            f"checkpoint was written with obs_norm={ck_obs_norm} but this object was "
            f"constructed with obs_norm={es_obs_norm} — rebuild with the matching setting "
            f"(the running obs stats are part of training state), e.g. pass "
            f"obs_norm={ck_obs_norm} to the constructor or config recipe")


def restore_run(es, tree: dict, meta: dict, states: list, to_dev) -> None:
    """Put the restored ``states`` and the rest of a checkpoint's content
    on ``es``: generation, best member, archive and centers' BCs, NSRA's
    schedule, the meta RNG.  ``tree`` holds CPU tensors or numpy arrays
    (a JAX checkpoint's, ``interop.restore_from_jax``); ``to_dev`` moves
    one to ``es.device``."""
    if hasattr(es, "meta_states"):
        es.meta_states = states
    es.state = states[0]
    es.generation = int(tree["generation"])
    br = float(tree["best_reward"])
    es.best_reward = -np.inf if br <= -1e29 else br
    es._best_flat = to_dev(tree["best_flat"]) if int(tree["has_best"]) else None
    if hasattr(es, "archive"):
        from ..algo.archive import NoveltyArchive

        es.archive = NoveltyArchive.from_state_dict({
            "k": meta["archive_k"], "bc_dim": meta["archive_bc_dim"],
            "max_size": meta.get("archive_max_size", 0),
            "bcs": np.asarray(tree["archive_bcs"], np.float32)})
        es._center_bc = [np.array(b, dtype=np.float32) for b in tree["center_bc"]]
    if "nsra_weight" in meta and hasattr(es, "weight"):
        es.weight = float(meta["nsra_weight"])
        es._stagnation = int(meta["nsra_stagnation"])
    if "meta_rng_state" in meta and hasattr(es, "_rng"):
        es._rng = np.random.default_rng()
        es._rng.bit_generator.state = meta["meta_rng_state"]


def _unpack_state(es, packed: dict, template, host_opt, to_dev):
    """A state of ``es``'s backend from its packed form; ``template`` (the
    fresh object's state) gives the optimizer state's type."""
    if es.backend == "host":
        from ..host.engine import HostState

        return HostState(params_flat=to_dev(packed["params_flat"]).float(),
                         opt_state=_map_tensors(host_opt, to_dev) if host_opt else host_opt,
                         key=int(packed["key"]), generation=int(packed["generation"]),
                         sigma=float(packed["sigma"]))
    from ..parallel.engine import ESState

    opt = packed["opt_state"]
    if opt is not None:
        opt = _unpack_opt(opt, template.opt_state, to_dev)
    obs_stats = packed.get("obs_stats")
    return ESState(params_flat=to_dev(packed["params_flat"]), opt_state=opt,
                   seed=int(packed["seed"]), generation=int(packed["generation"]),
                   sigma=to_dev(packed["sigma"]),
                   obs_stats=None if obs_stats is None else tuple(map(to_dev, obs_stats)))


def latest_checkpoint(root: str) -> str | None:
    """The newest checkpoint under ``root`` with a committed ``state/``
    payload: a save still draining, or one that crashed mid-write, leaves a
    directory without it, which must not shadow the older restorable one."""
    try:
        cks = sorted(d for d in os.listdir(root) if d.startswith("gen_"))
    except OSError:
        return None
    for d in reversed(cks):
        if os.path.isdir(os.path.join(root, d, "state")):
            return os.path.join(root, d)
    return None


class PeriodicCheckpointer:
    """Save every K generations and keep the newest ``max_to_keep``.

        ck = PeriodicCheckpointer(es, "ckpts", every=10)
        es.train(100, log_fn=ck.on_record)

    Under a multi-rank mesh every rank runs the same checkpointer (its
    ``on_record`` on every rank's records); only rank 0 writes.

    ``asynchronous``: each save's payload drains in a writer thread while
    training goes on; at most one save is in flight (the previous one is
    waited for before the next starts), and the collection of old
    checkpoints waits until the new one is durable.
    """

    def __init__(self, es, root: str, every: int = 10, max_to_keep: int = 3,
                 asynchronous: bool = False):
        self.es = es
        self.root = os.path.abspath(root)
        self.every = int(every)
        self.max_to_keep = int(max_to_keep)
        self.asynchronous = bool(asynchronous)
        self._pending: AsyncSaveHandle | None = None
        os.makedirs(self.root, exist_ok=True)

    def on_record(self, record: dict) -> None:
        gen = record["generation"]
        if (gen + 1) % self.every == 0:
            self.save(gen)

    def save(self, gen: int) -> str:
        """Save generation ``gen``'s checkpoint.  Every rank calls it (a
        param-sharded ES gathers its shards first, a collective); rank 0
        writes and collects."""
        self.wait()
        path = os.path.join(self.root, f"gen_{gen:08d}")
        self._pending = save_checkpoint(self.es, path, asynchronous=self.asynchronous)
        if self._pending is None:
            self._gc()  # a sync save is durable already
        # async: the collection waits for wait(), or it could delete the
        # last durable checkpoint while this one still drains
        return path

    def wait(self) -> None:
        """Block until the save in flight (if any) is durable, then collect
        old checkpoints.  Called before each new save; call it before
        reading ``latest()`` or exiting."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.wait()
            self._gc()

    def close(self) -> None:
        """Drain the save in flight."""
        self.wait()

    def latest(self) -> str | None:
        """The newest restorable checkpoint (:func:`latest_checkpoint`)."""
        return latest_checkpoint(self.root)

    @leader_only
    def _gc(self) -> None:
        cks = sorted(d for d in os.listdir(self.root) if d.startswith("gen_"))
        for stale in cks[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.root, stale), ignore_errors=True)
