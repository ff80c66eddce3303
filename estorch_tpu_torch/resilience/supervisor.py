"""Supervised training: the layer that keeps a run alive end to end.

Counterpart of ``estorch_tpu/resilience/supervisor.py``, at two
granularities:

* :func:`run_resilient`, in process: each ``es.train(1)`` runs inside a
  snapshot and restore.  A generation that raises (a dead env, a crash
  inside a checkpoint save, injected chaos) is rolled back whole (state,
  generation, history, best member, meta-population and archive), counted
  in ``generations_skipped`` and re-run.  The sample is keyed on
  ``(seed, generation)``, so the re-run of a transient fault is
  bit-identical to a run that never faulted.  A persistent fault re-raises
  after ``max_consecutive_skips``.

* :class:`Supervisor`, across processes: training runs in a child process
  that is *spawned* (a fresh interpreter: the parent may hold a CUDA
  context, which a fork must not inherit).  The parent watches the
  child's exit status and its heartbeat file (``ESTORCH_OBS_HEARTBEAT``,
  ``obs/recorder.py``), which catches a child that is alive and stopped
  making progress.  On a death or a stale beat it restarts the child with
  exponential backoff, and the child resumes from the newest committed
  checkpoint (``utils/checkpoint.py``).  Each restart's reason, exit code
  and last beat, and the counters summed over the children, land in the
  run manifest's ``resilience`` section, which ``python -m
  estorch_tpu_torch.obs summarize`` reads.

SIGKILL the run at any point, and the supervisor drives it to the same
final parameters.
"""

from __future__ import annotations

import collections
import copy
import importlib
import json
import multiprocessing as mp
import os
import signal
import time

from ..obs.recorder import HEARTBEAT_ENV, STALE_AFTER_S, read_heartbeat
from . import chaos as _chaos


# ---------------------------------------------------------------------
# in process: per-generation containment
# ---------------------------------------------------------------------

def _snapshot(es) -> dict:
    """Everything ``es.train(1)`` may change.  References suffice for the
    states: every engine builds the next state from new tensors (the device
    and pooled engines' update, ``optim.Adam``, the obs-stats merge, the
    host engine's ``parameters_to_vector`` and deep-copied optimizer state)
    and none writes a state's tensor in place.  Lists are copied, the
    archive is taken as its stacked BCs.  A param-sharded state's shards
    are copied all the same (the JAX package's donated state must be).  IW-ES's reuse window (F11) and
    the novelty family's meta RNG (F12) are taken too: the JAX package's
    rollback leaves both moved by the aborted attempt."""
    state = es.state
    if getattr(es, "_shard_params", False):
        # this rank's shards and optimizer state copied, as the JAX package
        # copies its donated sharded state
        from ..parallel.sharded import clone_state

        state = clone_state(state)
    snap = {
        "state": state,
        "generation": es.generation,
        "history_len": len(es.history),
        "best_reward": es.best_reward,
        "best_flat": es._best_flat,
        # a rolled-back first record took the cost model with it
        "cost_model_emitted": es._cost_model_emitted,
    }
    if hasattr(es, "meta_states"):
        snap["meta_states"] = list(es.meta_states)
        snap["center_bc"] = list(es._center_bc)
    if hasattr(es, "archive"):
        snap["archive"] = es.archive.state_dict()
    if hasattr(es, "weight"):  # NSRA's schedule
        snap["nsra"] = (es.weight, es._stagnation)
    if hasattr(es, "_prev"):  # IW-ES: the window is appended before the record's save
        snap["iwes"] = (list(es._prev), es._dry_gens, es._dry_best_ess)
    if hasattr(es, "_rng"):  # the novelty family draws the center first
        snap["meta_rng"] = copy.deepcopy(es._rng.bit_generator.state)
    return snap


def _restore(es, snap: dict) -> None:
    es.state = snap["state"]
    es.generation = snap["generation"]
    del es.history[snap["history_len"]:]
    es.best_reward = snap["best_reward"]
    es._best_flat = snap["best_flat"]
    es._cost_model_emitted = snap["cost_model_emitted"]
    if "meta_states" in snap:
        es.meta_states = list(snap["meta_states"])
        es._center_bc = list(snap["center_bc"])
    if "archive" in snap:
        from ..algo.archive import NoveltyArchive

        es.archive = NoveltyArchive.from_state_dict(snap["archive"])
    if "nsra" in snap:
        es.weight, es._stagnation = snap["nsra"]
    if "iwes" in snap:
        prev, es._dry_gens, es._dry_best_ess = snap["iwes"]
        es._prev = collections.deque(prev, maxlen=es._prev.maxlen)
    if "meta_rng" in snap:
        es._rng.bit_generator.state = copy.deepcopy(snap["meta_rng"])
    es.obs.discard_phases()  # the aborted generation's partial spans


def run_resilient(es, n_steps: int, n_proc: int = 1, log_fn=None, verbose: bool = False,
                  checkpointer=None, max_skips: int = 16, max_consecutive_skips: int = 4):
    """Train ``n_steps`` generations, rolling back and re-running any
    generation that raises instead of dying.

    ``checkpointer`` (a ``PeriodicCheckpointer``) is composed into the
    record callback, so a crash inside a save rolls the generation just
    finished back too: it re-runs and re-saves.  Up to
    ``max_consecutive_skips`` failed attempts in a row (``max_skips`` in
    all) are tolerated; one more re-raises.  Returns ``es``.
    """
    target = es.generation + int(n_steps)
    consec = skips = 0

    def _log(record):
        if checkpointer is not None:
            checkpointer.on_record(record)
        if log_fn is not None:
            log_fn(record)

    while es.generation < target:
        # the process-level chaos events key on the next generation to run
        _chaos.process_wedge(es.generation)
        _chaos.process_kill(es.generation)
        snap = _snapshot(es)
        try:
            es.train(1, n_proc=n_proc, log_fn=_log, verbose=verbose)
        except Exception as e:  # noqa: BLE001 — containment is the feature;
            # every skip is counted, recorded and bounded below
            _restore(es, snap)
            skips += 1
            consec += 1
            es.obs.counters.inc("generations_skipped")
            es.obs.event("generation_skipped", gen=snap["generation"], error=repr(e)[:200])
            if consec > max_consecutive_skips or skips > max_skips:
                raise
            continue
        consec = 0
    return es


# ---------------------------------------------------------------------
# across processes: supervised restart from a checkpoint
# ---------------------------------------------------------------------

def _resolve_factory(es_factory):
    """A picklable callable, or a ``"module:attr"`` spec string."""
    if isinstance(es_factory, str):
        mod, _, attr = es_factory.partition(":")
        if not attr:
            raise ValueError(f"factory spec {es_factory!r} must be 'module:attr'")
        return getattr(importlib.import_module(mod), attr)
    return es_factory


def _generic_child_main(child_spec, child_args: tuple, root: str) -> None:
    """A generic supervised child (``child_target``): the heartbeat goes
    into the supervision root, and the target is resolved in the child."""
    os.environ[HEARTBEAT_ENV] = os.path.join(root, "heartbeat.json")
    _resolve_factory(child_spec)(root, *child_args)


def _child_main(es_factory, root: str, target_generation: int, every: int, n_proc: int,
                verbose: bool) -> None:
    """The spawned child: build, resume from the latest checkpoint, train
    resiliently to the target, save a final checkpoint."""
    # before the factory: ES reads the heartbeat path at construction
    os.environ[HEARTBEAT_ENV] = os.path.join(root, "heartbeat.json")
    es = _resolve_factory(es_factory)()

    from ..obs.sinks import JsonlSink
    from ..utils.checkpoint import PeriodicCheckpointer, restore_checkpoint

    # beat through the setup: the kernels' load (a build from scratch runs
    # nvcc), the restore and the manifest's IO
    if es.device.type == "cuda":
        from ..ops._build import load_library

        es.obs.note("supervisor_kernels")
        load_library()
    es.obs.note("supervisor_setup")
    ck = PeriodicCheckpointer(es, root, every=every)
    latest = ck.latest()
    if latest is not None:
        es.obs.note("supervisor_restore")
        restore_checkpoint(es, latest)
        es.obs.counters.inc("supervisor_resumes")
        es.obs.event("resumed_from_checkpoint", path=latest, gen=es.generation)
    manifest_path = os.path.join(root, "manifest.json")
    if not os.path.exists(manifest_path):
        es.obs.note("supervisor_manifest")
        es.write_manifest(manifest_path)
    sink = JsonlSink(os.path.join(root, "run.jsonl"))
    try:
        if es.generation < target_generation:
            run_resilient(es, target_generation - es.generation, n_proc=n_proc, log_fn=sink,
                          verbose=verbose, checkpointer=ck)
        if es.generation > 0:
            # a final checkpoint whatever the alignment with ``every``
            ck.save(es.generation - 1)
        ck.close()
    finally:
        sink.close()
        if hasattr(es.engine, "close"):
            es.engine.close()


class Supervisor:
    """Run training to ``target_generation`` with automatic restarts.

    ``es_factory`` is a picklable zero-argument callable (a module-level
    function) or a ``"module:attr"`` spec, importable in a fresh
    interpreter: the child is spawned, never forked.  The factory owns the
    child's platform policy: its device, and any flag the parent sets
    (``torch.backends.cuda.matmul.allow_tf32``, ...), or the child is not
    the same run.

    ``ckpt_root`` is the unit of resumability: the heartbeat, the run
    JSONL, the manifest, the published counter totals (``counters.json``)
    and the ``gen_*`` checkpoints all live there.
    """

    def __init__(self, es_factory=None, ckpt_root: str = "", target_generation: int = 0, *,
                 every: int = 5, n_proc: int = 1, max_restarts: int = 5, backoff_s: float = 0.5,
                 backoff_max_s: float = 30.0, stale_after_s: float = STALE_AFTER_S,
                 startup_grace_s: float = 120.0, poll_s: float = 0.5, verbose: bool = False,
                 child_target=None, child_args: tuple = ()):
        if (es_factory is None) == (child_target is None):
            raise ValueError("pass exactly one of es_factory (training child) or "
                             "child_target (generic supervised child)")
        if not ckpt_root:
            raise ValueError("ckpt_root is required")
        self.es_factory = es_factory
        self.child_target = child_target
        self.child_args = tuple(child_args)
        self.ckpt_root = os.path.abspath(ckpt_root)
        self.target_generation = int(target_generation)
        self.every = int(every)
        self.n_proc = int(n_proc)
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.stale_after_s = float(stale_after_s)
        self.startup_grace_s = float(startup_grace_s)
        self.poll_s = float(poll_s)
        self.verbose = bool(verbose)
        self.restarts: list[dict] = []
        self._counters_total: dict[str, float] = {}
        self._hists_total: dict[str, dict] = {}
        self._counters_through_ts = 0.0
        self._publish_error: str | None = None
        self._child = None
        self._stop_requested = False
        self._stop_signaled = False
        os.makedirs(self.ckpt_root, exist_ok=True)

    @property
    def heartbeat_path(self) -> str:
        return os.path.join(self.ckpt_root, "heartbeat.json")

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.ckpt_root, "manifest.json")

    def latest_checkpoint(self) -> str | None:
        from ..utils.checkpoint import latest_checkpoint

        return latest_checkpoint(self.ckpt_root)

    def run(self) -> dict:
        """Drive the run to completion: ``{"ok", "restarts", "checkpoint",
        "reason"}``."""
        ctx = mp.get_context("spawn")
        attempt = 0
        ok = False
        reason = None
        while True:
            if self._stop_requested:  # a stop during the backoff: spawn nothing
                ok = True
                break
            started = time.time()
            if self.child_target is not None:
                child = ctx.Process(target=_generic_child_main,
                                    args=(self.child_target, self.child_args, self.ckpt_root))
            else:
                child = ctx.Process(target=_child_main,
                                    args=(self.es_factory, self.ckpt_root,
                                          self.target_generation, self.every, self.n_proc,
                                          self.verbose))
            child.start()
            self._child = child
            failure = self._watch(child, started)
            if failure is not None and not self._stop_requested:
                # recorded before the counters are published, so the
                # published restart_count already counts this death
                self.restarts.append({"ts": time.time(), "attempt": attempt,
                                      "reason": failure, "exitcode": child.exitcode,
                                      "heartbeat": read_heartbeat(self.heartbeat_path)})
            self._accumulate_counters(started)
            if failure is None:
                ok = True
                break
            if self._stop_requested:
                # an operator's stop is completion when the child drained
                # (exit 0) or died of the forwarded SIGTERM before it could
                # install a handler
                ok = child.exitcode == 0 or (self._stop_signaled
                                             and child.exitcode == -int(signal.SIGTERM))
                reason = None if ok else failure
                break
            attempt += 1
            if attempt > self.max_restarts:
                reason = failure
                break
            time.sleep(min(self.backoff_s * (2 ** (attempt - 1)), self.backoff_max_s))
        self._write_provenance(ok)
        return {"ok": ok, "restarts": list(self.restarts),
                "checkpoint": self.latest_checkpoint(), "reason": reason}

    def request_stop(self, signum: int | None = None) -> None:
        """An operator's stop (signal-handler safe): forward SIGTERM to the
        child, once, so it can drain, and restart no more."""
        del signum
        self._stop_requested = True
        child = self._child
        if child is not None and child.is_alive() and not self._stop_signaled:
            self._stop_signaled = True
            child.terminate()

    def _watch(self, child, started: float) -> str | None:
        """Block until the child exits or is killed as wedged: None on a
        clean exit, else the reason."""
        while True:
            child.join(timeout=self.poll_s)
            if child.exitcode is not None:
                if child.exitcode == 0:
                    return None
                return (f"child died with exit code {child.exitcode}"
                        + (" (signal)" if child.exitcode < 0 else ""))
            if self._stop_requested and not self._stop_signaled:
                # the stop came between start() and the _child assignment
                self._stop_signaled = True
                child.terminate()
            hb = read_heartbeat(self.heartbeat_path)
            if hb is not None and float(hb.get("ts", 0.0)) >= started:
                if hb["age_s"] > self.stale_after_s:  # this child has beaten
                    child.kill()
                    child.join(timeout=10)
                    return (f"heartbeat stale ({hb['age_s']:.0f}s > "
                            f"{self.stale_after_s:.0f}s) — killed wedged child "
                            f"(last phase={hb.get('phase')!r} gen={hb.get('generation')})")
            elif time.time() - started > self.startup_grace_s:
                child.kill()
                child.join(timeout=10)
                return (f"no heartbeat within {self.startup_grace_s:.0f}s of start — child "
                        "wedged before init finished")

    def _accumulate_counters(self, started: float) -> None:
        """Fold the exited child's last beat into the cross-restart totals:
        each child counts from zero, so the sum over children is the run's
        total (a SIGKILLed child's counters survive it this way).  A beat
        older than this child's start is an earlier child's, counted
        already.  The totals are published each time."""
        hb = read_heartbeat(self.heartbeat_path)
        if hb is not None and float(hb.get("ts", 0.0)) >= started:
            for name, val in (hb.get("counters") or {}).items():
                if isinstance(val, (int, float)):
                    self._counters_total[name] = self._counters_total.get(name, 0) + val
            if isinstance(hb.get("hists"), dict):
                from ..obs.hist import merge_snapshots

                self._hists_total = merge_snapshots(self._hists_total, hb["hists"])
            self._counters_through_ts = float(hb.get("ts", 0.0))
        self._publish_counters(through_ts=self._counters_through_ts)

    def _publish_counters(self, through_ts: float, completed: bool | None = None) -> None:
        """Publish ``counters.json`` (``obs/export/sidecar.py``): the
        totals, ``through_ts`` (the beat they include), the histograms and
        ``restart_count`` (and ``completed`` at the end)."""
        from ..obs.export.sidecar import publish_counters

        extra: dict = {"restart_count": len(self.restarts)}
        if completed is not None:
            extra["completed"] = completed
        try:
            publish_counters(self.ckpt_root, self._counters_total, through_ts, extra=extra,
                             hists=self._hists_total or None)
            self._publish_error = None
        except OSError as e:
            # observability is best effort: a full disk is no supervision
            # failure, and the error rides the manifest
            self._publish_error = repr(e)

    def _write_provenance(self, ok: bool) -> None:
        """Merge the restarts into the run manifest, atomically."""
        self._publish_counters(through_ts=self._counters_through_ts, completed=ok)
        try:
            with open(self.manifest_path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}  # no child wrote one: a provenance-only file
        data["resilience"] = {
            "target_generation": self.target_generation,
            "completed": ok,
            "restart_count": len(self.restarts),
            "restarts": self.restarts,
            "counters": dict(self._counters_total),
        }
        if self._publish_error:
            data["resilience"]["counters_publish_error"] = self._publish_error
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, default=float)
        os.replace(tmp, self.manifest_path)
