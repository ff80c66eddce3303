"""Deterministic chaos injection: faults pinned to (generation, member).

Counterpart of ``estorch_tpu/resilience/chaos.py``.  A :class:`ChaosPlan`
schedules each fault at an exact point, so a test can hold "a run whose
update is poisoned at generation 2 ends bit-identical to one that never
was" instead of waiting for a race.  The plan travels as JSON in the
``ESTORCH_CHAOS`` environment variable, the JAX package's, so one plan
drives both packages and forked workers inherit it:

    {"events": [{"kind": "straggler", "gen": 4, "member": 2,
                 "sleep_s": 2.0, "jitter_s": 0.5},
                {"kind": "nan_fitness", "gen": 9, "member": "all"}],
     "ledger": "/path/to/chaos_ledger"}

:meth:`ChaosPlan.parse` accepts every kind the JAX plan accepts.  The
training hooks here fire these:

==============  ====================================================
kind            fires where
==============  ====================================================
rollout_exc     inside a member's rollout (thread and fork workers);
                the member gets NaN fitness
straggler       the same place, a ``sleep_s`` stall plus a jitter in
                [0, ``jitter_s``) seeded by the event id
nan_fitness     on the gathered fitness (host and pooled engines)
kill_worker     SIGKILL of a process worker at the generation start
nan_update      poisons the update direction (host engine, and the
                device and pooled engines' update, which the JAX
                package's lack)
ckpt_crash      raises inside ``save_checkpoint``, after the sidecar
                files and before the payload's commit
die             SIGKILL of this whole process before the generation
                (``run_resilient``)
wedge           a silent ``sleep_s`` before the generation, no beats
                (``run_resilient``; the supervisor's watchdog kills it)
straggle_host   a ``sleep_s`` stall (plus jitter) of one host at one
                dispatch (elastic) or generation (``train_sync``)
kill_host       one host's death at one dispatch: a host process
                SIGKILLs itself, a host thread drops its connection
kill_replica    SIGKILL of serving replica ``replica`` (the fleet's
                monitor, serve/fleet.py): router failover and respawn
wedge_replica   SIGSTOP of serving replica ``replica``: an alive process
                holding its CUDA context, a silent socket; the breaker
                opens on timeouts and the fleet escalates to SIGKILL
==============  ====================================================

Training events key on ``gen``; the two serving events on ``at_s``,
seconds since the fleet armed the plan (a server has no generation
clock).  :func:`serve_faults` claims the due ones through the same
once-semantics ledger, so a respawned fleet does not replay a kill.
``straggle_host``/``kill_host`` fire through :func:`host_fault`, keyed on
(dispatch, host) in an elastic run (``parallel/elastic.py``) and on
(generation, rank) in ``multihost.train_sync``.

The module imports only the standard library at load (NumPy inside the
two functions that need it), so the fleet supervisor loads it by path
without the package.

Events fire once: an in-memory set, and across processes the plan's
optional ``ledger`` file of fired ids, appended.  With ``ESTORCH_CHAOS``
unset every hook costs one environment lookup.
"""

from __future__ import annotations

import json
import os
import random
import signal
import threading
import time

CHAOS_ENV = "ESTORCH_CHAOS"

KINDS = ("rollout_exc", "straggler", "nan_fitness", "kill_worker", "nan_update",
         "ckpt_crash", "die", "wedge", "straggle_host", "kill_host", "kill_replica",
         "wedge_replica")

# serving events are scheduled in seconds since the fleet armed the plan
SERVE_KINDS = ("kill_replica", "wedge_replica")


class ChaosError(RuntimeError):
    """An injected fault (a rollout exception)."""


class ChaosPlan:
    """A deterministic, replayable schedule of faults; each event gets a
    stable ``id`` (its index) for the once-semantics."""

    def __init__(self, events, ledger: str | None = None):
        self._events: list[dict] = []
        self._by_gen: dict[int, list[dict]] = {}
        self._serve_events: list[dict] = []
        for i, ev in enumerate(events):
            kind = ev.get("kind")
            if kind not in KINDS:
                raise ValueError(f"unknown chaos event kind {kind!r} (event {i}); "
                                 f"known: {', '.join(KINDS)}")
            ev = dict(ev, id=i)
            if kind in SERVE_KINDS:
                if "at_s" not in ev:
                    raise ValueError(f"chaos event {i} ({kind}) has no 'at_s' — serve "
                                     "events are wall-clock scheduled")
                self._serve_events.append(ev)
            else:
                if "gen" not in ev:
                    raise ValueError(f"chaos event {i} ({kind}) has no 'gen'")
                self._by_gen.setdefault(int(ev["gen"]), []).append(ev)
            self._events.append(ev)
        self.ledger = ledger
        self._fired: set[int] = set()
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text: str) -> "ChaosPlan":
        data = json.loads(text)
        if not isinstance(data, dict):
            raise ValueError("chaos plan must be a JSON object")
        return cls(data.get("events", []), ledger=data.get("ledger"))

    @classmethod
    def from_env(cls) -> "ChaosPlan | None":
        text = os.environ.get(CHAOS_ENV)
        return cls.parse(text) if text else None

    @classmethod
    def generate(cls, seed: int, n_generations: int, ledger: str | None = None,
                 kill_every: int = 0, n_workers: int = 1, p_rollout_exc: float = 0.0,
                 p_nan_burst: float = 0.0, population_size: int = 1,
                 straggler_every: int = 0, straggler_sleep_s: float = 1.0,
                 straggler_jitter_s: float = 0.0, straggle_host_every: int = 0,
                 straggle_host: int = 0, straggle_host_sleep_s: float = 1.0,
                 straggle_host_jitter_s: float = 0.0) -> "ChaosPlan":
        """A seeded random plan, the JAX package's draw for draw: the same
        seed gives the same plan JSON in both packages."""
        import numpy as np

        rng = np.random.default_rng(seed)
        events: list[dict] = []
        for g in range(1, n_generations + 1):
            if kill_every and g % kill_every == 0:
                events.append({"kind": "kill_worker", "gen": g,
                               "worker": int(rng.integers(n_workers))})
            if straggler_every and g % straggler_every == 0:
                ev = {"kind": "straggler", "gen": g,
                      "member": int(rng.integers(population_size)),
                      "sleep_s": float(straggler_sleep_s)}
                if straggler_jitter_s > 0.0:
                    ev["jitter_s"] = float(straggler_jitter_s)
                events.append(ev)
            if straggle_host_every and g % straggle_host_every == 0:
                ev = {"kind": "straggle_host", "gen": g, "host": int(straggle_host),
                      "sleep_s": float(straggle_host_sleep_s)}
                if straggle_host_jitter_s > 0.0:
                    ev["jitter_s"] = float(straggle_host_jitter_s)
                events.append(ev)
            if p_rollout_exc and rng.random() < p_rollout_exc:
                events.append({"kind": "rollout_exc", "gen": g,
                               "member": int(rng.integers(population_size))})
            if p_nan_burst and rng.random() < p_nan_burst:
                events.append({"kind": "nan_fitness", "gen": g, "member": "all"})
        return cls(events, ledger=ledger)

    @property
    def events(self) -> list[dict]:
        return [dict(ev) for ev in self._events]

    def to_json(self) -> str:
        """The environment form: ``os.environ[CHAOS_ENV] = plan.to_json()``."""
        data: dict = {"events": [{k: v for k, v in ev.items() if k != "id"}
                                 for ev in self._events]}
        if self.ledger:
            data["ledger"] = self.ledger
        return json.dumps(data)

    def events_at(self, generation: int, kind: str | None = None) -> list[dict]:
        evs = self._by_gen.get(int(generation), [])
        return [ev for ev in evs if kind is None or ev["kind"] == kind]

    def serve_events_due(self, elapsed_s: float) -> list[dict]:
        """The serve events (``kill_replica``/``wedge_replica``) whose
        ``at_s`` has passed, each claimed through :meth:`fire` (once per
        id across every process sharing the ledger).  The caller (the
        fleet's monitor) delivers the SIGKILL or SIGSTOP itself."""
        due = []
        for ev in self._serve_events:
            if float(ev["at_s"]) <= float(elapsed_s) and self.fire(ev):
                due.append(dict(ev))
        return due

    def fire(self, event: dict) -> bool:
        """Claim ``event``: True once per event id across every process
        sharing the plan's ledger file."""
        eid = int(event["id"])
        with self._lock:
            if eid in self._fired:
                return False
            if self.ledger:
                fired = self._read_ledger()
                self._fired |= fired
                if eid in fired:
                    return False
                with open(self.ledger, "a") as f:  # O_APPEND: small writes stay whole
                    f.write(f"{eid}\n")
                    f.flush()
            self._fired.add(eid)
            return True

    def _read_ledger(self) -> set[int]:
        try:
            with open(self.ledger) as f:
                return {int(line) for line in f if line.strip()}
        except (OSError, ValueError):
            return set()


_cache_text: str | None = None
_cache_plan: ChaosPlan | None = None


def active_plan() -> ChaosPlan | None:
    """The ``ESTORCH_CHAOS`` plan, parsed once per distinct value."""
    global _cache_text, _cache_plan
    text = os.environ.get(CHAOS_ENV)
    if not text:
        return None
    if text != _cache_text:
        _cache_text, _cache_plan = text, ChaosPlan.parse(text)
    return _cache_plan


def reset_cache() -> None:
    """Forget the cached plan (tests that reuse the same plan text)."""
    global _cache_text, _cache_plan
    _cache_text = _cache_plan = None


def _matches_member(ev: dict, member: int) -> bool:
    m = ev.get("member", "all")
    if m == "all":
        return True
    if isinstance(m, (list, tuple)):
        return int(member) in [int(x) for x in m]
    return int(m) == int(member)


def straggler_sleep_s(ev: dict) -> float:
    """A straggler's stall: ``sleep_s`` plus a jitter in [0, ``jitter_s``)
    from ``random.Random(event id)``, the JAX package's draw."""
    base = float(ev.get("sleep_s", 1.0))
    jitter = float(ev.get("jitter_s", 0.0))
    if jitter <= 0.0:
        return base
    return base + random.Random(int(ev["id"])).uniform(0.0, jitter)


def member_fault(generation, member: int) -> None:
    """Rollout faults of one (generation, member): ``straggler`` sleeps,
    ``rollout_exc`` raises :class:`ChaosError`."""
    plan = active_plan()
    if plan is None:
        return
    gen = int(generation)
    for ev in plan.events_at(gen, "straggler"):
        if _matches_member(ev, member) and plan.fire(ev):
            time.sleep(straggler_sleep_s(ev))
    for ev in plan.events_at(gen, "rollout_exc"):
        if _matches_member(ev, member) and plan.fire(ev):
            raise ChaosError(f"injected rollout exception (gen {gen}, member {member})")


def _matches_host(ev: dict, host: int) -> bool:
    h = ev.get("host", "all")
    if h == "all":
        return True
    if isinstance(h, (list, tuple)):
        return int(host) in [int(x) for x in h]
    return int(h) == int(host)


def host_fault(dispatch, host: int) -> bool:
    """Host faults of one (dispatch, host) of an elastic run, or one
    (generation, rank) of the synchronous multi-rank loop.
    ``straggle_host`` sleeps as ``straggler`` does; returns True when a
    ``kill_host`` fired: the caller owns the death (a host process SIGKILLs
    itself, a host thread drops its connection)."""
    plan = active_plan()
    if plan is None:
        return False
    gen = int(dispatch)
    for ev in plan.events_at(gen, "straggle_host"):
        if _matches_host(ev, host) and plan.fire(ev):
            time.sleep(straggler_sleep_s(ev))
    return any(plan.fire(ev) for ev in plan.events_at(gen, "kill_host")
               if _matches_host(ev, host))


def mutate_fitness(generation, fitness):
    """``nan_fitness``: a copy of ``fitness`` with the event's members NaN,
    or the input itself when nothing fires."""
    plan = active_plan()
    if plan is None:
        return fitness
    import numpy as np

    out = fitness
    for ev in plan.events_at(int(generation), "nan_fitness"):
        if plan.fire(ev):
            out = np.array(out, np.float32, copy=True)
            m = ev.get("member", "all")
            if m == "all":
                out[:] = np.nan
            else:
                out[np.asarray(m if isinstance(m, (list, tuple)) else [m], np.intp)] = np.nan
    return out


def kill_workers(generation, pids) -> list[int]:
    """``kill_worker``: SIGKILL the scheduled workers; returns the pids killed."""
    plan = active_plan()
    if plan is None:
        return []
    killed: list[int] = []
    for ev in plan.events_at(int(generation), "kill_worker"):
        w = int(ev.get("worker", 0))
        if 0 <= w < len(pids) and plan.fire(ev):
            os.kill(pids[w], signal.SIGKILL)
            killed.append(pids[w])
    return killed


def poison_update(generation) -> bool:
    """``nan_update``: True when this generation's update direction is to
    be poisoned (the post-update guard must reject it)."""
    plan = active_plan()
    if plan is None:
        return False
    return any(plan.fire(ev) for ev in plan.events_at(int(generation), "nan_update"))


def crash_checkpoint(generation) -> None:
    """``ckpt_crash``: raise mid-checkpoint (the caller has written the
    sidecar files and not committed the payload)."""
    plan = active_plan()
    if plan is None:
        return
    for ev in plan.events_at(int(generation), "ckpt_crash"):
        if plan.fire(ev):
            raise ChaosError(f"injected checkpoint-write crash (gen {int(generation)})")


def process_kill(generation) -> None:
    """``die``: SIGKILL this whole process.  ``fire`` writes the ledger
    before the kill, so the restarted replay of the generation lives."""
    plan = active_plan()
    if plan is None:
        return
    for ev in plan.events_at(int(generation), "die"):
        if plan.fire(ev):
            os.kill(os.getpid(), signal.SIGKILL)


def serve_faults(elapsed_s: float) -> list[dict]:
    """The serving fleet's due faults (one environment lookup when
    ``ESTORCH_CHAOS`` is unset): the claimed ``kill_replica`` /
    ``wedge_replica`` events, which the fleet's monitor maps to its
    replicas' processes."""
    plan = active_plan()
    if plan is None:
        return []
    return plan.serve_events_due(elapsed_s)


def process_wedge(generation) -> None:
    """``wedge``: sleep ``sleep_s`` (default an hour) without beating; the
    supervisor's staleness watchdog must find and kill this process."""
    plan = active_plan()
    if plan is None:
        return
    for ev in plan.events_at(int(generation), "wedge"):
        if plan.fire(ev):
            time.sleep(float(ev.get("sleep_s", 3600.0)))
