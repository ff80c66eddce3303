"""Race rules R18–R22: the lockset pass over the whole-program view.

These are the first ``scope="project"`` rules: their check receives a
:class:`~estorch_tpu_torch.analysis.project.ProjectContext` (every module's
summary, linked), not a single ModuleContext.  The bug class is the one
CPU pytest can never see — writes that are correct in every unit test
and corrupt state only when the fleet's poll/monitor/rollout threads
interleave just wrong.

The noise budget follows R02/R03: every heuristic errs toward silence.

* R18 unguarded-shared-write — an attribute written under a lock on
  some paths and bare on others.  The locked write is the module's own
  testimony that the attribute is shared; the bare write is the race.
  Suppressed when the bare writer's name says ``locked`` (caller-holds-
  lock convention) or when every known call site of the bare writer
  already holds a lock.
* R19 lock-order-inversion — locks A and B acquired as A→B on one path
  and B→A on another (lexical nesting plus one level of call
  expansion).  Classic deadlock; reported once per unordered pair.
* R20 callback-mutates-foreign-state — a function reachable from a
  concurrency root (Thread target, HTTP ``do_*`` handler, callback
  kwarg, signal handler) writes an attribute of an object it does not
  own (a parameter or shared loop variable, not ``self``) with no lock
  held.  Locals built from calls are fresh and exempt.
* R21 await-under-lock — a blocking call (``recv``/``accept``/zero-arg
  ``wait``/``join``/``get``/``communicate``, ``time.sleep``, untimed
  ``urlopen``) while holding a lock: every other thread that wants the
  lock now waits on a socket it never sees.  ``with cond: cond.wait()``
  is the Condition protocol and exempt.
* R22 daemon-thread-orphan — a non-daemon thread that no shutdown path
  ever joins: interpreter exit blocks on it forever.  Either mark it
  ``daemon=True`` (this repo's convention for service loops) or join it
  in ``close``/``shutdown``.
"""

from __future__ import annotations

from .engine import get_rule, rule
from .project import ProjectContext, project_finding


def _locked_by_convention(pctx: ProjectContext, module: str,
                          symbol: str) -> bool:
    """The two sanctioned ways a function writes shared state bare:
    its name declares the caller holds the lock, or every known call
    site actually does."""
    tail = symbol.rsplit(".", 1)[-1]
    if "locked" in tail:
        return True
    return pctx.always_called_locked(module, symbol)


@rule("R18", "unguarded-shared-write", "warning",
      "attribute written under a lock on some paths, bare on others",
      scope="project")
def check_unguarded_shared_write(pctx: ProjectContext):
    r = get_rule("R18")
    out = []
    for s in pctx.summaries:
        # group writes per attribute; self-writes additionally keyed by
        # class so two classes' unrelated `self.x` never merge
        groups: dict[tuple[str, str], list] = {}
        for w in s.attr_writes:
            key = (f"self:{w.owner}" if w.kind == "self" else "foreign",
                   w.attr)
            groups.setdefault(key, []).append(w)
        # a locked foreign write vouches for same-attr self-writes too
        # (Replica.__init__ sets self.health; the router writes
        # rep.health under its lock) — merge self groups into a foreign
        # group for the same attr when the foreign group has evidence
        merged: dict[tuple[str, str], list] = {}
        for key, writes in groups.items():
            kind, attr = key
            if kind != "foreign" and ("foreign", attr) in groups:
                merged.setdefault(("foreign", attr), []).extend(writes)
            else:
                merged.setdefault(key, []).extend(writes)
        for (kind, attr), writes in sorted(merged.items()):
            locked = [w for w in writes if w.locks]
            bare = [w for w in writes if not w.locks and not w.in_init]
            if not locked or not bare:
                continue
            guard = sorted({l for w in locked for l in w.locks})
            seen_sites = set()
            for w in bare:
                if _locked_by_convention(pctx, s.module, w.symbol):
                    continue
                sk = (w.site.line, w.site.col)
                if sk in seen_sites:
                    continue
                seen_sites.add(sk)
                out.append(project_finding(
                    r, s, w.site,
                    f"`.{attr}` is written under {'/'.join(guard)} "
                    f"elsewhere in this module but bare here — "
                    f"torn/stale reads on the locked paths",
                    f"hold {guard[0]} for this write too (or rename the "
                    f"helper *_locked and acquire at every call site)",
                    w.symbol))
    return out


@rule("R19", "lock-order-inversion", "error",
      "two locks acquired in opposite orders on different paths",
      scope="project")
def check_lock_order_inversion(pctx: ProjectContext):
    r = get_rule("R19")
    # edge -> first (summary, symbol, site) that exhibits it
    edges: dict[tuple[str, str], tuple] = {}
    for s in pctx.summaries:
        for e in s.lock_edges:
            edges.setdefault((e.outer, e.inner), (s, e.symbol, e.site))
        # one level of call expansion: f holds L and calls g; g acquires
        # M at any depth of its own body -> edge L->M at the call site
        for cs in s.call_sites:
            if not cs.locks:
                continue
            node = pctx._resolve_callee(s, cs)
            if node is None:
                continue
            callee_summary = pctx.by_module[node[0]]
            for inner in callee_summary.acquires.get(node[1], ()):
                for outer in cs.locks:
                    if outer != inner:
                        edges.setdefault((outer, inner),
                                         (s, cs.caller, cs.site))
    out = []
    reported = set()
    for (a, b), (s, symbol, site) in sorted(
            edges.items(), key=lambda kv: (kv[1][0].path, kv[1][2].line)):
        if (b, a) not in edges or frozenset((a, b)) in reported:
            continue
        reported.add(frozenset((a, b)))
        s2, sym2, site2 = edges[(b, a)]
        out.append(project_finding(
            r, s, site,
            f"lock order inversion: {a} → {b} here, but "
            f"{b} → {a} at {s2.path}:{site2.line} ({sym2}) — "
            f"two threads on these paths deadlock",
            f"pick one global order for {a} and {b} and acquire them "
            f"in that order on every path",
            symbol))
    return out


@rule("R20", "callback-mutates-foreign-state", "warning",
      "thread/handler-reachable code writes another object's attribute "
      "with no lock held", scope="project")
def check_callback_mutates_foreign_state(pctx: ProjectContext):
    r = get_rule("R20")
    out = []
    for s in pctx.summaries:
        for w in s.attr_writes:
            if w.kind != "foreign" or w.locks:
                continue
            if not pctx.is_reachable(s.module, w.symbol):
                continue
            if _locked_by_convention(pctx, s.module, w.symbol):
                continue
            out.append(project_finding(
                r, s, w.site,
                f"`{w.owner}.{w.attr}` written from thread/handler-"
                f"reachable code with no lock — the owner's other "
                f"threads see a torn update",
                f"acquire the lock that owns `{w.owner}` (or publish "
                f"via a queue/atomic swap instead of in-place mutation)",
                w.symbol))
    return out


@rule("R21", "await-under-lock", "warning",
      "blocking socket/subprocess/queue wait while holding a lock",
      scope="project")
def check_await_under_lock(pctx: ProjectContext):
    r = get_rule("R21")
    out = []
    for s in pctx.summaries:
        for b in s.blocking_calls:
            if b.receiver_is_held_lock:
                continue  # `with cond: cond.wait()` — Condition protocol
            out.append(project_finding(
                r, s, b.site,
                f"{b.desc} can block indefinitely while holding "
                f"{'/'.join(b.locks)} — every thread contending that "
                f"lock wedges behind this wait",
                "move the blocking call outside the with-block (snapshot "
                "under the lock, wait outside) or give it a timeout",
                b.symbol))
    return out


@rule("R22", "daemon-thread-orphan", "warning",
      "non-daemon thread that no shutdown path ever joins",
      scope="project")
def check_daemon_thread_orphan(pctx: ProjectContext):
    r = get_rule("R22")
    out = []
    for s in pctx.summaries:
        for t in s.thread_creates:
            if t.daemon:
                continue
            if t.stored and (t.stored in s.daemon_marked
                             or t.stored in s.joined):
                continue
            if t.stored:
                msg = (f"non-daemon thread stored as {t.stored} is never "
                       f"joined on any shutdown path — interpreter exit "
                       f"blocks on it forever")
            else:
                msg = ("non-daemon thread started and dropped — nothing "
                       "can ever join it, interpreter exit blocks on it "
                       "forever")
            out.append(project_finding(
                r, s, t.site, msg,
                "pass daemon=True (the service-loop convention here) or "
                "keep the handle and join it in close()/shutdown()",
                t.symbol))
    return out
