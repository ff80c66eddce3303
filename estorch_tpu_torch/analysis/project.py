"""Whole-program view: cross-module linking for the lockset rules.

The per-file :class:`~estorch_tpu_torch.analysis.context.ModuleContext` is
blind to the bug class that actually corrupts async-folded updates:
data races.  ``serve/router.py`` writes ``rep.health`` from a poll
thread while ``serve/fleet.py``'s monitor thread respawns the replica
behind it — no single file shows both sides.  This module adds the
cross-module layer:

* :func:`build_summary` distills one ModuleContext into a picklable
  :class:`ModuleSummary` — attribute writes with their lexical lockset,
  lock-acquisition edges, blocking calls under locks, thread creations
  and joins, call sites, and concurrency roots (``threading.Thread``
  targets, ``do_*`` HTTP handler methods, callback kwargs,
  ``signal.signal`` handlers).  Summaries are what the process-pool
  workers ship back to the parent, so every field is a frozen
  dataclass of strings and ints.
* :class:`ProjectContext` links summaries into the whole-program view:
  a name-resolved call graph, the set of functions reachable from a
  concurrency root, and per-callee locksets ("is this helper ALWAYS
  called under a lock?").

The lockset model is deliberately lexical (a ``with lock:`` block in
the same function body) plus ONE level of call expansion for lock-order
edges.  That misses locks held across deep call chains — accepted, per
the R02/R03 philosophy: a missed race is recoverable via the
interleaving harness; a false "race" on correct code teaches people to
ignore the analyzer.

Lock identity is spelling-based: ``self.X`` inside ``class C`` is
``C.X``, anything else is its dotted spelling.  An expression counts as
a lock when the module assigns it from ``threading.Lock/RLock/
Condition/Semaphore`` anywhere, or when its last segment ends in
``lock``/``mutex`` (the fleet's ``rep.lock``, ``self._canary_lock``).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from .context import ModuleContext, dotted_name
from .findings import Finding

_LOCK_FACTORY_TAILS = {"Lock", "RLock", "Condition", "Semaphore",
                       "BoundedSemaphore"}
_LOCKISH_NAME = re.compile(r"(?i)(lock|mutex)$")
_FN_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

# R21 fodder: calls that block indefinitely by default.  The first set
# blocks regardless of arguments (recv takes a size, not a timeout);
# the second only when called with no args and no timeout=/block= kwarg
# (so dict.get(k), t.join(5), proc.wait(timeout=10) stay silent).
_ALWAYS_BLOCKING_TAILS = {"accept", "recv", "recv_into", "recvfrom",
                          "getresponse"}
_ZERO_ARG_BLOCKING_TAILS = {"wait", "join", "communicate", "get"}

# kwarg names whose callable value is a concurrency root: the function
# will run on someone else's thread/timer/request, not the caller's.
# `target=` deliberately ABSENT: threading.Thread targets are rooted by
# the Thread-specific path, and a multiprocessing.Process target runs
# in its own address space — its writes cannot race this process
_CALLBACK_KWARG = re.compile(r"^(callback|on_[a-z0-9_]+"
                             r"|[a-z0-9_]+_(?:cb|callback|hook))$")


@dataclass(frozen=True)
class Site:
    """Where a record was extracted — enough to build a Finding later."""
    line: int
    col: int
    snippet: str


@dataclass(frozen=True)
class AttrWrite:
    kind: str  # "self" | "foreign"
    owner: str  # class name for self-writes, receiver spelling otherwise
    attr: str
    symbol: str  # qualname of the writing function
    locks: tuple[str, ...]  # lexically held locks at the write
    in_init: bool
    site: Site


@dataclass(frozen=True)
class LockEdge:
    outer: str
    inner: str
    symbol: str
    site: Site


@dataclass(frozen=True)
class BlockingCall:
    desc: str  # "conn.recv()" — the spelled call head
    locks: tuple[str, ...]
    receiver_is_held_lock: bool  # `with cond: cond.wait()` — exempt
    symbol: str
    site: Site


@dataclass(frozen=True)
class ThreadCreate:
    daemon: bool
    target: str  # resolved target ident ("C._poll_loop", "fn") or ""
    stored: str  # storage ident, "list:xs" for appends, "" if dropped
    symbol: str
    site: Site


@dataclass(frozen=True)
class CallSite:
    caller: str  # qualname of the calling function
    callee: str  # raw spelling: "self.m", "f", "mod.f"
    cls: str  # enclosing class of the caller ("" at module level)
    locks: tuple[str, ...]
    site: Site


@dataclass(frozen=True)
class ModuleSummary:
    """Everything the project pass needs from one module — picklable."""
    path: str
    module: str  # dotted module name guessed from the path
    aliases: dict[str, str] = field(default_factory=dict)
    attr_writes: tuple[AttrWrite, ...] = ()
    lock_edges: tuple[LockEdge, ...] = ()
    acquires: dict[str, tuple[str, ...]] = field(default_factory=dict)
    blocking_calls: tuple[BlockingCall, ...] = ()
    thread_creates: tuple[ThreadCreate, ...] = ()
    joined: frozenset[str] = frozenset()
    daemon_marked: frozenset[str] = frozenset()
    call_sites: tuple[CallSite, ...] = ()
    roots: frozenset[str] = frozenset()
    lock_defs: dict[str, str] = field(default_factory=dict)
    functions: frozenset[str] = frozenset()
    classes: frozenset[str] = frozenset()


def module_name_of(path: str) -> str:
    name = path.replace("\\", "/")
    if name.endswith(".py"):
        name = name[:-3]
    if name.endswith("/__init__"):
        name = name[: -len("/__init__")]
    return name.strip("/").replace("/", ".")


def _collect_lock_defs(ctx: ModuleContext) -> dict[str, str]:
    """ident -> factory tail for every ``X = threading.Lock()``-shaped
    assignment, regardless of where it appears (class body order must
    not matter: methods above ``__init__`` still see ``self._lock``).
    Scans the call-valued assigns the context pass already collected."""
    lock_defs: dict[str, str] = {}
    for assign, cls in ctx.call_assigns:
        resolved = ctx.resolve(assign.value.func) or ""
        tail = resolved.rsplit(".", 1)[-1]
        if tail in _LOCK_FACTORY_TAILS:
            for t in assign.targets:
                ident = _ident(t, cls)
                if ident:
                    lock_defs[ident] = tail
    return lock_defs


def _ident(expr: ast.AST, cls: str) -> str | None:
    """Canonical spelling of a name/attribute: ``self.X`` in class C
    becomes ``C.X`` so locks and thread targets match across methods."""
    d = dotted_name(expr)
    if d is None:
        return None
    if cls and (d == "self" or d.startswith("self.")):
        rest = d[5:]
        return f"{cls}.{rest}" if rest else cls
    return d


def build_summary(ctx: ModuleContext) -> ModuleSummary:
    lock_defs = _collect_lock_defs(ctx)
    attr_writes: list[AttrWrite] = []
    lock_edges: list[LockEdge] = []
    acquires: dict[str, set[str]] = {}
    blocking: list[BlockingCall] = []
    threads: list[ThreadCreate] = []
    joined: set[str] = set()
    daemon_marked: set[str] = set()
    call_sites: list[CallSite] = []
    roots: set[str] = set()
    classes: set[str] = set()
    handled_calls: set[ast.Call] = set()  # Thread() calls already recorded
    # spawn-helper indirection: `def spawn(name, target): Thread(target=
    # target)` makes every callable argument at spawn() call sites a root
    spawner_syms: set[str] = set()
    call_args: list[tuple[str, tuple[str, ...]]] = []
    # `for target, name in ((self._poll_loop, "poll"), ...)` — idents
    # mentioned in literal loop iterables, per function, so a spawner
    # looping over (callable, name) pairs still roots the callables
    literal_loop_idents: dict[str, set[str]] = {}

    def site(node: ast.AST) -> Site:
        line = getattr(node, "lineno", 0)
        return Site(line, getattr(node, "col_offset", 0), ctx.line_at(line))

    def is_lock(ident: str | None) -> bool:
        if not ident:
            return False
        return ident in lock_defs or bool(
            _LOCKISH_NAME.search(ident.rsplit(".", 1)[-1]))

    def is_thread_call(node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and (ctx.resolve(node.func) or "").endswith(
                    "threading.Thread"))

    def value_is_foreign(value: ast.AST, scope: dict) -> bool:
        """Does this expression yield an object someone else may hold?
        Calls are fresh (constructor/copy results); anything referencing
        ``self`` or a foreign name (param, shared-iterable loop var) is
        foreign."""
        if isinstance(value, ast.Call):
            return False
        for n in ast.walk(value):
            if isinstance(n, ast.Name) and (
                    n.id == "self" or n.id in scope["foreign"]):
                return True
        return False

    def scoped(ident: str, symbol: str) -> str:
        """Bare local names are per-function: `t` in start() and `t` in
        an unrelated helper must not satisfy each other's join."""
        if ident and "." not in ident and not ident.startswith("list:"):
            return f"{symbol}:{ident}"
        return ident

    def record_thread(call: ast.Call, stored: str, symbol: str,
                      cls: str) -> None:
        handled_calls.add(call)
        stored = scoped(stored, symbol)
        daemon = False
        target = ""
        for kw in call.keywords:
            if kw.arg == "daemon":
                daemon = (isinstance(kw.value, ast.Constant)
                          and kw.value.value is True)
            elif kw.arg == "target":
                target = _ident(kw.value, cls) or ""
        if target:
            roots.add(target)
            # target is a bare name with no matching def: the enclosing
            # function is a spawn helper and ITS callers supply the real
            # target — their callable arguments become roots (post-pass)
            if "." not in target and target not in ctx.defs_by_name:
                spawner_syms.add(symbol)
        threads.append(ThreadCreate(daemon=daemon, target=target,
                                    stored=stored, symbol=symbol,
                                    site=site(call)))

    seen_calls: set[ast.Call] = set()  # one record per Call node

    def handle_call(call: ast.Call, symbol: str, cls: str,
                    locks: tuple[str, ...]) -> None:
        if call in seen_calls:
            return
        seen_calls.add(call)
        func = call.func
        resolved = ctx.resolve(func) or ""
        if (isinstance(func, ast.Attribute) and func.attr == "append"
                and call.args and is_thread_call(call.args[0])
                and call.args[0] not in handled_calls):
            recv = _ident(func.value, cls)
            record_thread(call.args[0], f"list:{recv}" if recv else "",
                          symbol, cls)
        if call not in handled_calls and is_thread_call(call):
            record_thread(call, "", symbol, cls)
        # callback kwargs / signal handlers are concurrency roots
        for kw in call.keywords:
            if (kw.arg and _CALLBACK_KWARG.match(kw.arg)
                    and isinstance(kw.value, (ast.Name, ast.Attribute))):
                ident = _ident(kw.value, cls)
                if ident:
                    roots.add(ident)
        if resolved == "signal.signal" and len(call.args) >= 2:
            ident = _ident(call.args[1], cls)
            if ident:
                roots.add(ident)
        if isinstance(func, ast.Attribute):
            tail = func.attr
            recv = _ident(func.value, cls)
            # thread joins: X.join() / X.join(t) — sep.join(parts) has a
            # non-timeout positional and is excluded by the arg shapes
            if tail == "join" and recv and len(call.args) <= 1:
                joined.add(scoped(recv, symbol))
            has_timeout = any(kw.arg in ("timeout", "block")
                              for kw in call.keywords)
            blocking_shape = (
                tail in _ALWAYS_BLOCKING_TAILS and not has_timeout
            ) or (
                tail in _ZERO_ARG_BLOCKING_TAILS
                and not call.args and not has_timeout
            ) or resolved == "time.sleep" or (
                resolved.endswith("urlopen") and not has_timeout
            )
            if blocking_shape and locks:
                blocking.append(BlockingCall(
                    desc=f"{dotted_name(func) or tail}()", locks=locks,
                    receiver_is_held_lock=recv in locks,
                    symbol=symbol, site=site(call)))
        spelled = dotted_name(func)
        if spelled:
            call_sites.append(CallSite(caller=symbol, callee=spelled,
                                       cls=cls, locks=locks,
                                       site=site(call)))
            arg_idents = tuple(
                i for i in (
                    _ident(a, cls) for a in call.args
                    if isinstance(a, (ast.Name, ast.Attribute)))
                if i)
            if arg_idents:
                call_args.append((spelled, arg_idents))

    def record_attr_write(target: ast.Attribute, symbol: str, cls: str,
                          locks: tuple[str, ...], scope: dict,
                          at: ast.AST) -> None:
        base = target.value
        base_dotted = dotted_name(base) or ""
        if target.attr == "daemon":
            recv = _ident(base, cls)
            if recv:
                daemon_marked.add(scoped(recv, symbol))
            return
        if base_dotted == "self" or base_dotted.startswith("self."):
            attr_writes.append(AttrWrite(
                kind="self", owner=cls or "<module>", attr=target.attr,
                symbol=symbol, locks=locks,
                in_init=symbol.endswith("__init__"), site=site(at)))
        elif value_is_foreign(base, scope):
            attr_writes.append(AttrWrite(
                kind="foreign", owner=base_dotted or "<expr>",
                attr=target.attr, symbol=symbol, locks=locks,
                in_init=False, site=site(at)))

    def walk(node: ast.AST, symbol: str, cls: str,
             locks: tuple[str, ...], scope: dict) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                classes.add(child.name)
                # HTTP handler classes: every do_* method runs on the
                # server's request thread — each is a concurrency root.
                # ctx.qualnames carries the full nesting prefix, so
                # handler classes built inside factory closures root as
                # "_make_handler.RouterHandler.do_GET"
                if any((dotted_name(b) or "").rsplit(".", 1)[-1]
                       .endswith("HTTPRequestHandler")
                       for b in child.bases):
                    for item in child.body:
                        if (isinstance(item, _FN_NODES)
                                and item.name.startswith("do_")):
                            roots.add(ctx.qualnames.get(item, item.name))
                walk(child, symbol, child.name, locks, scope)
            elif isinstance(child, _FN_NODES):
                # a nested def does not hold the caller's locks at
                # runtime, and gets its own fresh/foreign tracking
                params = {a.arg for a in child.args.args
                          + child.args.posonlyargs + child.args.kwonlyargs
                          if a.arg not in ("self", "cls")}
                inner = {"foreign": set(params), "fresh": set()}
                walk(child, ctx.qualnames.get(child, child.name),
                     cls, (), inner)
            elif isinstance(child, ast.With):
                new_locks = locks
                for item in child.items:
                    ident = _ident(item.context_expr, cls)
                    if is_lock(ident):
                        for outer in new_locks:
                            if outer != ident:
                                lock_edges.append(LockEdge(
                                    outer=outer, inner=ident,
                                    symbol=symbol, site=site(child)))
                        acquires.setdefault(symbol, set()).add(ident)
                        new_locks = new_locks + (ident,)
                    for n in ast.walk(item.context_expr):
                        if isinstance(n, ast.Call):
                            handle_call(n, symbol, cls, locks)
                walk(child, symbol, cls, new_locks, scope)
            elif isinstance(child, (ast.Assign, ast.AugAssign,
                                    ast.AnnAssign)):
                targets = (child.targets if isinstance(child, ast.Assign)
                           else [child.target])
                value = child.value
                if value is not None and is_thread_call(value):
                    stored = ""
                    if targets and not isinstance(child, ast.AugAssign):
                        stored = _ident(targets[0], cls) or ""
                    record_thread(value, stored, symbol, cls)
                for t in targets:
                    if isinstance(t, ast.Attribute):
                        record_attr_write(t, symbol, cls, locks, scope,
                                          child)
                    elif isinstance(t, ast.Name) and value is not None:
                        if value_is_foreign(value, scope):
                            scope["foreign"].add(t.id)
                        else:
                            scope["foreign"].discard(t.id)
                            scope["fresh"].add(t.id)
                    elif isinstance(t, ast.Tuple):
                        for el in t.elts:
                            if isinstance(el, ast.Attribute):
                                record_attr_write(el, symbol, cls, locks,
                                                  scope, child)
                if value is not None:
                    for n in ast.walk(value):
                        if isinstance(n, ast.Call):
                            handle_call(n, symbol, cls, locks)
            elif isinstance(child, (ast.For, ast.AsyncFor)):
                if isinstance(child.iter, (ast.Tuple, ast.List)):
                    for n in ast.walk(child.iter):
                        if isinstance(n, (ast.Name, ast.Attribute)):
                            el = _ident(n, cls)
                            if el:
                                literal_loop_idents.setdefault(
                                    symbol, set()).add(el)
                if isinstance(child.target, ast.Name):
                    if value_is_foreign(child.iter, scope):
                        scope["foreign"].add(child.target.id)
                        it = _ident(child.iter, cls)
                        if it:
                            scope.setdefault("loop_src", {})[
                                child.target.id] = f"list:{it}"
                    else:
                        scope["fresh"].add(child.target.id)
                    # `for t in xs: t.join()` joins every thread stored
                    # via xs.append(...) — match the "list:xs" ident that
                    # appended threads are stored under
                    it = _ident(child.iter, cls)
                    if it:
                        tvar = child.target.id
                        for n in ast.walk(child):
                            if (isinstance(n, ast.Call)
                                    and isinstance(n.func, ast.Attribute)
                                    and n.func.attr == "join"
                                    and isinstance(n.func.value, ast.Name)
                                    and n.func.value.id == tvar
                                    and len(n.args) <= 1):
                                joined.add(f"list:{it}")
                                break
                for n in ast.walk(child.iter):
                    if isinstance(n, ast.Call):
                        handle_call(n, symbol, cls, locks)
                walk(child, symbol, cls, locks, scope)
            elif isinstance(child, ast.Call):
                handle_call(child, symbol, cls, locks)
                walk(child, symbol, cls, locks, scope)
            else:
                walk(child, symbol, cls, locks, scope)

    module_scope = {"foreign": set(), "fresh": set()}
    walk(ctx.tree, "<module>", "", (), module_scope)

    # spawn-helper call sites: their callable args are the real targets
    spawner_tails = {sym.rsplit(".", 1)[-1] for sym in spawner_syms}
    for spelled, arg_idents in call_args:
        if spelled.rsplit(".", 1)[-1] in spawner_tails:
            roots.update(arg_idents)
    for sym in spawner_syms:
        roots.update(literal_loop_idents.get(sym, ()))

    return ModuleSummary(
        path=ctx.path,
        module=module_name_of(ctx.path),
        aliases=dict(ctx.aliases),
        attr_writes=tuple(attr_writes),
        lock_edges=tuple(lock_edges),
        acquires={k: tuple(sorted(v)) for k, v in acquires.items()},
        blocking_calls=tuple(blocking),
        thread_creates=tuple(threads),
        joined=frozenset(joined),
        daemon_marked=frozenset(daemon_marked),
        call_sites=tuple(call_sites),
        roots=frozenset(roots),
        lock_defs=lock_defs,
        functions=frozenset(ctx.qualnames.values()),
        classes=frozenset(classes),
    )


class ProjectContext:
    """The linked whole-program view the R18–R22 checks run against."""

    def __init__(self, summaries: list[ModuleSummary]):
        self.summaries = sorted(summaries, key=lambda s: s.path)
        self.by_module = {s.module: s for s in self.summaries}
        self._resolved_sites: list[tuple[ModuleSummary, CallSite,
                                         tuple[str, str] | None]] = []
        for s in self.summaries:
            for cs in s.call_sites:
                self._resolved_sites.append(
                    (s, cs, self._resolve_callee(s, cs)))
        # callee -> locksets at every known call site (for "is this
        # helper always called under a lock?")
        self.callee_locksets: dict[tuple[str, str],
                                   list[tuple[str, ...]]] = {}
        for _, cs, node in self._resolved_sites:
            if node is not None:
                self.callee_locksets.setdefault(node, []).append(cs.locks)
        self.reachable = self._compute_reachable()

    # -- name resolution ----------------------------------------------

    def _resolve_callee(self, s: ModuleSummary,
                        cs: CallSite) -> tuple[str, str] | None:
        c = cs.callee
        if c.startswith("self."):
            meth = c[5:]
            if cs.cls and f"{cs.cls}.{meth}" in s.functions:
                return (s.module, f"{cs.cls}.{meth}")
            return None
        head, _, rest = c.partition(".")
        canon = s.aliases.get(head, head)
        full = canon + ("." + rest if rest else "")
        if "." not in full:
            if full in s.functions:
                return (s.module, full)
            return None
        mod_part, _, fn = full.rpartition(".")
        mod_part = mod_part.lstrip(".")
        if not fn:
            return None
        for m, summ in self.by_module.items():
            if fn not in summ.functions:
                continue
            if (m == mod_part or m.endswith("." + mod_part)
                    or (mod_part and mod_part.endswith(m))):
                return (m, fn)
        return None

    def _root_nodes(self) -> set[tuple[str, str]]:
        nodes: set[tuple[str, str]] = set()
        for s in self.summaries:
            for r in s.roots:
                # same module first — exact qualname or nested-def tail
                # ("run" matches "Router._hedge.run")
                local = [q for q in s.functions
                         if q == r or q.endswith("." + r)]
                if local:
                    nodes.update((s.module, q) for q in local)
                    continue
                # dotted spelling of a function in another module
                mod_part, _, fn = r.rpartition(".")
                for m, summ in self.by_module.items():
                    if fn in summ.functions and (
                            m == mod_part or m.endswith("." + mod_part)):
                        nodes.add((m, fn))
        return nodes

    def _compute_reachable(self) -> set[tuple[str, str]]:
        edges: dict[tuple[str, str], set[tuple[str, str]]] = {}
        for s, cs, node in self._resolved_sites:
            if node is not None:
                edges.setdefault((s.module, cs.caller), set()).add(node)
        seen = set(self._root_nodes())
        stack = list(seen)
        while stack:
            cur = stack.pop()
            for nxt in edges.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return seen

    def is_reachable(self, module: str, symbol: str) -> bool:
        """Reachable from a concurrency root — including lexically
        nested defs, which run inside their reachable parent."""
        parts = symbol.split(".")
        for i in range(len(parts), 0, -1):
            if (module, ".".join(parts[:i])) in self.reachable:
                return True
        return False

    def always_called_locked(self, module: str, symbol: str) -> bool:
        sites = self.callee_locksets.get((module, symbol))
        return bool(sites) and all(locks for locks in sites)


def project_finding(rule_, summary: ModuleSummary, site: Site,
                    message: str, hint: str, symbol: str,
                    severity: str | None = None) -> Finding:
    return Finding(
        rule=rule_.id, file=summary.path, line=site.line, col=site.col,
        severity=severity or rule_.severity, message=message, hint=hint,
        symbol=symbol, snippet=site.snippet)
