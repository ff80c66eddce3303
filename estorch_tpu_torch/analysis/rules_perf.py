"""Measurement-honesty rules: R07 unfenced-device-timing, R09
nonmonotonic-span-clock, R12 gauge-shaped-latency, R14
compile-in-request-path.

CUDA launches are asynchronous: a kernel launch, a torch op on a card
tensor, a CUDA graph's replay all return as soon as the work is queued,
and the card runs it in the background.  So

    t0 = time.perf_counter()
    out = weighted_noise_sum(table, offs, w, dim)
    dt = time.perf_counter() - t0        # measures the LAUNCH, not the work

silently reports microseconds for milliseconds of card work — the
classic way a "10x speedup" enters a benchmark table and later
evaporates.  The fix is a fence between the launch and the second clock
read: ``torch.cuda.synchronize()``, ``event.synchronize()`` /
``start.elapsed_time(end)``, or any host copy of the outputs
(``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, ``np.asarray``).

R07 flags a ``perf_counter``/``time``/``monotonic`` delta whose window
contains *provable* card work with no fence between that work and the
closing clock read.  "Provable" is deliberately conservative (the
R02/R03 philosophy — silence over noise): a call of a name bound from
``torch.compile(...)``/``make_graphed_callables(...)`` in this module
(``self.<attr>`` assignments included) or of a captured def, a CUDA
graph's ``.replay()``, one of the port's kernel wrappers
(``weighted_noise_sum``, ``population_noise_matvec``), a ``.cuda()`` /
``.to("cuda...")`` copy, or a ``torch.*`` call given ``device="cuda..."``.
"""

from __future__ import annotations

import ast
import re

from .context import CAPTURE_CALLS, ModuleContext
from .engine import get_rule, iter_scopes, make_finding, rule, scope_nodes, walk_tree

_CLOCK_CALLS = {"time.time", "time.perf_counter", "time.monotonic"}

# host reads that wait for pending card work.  np.asarray & friends only
# fence the tensors THEY are given — but treating any window with some
# host read in it as fenced is the conservative choice (false silence
# beats false noise; the baseline handles true positives)
_FENCE_CALLS = {"torch.cuda.synchronize", "numpy.asarray", "numpy.array",
                "numpy.asanyarray"}
_FENCE_METHODS = {"synchronize", "elapsed_time", "item", "tolist", "cpu", "numpy"}

# the port's kernel wrappers (ops/noise_kernels.py): each launches a kernel
_KERNEL_WRAPPERS = {"weighted_noise_sum", "population_noise_matvec"}


def _is_clock_call(ctx: ModuleContext, node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and ctx.resolve(node.func) in _CLOCK_CALLS)


def _captured_names(ctx: ModuleContext) -> tuple[set[str], set[str]]:
    """Module-wide (plain names, attribute names) bound to captured
    callables: ``f = torch.compile(g)`` and ``self._step =
    torch.compile(...)``, plus the captured defs.  Attribute names are
    collected module-wide — cross-method ``self._step(...)`` is the
    common engine idiom."""
    names: set[str] = set()
    attrs: set[str] = set()
    for node in walk_tree(ctx.tree):
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and ctx.resolve(node.value.func) in CAPTURE_CALLS):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                names.add(tgt.id)
            elif isinstance(tgt, ast.Attribute):
                attrs.add(tgt.attr)
    for fn in ctx.captured:
        name = getattr(fn, "name", None)
        if name:
            names.add(name)
    return names, attrs


def _card_device(node: ast.AST | None) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and node.value.startswith("cuda"))


def _call_kind(ctx: ModuleContext, node: ast.Call,
               cap_names: set[str], cap_attrs: set[str]) -> str | None:
    """"launch", "fence", or None for one Call node."""
    func = node.func
    resolved = ctx.resolve(func)
    if resolved in _FENCE_CALLS:
        return "fence"
    if isinstance(func, ast.Attribute):
        if func.attr in _FENCE_METHODS and (not node.args or func.attr == "elapsed_time"):
            return "fence"
        if func.attr in cap_attrs or func.attr == "replay":
            return "launch"
        if func.attr == "cuda" and not node.args:
            return "launch"
        if func.attr == "to" and node.args and _card_device(node.args[0]):
            return "launch"
    elif isinstance(func, ast.Name) and func.id in cap_names:
        return "launch"
    if resolved is not None:
        if resolved.rsplit(".", 1)[-1] in _KERNEL_WRAPPERS:
            return "launch"
        if resolved.startswith("torch.") and _card_device(
                next((kw.value for kw in node.keywords if kw.arg == "device"), None)):
            return "launch"
    return None


@rule("R07", "unfenced-device-timing", "warning",
      "wall-clock delta around card work (a kernel, a captured call, a "
      "copy to the card) without torch.cuda.synchronize()/an event fence "
      "measures the launch, not the work")
def check_unfenced_timing(ctx: ModuleContext):
    r = get_rule("R07")
    cap_names, cap_attrs = _captured_names(ctx)
    out = []
    for symbol, scope in iter_scopes(ctx):
        starts: list[tuple[str, int]] = []  # (timer var, lineno)
        deltas: list[tuple[str, int, ast.AST]] = []  # (var, lineno, node)
        calls: list[tuple[str, int]] = []  # (kind, lineno)
        for node in scope_nodes(scope):
            if (isinstance(node, ast.Assign)
                    and _is_clock_call(ctx, node.value)):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        starts.append((tgt.id, node.lineno))
            elif (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)
                    and _is_clock_call(ctx, node.left)
                    and isinstance(node.right, ast.Name)):
                deltas.append((node.right.id, node.lineno, node))
            elif isinstance(node, ast.Call):
                kind = _call_kind(ctx, node, cap_names, cap_attrs)
                if kind is not None:
                    calls.append((kind, node.lineno))
        for var, d_line, d_node in deltas:
            t_lines = [ln for v, ln in starts if v == var and ln < d_line]
            if not t_lines:
                continue
            t_line = max(t_lines)  # nearest start of THIS window
            unfenced = None
            # same-line tie-break: launch before fence, so the idiom
            # `kernel(...).cpu()` (fence wrapping the launch on one line)
            # counts as fenced
            order = {"launch": 0, "fence": 1}
            for kind, c_line in sorted(
                    calls, key=lambda kc: (kc[1], order[kc[0]])):
                if not (t_line < c_line <= d_line):
                    continue
                if kind == "launch":
                    unfenced = c_line
                elif kind == "fence":
                    unfenced = None  # everything launched so far is fenced
            if unfenced is not None:
                out.append(make_finding(
                    ctx, r, d_node,
                    f"`{var}` delta spans card work (line {unfenced}) with "
                    "no fence before the second clock read — this measures "
                    "the asynchronous launch, not the card's work",
                    "call torch.cuda.synchronize() (or time with CUDA "
                    "events and event.synchronize()) before taking the delta",
                    symbol))
    return out


# ---------------------------------------------------------------------
# R09: wall-clock (time.time) used for an elapsed-time measurement
# ---------------------------------------------------------------------
#
# ``time.time()`` is the WALL clock: NTP steps, leap smearing, and
# suspend/resume move it — backwards included.  Using it to time a span
# or age a within-process timestamp silently corrupts exactly the
# telemetry that perf gates and staleness watchdogs trust; the monotonic
# clocks (``time.perf_counter()``/``time.monotonic()``) exist for this.
#
# Wall time IS required when the timestamp crosses a process boundary
# (the heartbeat protocol: writer pid != reader pid, so no monotonic
# clock is shared — obs/recorder.py's ``age_s`` must stay wall-clock).
# The rule is therefore conservative: it only flags a delta whose BOTH
# ends are provably this module's own ``time.time()`` reads — a start
# bound from ``time.time()`` in the same scope (or a ``self.<attr>``
# assigned from it anywhere in the module) subtracted from a fresh
# ``time.time()`` call.  A start read from a file/dict (the heartbeat
# reader) is untyped and stays silent.

_WALL_CLOCK = "time.time"


def _is_wall_call(ctx: ModuleContext, node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and ctx.resolve(node.func) == _WALL_CLOCK)


@rule("R09", "nonmonotonic-span-clock", "warning",
      "time.time() delta measures elapsed time with the wall clock — "
      "NTP steps/suspend skew spans and ages; use time.perf_counter() "
      "or time.monotonic()")
def check_nonmonotonic_span_clock(ctx: ModuleContext):
    r = get_rule("R09")
    # self.<attr> = time.time() is collected module-wide: the serving/
    # supervisor idiom stamps the start in __init__ and takes the delta
    # in another method
    wall_attrs: set[str] = set()
    for node in walk_tree(ctx.tree):
        if isinstance(node, ast.Assign) and _is_wall_call(ctx, node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute):
                    wall_attrs.add(tgt.attr)
    out = []
    for symbol, scope in iter_scopes(ctx):
        wall_names: set[str] = set()
        deltas: list[ast.BinOp] = []
        for node in scope_nodes(scope):
            if isinstance(node, ast.Assign) and _is_wall_call(
                    ctx, node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        wall_names.add(tgt.id)
            elif (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)
                    and _is_wall_call(ctx, node.left)):
                deltas.append(node)
        for node in deltas:
            right = node.right
            start = None
            if isinstance(right, ast.Name) and right.id in wall_names:
                start = f"`{right.id}`"
            elif (isinstance(right, ast.Attribute)
                    and right.attr in wall_attrs):
                start = f"`self.{right.attr}`-style attribute"
            if start is not None:
                out.append(make_finding(
                    ctx, r, node,
                    f"elapsed time measured as time.time() minus {start} "
                    "(also bound from time.time()) — the wall clock can "
                    "step backwards under NTP/suspend, corrupting the "
                    "span/age",
                    "bind both ends to time.perf_counter() (spans) or "
                    "time.monotonic() (ages/deadlines); keep time.time() "
                    "only for timestamps that cross a process boundary",
                    symbol))
    return out


# ---------------------------------------------------------------------
# R12: a perf_counter/monotonic DURATION recorded through a gauge
# ---------------------------------------------------------------------
#
# A gauge is last-write-wins: ``hub.gauge("predict_ms", dt)`` keeps
# whichever batch happened to finish last, which is almost never the
# sample the tail lives in — a 5x slowdown on 1% of requests is
# invisible the moment the next normal batch overwrites it.  Durations
# belong in a streaming histogram (``hub.observe`` / ``hists.observe``,
# obs/hist.py), whose bucket counts keep every sample's contribution to
# p99.  The rule is conservative (the R02/R03 philosophy): it only
# flags a ``.gauge(...)`` call whose VALUE expression provably carries a
# monotonic-clock delta — the delta taken inline, or a name bound from
# ``time.perf_counter()/time.monotonic() - <start>`` in the same scope.
# Gauges of genuinely last-write facts (queue depth, ratios, sums
# re-derivable elsewhere) stay silent.

_MONO_CLOCK_CALLS = {"time.perf_counter", "time.monotonic"}


def _is_mono_clock_call(ctx: ModuleContext, node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and ctx.resolve(node.func) in _MONO_CLOCK_CALLS)


def _is_mono_delta(ctx: ModuleContext, node: ast.AST,
                   mono_names: set[str]) -> bool:
    """Is this expression a monotonic-clock delta (``clock() - x`` or
    ``now - t0`` with both sides clock-bound)?"""
    if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)):
        return False
    left_clock = (_is_mono_clock_call(ctx, node.left)
                  or (isinstance(node.left, ast.Name)
                      and node.left.id in mono_names))
    return left_clock


@rule("R12", "gauge-shaped-latency", "warning",
      "a perf_counter/monotonic duration recorded via a last-write-wins "
      "gauge destroys the tail — observe it into a histogram instead")
def check_gauge_shaped_latency(ctx: ModuleContext):
    r = get_rule("R12")
    out = []
    for symbol, scope in iter_scopes(ctx):
        mono_names: set[str] = set()   # t0 = time.perf_counter()
        delta_names: set[str] = set()  # dt = time.perf_counter() - t0
        gauges: list[ast.Call] = []
        for node in scope_nodes(scope):
            if isinstance(node, ast.Assign):
                if _is_mono_clock_call(ctx, node.value):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            mono_names.add(tgt.id)
                elif _is_mono_delta(ctx, node.value, mono_names):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            delta_names.add(tgt.id)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "gauge"
                  and len(node.args) >= 2):
                gauges.append(node)
        for call in gauges:
            value = call.args[1]
            duration = None
            if _is_mono_delta(ctx, value, mono_names):
                duration = "an inline clock delta"
            else:
                for sub in ast.walk(value):
                    if isinstance(sub, ast.Name) and sub.id in delta_names:
                        duration = f"`{sub.id}` (a clock delta)"
                        break
                    if _is_mono_delta(ctx, sub, mono_names):
                        duration = "an inline clock delta"
                        break
            if duration is not None:
                out.append(make_finding(
                    ctx, r, call,
                    f"gauge value is {duration}: last-write-wins keeps "
                    "only the final sample, so the latency tail (the p99 "
                    "a shed or recompile ruins) is erased",
                    "record the duration with hists.observe(name, dt) "
                    "(obs/hist.py streaming histogram); keep gauges for "
                    "genuinely last-write facts like queue depth",
                    symbol))
    return out


# ---------------------------------------------------------------------
# R14: a compile or a native build in a per-request/per-call scope
# ---------------------------------------------------------------------
#
# ``torch.compile(...)`` returns a WRAPPER whose compiled graphs are
# cached ON THAT WRAPPER OBJECT (a new wrapper recompiles); a TorchScript
# ``torch.jit.script``/``trace`` compiles anew at each call of it; and
# ``torch.utils.cpp_extension.load*`` or the port's ``ops/_build.py``
# loader (``build``/``load_library``) hashes the sources and, on a miss,
# runs nvcc.  Construct them once at load time and every call after the
# first reuses the result; construct them inside a request handler or a
# dispatch loop and every single call pays a compile (or at least the
# source hash and the lock) — the serving-path recompile storm the warm
# bundle exists to kill.  The rule flags these constructions in the two
# shapes that are per-call by construction:
#
# * anywhere inside an HTTP handler method (``do_GET``/``do_POST``/…) —
#   stdlib http.server calls these once per request;
# * inside a ``for``/``while`` loop body, EXCEPT in recognized load-time
#   scopes where building a ladder of programs in a loop is the
#   legitimate idiom: module level, ``__init__``/``__post_init__``, and
#   functions named for set-up (``build``/``init``/``setup``/``load``/
#   ``warm``/``compile``/``export``/``make`` in the name).

_HANDLER_RE = re.compile(r"(^|\.)do_[A-Z]+$")
_SETUP_NAME_PARTS = ("build", "init", "setup", "load", "warm", "compile",
                     "export", "make")
_COMPILE_CTORS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                  "torch.utils.cpp_extension.load",
                  "torch.utils.cpp_extension.load_inline"}
_LOADER_TAILS = ("build", "load_library")


def _is_compile_call(ctx: ModuleContext, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    resolved = ctx.resolve(node.func)
    if resolved is None:
        return False
    if resolved in _COMPILE_CTORS:
        return True
    head, _, tail = resolved.rpartition(".")
    return tail in _LOADER_TAILS and head.rsplit(".", 1)[-1] == "_build"


def _loop_compile_calls(ctx: ModuleContext, loop: ast.AST):
    """Compile calls inside one loop's per-iteration subtree, nested defs
    excluded.  A ``for``'s iterator/target evaluate ONCE, before the loop
    — so only body/orelse are walked; a ``while``'s test re-runs every
    iteration and stays in scope."""
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        stack = list(loop.body) + list(loop.orelse)
    else:
        stack = list(ast.iter_child_nodes(loop))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if _is_compile_call(ctx, node):
            yield node
        stack.extend(ast.iter_child_nodes(node))


@rule("R14", "compile-in-request-path", "error",
      "torch.compile / torch.jit / cpp_extension.load / the ops/_build.py "
      "loader called inside a per-request/per-call scope compiles on every "
      "call — hoist it to load time and reuse the result")
def check_compile_in_request_path(ctx: ModuleContext):
    r = get_rule("R14")
    out = []
    seen: set[int] = set()

    def report(node: ast.AST, symbol: str, where: str) -> None:
        if id(node) in seen:
            return
        seen.add(id(node))
        out.append(make_finding(
            ctx, r, node,
            f"`{ctx.resolve(node.func)}` called {where} — the compiled "
            "result caches on what it returns, so calling it per call "
            "means compiling (or hashing and locking the build) per call",
            "call it once at load/init time (the server's engine build, "
            "__init__, a module-level set-up function) and reuse what it returned",
            symbol))

    for symbol, scope in iter_scopes(ctx):
        if _HANDLER_RE.search(symbol):
            for node in scope_nodes(scope):
                if _is_compile_call(ctx, node):
                    report(node, symbol,
                           "inside an HTTP request handler (called once "
                           "per request)")
        name = symbol.rsplit(".", 1)[-1].lower()
        if (symbol == "<module>" or name in ("__init__", "__post_init__")
                or any(part in name for part in _SETUP_NAME_PARTS)):
            continue
        for node in scope_nodes(scope):
            if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
                for call in _loop_compile_calls(ctx, node):
                    report(call, symbol,
                           "inside a loop body (a compile per iteration)")
    return out
