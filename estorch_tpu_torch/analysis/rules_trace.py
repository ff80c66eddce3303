"""Capture-time and device-placement rules: R02 host-sync-in-hot-path,
R03 impure-capture, R04 grad-mode-forward, R10 loop-invariant-host-copy,
R16 per-variant-launches.

R02 and R03 key off the captured-code set computed in
:mod:`~estorch_tpu_torch.analysis.context`: code the module can prove is
recorded once and replayed — ``torch.compile``, ``make_graphed_callables``
and ``with torch.cuda.graph(...)`` bodies.  R02 also reads the body of a
rollout's per-env-step loop (``for _ in range(horizon)``): the loop the
JAX package runs as one ``lax.scan`` and the port runs as host Python
launching kernels, where one host sync a step stalls the launch queue
``horizon`` times a generation.  Eager host code is never flagged by
R02/R03 — ``float(x)`` in a logging helper is fine.
"""

from __future__ import annotations

import ast

from .context import ModuleContext
from .engine import (enclosing_defs, get_rule, iter_scopes, make_finding, rule, scope_nodes,
                     symbol_map, walk_tree)

_FN_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _block_nodes(stmts: list[ast.stmt]):
    """Nodes of a statement block, nested defs not descended (their
    bodies run when called, not here)."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _captured_regions(ctx: ModuleContext):
    """(nodes, qualname, what) for every captured def and CUDA-graph
    ``with`` block of the module."""
    for fn, qualname in ctx.qualnames.items():
        if ctx.is_captured(fn):
            yield scope_nodes(fn), qualname, "captured (torch.compile / CUDA graph) code"
    enclosing = enclosing_defs(ctx.tree)
    for node in ctx.captured_withs:
        owner = enclosing.get(node)
        qualname = ctx.qualnames.get(owner, "<module>") if owner else "<module>"
        yield list(_block_nodes(node.body)), qualname, "a `torch.cuda.graph` capture"


# ---------------------------------------------------------------------
# R02 host-sync-in-hot-path
# ---------------------------------------------------------------------

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_CALLS = {  # resolved dotted names that wait for the device
    "numpy.array", "numpy.asarray", "numpy.asanyarray", "numpy.copy",
    "torch.cuda.synchronize",
}
_CAST_BUILTINS = {"float", "int", "bool", "complex"}
_STATIC_ATTRS = {"shape", "ndim", "size", "dtype", "device"}  # host metadata


def _is_static_expr(node: ast.AST) -> bool:
    """``x.shape[0]``-style expressions are host ints — casting them is
    shape arithmetic, not a host sync."""
    if isinstance(node, ast.Subscript):
        return _is_static_expr(node.value)
    if isinstance(node, ast.Attribute):
        return node.attr in _STATIC_ATTRS
    if isinstance(node, ast.BinOp):
        return _is_static_expr(node.left) and _is_static_expr(node.right)
    if isinstance(node, ast.Call):  # len(x.shape), min(x.shape, ...)
        res = node.func
        return (isinstance(res, ast.Name)
                and res.id in ("len", "min", "max", "prod")
                and all(_is_static_expr(a) or isinstance(a, ast.Constant)
                        for a in node.args))
    return isinstance(node, ast.Constant)


def _touches_tensor_value(node: ast.AST) -> bool:
    """Whether a cast argument references any plain name other than
    ``self``/``cls`` — ``float(self.config.clip)`` reads static Python
    config and is fine; ``float(loss)`` waits for the device."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id not in ("self", "cls"):
            return True
    return False


def _mentions_horizon(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        name = (sub.id if isinstance(sub, ast.Name)
                else sub.attr if isinstance(sub, ast.Attribute) else None)
        if name and "horizon" in name.lower():
            return True
    return False


def _step_loops(ctx: ModuleContext):
    """(body nodes, qualname, what) for every rollout per-env-step loop:
    ``for ... in range(<horizon>)``."""
    symbols = symbol_map(ctx)
    for node in walk_tree(ctx.tree):
        if (isinstance(node, (ast.For, ast.AsyncFor))
                and isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "range"
                and any(_mentions_horizon(a) for a in node.iter.args)):
            yield (list(_block_nodes(node.body)), symbols.get(node, "<module>"),
                   "a rollout's per-env-step loop")


@rule("R02", "host-sync-in-hot-path", "error",
      "host synchronization (.item()/.cpu()/float(t)/torch.cuda."
      "synchronize()) inside CUDA-graph or torch.compile captured code, "
      "or inside a rollout's per-env-step loop")
def check_host_sync(ctx: ModuleContext):
    r = get_rule("R02")
    out = []
    seen: set[int] = set()
    regions = list(_captured_regions(ctx)) + list(_step_loops(ctx))
    for nodes, qualname, where in regions:
        for node in nodes:
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            func = node.func
            if (isinstance(func, ast.Attribute)
                    and func.attr in _SYNC_METHODS and not node.args):
                seen.add(id(node))
                out.append(make_finding(
                    ctx, r, node,
                    f"`.{func.attr}()` waits for the device inside {where}",
                    "keep values on the device; read them on the host "
                    "after the loop or the captured call returns",
                    qualname))
                continue
            resolved = ctx.resolve(func)
            if resolved in _SYNC_CALLS:
                seen.add(id(node))
                out.append(make_finding(
                    ctx, r, node,
                    f"`{resolved}` waits for the device inside {where}",
                    "use torch ops on the device there; synchronize or "
                    "convert to numpy only after it",
                    qualname))
                continue
            if (resolved in _CAST_BUILTINS and len(node.args) == 1
                    and not isinstance(node.args[0], ast.Constant)
                    and not _is_static_expr(node.args[0])
                    and _touches_tensor_value(node.args[0])):
                seen.add(id(node))
                out.append(make_finding(
                    ctx, r, node,
                    f"`{resolved}(...)` on a tensor waits for the device "
                    f"inside {where}",
                    "keep it as a 0-d tensor, or hoist the cast out of "
                    "the loop or captured function",
                    qualname, severity="warning"))
    return out


# ---------------------------------------------------------------------
# R03 impure-capture
# ---------------------------------------------------------------------

_IMPURE_CALLS = {
    "time.time", "time.perf_counter", "time.monotonic", "time.sleep",
    "datetime.datetime.now", "datetime.datetime.utcnow", "builtins.open",
    "open", "input",
}


def _is_impure_call(resolved: str | None) -> str | None:
    if resolved is None:
        return None
    if resolved in _IMPURE_CALLS:
        return resolved
    if resolved == "print":
        return "print"
    head = resolved.rsplit(".", 1)[0]
    if head in ("numpy.random", "random"):
        return resolved
    return None


def _local_bindings(fn: ast.AST) -> set[str]:
    args = fn.args
    bound = {a.arg for a in (args.posonlyargs + args.args
                             + args.kwonlyargs)}
    if args.vararg:
        bound.add(args.vararg.arg)
    if args.kwarg:
        bound.add(args.kwarg.arg)
    for node in scope_nodes(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            bound.add(node.id)
        elif isinstance(node, _FN_NODES):
            bound.add(node.name)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            bound.add(node.name)
    return bound


@rule("R03", "impure-capture", "error",
      "side effect or hidden host state inside CUDA-graph or "
      "torch.compile captured code (runs at capture, not at replay)")
def check_impure_capture(ctx: ModuleContext):
    r = get_rule("R03")
    out = []
    for fn, qualname in ctx.qualnames.items():
        if not ctx.is_captured(fn):
            continue
        local = _local_bindings(fn)
        for node in scope_nodes(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    base = tgt
                    while isinstance(base, (ast.Attribute, ast.Subscript)):
                        base = base.value
                    if (tgt is not base and isinstance(base, ast.Name)
                            and base.id not in local
                            and base.id not in ctx.aliases):
                        out.append(make_finding(
                            ctx, r, node,
                            f"mutation of closed-over `{base.id}` in "
                            "captured code happens at capture only",
                            "return the updated value from the captured "
                            "function, or keep the state in a tensor it "
                            "updates in place",
                            qualname))
    for nodes, qualname, where in _captured_regions(ctx):
        for node in nodes:
            if isinstance(node, ast.Call):
                impure = _is_impure_call(ctx.resolve(node.func))
                if impure is not None:
                    out.append(make_finding(
                        ctx, r, node,
                        f"`{impure}` inside {where} runs once at capture, "
                        "not at each replay",
                        "draw from a torch.Generator on the device and do "
                        "host I/O and clock reads outside the captured "
                        "region",
                        qualname))
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                out.append(make_finding(
                    ctx, r, node,
                    f"`{'global' if isinstance(node, ast.Global) else 'nonlocal'}"
                    f" {', '.join(node.names)}` mutated inside {where} only "
                    "mutates at capture",
                    "thread the value through the captured function's "
                    "inputs and outputs instead",
                    qualname))
    return out


# ---------------------------------------------------------------------
# R04 grad-mode-forward
# ---------------------------------------------------------------------
#
# JAX's rollouts and serving programs are pure: nothing they compute
# survives the call, and the update donates the old state.  In torch a
# forward run in grad mode over any tensor that requires grad (a torch
# policy's nn.Parameters, on the host path and in serving) records an
# autograd graph whose saved activations stay alive as long as the
# outputs do — per env step and per request, memory that ES never uses.
# ES needs no gradient, so every forward on a rollout or serving path
# belongs under ``torch.no_grad()`` / ``torch.inference_mode()``.
#
# Conservative: a forward counts only where its name says so (a
# ``forward``/``apply_params``/``population_apply`` method, the port's
# population forwards, or calling a ``policy``/``module``/``model``), in
# a scope whose qualname names a rollout, an evaluation, a prediction or
# serving; it is clean under a grad-free ``with`` or inside a def (or
# any enclosing def) decorated grad-free.

_FORWARD_ATTRS = {"forward", "apply_params", "population_apply"}
_FORWARD_NAMES = {"member_params_apply", "mlp_streamed_apply",
                  "mlp_decomposed_population_apply", "mlp_lowrank_population_apply"}
_CALLABLE_TAILS = ("policy", "module", "model")
_PATH_TOKENS = ("rollout", "predict", "serve", "evaluate", "episode")
_NO_GRAD = {"torch.no_grad", "torch.inference_mode", "torch.autograd.no_grad",
            "torch.autograd.grad_mode.no_grad", "torch.autograd.grad_mode.inference_mode"}


def _is_no_grad(ctx: ModuleContext, expr: ast.AST) -> bool:
    if isinstance(expr, ast.Call):
        if ctx.resolve(expr.func) == "torch.set_grad_enabled":
            return bool(expr.args) and isinstance(expr.args[0], ast.Constant) \
                and expr.args[0].value is False
        expr = expr.func
    return ctx.resolve(expr) in _NO_GRAD


def _forward_name(ctx: ModuleContext, call: ast.Call) -> str | None:
    func = call.func
    if isinstance(func, ast.Attribute):
        if func.attr in _FORWARD_ATTRS:
            return f".{func.attr}"
        tail = func.attr
    elif isinstance(func, ast.Name):
        tail = func.id
    else:
        return None
    resolved = ctx.resolve(func) or tail
    if resolved.rsplit(".", 1)[-1] in _FORWARD_NAMES:
        return resolved.rsplit(".", 1)[-1]
    if tail.lower().endswith(_CALLABLE_TAILS):
        return tail
    return None


@rule("R04", "grad-mode-forward", "info",
      "a forward on a rollout or serving path outside torch.no_grad()/"
      "inference_mode() records an autograd graph ES never uses")
def check_grad_mode_forward(ctx: ModuleContext):
    r = get_rule("R04")
    enclosing = enclosing_defs(ctx.tree)

    def grad_free_def(fn: ast.AST | None) -> bool:
        while fn is not None:
            if any(_is_no_grad(ctx, d) for d in getattr(fn, "decorator_list", [])):
                return True
            fn = enclosing.get(fn)
        return False

    guarded: set[int] = set()
    for node in walk_tree(ctx.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_no_grad(ctx, item.context_expr) for item in node.items):
            guarded.update(id(n) for n in _block_nodes(node.body))
    out = []
    for symbol, scope in iter_scopes(ctx):
        if scope is ctx.tree or not any(t in symbol.lower() for t in _PATH_TOKENS):
            continue
        if grad_free_def(scope):
            continue
        for node in scope_nodes(scope):
            if not isinstance(node, ast.Call) or id(node) in guarded:
                continue
            name = _forward_name(ctx, node)
            if name is None:
                continue
            out.append(make_finding(
                ctx, r, node,
                f"`{name}(...)` runs in grad mode on a rollout or serving "
                "path: any parameter that requires grad keeps an autograd "
                "graph alive with its outputs",
                "run it under `with torch.no_grad():` (or inference_mode), "
                "or decorate the function with @torch.no_grad()",
                symbol))
    return out


# ---------------------------------------------------------------------
# R10 loop-invariant-host-copy
# ---------------------------------------------------------------------
#
# JAX's R10 catches a host array baked into a sharded program, replicated
# on every device where an operand placed once would do.  The torch form
# of the same waste is a host-to-card copy of a value that does not
# change across a loop's iterations made inside the loop: every
# iteration pays a pageable copy and a launch for bytes that could sit
# on the card from before the loop.  Flagged inside a for/while body: a
# ``torch.as_tensor``/``torch.tensor``/``torch.from_numpy(...)`` with a
# ``device=`` other than "cpu", a ``.cuda()``, or a ``.to(<device>)``
# whose source names nothing the loop binds (its target, or any name
# the body assigns).  Copies of per-iteration values (a new observation
# batch each step) stay silent.

_COPY_CTORS = {"torch.as_tensor", "torch.tensor", "torch.asarray"}
_DEVICE_HINTS = ("device", "dev", "cuda")


def _cpu_literal(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _devicey(node: ast.AST) -> bool:
    """A ``.to(...)`` argument that names a device: "cuda..." or a
    name/attribute spelled like one."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda")
    name = (node.id if isinstance(node, ast.Name)
            else node.attr if isinstance(node, ast.Attribute) else None)
    return bool(name) and any(h in name.lower() for h in _DEVICE_HINTS)


def _card_copy_source(ctx: ModuleContext, call: ast.Call) -> ast.AST | None:
    """The copied expression of a host-to-card copy, else None."""
    func = call.func
    resolved = ctx.resolve(func)
    if resolved in _COPY_CTORS and call.args:
        dev = next((kw.value for kw in call.keywords if kw.arg == "device"), None)
        if dev is not None and not _cpu_literal(dev):
            return call.args[0]
        return None
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr == "cuda" and not call.args:
        return func.value
    if func.attr == "to":
        dev = call.args[0] if call.args else next(
            (kw.value for kw in call.keywords if kw.arg == "device"), None)
        if dev is not None and _devicey(dev):
            return func.value
    return None


def _loop_bound_names(loop: ast.AST) -> set[str]:
    names = set()
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        names |= {n.id for n in ast.walk(loop.target) if isinstance(n, ast.Name)}
    for node in _block_nodes(list(loop.body) + list(loop.orelse)):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
            names |= {n.id for n in ast.walk(node.target) if isinstance(n, ast.Name)}
    return names


@rule("R10", "loop-invariant-host-copy", "warning",
      "host array or CPU tensor copied to the card inside a loop although "
      "it does not change across iterations — place it once before the loop")
def check_loop_invariant_copy(ctx: ModuleContext):
    r = get_rule("R10")
    out = []
    seen: set[int] = set()
    for symbol, scope in iter_scopes(ctx):
        for loop in scope_nodes(scope):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            bound = _loop_bound_names(loop)
            for node in _block_nodes(list(loop.body) + list(loop.orelse)):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                src = _card_copy_source(ctx, node)
                if src is None:
                    continue
                refs = {n.id for n in ast.walk(src) if isinstance(n, ast.Name)}
                if refs & bound or not refs:
                    continue
                seen.add(id(node))
                out.append(make_finding(
                    ctx, r, node,
                    "host-to-card copy of a loop-invariant value inside a "
                    "loop: every iteration pays the copy and a launch for "
                    "the same bytes",
                    "copy it to the card once before the loop and reuse "
                    "the device tensor",
                    symbol))
    return out


# ---------------------------------------------------------------------
# R16 per-variant-launches
# ---------------------------------------------------------------------
#
# The scenario suite's one-program contract (estorch_tpu_torch/scenarios,
# ROADMAP item 8): per-variant physics constants ride the env state as a
# (members, params) table gathered per member, so one rollout serves any
# number of variants and the launches a generation stay constant in the
# variant count (chip_smoke.py phase 16 gates exactly that at 1, 10 and
# 1000 variants).  A Python loop over the variants that launches device
# work per variant — a rollout, an env step, an engine generation, a
# torch op on the card — makes the launches grow with the variant count:
# the torch form of JAX's recompile-per-variant.
#
# Shape detected: a loop (or comprehension) whose target/iterable names
# read scenario-ish ("scenario"/"variant"/"domain"), whose per-iteration
# subtree calls device work with the loop variable (or a value derived
# from it inside the loop) among the call's names.  Device work is a
# rollout, env-step or engine call by name, ``.cuda()``/``.to(<device>)``,
# or a ``torch.*`` call given a ``device=`` other than "cpu".  Host work
# per variant (drawing the variant table on the CPU) stays silent.

_SCENARIO_TOKENS = ("scenario", "variant", "domain")
_DEVICE_WORK_TAILS = {"step", "step_p", "reset", "generation_step", "evaluate",
                      "make_batched_rollout", "apply_params", "population_apply"}


def _scenarioish_names(*nodes: ast.AST) -> bool:
    for node in nodes:
        if node is None:
            continue
        for sub in ast.walk(node):
            name = None
            if isinstance(sub, ast.Name):
                name = sub.id
            elif isinstance(sub, ast.Attribute):
                name = sub.attr
            if name and any(t in name.lower() for t in _SCENARIO_TOKENS):
                return True
    return False


def _target_names(target: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}


def _is_device_work(ctx: ModuleContext, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    if _card_copy_source(ctx, node) is not None:
        return True
    resolved = ctx.resolve(node.func)
    if resolved is None:
        return False
    tail = resolved.rsplit(".", 1)[-1]
    if tail in _DEVICE_WORK_TAILS or "rollout" in tail.lower():
        return True
    if resolved.startswith("torch."):
        dev = next((kw.value for kw in node.keywords if kw.arg == "device"), None)
        return dev is not None and not _cpu_literal(dev)
    return False


def _derived_names(body: list[ast.AST], seeds: set[str]) -> set[str]:
    """Seeds plus names bound (one straight-line pass, iterated to a
    fixpoint) from expressions referencing a seed — `p = scenario.g`
    makes `p` per-scenario too."""
    names = set(seeds)
    changed = True
    while changed:
        changed = False
        for stmt in body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Assign):
                    continue
                refs = {n.id for n in ast.walk(node.value)
                        if isinstance(n, ast.Name)}
                if refs & names:
                    for t in node.targets:
                        new = _target_names(t) - names
                        if new:
                            names |= new
                            changed = True
    return names


def _loop_sites(scope: ast.AST):
    """(per-iteration body nodes, target names, scenario-ish?) for every
    for-loop and comprehension in one scope."""
    for node in scope_nodes(scope):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            yield (list(node.body) + list(node.orelse),
                   _target_names(node.target),
                   _scenarioish_names(node.target, node.iter))
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            parts = ([node.key, node.value]
                     if isinstance(node, ast.DictComp) else [node.elt])
            targets: set[str] = set()
            scenarioish = False
            for gen in node.generators:
                targets |= _target_names(gen.target)
                scenarioish = scenarioish or _scenarioish_names(
                    gen.target, gen.iter)
            yield [p for p in parts if p is not None], targets, scenarioish


@rule("R16", "per-variant-launches", "warning",
      "a Python loop over scenario variants launches device work per "
      "variant — launches grow with the variant count instead of one "
      "rollout over the variant table")
def check_per_variant_launches(ctx: ModuleContext):
    r = get_rule("R16")
    out = []
    seen: set[int] = set()
    enclosing = enclosing_defs(ctx.tree)  # once per module, not per finding
    for _symbol, scope in iter_scopes(ctx):
        for body, targets, scenarioish in _loop_sites(scope):
            if not scenarioish or not targets:
                continue
            per_variant = _derived_names(body, targets)
            for stmt in body:
                # a lambda or def in the loop runs when called, not here
                work = [n for n in _block_nodes([stmt]) if _is_device_work(ctx, n)]
                # one finding per launch SITE: rollout(env.step(v)) is one
                # smell, not two — drop work nested inside other work
                nested = {id(inner) for outer in work
                          for inner in ast.walk(outer)
                          if inner is not outer and _is_device_work(ctx, inner)}
                for node in work:
                    if id(node) in nested:
                        continue
                    refs = {n.id for n in ast.walk(node)
                            if isinstance(n, ast.Name)
                            and isinstance(n.ctx, ast.Load)}
                    if not (refs & per_variant) or id(node) in seen:
                        continue
                    seen.add(id(node))
                    names = sorted(refs & per_variant)
                    qualname = ctx.qualnames.get(
                        enclosing.get(node) or ctx.tree, "<module>")
                    out.append(make_finding(
                        ctx, r, node,
                        f"per-scenario value(s) {names} drive device work "
                        "inside a scenario loop — every variant adds its "
                        "own launches (launches grow with the variant "
                        "count)",
                        "put the variants in one table riding the env "
                        "state (ScenarioEnv over a ScenarioDistribution) "
                        "and run ONE rollout over all members",
                        qualname))
    return out
