"""Per-module analysis context: AST, import aliases, captured code.

Built once per file and shared by every rule, so each rule stays a small
visitor instead of re-deriving "is this call torch.compile?" or "does
this function body get captured?" on its own.

Captured-code detection (the "hot path" of R02/R03) is deliberately
conservative: code counts as captured only when the module gives static
evidence that torch records it once and replays it —

* a def decorated with ``torch.compile`` (bare, called, or wrapped in
  ``partial(torch.compile, ...)``), or
* a def whose NAME is passed to ``torch.compile(f)`` or
  ``torch.cuda.make_graphed_callables(f, ...)`` (a tuple of names too)
  in the same module, or
* a def lexically nested inside a captured def, or
* the body of a ``with torch.cuda.graph(g):`` block (kept apart, in
  ``captured_withs``: it is a block of the enclosing scope, not a def).

Anything the analyzer cannot prove captured is treated as eager host
code — missed hazards are acceptable, false "host sync in captured
code" noise on plain Python is not.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

# resolved call heads that capture their callable argument(s)
CAPTURE_CALLS = {"torch.compile", "torch.cuda.make_graphed_callables",
                 "torch.cuda.graphs.make_graphed_callables"}
# resolved context-manager heads whose body is captured into a CUDA graph
CAPTURE_WITHS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}


def dotted_name(node: ast.AST) -> str | None:
    """``torch.cuda.graph`` -> "torch.cuda.graph"; None for non-name expressions."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class ModuleContext:
    path: str
    source: str
    tree: ast.Module
    lines: list[str] = field(default_factory=list)
    # import alias -> canonical dotted path ("F" -> "torch.nn.functional")
    aliases: dict[str, str] = field(default_factory=dict)
    # function name -> def nodes with that name (module-wide, by name)
    defs_by_name: dict[str, list[ast.AST]] = field(default_factory=dict)
    # def nodes whose bodies are captured (see module docstring)
    captured: set[ast.AST] = field(default_factory=set)
    # ``with torch.cuda.graph(...)`` blocks, whose bodies are captured
    captured_withs: list[ast.AST] = field(default_factory=list)
    # def node -> enclosing qualname ("Engine._step.body")
    qualnames: dict[ast.AST, str] = field(default_factory=dict)
    # every call-valued Assign with its nearest enclosing class name —
    # the lockset layer scans these for Lock()/RLock()/... factories
    # without re-walking the tree
    call_assigns: list[tuple[ast.Assign, str]] = field(default_factory=list)

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    # node -> resolved path: a dozen rules re-resolve the same call
    # heads, and the dotted-name walk is pure per-node work
    _resolve_cache: dict[ast.AST, str | None] = field(default_factory=dict)

    def resolve(self, node: ast.AST) -> str | None:
        """Canonical dotted path of a name/attribute expression, expanding
        the module's import aliases: with ``import torch.nn.functional as F``,
        ``F.relu`` resolves to "torch.nn.functional.relu"."""
        try:
            return self._resolve_cache[node]
        except KeyError:
            pass
        dotted = dotted_name(node)
        if dotted is None:
            out = None
        else:
            head, _, rest = dotted.partition(".")
            canon = self.aliases.get(head, head)
            out = canon + ("." + rest if rest else "")
        self._resolve_cache[node] = out
        return out

    def is_captured(self, fn: ast.AST) -> bool:
        return fn in self.captured


def _record_alias(node: ast.AST, aliases: dict[str, str]) -> None:
    if isinstance(node, ast.Import):
        for a in node.names:
            aliases[a.asname or a.name.partition(".")[0]] = (
                a.name if a.asname else a.name.partition(".")[0])
    elif isinstance(node, ast.ImportFrom):
        # relative imports keep their dots ("..utils.backend.shard_map")
        # — unresolvable to an absolute module, but enough for the
        # distinctive-tail rule to see through in-repo shims
        prefix = "." * node.level + (node.module or "")
        for a in node.names:
            aliases[a.asname or a.name] = (
                f"{prefix}.{a.name}" if prefix else a.name)


_FN_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _is_capture_head(ctx: ModuleContext, func: ast.AST) -> bool:
    return ctx.resolve(func) in CAPTURE_CALLS


def _decorator_captures(ctx: ModuleContext, dec: ast.AST) -> bool:
    if isinstance(dec, ast.Call):
        # @torch.compile(mode=...) / @partial(torch.compile, ...)
        if _is_capture_head(ctx, dec.func):
            return True
        head = ctx.resolve(dec.func)
        if head is not None and head.rsplit(".", 1)[-1] == "partial":
            return bool(dec.args) and _is_capture_head(ctx, dec.args[0])
        return False
    return _is_capture_head(ctx, dec)


def build_context(path: str, source: str) -> ModuleContext:
    tree = ast.parse(source, filename=path)
    ctx = ModuleContext(path=path, source=source, tree=tree,
                        lines=source.splitlines())

    # ---- single structural pass --------------------------------------
    # One recursive traversal collects import aliases, qualnames,
    # defs_by_name, the lexical-parent-function map, and every Call node
    # (capture heads are filtered AFTER the walk, once aliases are
    # complete).  parent_fn matters twice: name references at a capture
    # call site resolve against the call's enclosing scope chain, not
    # module-wide — an unrelated host function that happens to share a
    # closure name like `body`/`step_fn` must not become captured — and it
    # is the same map engine.enclosing_defs serves to the rules, so it
    # is cached on the tree here instead of being rebuilt there.
    parent_fn: dict[ast.AST, ast.AST | None] = {}
    calls: list[ast.Call] = []
    withs: list[ast.AST] = []

    def walk(node: ast.AST, prefix: str, fn: ast.AST | None,
             cls: str) -> None:
        for child in ast.iter_child_nodes(node):
            parent_fn[child] = fn
            if isinstance(child, _FN_NODES):
                qn = f"{prefix}{child.name}"
                ctx.qualnames[child] = qn
                ctx.defs_by_name.setdefault(child.name, []).append(child)
                walk(child, qn + ".", child, cls)
                continue
            if isinstance(child, ast.ClassDef):
                walk(child, f"{prefix}{child.name}.", fn, child.name)
                continue
            if isinstance(child, ast.Call):
                calls.append(child)
            elif isinstance(child, (ast.With, ast.AsyncWith)):
                withs.append(child)
            elif isinstance(child, (ast.Import, ast.ImportFrom)):
                _record_alias(child, ctx.aliases)
            elif isinstance(child, ast.Assign) and isinstance(
                    child.value, ast.Call):
                ctx.call_assigns.append((child, cls))
            walk(child, prefix, fn, cls)

    walk(tree, "", None, "")
    tree._esguard_parent_fn = parent_fn

    def resolve_local_def(call: ast.Call, name: str) -> ast.AST | None:
        chain = []
        scope = parent_fn.get(call)
        while scope is not None:
            chain.append(scope)
            scope = parent_fn.get(scope)
        chain.append(None)  # module scope
        candidates = ctx.defs_by_name.get(name, [])
        for scope in chain:  # innermost enclosing scope wins
            for fn in candidates:
                if parent_fn.get(fn) is scope:
                    return fn
        return None

    for fn in ctx.qualnames:
        for dec in getattr(fn, "decorator_list", []):
            if _decorator_captures(ctx, dec):
                ctx.captured.add(fn)
    for node in calls:
        if not _is_capture_head(ctx, node.func) or not node.args:
            continue
        first = node.args[0]
        names = first.elts if isinstance(first, (ast.Tuple, ast.List)) else [first]
        for arg in names:
            if isinstance(arg, ast.Name):
                fn = resolve_local_def(node, arg.id)
                if fn is not None:
                    ctx.captured.add(fn)
    for node in withs:
        if any(isinstance(item.context_expr, ast.Call)
               and ctx.resolve(item.context_expr.func) in CAPTURE_WITHS
               for item in node.items):
            ctx.captured_withs.append(node)

    # ---- propagate into lexically nested defs ------------------------
    def mark_nested(fn: ast.AST) -> None:
        for child in ast.walk(fn):
            if child is not fn and isinstance(child, _FN_NODES):
                ctx.captured.add(child)

    for fn in list(ctx.captured):
        mark_nested(fn)
    return ctx
