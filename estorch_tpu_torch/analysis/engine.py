"""esguard rule engine: registry, per-file runner, path expansion.

A rule is a function ``(ModuleContext) -> Iterable[Finding]`` registered
with :func:`rule`.  The runner parses each ``.py`` file once, builds one
:class:`~estorch_tpu_torch.analysis.context.ModuleContext`, and feeds it to
every enabled rule — so adding a rule costs one function, not a new
traversal pipeline.

Rules come in two scopes.  ``scope="module"`` (the default) sees one
file at a time.  ``scope="project"`` rules (the R18–R22 lockset family)
receive a :class:`~estorch_tpu_torch.analysis.project.ProjectContext` linking
every analyzed module — import aliases, call graph, shared-state
inventory — built from per-file :class:`ModuleSummary` records.  The
per-file work (parse + module rules + summary extraction) fans out
across a fork-based process pool; the cheap project pass links the
returned summaries in the parent.

The engine itself never imports the analyzed code: everything is
``ast``-level, runs on CPU in milliseconds, and is safe to point at
modules whose import would grab an accelerator.
"""

from __future__ import annotations

import ast
import concurrent.futures
import fnmatch
import multiprocessing
import os
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator

from .context import ModuleContext, build_context
from .findings import Finding


@dataclass(frozen=True)
class Rule:
    id: str  # "R01"
    name: str  # "prng-key-reuse"
    severity: str  # default severity for findings it emits
    description: str
    check: Callable[..., Iterable[Finding]]
    scope: str = "module"  # "module" -> ModuleContext, "project" -> ProjectContext


_REGISTRY: dict[str, Rule] = {}


def rule(id: str, name: str, severity: str, description: str,
         scope: str = "module"):
    """Register ``check(ctx) -> Iterable[Finding]`` under a rule id."""

    def deco(check: Callable[..., Iterable[Finding]]):
        if id in _REGISTRY:
            raise ValueError(f"duplicate rule id {id}")
        _REGISTRY[id] = Rule(id, name, severity, description, check, scope)
        return check

    return deco


def all_rules() -> list[Rule]:
    _load_builtin_rules()
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def get_rule(rule_id: str) -> Rule:
    _load_builtin_rules()
    return _REGISTRY[rule_id]


def _load_builtin_rules() -> None:
    # import for side effect: each module registers its rules on import
    from . import (rules_host, rules_perf, rules_prng,  # noqa: F401
                   rules_races, rules_resilience, rules_trace)


def render_rule_table() -> str:
    """The registry as a markdown table — docs/analysis.md embeds this
    between markers so the catalog cannot drift from the code (a test
    diffs the two)."""
    rows = [
        "| id | name | severity | scope | description |",
        "| --- | --- | --- | --- | --- |",
    ]
    for r in all_rules():
        rows.append(f"| {r.id} | `{r.name}` | {r.severity} | {r.scope} "
                    f"| {r.description} |")
    return "\n".join(rows) + "\n"


def _rebase(path: str) -> str:
    """Cwd-relative spelling when the path lives under cwd, else as-is.
    Findings, baseline identities, and exclude globs all see THIS form,
    so `analysis /abs/repo/pkg` and `analysis pkg` (from the repo root)
    exclude and suppress identically."""
    rel = os.path.relpath(path)
    return path if rel.startswith("..") else rel


def iter_py_files(paths: Iterable[str],
                  exclude: Iterable[str] = ()) -> Iterator[str]:
    """Expand files/dirs to ``.py`` paths (cwd-relative where possible,
    see :func:`_rebase`), skipping ``exclude`` globs (matched against the
    normalized relative path AND its basename)."""
    exclude = list(exclude)

    def excluded(p: str) -> bool:
        norm = _rebase(p).replace(os.sep, "/")
        return any(
            fnmatch.fnmatch(norm, pat) or fnmatch.fnmatch(
                os.path.basename(norm), pat)
            for pat in exclude
        )

    paths = [_rebase(p) for p in paths]
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py") and not excluded(path):
                yield path
        elif os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(
                    d for d in dirs
                    if d != "__pycache__"
                    and not excluded(os.path.join(root, d)))
                for f in sorted(files):
                    full = os.path.join(root, f)
                    if f.endswith(".py") and not excluded(full):
                        yield full


def _syntax_finding(path: str, e: SyntaxError) -> Finding:
    return Finding(
        rule="R00", file=path, line=e.lineno or 0, col=e.offset or 0,
        severity="error", message=f"file does not parse: {e.msg}",
        hint="fix the syntax error; esguard skipped this file",
        symbol="<module>", snippet=(e.text or "").strip(),
    )


def _split_rules(rules: list[Rule]) -> tuple[list[Rule], list[Rule]]:
    return ([r for r in rules if r.scope == "module"],
            [r for r in rules if r.scope == "project"])


def analyze_source(path: str, source: str,
                   rules: Iterable[Rule] | None = None) -> list[Finding]:
    """Run rules over one module's source.  Syntax errors become a single
    parse-error finding instead of aborting the whole run.  Project
    rules see a single-module ProjectContext — a one-file "program" —
    so fixtures and single-file invocations still exercise R18–R22."""
    from .project import ProjectContext, build_summary
    if rules is None:
        rules = all_rules()
    mod_rules, proj_rules = _split_rules(list(rules))
    try:
        ctx = build_context(path, source)
    except SyntaxError as e:
        return [_syntax_finding(path, e)]
    findings: list[Finding] = []
    for r in mod_rules:
        findings.extend(r.check(ctx))
    if proj_rules:
        pctx = ProjectContext([build_summary(ctx)])
        for r in proj_rules:
            findings.extend(r.check(pctx))
    return findings


def _analyze_one(task: tuple[str, tuple[str, ...], bool]):
    """Process-pool unit: one file -> (module-rule findings, summary).
    Top-level so it pickles; rules rehydrate from the registry by id
    (the fork start method means workers inherit a loaded registry)."""
    from .project import build_summary
    path, rule_ids, need_summary = task
    mod_rules = [get_rule(i) for i in rule_ids]
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    try:
        ctx = build_context(path, source)
    except SyntaxError as e:
        return [_syntax_finding(path, e)], None
    findings: list[Finding] = []
    for r in mod_rules:
        findings.extend(r.check(ctx))
    summary = build_summary(ctx) if need_summary else None
    return findings, summary


def default_jobs() -> int:
    return max(1, min(os.cpu_count() or 1, 8))


def analyze_paths(paths: Iterable[str],
                  rules: Iterable[Rule] | None = None,
                  exclude: Iterable[str] = (),
                  jobs: int | None = None) -> list[Finding]:
    """Analyze every file under ``paths``: module rules per file (in a
    fork process pool when it pays off), then the whole-program pass
    over the linked summaries.  ``jobs<=1`` forces the serial path; any
    pool failure falls back to it too — the analyzer must never be the
    thing that breaks CI."""
    from .project import ProjectContext
    if rules is None:
        rules = all_rules()
    mod_rules, proj_rules = _split_rules(list(rules))
    files = list(iter_py_files(paths, exclude))
    tasks = [(p, tuple(r.id for r in mod_rules), bool(proj_rules))
             for p in files]
    if jobs is None:
        jobs = default_jobs()
    results = None
    if (jobs > 1 and len(tasks) >= 16
            and "fork" in multiprocessing.get_all_start_methods()):
        try:
            mp_ctx = multiprocessing.get_context("fork")
            with concurrent.futures.ProcessPoolExecutor(
                    max_workers=jobs, mp_context=mp_ctx) as pool:
                results = list(pool.map(
                    _analyze_one, tasks,
                    chunksize=max(1, len(tasks) // (jobs * 4))))
        except Exception:
            results = None  # serial fallback below
    if results is None:
        results = [_analyze_one(t) for t in tasks]
    findings: list[Finding] = []
    summaries = []
    for file_findings, summary in results:
        findings.extend(file_findings)
        if summary is not None:
            summaries.append(summary)
    if proj_rules:
        pctx = ProjectContext(summaries)
        for r in proj_rules:
            findings.extend(r.check(pctx))
    return findings


# ---------------------------------------------------------------------
# shared helpers for the rule modules
# ---------------------------------------------------------------------

def walk_tree(tree: ast.Module) -> tuple[ast.AST, ...]:
    """``ast.walk(tree)`` flattened once and cached on the tree — the
    traversal itself (deque + iter_child_nodes per node) costs more than
    most rules' per-node work, and every rule repeats it."""
    cached = getattr(tree, "_esguard_all_nodes", None)
    if cached is None:
        cached = tuple(ast.walk(tree))
        tree._esguard_all_nodes = cached
    return cached


def enclosing_defs(tree: ast.Module) -> dict[ast.AST, ast.AST | None]:
    """node -> nearest enclosing function def (None at module level).
    Cached on the tree: a dozen rules ask for this map per file, and on
    a single-core runner rebuilding it dominated the whole-tree wall
    time (the ~2s run_lint budget)."""
    cached = getattr(tree, "_esguard_parent_fn", None)
    if cached is not None:
        return cached
    parent_fn: dict[ast.AST, ast.AST | None] = {}

    def walk(node: ast.AST, fn: ast.AST | None) -> None:
        for child in ast.iter_child_nodes(node):
            parent_fn[child] = fn
            walk(child, child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)

    walk(tree, None)
    tree._esguard_parent_fn = parent_fn
    return parent_fn


def scope_nodes(scope: ast.AST):
    """Nodes belonging to one function (or module) scope: walks the body
    without descending into nested function defs, so a rule iterating
    per-scope never double-reports a nested function's body.  Cached on
    the scope node — every iter_scopes-driven rule re-enumerates the
    same scopes."""
    cached = getattr(scope, "_esguard_scope_nodes", None)
    if cached is not None:
        return cached
    out = []
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        out.append(node)
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))
    scope._esguard_scope_nodes = out
    return out


def iter_scopes(ctx: ModuleContext):
    """All (symbol, scope_node) pairs: the module plus every function."""
    yield "<module>", ctx.tree
    for fn, qualname in ctx.qualnames.items():
        yield qualname, fn


def symbol_map(ctx: ModuleContext) -> dict:
    """node -> qualname of its own scope, cached on the tree (the
    iter_scopes × scope_nodes product is the same for every rule)."""
    cached = getattr(ctx.tree, "_esguard_symbol_of", None)
    if cached is None:
        cached = {}
        for symbol, scope in iter_scopes(ctx):
            for node in scope_nodes(scope):
                cached.setdefault(node, symbol)
        ctx.tree._esguard_symbol_of = cached
    return cached


def make_finding(ctx: ModuleContext, rule_: Rule, node: ast.AST,
                 message: str, hint: str, symbol: str,
                 severity: str | None = None) -> Finding:
    line = getattr(node, "lineno", 0)
    return Finding(
        rule=rule_.id, file=ctx.path, line=line,
        col=getattr(node, "col_offset", 0),
        severity=severity or rule_.severity, message=message, hint=hint,
        symbol=symbol, snippet=ctx.line_at(line),
    )
