"""Resilience rule: R08 swallowed-fault.

A recovery/retry path that catches an exception and does NOTHING — no
re-raise, no log, no counter — turns a fault into silence: the dead
worker whose slice is NaN every generation, the checkpoint that never
finalized, the retry that never happened, all invisible until someone
audits a finished run.  The resilience layer's contract
(docs/resilience.md) is that every swallowed fault leaves evidence: a
telemetry counter bump, a flight-recorder event, or a re-raise.

Flagged: ``except`` handlers whose body is ONLY ``pass``, outside two
legitimate shapes:

* **teardown** — ``__del__`` / ``__exit__`` / ``close`` / ``shutdown``
  bodies (and ``*_close`` helpers): the object is dying, there is no one
  to tell, and raising from ``__del__`` is its own hazard;
* **fall-through probes** — a ``try`` whose body exits the scope
  (``return`` / ``continue`` / ``break``): the pass-handler IS the
  dispatch to the next strategy on the following line — the R06-
  prescribed probe idiom (envs/rollout.py ``carry_init_takes_params``),
  not a swallow.

A handler that does anything real (assigns a flag consumed later, bumps
a counter, logs, raises) is clean — the rule asks for evidence, not a
specific API.
"""

from __future__ import annotations

import ast

from .context import ModuleContext
from .engine import (enclosing_defs, get_rule, iter_scopes, make_finding,
                     rule, scope_nodes, symbol_map, walk_tree)

_TEARDOWN_NAMES = {"__del__", "__exit__", "close", "shutdown"}


def _is_teardown(fn: ast.AST | None) -> bool:
    if fn is None:
        return False
    name = getattr(fn, "name", "")
    return (name in _TEARDOWN_NAMES or name.endswith("_close")
            or name.endswith("_shutdown"))


def _pass_only(handler: ast.ExceptHandler) -> bool:
    return all(isinstance(s, ast.Pass) for s in handler.body)


def _falls_through(try_node: ast.Try) -> bool:
    """True when the try body's last statement exits the scope — the
    handler's ``pass`` then means "fall through to the next strategy"."""
    body = try_node.body
    return bool(body) and isinstance(body[-1],
                                     (ast.Return, ast.Continue, ast.Break))


@rule("R08", "swallowed-fault", "warning",
      "except handler swallows a fault with no re-raise, log, or counter")
def check_swallowed_fault(ctx: ModuleContext):
    r = get_rule("R08")
    parent_fn = enclosing_defs(ctx.tree)
    symbol_of = symbol_map(ctx)
    out = []
    for node in walk_tree(ctx.tree):
        if not isinstance(node, ast.Try):
            continue
        if _is_teardown(parent_fn.get(node)):
            continue
        if _falls_through(node):
            continue
        for handler in node.handlers:
            if not _pass_only(handler):
                continue
            out.append(make_finding(
                ctx, r, handler,
                "fault swallowed: this handler neither re-raises, logs, "
                "nor bumps a counter — the failure leaves no evidence",
                "record it (telemetry counter/event, logging, a flag the "
                "caller checks) or re-raise; pass-only is legitimate only "
                "in teardown (__del__/close) or fall-through probes",
                symbol_of.get(node, "<module>")))
    return out
