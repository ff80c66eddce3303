"""R01 global-rng-draw: a random draw that bypasses the run's generators.

The ES correctness contract (Salimans et al. 2017 mirrored sampling, and
the port's offset-derivation scheme) depends on every draw coming from a
stream the run owns: the port's random streams are ``torch.Generator``
objects seeded from ``(seed, generation, ...)`` (ROADMAP: "random streams
are ``torch.Generator``s"), so a checkpoint resume, a replayed log, a
rank of a multi-process run and the CPU twin of a card run all draw the
same numbers.  A draw from torch's GLOBAL generator breaks that silently:
its state is shared by every caller in the process (a test, a library, a
data loader), is not checkpointed, differs per rank, and is another
stream on the card than on the CPU.  ``torch.manual_seed`` in library
code is the same hazard from the other side: it reseeds every other
caller's stream behind its back.

Flagged:

* a call of a torch sampling function — ``torch.randn``/``rand``/
  ``randint``/``randperm``/``normal``/``bernoulli``/``multinomial``/
  ``poisson`` and their ``*_like`` forms — with no ``generator=``
  keyword;
* an in-place sampling method — ``.normal_()``/``.uniform_()``/
  ``.bernoulli_()``/``.random_()``/``.exponential_()``/
  ``.geometric_()``/``.log_normal_()``/``.cauchy_()`` — with no
  ``generator=`` keyword;
* ``torch.manual_seed`` / ``torch.seed`` / ``torch.cuda.manual_seed``
  / ``torch.cuda.manual_seed_all`` / ``torch.random.manual_seed``.

The ``*_like`` forms take no generator in torch; drawing into
``torch.empty_like(x)`` with ``.normal_(generator=g)`` is the fix.
"""

from __future__ import annotations

import ast

from .context import ModuleContext
from .engine import get_rule, make_finding, rule, symbol_map, walk_tree

_SAMPLERS = {"randn", "rand", "randint", "randperm", "normal", "bernoulli",
             "multinomial", "poisson", "randn_like", "rand_like",
             "randint_like"}
_SAMPLE_METHODS = {"normal_", "uniform_", "bernoulli_", "random_",
                   "exponential_", "geometric_", "log_normal_", "cauchy_"}
_RESEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
            "torch.cuda.manual_seed_all", "torch.random.manual_seed",
            "torch.random.seed"}


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


@rule("R01", "global-rng-draw", "error",
      "random draw from torch's global generator (no generator=) or a "
      "global reseed — random streams must be the run's torch.Generators")
def check_global_rng(ctx: ModuleContext):
    r = get_rule("R01")
    symbols = symbol_map(ctx)
    out = []
    for node in walk_tree(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        resolved = ctx.resolve(node.func)
        what = None
        if resolved in _RESEEDS:
            out.append(make_finding(
                ctx, r, node,
                f"`{resolved}` reseeds the process-wide generator every "
                "other caller draws from",
                "seed a torch.Generator of the run's own "
                "(torch.Generator(device).manual_seed(seed)) and pass it "
                "as generator=",
                symbols.get(node, "<module>")))
            continue
        if _has_generator(node):
            continue
        if resolved is not None and resolved.startswith("torch."):
            head, _, tail = resolved.rpartition(".")
            if head in ("torch", "torch.random") and tail in _SAMPLERS:
                what = f"`{resolved}`"
        if (what is None and isinstance(node.func, ast.Attribute)
                and node.func.attr in _SAMPLE_METHODS):
            what = f"`.{node.func.attr}()`"
        if what is None:
            continue
        out.append(make_finding(
            ctx, r, node,
            f"{what} draws from torch's global generator: not "
            "checkpointed, not the same stream on every rank or device",
            "pass generator= a torch.Generator derived from the run's "
            "seed (ops/noise.py streams), or draw with .normal_(generator=g) "
            "into an empty tensor",
            symbols.get(node, "<module>")))
    return out
