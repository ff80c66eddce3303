"""Share of the traced window in which the card was idle while the host was
inside the program's ``estorch.eval`` range (``parallel/engine.py``
``ESEngine.generation_step``: every chunk's rollout): the card drained the
launch queue while the host was still launching the rollout.  With
``boundary_idle_pct`` it sums to ``device_idle_pct``."""

from esbench import phases


def read(ctx):
    window_ns = ctx.trace.window[1] - ctx.trace.window[0]
    idle = phases.rollout_idle_ns(ctx.trace)
    if window_ns <= 0 or idle is None:
        return None
    return 100.0 * idle / window_ns
