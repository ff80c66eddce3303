"""Share of the traced window in which the card was idle while the host was
outside every ``estorch.eval`` range: drawing the sample, ranking, the
update, waiting on the device, copying the metrics back, recording, or
between them.  ``device_idle_pct`` less ``rollout_idle_pct``, by the
window's same reading."""

from esbench import phases


def read(ctx):
    window_ns = ctx.trace.window[1] - ctx.trace.window[0]
    idle = phases.rollout_idle_ns(ctx.trace)
    if window_ns <= 0 or idle is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s) - 100.0 * idle / window_ns
