"""Share of the traced window in which no kernel, memcpy or memset ran on
the card: 100 minus the union of their intervals over the window."""


def read(ctx):
    window_s = ctx.trace.window_s
    busy = ctx.trace.busy_s()
    if window_s <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window_s)
