"""The whole step's share of the card's float32 peak: the benchmark's count
of model FLOPs in the traced window (``costs.generation_flops``: the member
forward at every alive member env step, each conv at every output position,
plus the sample's and the update's 2·rows·dim) over the window's length
(the trace's) and 67 TFLOP/s."""

from esbench import costs


def read(ctx):
    window_s = ctx.trace.window_s
    if window_s <= 0 or not ctx.generations:
        return None
    member_steps = ctx.population * ctx.horizon
    flops = len(ctx.generations) * costs.generation_flops(
        ctx.config, ctx.obs_shape, ctx.dim, member_steps)
    return 100.0 * flops / window_s / costs.F32_PEAK_FLOPS
