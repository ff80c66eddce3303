"""The update reduction (``ops/noise_kernels.py`` ``weighted_noise_sum``,
Σ_k w_k·ε_k over the pairs' rows) against its roofline: the benchmark's
least time for a generation's call (``costs.reduction_bound_s``: the
distinct table bytes of its rows plus weights, offsets and output, or
2·rows·dim FLOPs) over its device time, in the generations traced with
the entry's spans."""

from esbench import costs

ENTRIES = ("estorch_tpu_torch.ops.noise_kernels:weighted_noise_sum",)


def read(ctx):
    if ctx.workload["update"] != "kernel":
        return None
    # one call a generation, in order; a call whose ops the profiler lost counts for nothing
    calls = ctx.span_trace.calls(ENTRIES[0])
    if len(calls) != len(ctx.span_generations):
        return None
    bound = device_s = 0.0
    for g, ops in zip(ctx.span_generations, calls):
        if ops:
            bound += costs.reduction_bound_s(ctx.pair_offsets(g), ctx.dim,
                                             int(ctx.config["table_size"]))
            device_s += sum(d.seconds for d in ops)
    return 100.0 * bound / device_s if device_s > 0 else None
