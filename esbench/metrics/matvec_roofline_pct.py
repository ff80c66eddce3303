"""The streamed forward's noise term (``ops/noise_kernels.py``
``population_noise_matvec``, y_i = c_i·(x_i @ E_i)) against its roofline:
the benchmark's least time for the calls (``costs.matvec_bound_s``: the
distinct table bytes each generation's offsets cover for each layer's
slice plus x, c and y, or 2·n·d·h FLOPs) over their device time, in the
generations traced with the entry's spans."""

from esbench import costs

ENTRIES = ("estorch_tpu_torch.ops.noise_kernels:population_noise_matvec",)


def read(ctx):
    if ctx.config["policy"]["kind"] != "mlp" or ctx.workload["forward"] != "streamed":
        return None
    calls = [ops for ops in ctx.span_trace.calls(ENTRIES[0]) if ops]
    device_s = sum(d.seconds for ops in calls for d in ops)
    if device_s <= 0:
        return None
    kernels = [(shape, start) for layer, leaf, shape, start in ctx.layout if leaf == "kernel"]
    members = ctx.population // ctx.chunks
    bound = 0.0
    for g in ctx.span_generations:
        offs = ctx.pair_offsets(g)
        for j in range(ctx.chunks):
            pairs = offs[j * members // 2:(j + 1) * members // 2]
            for (d, h), start in kernels:
                bound += ctx.horizon * costs.matvec_bound_s(
                    pairs, start, members, d, h, int(ctx.config["table_size"]))
    expected = ctx.horizon * ctx.chunks * len(kernels) * len(ctx.span_generations)
    # the calls whose ops the profiler kept, if it lost some
    return 100.0 * bound * min(1.0, len(calls) / expected) / device_s
