"""CUDA kernel launches in the traced generations, over their env steps of
a rollout chunk (horizon × chunks a generation): the host's work an env
step, which the host-paced cells' time follows."""


def read(ctx):
    steps = ctx.horizon * ctx.chunks * len(ctx.generations)
    kernels = len(ctx.trace.kernels())
    return kernels / steps if steps and kernels else None
