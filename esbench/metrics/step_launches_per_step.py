"""CUDA kernel launches made inside the program's ``estorch.step`` ranges
(``envs/rollout.py``: the action, the env's step and the rollout's masks
and sums), over the env steps of a rollout chunk (horizon × chunks a
generation), the denominator of ``launches_per_env_step``."""

from esbench import phases


def read(ctx):
    steps = ctx.horizon * ctx.chunks * len(ctx.generations)
    spans = phases.ranges(ctx.trace, phases.STEP)
    if not steps or not spans:
        return None
    return len(phases.launched_inside(ctx.trace, ctx.trace.kernels(), spans)) / steps
