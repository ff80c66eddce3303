"""Device milliseconds of the standard forward a chunk's env step: the
kernels launched under the members' forward over materialized weights
(``envs/rollout.py`` ``member_params_apply`` / ``population_forward``, a
policy's ``population_apply``: cuBLAS ``bmm``, the conv patch copy, VBN),
in the generations traced with the entries' spans."""

ENTRIES = (
    "estorch_tpu_torch.envs.rollout:member_params_apply",
    "estorch_tpu_torch.envs.rollout:population_forward",
    "estorch_tpu_torch.models.policies:NatureCNN.population_apply",
    "estorch_tpu_torch.models.policies:RecurrentPolicy.population_apply",
    "estorch_tpu_torch.models.policies:RecurrentNatureCNN.population_apply",
)


def read(ctx):
    ops = ctx.span_trace.under(ENTRIES)
    steps = ctx.horizon * ctx.chunks * len(ctx.span_generations)
    if not ops or not steps:
        return None
    return 1e3 * sum(d.seconds for d in ops) / steps
