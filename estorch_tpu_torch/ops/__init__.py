from .gradient import es_gradient, fold_mirrored_weights, rank_weighted_noise_sum
from .noise import (
    DEFAULT_TABLE_SIZE,
    NoiseTable,
    make_noise_table,
    member_noise,
    member_offsets,
    pair_signs,
    sample_pair_offsets,
)
from .noise_kernels import (
    flat_layer_offsets,
    launch_counts,
    mlp_streamed_apply,
    population_noise_matvec,
    reset_launch_counts,
    weighted_noise_sum,
)
from .lowrank import (
    LowRankSpec,
    LowRankTreeSpec,
    lowrank_noise_tree,
    lowrank_tree_noise,
    lowrank_tree_perturb,
    lowrank_tree_weighted_sum,
    lowrank_weighted_sum,
    make_lowrank_spec,
    make_lowrank_tree_spec,
)
from .params import ParamSpec, make_param_spec
from .ranks import centered_rank, centered_rank_np, centered_rank_safe, compute_ranks

__all__ = [
    "DEFAULT_TABLE_SIZE", "LowRankSpec", "LowRankTreeSpec", "NoiseTable", "ParamSpec",
    "centered_rank", "centered_rank_np", "centered_rank_safe", "compute_ranks", "es_gradient",
    "flat_layer_offsets", "fold_mirrored_weights", "launch_counts",
    "lowrank_noise_tree", "lowrank_tree_noise", "lowrank_tree_perturb",
    "lowrank_tree_weighted_sum", "lowrank_weighted_sum", "make_lowrank_spec",
    "make_lowrank_tree_spec",
    "make_noise_table", "make_param_spec", "member_noise", "member_offsets",
    "mlp_streamed_apply", "pair_signs", "population_noise_matvec",
    "rank_weighted_noise_sum", "reset_launch_counts", "sample_pair_offsets",
    "weighted_noise_sum",
]
