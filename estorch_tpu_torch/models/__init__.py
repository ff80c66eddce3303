from .decomposed import (
    mlp_decomposed_apply,
    mlp_decomposed_population_apply,
    mlp_lowrank_apply,
    mlp_lowrank_population_apply,
    supports_decomposed,
)
from .obsnorm_torch import TorchRunningObsNorm
from .policies import MLPPolicy, NatureCNN, RecurrentNatureCNN, RecurrentPolicy
from .vbn import VirtualBatchNorm, capture_reference_stats
from .vbn_torch import TorchVirtualBatchNorm

__all__ = [
    "MLPPolicy", "NatureCNN", "RecurrentNatureCNN", "RecurrentPolicy", "TorchRunningObsNorm",
    "TorchVirtualBatchNorm",
    "VirtualBatchNorm", "capture_reference_stats", "mlp_decomposed_apply",
    "mlp_decomposed_population_apply", "mlp_lowrank_apply", "mlp_lowrank_population_apply",
    "supports_decomposed",
]
