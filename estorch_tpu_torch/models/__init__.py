from .decomposed import (
    mlp_decomposed_apply,
    mlp_decomposed_population_apply,
    mlp_lowrank_apply,
    mlp_lowrank_population_apply,
    supports_decomposed,
)
from .policies import MLPPolicy, NatureCNN
from .vbn import VirtualBatchNorm, capture_reference_stats

__all__ = [
    "MLPPolicy", "NatureCNN", "VirtualBatchNorm", "capture_reference_stats",
    "mlp_decomposed_apply", "mlp_decomposed_population_apply",
    "mlp_lowrank_apply", "mlp_lowrank_population_apply", "supports_decomposed",
]
