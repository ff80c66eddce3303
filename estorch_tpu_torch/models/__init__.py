from .decomposed import (
    mlp_decomposed_apply,
    mlp_decomposed_population_apply,
    mlp_lowrank_apply,
    mlp_lowrank_population_apply,
    supports_decomposed,
)
from .policies import MLPPolicy

__all__ = [
    "MLPPolicy", "mlp_decomposed_apply", "mlp_decomposed_population_apply",
    "mlp_lowrank_apply", "mlp_lowrank_population_apply", "supports_decomposed",
]
