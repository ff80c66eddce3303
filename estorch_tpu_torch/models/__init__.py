from .decomposed import mlp_decomposed_apply, supports_decomposed
from .policies import MLPPolicy

__all__ = ["MLPPolicy", "mlp_decomposed_apply", "supports_decomposed"]
