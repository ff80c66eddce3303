from .engine import (
    EngineConfig,
    ESEngine,
    ESState,
    EvalResult,
    Sample,
    generation_seed,
    merge_obs_moments,
    merge_obs_moments_np,
    normalize_obs,
)
from .pooled import PooledEngine, PooledEvalResult

__all__ = [
    "ESEngine", "ESState", "EngineConfig", "EvalResult", "Sample", "generation_seed",
    "merge_obs_moments", "merge_obs_moments_np", "normalize_obs", "PooledEngine",
    "PooledEvalResult",
]
