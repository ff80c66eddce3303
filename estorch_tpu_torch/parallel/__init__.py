from .engine import (
    EngineConfig,
    ESEngine,
    ESState,
    Sample,
    generation_seed,
    merge_obs_moments,
    merge_obs_moments_np,
    normalize_obs,
)

__all__ = [
    "ESEngine", "ESState", "EngineConfig", "Sample", "generation_seed",
    "merge_obs_moments", "merge_obs_moments_np", "normalize_obs",
]
