from .engine import EngineConfig, ESEngine, ESState, Sample, generation_seed

__all__ = ["ESEngine", "ESState", "EngineConfig", "Sample", "generation_seed"]
