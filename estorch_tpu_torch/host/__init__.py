from .engine import HostEngine, HostEvalResult, HostRolloutResult, HostState

__all__ = ["HostEngine", "HostEvalResult", "HostRolloutResult", "HostState"]
