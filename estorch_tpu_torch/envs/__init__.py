from .agent import DeviceAgent
from .base import DeviceEnv
from .cartpole import CartPole
from .pendulum import Pendulum
from .rollout import RolloutResult, make_batched_rollout, select_action

__all__ = [
    "CartPole", "DeviceAgent", "DeviceEnv", "Pendulum", "RolloutResult",
    "make_batched_rollout", "select_action",
]
