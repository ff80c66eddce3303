from .agent import DeviceAgent
from .base import DeviceEnv
from .cartpole import CartPole
from .pendulum import Pendulum
from .rollout import (
    ObsMoments,
    RolloutResult,
    make_batched_rollout,
    member_params_apply,
    select_action,
)

__all__ = [
    "CartPole", "DeviceAgent", "DeviceEnv", "ObsMoments", "Pendulum", "RolloutResult",
    "make_batched_rollout", "member_params_apply", "select_action",
]
