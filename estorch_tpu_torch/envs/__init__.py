from .acrobot import Acrobot
from .agent import DeviceAgent, PooledAgent, collect_reference_batch
from .base import DeviceEnv, EnvSpec
from .cartpole import CartPole
from .locomotion import (
    Cheetah2D,
    DeceptiveValley,
    Hopper2D,
    Humanoid2D,
    PlanarLayout,
    PositionOnly,
    Swimmer2D,
    Walker2D,
)
from .mountain_car import MountainCarContinuous
from .mountain_car_discrete import MountainCar
from .pendulum import Pendulum
from .rollout import (
    ObsMoments,
    RolloutResult,
    carry_init_takes_params,
    make_batched_rollout,
    make_population_rollout,
    make_rollout,
    map_carry,
    member_params_apply,
    population_forward,
    select_action,
)
from .synthetic import RecallEnv, SyntheticEnv

__all__ = [
    "Acrobot", "CartPole", "Cheetah2D", "DeceptiveValley", "DeviceAgent", "DeviceEnv", "EnvSpec",
    "Hopper2D", "Humanoid2D", "MountainCar", "MountainCarContinuous", "ObsMoments",
    "Pendulum", "PlanarLayout", "PooledAgent", "PositionOnly", "RecallEnv", "RolloutResult", "Swimmer2D",
    "SyntheticEnv", "Walker2D", "carry_init_takes_params", "collect_reference_batch",
    "make_batched_rollout", "make_population_rollout", "make_rollout", "map_carry", "member_params_apply", "population_forward",
    "select_action",
]
