"""estorch_tpu_torch — the PyTorch/CUDA port of estorch_tpu.

The JAX package ``estorch_tpu`` stays the reference; this package mirrors
its module paths and names, imports ``torch`` and never JAX, and runs on a
CUDA card unless the caller passes ``device="cpu"``.  ES runs the
standard, decomposed, low-rank and streamed forwards, with obs
normalization and bf16 as options, on every device env of the JAX package
(classic control, synthetic, planar locomotion), and on the pooled backend
(``PooledAgent``: the C++ envpool's CartPole, Pendulum and pixel Pong84,
or gymnasium envs, with Atari preprocessing; ``NatureCNN`` with
VirtualBatchNorm); ``configs`` holds the device and pooled recipes.
Recurrent policies (``RecurrentPolicy``: GRU or LSTM cores, stacked, with
a learned episode-start carry; ``RecurrentNatureCNN``) train on the device
and pooled backends, and VBN on the device path takes its frozen
statistics from ``collect_reference_batch``.  The streamed forward and the
``noise_kernel`` update run two hand-written Hopper kernels
(``ops/csrc``), whose plain PyTorch versions sit beside them in
``ops/noise_kernels.py``.
"""

from .algo import ES
from .envs import (
    Acrobot,
    CartPole,
    Cheetah2D,
    DeceptiveValley,
    DeviceAgent,
    Hopper2D,
    Humanoid2D,
    MountainCar,
    MountainCarContinuous,
    Pendulum,
    PooledAgent,
    PositionOnly,
    RecallEnv,
    Swimmer2D,
    SyntheticEnv,
    Walker2D,
    collect_reference_batch,
)
from .models import MLPPolicy, NatureCNN, RecurrentNatureCNN, RecurrentPolicy, VirtualBatchNorm
from .ops import NoiseTable, make_noise_table
from .optim import adam, sgd
from .parallel import EngineConfig, ESEngine, ESState, PooledEngine
from .utils import resolve_device

__all__ = [
    "Acrobot", "CartPole", "Cheetah2D", "DeceptiveValley", "DeviceAgent", "ES", "ESEngine",
    "ESState", "EngineConfig", "Hopper2D", "Humanoid2D", "MLPPolicy", "MountainCar",
    "MountainCarContinuous", "NatureCNN", "NoiseTable", "Pendulum", "PooledAgent",
    "PooledEngine", "PositionOnly", "RecallEnv", "RecurrentNatureCNN", "RecurrentPolicy",
    "Swimmer2D", "SyntheticEnv", "VirtualBatchNorm", "Walker2D", "adam",
    "collect_reference_batch", "make_noise_table", "resolve_device", "sgd",
]
