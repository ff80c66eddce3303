"""estorch_tpu_torch — the PyTorch/CUDA port of estorch_tpu.

The JAX package ``estorch_tpu`` stays the reference; this package mirrors
its module paths and names, imports ``torch`` and never JAX, and runs on a
CUDA card unless the caller passes ``device="cpu"``.  ES runs the
standard, decomposed, low-rank and streamed forwards, with obs
normalization and bf16 as options; the streamed forward and the
``noise_kernel`` update run two hand-written Hopper kernels
(``ops/csrc``), whose plain PyTorch versions sit beside them in
``ops/noise_kernels.py``.
"""

from .algo import ES
from .envs import CartPole, DeviceAgent, Pendulum
from .models import MLPPolicy
from .ops import NoiseTable, make_noise_table
from .optim import adam, sgd
from .parallel import EngineConfig, ESEngine, ESState
from .utils import resolve_device

__all__ = [
    "CartPole", "DeviceAgent", "ES", "ESEngine", "ESState", "EngineConfig",
    "MLPPolicy", "NoiseTable", "Pendulum", "adam", "make_noise_table",
    "resolve_device", "sgd",
]
