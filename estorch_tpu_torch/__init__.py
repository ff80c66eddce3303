"""estorch_tpu_torch — the PyTorch/CUDA port of estorch_tpu.

The JAX package ``estorch_tpu`` stays the reference; this package mirrors
its module paths and names, imports ``torch`` and never JAX, and runs on a
CUDA card unless the caller passes ``device="cpu"``.  The streamed-noise
ES path runs two hand-written Hopper kernels (``ops/csrc``); their plain
PyTorch versions sit beside them in ``ops/noise_kernels.py``.
"""

from .algo import ES
from .envs import CartPole, DeviceAgent, Pendulum
from .models import MLPPolicy
from .ops import NoiseTable, make_noise_table
from .optim import adam
from .parallel import EngineConfig, ESEngine, ESState
from .utils import resolve_device

__all__ = [
    "CartPole", "DeviceAgent", "ES", "ESEngine", "ESState", "EngineConfig",
    "MLPPolicy", "NoiseTable", "Pendulum", "adam", "make_noise_table",
    "resolve_device",
]
