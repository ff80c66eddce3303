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
statistics from ``collect_reference_batch``.  The novelty family
(``NS_ES``, ``NSR_ES``, ``NSRA_ES``: a meta-population of centers, a
host ``NoveltyArchive`` of behavior characterizations) trains on the
device, pooled and host backends through the engines' split path, and
``IW_ES`` reuses earlier generations' rollouts through importance weights
on the device backend.  The streamed forward and the
``noise_kernel`` update run two hand-written Hopper kernels
(``ops/csrc``), whose plain PyTorch versions sit beside them in
``ops/noise_kernels.py``.  ``ES.train_async`` runs barrier-free
generations (``algo/scheduler.py``: the fold of late host results with
clipped importance weights, the overlap of generations on the card, and
bit-exact replay of a fold's event log); ``obs`` is the span and counter
hub every record's ``phases`` come from, and ``resilience`` the
deterministic chaos plans (``ESTORCH_CHAOS``) that drive its faults.
``ES.predict`` runs the serving forward, ``ES.export_bundle`` writes a
policy bundle, and ``serve`` (``python -m estorch_tpu_torch.serve``)
answers requests from it behind a dynamic micro-batcher.  ``scenarios``
randomizes the physics of every parameterized env family per episode
(``ES(scenarios=default_distribution(env, n_variants=10))``), accounts
fitness per variant, and tunes σ and the learning rate of several centers
by population-based training (``PBTController``).
"""

# The names below load lazily (PEP 562): importing the package imports no
# torch, so the stdlib-only entry points under it (``python -m
# estorch_tpu_torch.serve route``, the fleet supervisor and router, ``obs
# collect``/``dash``/``autoscale``) start without torch and outlive a
# replica whose CUDA context hangs.  The first use of a name imports its
# subpackage.
from ._lazy import lazy_names

_LAZY_FROM = {
    "algo": ("ES", "IW_ES", "NS_ES", "NSR_ES", "NSRA_ES", "NoveltyArchive"),
    "envs": ("Acrobot", "CartPole", "Cheetah2D", "DeceptiveValley", "DeviceAgent",
             "Hopper2D", "Humanoid2D", "MountainCar", "MountainCarContinuous", "Pendulum",
             "PooledAgent", "PositionOnly", "RecallEnv", "Swimmer2D", "SyntheticEnv",
             "Walker2D", "collect_reference_batch"),
    "models": ("MLPPolicy", "NatureCNN", "RecurrentNatureCNN", "RecurrentPolicy",
               "VirtualBatchNorm"),
    "ops": ("NoiseTable", "make_noise_table"),
    "optim": ("adam", "sgd"),
    "parallel": ("EngineConfig", "ESEngine", "ESState", "PooledEngine"),
    "utils": ("resolve_device",),
}
_SUBMODULES = ("algo", "configs", "envs", "host", "interop", "models", "obs", "ops", "optim",
               "parallel", "resilience", "scenarios", "serve", "utils")
__getattr__, __dir__ = lazy_names(
    __name__, globals(), {n: m for m, ns in _LAZY_FROM.items() for n in ns}, _SUBMODULES)

__all__ = [
    "Acrobot", "CartPole", "Cheetah2D", "DeceptiveValley", "DeviceAgent", "ES", "ESEngine",
    "ESState", "EngineConfig", "Hopper2D", "Humanoid2D", "IW_ES", "MLPPolicy", "MountainCar",
    "MountainCarContinuous", "NSRA_ES", "NSR_ES", "NS_ES", "NatureCNN", "NoiseTable",
    "NoveltyArchive", "Pendulum", "PooledAgent",
    "PooledEngine", "PositionOnly", "RecallEnv", "RecurrentNatureCNN", "RecurrentPolicy",
    "Swimmer2D", "SyntheticEnv", "VirtualBatchNorm", "Walker2D", "adam",
    "collect_reference_batch", "make_noise_table", "obs", "resilience", "resolve_device",
    "scenarios", "sgd",
]
