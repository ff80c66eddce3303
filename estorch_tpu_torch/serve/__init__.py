"""estorch_tpu_torch.serve — versioned policy bundles + dynamic-batching
inference server.  Counterpart of ``estorch_tpu.serve``.

The serving path: export a trained policy into a self-describing bundle
(serve/bundle.py: ``es.export_bundle(dir)``), serve it behind a dynamic
micro-batcher (serve/batcher.py, serve/server.py:
``python -m estorch_tpu_torch.serve --bundle dir``), drive it
(serve/client.py, serve/loadgen.py).  Everything runs on ``cuda`` unless
the caller asks for ``device="cpu"`` (``--device cpu``).  The fleet
(router, fleet supervisor) waits for ROADMAP.md port item 9c.

The bundle, predictor, server and warm modules load lazily (PEP 562), as
in the JAX package; the loadgen also runs as a file, with no package
import at all.
"""

from __future__ import annotations

from .batcher import (BatchError, BatcherClosed, BatcherSaturated,
                      DynamicBatcher, bucket_sizes)
from .client import ServeClient, ServeError

_LAZY = {
    "Bundle": "bundle",
    "BundleError": "bundle",
    "export_bundle": "bundle",
    "load_bundle": "bundle",
    "validate_bundle": "bundle",
    "make_single_predict": "predictor",
    "make_batched_predict": "predictor",
    "PolicyServer": "server",
    "find_free_port": "server",
    "run_load": "loadgen",
    "coldstart_probe": "loadgen",
    "BF16_DIVERGENCE_BOUND": "warm",
    "build_serving_batcher": "warm",
    "warm_bundle": "warm",
    "install_warmth": "warm",
}

__all__ = [
    "BatchError",
    "BatcherClosed",
    "BatcherSaturated",
    "DynamicBatcher",
    "bucket_sizes",
    "ServeClient",
    "ServeError",
    *sorted(_LAZY),
]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
