"""estorch_tpu_torch.serve — versioned policy bundles + dynamic-batching
inference server.  Counterpart of ``estorch_tpu.serve``.

The serving path: export a trained policy into a self-describing bundle
(serve/bundle.py: ``es.export_bundle(dir)``), serve it behind a dynamic
micro-batcher (serve/batcher.py, serve/server.py:
``python -m estorch_tpu_torch.serve --bundle dir``), drive it
(serve/client.py, serve/loadgen.py).  Everything runs on ``cuda`` unless
the caller asks for ``device="cpu"`` (``--device cpu``).  The fleet
(serve/router.py, serve/fleet.py: ``python -m estorch_tpu_torch.serve
route --fleet fleet.json``) runs N replica servers behind one router.

Every name loads lazily (PEP 562), so importing this package imports no
torch; the loadgen, router and fleet also run as files, with no package
import at all.
"""

from __future__ import annotations

from .._lazy import lazy_names

_LAZY = {
    # every name loads at first use, so ``python -m estorch_tpu_torch.serve
    # route`` (the router and the fleet) starts without torch
    "BatchError": "batcher",
    "BatcherClosed": "batcher",
    "BatcherSaturated": "batcher",
    "DynamicBatcher": "batcher",
    "bucket_sizes": "batcher",
    "ServeClient": "client",
    "ServeError": "client",
    # the fleet's front door (stdlib, torch-free)
    "Router": "router",
    "CircuitBreaker": "router",
    "Fleet": "fleet",
    "FleetError": "fleet",
    "load_fleet_config": "fleet",
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

__all__ = sorted(_LAZY)
_SUBMODULES = ("batcher", "bundle", "client", "fleet", "loadgen", "predictor", "router",
               "server", "warm")
__getattr__, __dir__ = lazy_names(__name__, globals(), _LAZY, _SUBMODULES)
