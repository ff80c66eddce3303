"""Serve-time batcher construction and the bundle's warm block.

Counterpart of ``estorch_tpu/serve/warm.py``.  The JAX package ships the
bucket ladder's compiled XLA programs with a bundle, so that a fresh
replica's first request never waits on a JIT build.  Torch keeps no
persistent cache of compiled programs: the port's eager forward builds
nothing, and the only compiles it knows are its native libraries' first
loads (``ops/_build.py``), which the serving path does not make.  So the
port's warm block has a format of its own, ``"torch_eager"``: no entries,
only what the export verified —

* :func:`warm_bundle` replays the serve-time load (``load_bundle`` →
  :func:`build_serving_batcher` with its bucket verification and, for
  bf16, the divergence measurement) on the exporting device, and
  returns the ladder it verified with the
  platform facts (torch and CUDA versions, the card's name, device count).
  A bf16 policy past the bound fails the export there, with the
  diagnosis, instead of shipping a bundle every server refuses;
* :func:`install_warmth` compares those facts with the serving process
  and returns the JAX package's structured status; a mismatch is a
  finding (the ladder is verified again at load anyway), never an error.

The server publishes ``compiles_at_load`` (the native libraries first
loaded during the bundle load, expected 0) and ``warm_cache_hits`` (0:
there is no cache to hit).
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from .batcher import DynamicBatcher
from .bundle import BundleError, load_bundle
from .validate import WARM_FORMAT


# The documented per-bucket accuracy bound for quantized serving: the
# worst row of the quantized program may deviate from the f32 anchor by
# at most this fraction of the anchor output's scale
# (serve/batcher.py::measure_quant_divergence defines the metric).
# bf16 keeps ~8 mantissa bits (~0.4% per rounding); two GEMM layers plus
# activations accumulate to low single-digit percents for well-scaled
# policies, so 5% separates "quantization noise" from "this policy
# amplifies rounding error" with margin on both sides.
BF16_DIVERGENCE_BOUND = 0.05


def build_serving_batcher(
    bundle,
    *,
    max_batch: int = 32,
    max_wait_ms: float = 4.0,
    max_queue: int = 256,
    dtype: str = "f32",
    quant_bound: float | None = None,
    telemetry=None,
) -> DynamicBatcher:
    """THE serve-time batcher construction — one definition shared by the
    server's engine build and the export-time replay, so what the export
    verified can never drift from what a serving process runs.

    ``dtype="bf16"`` builds the quantized fast path next to the f32
    reference: the batcher measures per-bucket divergence and excludes
    drifting buckets (f32 fallback at the same shape); a bundle that did
    not opt in, or a policy past the bound at the anchor, raises
    :class:`BundleError` — the server's 409, the CLI's exit 2.
    """
    batch_fn = bundle.batched_predict_fn()  # refuses recurrent bundles
    quant_fn = None
    bound = None
    if dtype != "f32":
        quant_fn = bundle.batched_predict_fn(dtype=dtype)  # opt-in check
        bound = float(quant_bound if quant_bound is not None else BF16_DIVERGENCE_BOUND)
    try:
        return DynamicBatcher(
            batch_fn, bundle.obs_shape, max_batch=max_batch,
            max_wait_ms=max_wait_ms, max_queue=max_queue,
            telemetry=telemetry, quant_fn=quant_fn, quant_bound=bound,
            quant_label=dtype,
        )
    except ValueError as e:
        # slot-dependent anchor or out-of-bound quantization: bundle-grade
        # rejections — /reload answers 409, the CLI exits 2
        raise BundleError(f"bundle at {bundle.path!r} cannot serve ({dtype}): {e}") from e


def platform_facts(device) -> dict:
    """What a warm block is checked against: torch's and CUDA's versions,
    the platform (``gpu``/``cpu``), the card's name and the device count."""
    from ..obs.manifest import describe_device

    desc = describe_device(device)
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": desc["platform"],
        "device_kind": desc["kind"],
        "device_count": torch.cuda.device_count() if desc["platform"] == "gpu" else 1,
    }


def warm_bundle(
    path: str,
    *,
    max_batch: int = 32,
    dtypes: Sequence[str] = ("f32",),
    quant_bound: float | None = None,
    device=None,
) -> dict:
    """Replay the serve-time load of the committed bundle at ``path`` on
    ``device`` and return the manifest's ``warm`` block: the f32 ladder's
    verified and excluded buckets for ``max_batch``, the dtypes replayed,
    the replay's seconds and :func:`platform_facts`.  Raises
    :class:`BundleError` where a server would refuse the bundle (a
    slot-dependent anchor, bf16 past its bound)."""
    t0 = time.perf_counter()
    bundle = load_bundle(path, device=device)
    buckets: list[int] = []
    excluded: list[int] = []
    # recurrent bundles serve in-process only: no batcher, no ladder
    for dtype in () if bundle.recurrent else dtypes:
        b = build_serving_batcher(bundle, max_batch=max_batch, dtype=dtype,
                                  quant_bound=quant_bound)
        if dtype == "f32":
            buckets = list(b.buckets)
            excluded = list(b.buckets_excluded)
        b.close(drain=True, timeout=10.0)
    block = {
        "format": WARM_FORMAT,
        "max_batch": int(max_batch),
        "buckets": buckets,
        "buckets_excluded": excluded,
        "dtypes": list(dtypes),
        "warm_s": round(time.perf_counter() - t0, 3),
        **platform_facts(bundle.device),
    }
    if bundle.recurrent:
        # no ladder exists — the ladder-complete structural check does not apply
        block["recurrent_only"] = True
    return block


def install_warmth(manifest: dict, device) -> dict:
    """Check a bundle's warm block against this process; returns a
    structured status dict (never raises on incompatibility — a stale warm
    block is still a valid bundle):

    ``{"installed": bool, "reason": str|None, "entries": 0,
       "cache_dir": None, "torch_version": str, "platform": str}``

    ``installed`` means the export verified its ladder on this platform
    (torch version, gpu/cpu); a different card name or device count is a
    ``note``.  There are never entries or a cache directory: torch caches
    no compiled programs.
    """
    warm = manifest.get("warm")
    if not isinstance(warm, dict):
        return {"installed": False, "reason": "no warmth packed", "entries": 0,
                "cache_dir": None}
    facts = platform_facts(device)
    out = {"installed": False, "entries": 0, "cache_dir": None,
           "torch_version": warm.get("torch_version"), "platform": warm.get("platform")}
    if warm.get("format") != WARM_FORMAT:
        out["reason"] = (f"unknown warmth format {warm.get('format')!r} — "
                         f"this version reads only {WARM_FORMAT!r}")
        return out
    if warm.get("torch_version") != facts["torch_version"]:
        out["reason"] = (
            f"warmth was verified under torch {warm.get('torch_version')}, this "
            f"process runs {facts['torch_version']}; the ladder is verified "
            "again at load (re-export the bundle with warm=True under the "
            "serving torch version)")
        return out
    if warm.get("platform") != facts["platform"]:
        out["reason"] = (
            f"warmth was verified on platform {warm.get('platform')!r}, this "
            f"process runs {facts['platform']!r}; the ladder is verified again "
            "at load")
        return out
    out["installed"] = True
    notes = [f"{k} {warm.get(k)!r} at export, {facts[k]!r} here"
             for k in ("device_kind", "device_count", "cuda_version")
             if warm.get(k) != facts[k]]
    if notes:
        out["note"] = ("; ".join(notes) + " — cuBLAS may pick other kernels, so "
                       "the buckets verified at load may differ from the export's")
    return out
