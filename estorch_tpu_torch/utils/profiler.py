"""The JAX package's historical ``utils.profiler`` surface: the profiling
hooks live in :mod:`estorch_tpu_torch.obs.trace`."""

from __future__ import annotations

from ..obs.trace import annotate, timed_generations, trace  # noqa: F401

__all__ = ["trace", "annotate", "timed_generations"]
