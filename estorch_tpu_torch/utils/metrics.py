"""The JAX package's historical ``utils.metrics`` surface: the record
sinks live in :mod:`estorch_tpu_torch.obs.sinks`."""

from __future__ import annotations

from ..obs.sinks import (JsonlSink, JsonlWriter, MultiSink,  # noqa: F401
                         MultiWriter, TensorBoardSink, TensorBoardWriter)

__all__ = ["JsonlWriter", "TensorBoardWriter", "MultiWriter",
           "JsonlSink", "TensorBoardSink", "MultiSink"]
