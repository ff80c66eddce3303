from .backend import DEFAULT_DEVICE, resolve_device
from .checkpoint import (PeriodicCheckpointer, latest_checkpoint, restore_checkpoint,
                         save_checkpoint)
from .metrics import JsonlWriter, MultiWriter, TensorBoardWriter
from .profiler import annotate, timed_generations, trace

__all__ = ["DEFAULT_DEVICE", "JsonlWriter", "MultiWriter", "PeriodicCheckpointer",
           "TensorBoardWriter", "annotate", "latest_checkpoint", "resolve_device",
           "restore_checkpoint", "save_checkpoint", "timed_generations", "trace"]
