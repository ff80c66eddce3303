from .backend import DEFAULT_DEVICE, resolve_device
from .checkpoint import (PeriodicCheckpointer, latest_checkpoint, restore_checkpoint,
                         save_checkpoint)

__all__ = ["DEFAULT_DEVICE", "PeriodicCheckpointer", "latest_checkpoint", "resolve_device",
           "restore_checkpoint", "save_checkpoint"]
