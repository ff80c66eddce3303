"""Device selection for the PyTorch port.

Counterpart of ``estorch_tpu/utils/backend.py``.  The port runs on a CUDA
card; the CPU is used only when a caller asks for it by name (the tests
do).  There is no silent fallback: a default-device call on a machine with
no card raises instead of quietly measuring the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` or ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when no card is present.

    Also switches TF32 off for float32 matmuls and cuDNN convolutions: TF32
    keeps about three decimal digits, and the port is held against the
    float32 JAX reference, so every float32 product stays a float32 one.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device, got {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
