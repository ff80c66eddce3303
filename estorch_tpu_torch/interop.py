"""Carry weights and noise across from the JAX package, as numpy arrays.

Both packages lay their params out the same way (``ops/params.py``), so a
JAX param tree or its flat ``params_flat`` and the JAX noise table can be
handed to the port and both compute the same thing.  Only numpy crosses
the boundary; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .ops.noise import NoiseTable
from .ops.params import ParamSpec, make_param_spec


def _to_torch_tree(tree: Any, device) -> Any:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _to_torch_tree(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32)).to(device)


def params_from_jax(tree_or_flat: Any, spec: ParamSpec | None = None,
                    device: str | torch.device = "cpu") -> tuple[torch.Tensor, dict]:
    """The port's ``(flat, param dict)`` from the JAX package's params.

    ``tree_or_flat`` is a nested dict of arrays (the flax params tree, as
    numpy) or the flat ``params_flat`` vector; the flat form needs the
    ``spec`` of the layout it is in.  The param dict holds views into the
    flat tensor.
    """
    if isinstance(tree_or_flat, dict) or hasattr(tree_or_flat, "items"):
        flat, spec = make_param_spec(_to_torch_tree(tree_or_flat, device))
        return flat, spec.unravel(flat)
    if spec is None:
        raise ValueError("a flat params vector needs the spec of its layout")
    flat = torch.as_tensor(np.array(tree_or_flat, dtype=np.float32)).to(device)
    return flat, spec.unravel(flat)


def table_from_numpy(array: Any, seed: int | None = None,
                     device: str | torch.device = "cpu") -> NoiseTable:
    """The port's ``NoiseTable`` holding ``array`` (e.g. the JAX table's data)."""
    return NoiseTable.from_numpy(array, seed=seed, device=device)
