"""Carry weights, noise and env states across from the JAX package, as
numpy arrays.

Both packages lay their params out the same way (``ops/params.py``), so a
JAX param tree (the MLP's, or NatureCNN's with its conv kernels in HWIO and
its VBN ``scale``/``bias``) or its flat ``params_flat``, a policy's frozen
``vbn_stats`` and the JAX noise table can be handed to the port and both
compute the same thing; batched JAX env states
are packed into the port's ``(n, state_dim)`` rows.  Only numpy crosses
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


def vbn_stats_from_jax(stats: Any, device: str | torch.device = "cpu") -> dict:
    """A policy's ``vbn_stats`` from the JAX package's frozen ``vbn_stats``
    collection (``{"vbn_i": {"mean", "var"}}``, as numpy): float32 tensors."""
    return _to_torch_tree(stats, device)


def obs_stats_from_jax(triple: Any, device: str | torch.device = "cpu") -> tuple:
    """The port's ``ESState.obs_stats`` from the JAX package's
    ``(count, mean, m2)`` Welford triple (as numpy): float32 tensors."""
    return tuple(torch.as_tensor(np.array(x, dtype=np.float32)).to(device) for x in triple)


def table_from_numpy(array: Any, seed: int | None = None,
                     device: str | torch.device = "cpu") -> NoiseTable:
    """The port's ``NoiseTable`` holding ``array`` (e.g. the JAX table's data)."""
    return NoiseTable.from_numpy(array, seed=seed, device=device)


def env_states_from_jax(env: Any, states: Any, device: str | torch.device = "cpu") -> torch.Tensor:
    """The port's ``(..., state_dim)`` states from batched JAX env states
    (as numpy): an array ``(..., state_dim)``, or the planar envs' dict of
    ``pos``, ``theta``, ``vel``, ``omega``, ``t`` with any leading shape,
    packed in ``env.layout`` (the wrappers forward their base's)."""
    if not (isinstance(states, dict) or hasattr(states, "items")):
        return torch.as_tensor(np.array(states, dtype=np.float32)).to(device)
    fields = {k: np.array(v, dtype=np.float32) for k, v in states.items()}
    lead = fields["t"].shape
    flat = [torch.from_numpy(fields[k].reshape((-1,) + fields[k].shape[len(lead):]))
            for k in ("pos", "theta", "vel", "omega", "t")]
    packed = env.layout.pack_fields(*flat)
    return packed.reshape(lead + (packed.shape[-1],)).to(device)
