"""Torch ``Linear`` MLP ↔ the port's ``MLPPolicy`` params.

Counterpart of ``estorch_tpu/models/torch_adapter.py`` (torch ↔ flax).  A
torch MLP trained on the host backend moves onto the device path, or a
device-trained ``MLPPolicy`` back into torch for deployment, without
retraining:

    params = torch_mlp_to_params(torch_policy, MLPPolicy(action_dim=2, hidden=(32, 32)))
    flat, spec = make_param_spec(params)   # the JAX package's ravel_pytree layout
    params_to_torch_mlp(params, torch_policy)

The torch policy's ``Linear`` layers, in module order, map one to one onto
``dense_0 … dense_{n-1}, head``.  A ``Linear`` stores its weight (out, in);
``MLPPolicy`` stores its kernel (in, out), as flax's ``Dense`` does.
"""

from __future__ import annotations

from typing import Any

import torch

from .decomposed import _ordered_dense_names


def _torch_linears(policy: torch.nn.Module) -> list[torch.nn.Linear]:
    linears = [m for m in policy.modules() if isinstance(m, torch.nn.Linear)]
    for i, lin in enumerate(linears):
        if lin.bias is None:
            raise ValueError(
                f"Linear layer {i} has bias=False; the adapter maps to MLPPolicy dense "
                "layers, which always carry a bias — add biases (they can be zero) or "
                "adapt the layer manually")
    return linears


def _check_count(linears: list, names: list[str]) -> None:
    if len(linears) != len(names):
        raise ValueError(f"layer count mismatch: torch has {len(linears)} Linear layers, "
                         f"MLPPolicy has {len(names)} dense layers ({names})")


def torch_mlp_to_params(torch_policy: torch.nn.Module, module: Any,
                        obs_dim: int | None = None) -> dict:
    """``module``'s param dict (on the CPU) carrying ``torch_policy``'s
    weights.  ``obs_dim`` defaults to the first ``Linear``'s input size;
    VBN ``scale``/``bias`` keep their initial values."""
    linears = _torch_linears(torch_policy)
    if obs_dim is None:
        obs_dim = linears[0].in_features
    params = module.init_params(int(obs_dim), torch.Generator().manual_seed(0))
    names = _ordered_dense_names(params)
    _check_count(linears, names)
    for lin, name in zip(linears, names):
        w = lin.weight.detach().cpu().T.contiguous()  # (out, in) -> (in, out)
        if tuple(params[name]["kernel"].shape) != tuple(w.shape):
            raise ValueError(f"shape mismatch at {name}: MLPPolicy "
                             f"{tuple(params[name]['kernel'].shape)} vs torch {tuple(w.shape)}")
        params[name]["kernel"] = w
        params[name]["bias"] = lin.bias.detach().cpu().clone()
    return params


def params_to_torch_mlp(params: dict, torch_policy: torch.nn.Module) -> None:
    """Load an ``MLPPolicy`` param dict into a torch policy in place."""
    linears = _torch_linears(torch_policy)
    names = _ordered_dense_names(params)
    _check_count(linears, names)
    with torch.no_grad():
        for lin, name in zip(linears, names):
            w = params[name]["kernel"].T
            if tuple(lin.weight.shape) != tuple(w.shape):
                # Tensor.copy_ broadcasts: a size-1 mismatch would duplicate rows
                raise ValueError(f"shape mismatch at {name}: torch {tuple(lin.weight.shape)} "
                                 f"vs MLPPolicy (transposed) {tuple(w.shape)}")
            lin.weight.copy_(w)
            lin.bias.copy_(params[name]["bias"])
