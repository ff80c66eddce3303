"""Parameter dict <-> flat vector, in ``ravel_pytree``'s layout.

Counterpart of ``estorch_tpu/ops/params.py``.  The flat layout is the one
the noise table's offsets address (``noise_kernels.flat_layer_offsets``),
so it must equal ``jax.flatten_util.ravel_pytree`` exactly:

- dict keys in sorted (string) order at every level, so ``dense_10``
  comes before ``dense_2`` and ``bias`` before ``kernel``;
- each leaf row-major; a dense kernel is stored (in, out).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def _leaves(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, torch.as_tensor(tree))]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Static description of a nested param dict: each leaf's path, shape
    and start offset in the flat vector."""

    dim: int
    paths: tuple[tuple, ...]
    shapes: tuple[tuple[int, ...], ...]
    offsets: tuple[int, ...]

    def unravel(self, flat: torch.Tensor) -> dict:
        """Nested dict of views into ``flat`` (no copies).

        ``flat`` is (dim,) or has leading axes, (..., dim): a stack of
        members' vectors unravels into leaves of shape (..., *leaf_shape).
        """
        if flat.ndim < 1 or flat.shape[-1] != self.dim:
            raise ValueError(f"flat vector must be (..., {self.dim}), got {tuple(flat.shape)}")
        lead = tuple(flat.shape[:-1])
        tree: dict = {}
        for path, shape, off in zip(self.paths, self.shapes, self.offsets):
            size = 1
            for s in shape:
                size *= s
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = flat[..., off:off + size].view(lead + shape)
        return tree

    def flatten(self, tree: Any) -> torch.Tensor:
        """The (dim,) vector of a dict in this spec's layout (a copy)."""
        leaves = []
        for path in self.paths:
            node = tree
            for k in path:
                node = node[k]
            leaves.append(node.reshape(-1))
        return torch.cat(leaves)


def map_tree(fn, tree: dict) -> dict:
    """``fn`` on every leaf of a nested param dict."""
    return {k: map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def make_param_spec(params: Any) -> tuple[torch.Tensor, ParamSpec]:
    """Flatten ``params`` once; return the flat vector and its spec."""
    leaves = _leaves(params)
    paths, shapes, offsets = [], [], []
    pos = 0
    for path, leaf in leaves:
        paths.append(path)
        shapes.append(tuple(int(s) for s in leaf.shape))
        offsets.append(pos)
        pos += leaf.numel()
    flat = torch.cat([leaf.reshape(-1) for _, leaf in leaves])
    return flat, ParamSpec(dim=pos, paths=tuple(paths), shapes=tuple(shapes),
                           offsets=tuple(offsets))


def count_params(params: Any) -> int:
    """The number of scalars in a param tree: nested dicts, lists or tuples
    of tensors or arrays (None leaves count none)."""
    if params is None:
        return 0
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(torch.as_tensor(params).numel())
