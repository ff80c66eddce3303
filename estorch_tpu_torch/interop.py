"""Carry weights, noise and env states across from the JAX package, as
numpy arrays.

Both packages lay their params out the same way (``ops/params.py``), so a
JAX param tree (the MLP's, or NatureCNN's with its conv kernels in HWIO and
its VBN ``scale``/``bias``) or its flat ``params_flat``, a policy's frozen
``vbn_stats`` and the JAX noise table can be handed to the port and both
compute the same thing; batched JAX env states
are packed into the port's ``(n, state_dim)`` rows (a ``ScenarioEnv``'s
too), a JAX scenario distribution's drawn table becomes a port
distribution (:func:`scenario_distribution_from_jax`), and a JAX
checkpoint's content restores a port ES in place
(:func:`restore_from_jax`).  Only numpy
crosses the boundary; nothing here imports JAX.
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
    packed in ``env.layout`` (the wrappers forward their base's).

    For a ``ScenarioEnv`` the JAX state is ``(base_state, params, variant,
    key)``: the base state packed as above, then the params in the
    distribution's sorted-name order, the variant, and a noise stream id
    taken from the key's last raw uint32 word (its low 24 bits; pass
    ``jax.random.key_data`` of a typed key), at step count 0.  The JAX
    package's threefry observation noise does not cross; the port's noise
    follows its own stream (``scenarios/env.py``)."""
    if isinstance(states, (tuple, list)) and hasattr(env, "distribution"):
        from .scenarios.env import _STREAMS

        base, params, variant, key = states
        packed = env_states_from_jax(env.base, base)
        lead = packed.shape[:-1]
        cols = [np.array(params[n], dtype=np.float32).reshape(lead)
                for n in env.distribution.names]
        stream = np.array(key, dtype=np.uint32).reshape(lead + (-1,))[..., -1] % _STREAMS
        cols += [np.array(variant, dtype=np.float32).reshape(lead),
                 stream.astype(np.float32), np.zeros(lead, np.float32)]
        tail = torch.from_numpy(np.stack(cols, axis=-1))
        return torch.cat([packed.cpu(), tail], dim=-1).to(device)
    if not (isinstance(states, dict) or hasattr(states, "items")):
        return torch.as_tensor(np.array(states, dtype=np.float32)).to(device)
    fields = {k: np.array(v, dtype=np.float32) for k, v in states.items()}
    lead = fields["t"].shape
    flat = [torch.from_numpy(fields[k].reshape((-1,) + fields[k].shape[len(lead):]))
            for k in ("pos", "theta", "vel", "omega", "t")]
    packed = env.layout.pack_fields(*flat)
    return packed.reshape(lead + (packed.shape[-1],)).to(device)


def scenario_distribution_from_jax(spec: dict, drawn: Any):
    """A port ``ScenarioDistribution`` that draws the JAX package's
    constants: ``spec`` is the JAX distribution's ``spec_json()`` and
    ``drawn`` its ``draw_all()`` as numpy (``{name: (n_variants,)}``).  The
    packages' streams differ (``ops/noise.py``), so without this the same
    spec names other constants in each."""
    from .scenarios import ScenarioDistribution

    dist = ScenarioDistribution.from_json(spec)
    table = np.stack([np.array(drawn[n], dtype=np.float32).reshape(-1) for n in dist.names],
                     axis=1)
    if table.shape != (dist.n_variants, len(dist.names)):
        raise ValueError(f"drawn table of shape {table.shape} does not match the spec's "
                         f"({dist.n_variants}, {len(dist.names)})")
    dist._table = torch.from_numpy(table)
    return dist


def _find_adam(node: Any):
    """The ``(count, mu, nu)`` node of an optax state as numpy: the
    ``ScaleByAdamState`` (a namedtuple, or the dict a checkpoint restores
    it as) wherever it sits in the optax chain's tuple."""
    if isinstance(node, dict) or hasattr(node, "items"):
        if {"count", "mu", "nu"} <= set(node.keys()):
            return node["count"], node["mu"], node["nu"]
        children = list(node.values())
    elif all(hasattr(node, k) for k in ("count", "mu", "nu")):
        return node.count, node.mu, node.nu
    elif isinstance(node, (list, tuple)):
        children = list(node)
    else:
        return None
    for child in children:
        found = _find_adam(child)
        if found is not None:
            return found
    return None


def restore_from_jax(es, tree: dict, meta: dict, history: list | None = None) -> None:
    """Restore the port's ``es`` (device or pooled backend) in place from
    a JAX package checkpoint's content: ``tree`` is the numeric tree of its
    ``_state_tree`` as numpy, ``meta`` its ``meta.json`` dict and
    ``history`` its ``history.json`` list (kept when None).

    Carried: params, the optax Adam state ``(count, mu, nu)`` as
    ``optim.AdamState``, generation, σ, obs stats, the best member, the
    history, the archive with its centers' BCs, the NSRA weight and the
    meta RNG state.  The JAX key is not: the port keeps its own ``seed``
    (its draws are not JAX's; tests inject JAX's).  A mismatch of backend,
    algorithm or obs-norm schema raises the checkpoint's ``ValueError``s.
    """
    from .optim import AdamState
    from .parallel.engine import ESState
    from .utils.checkpoint import check_meta, restore_run

    if es.backend == "host":
        raise ValueError("restore_from_jax carries device and pooled states; a host "
                         "checkpoint's torch optimizer state loads with torch directly")
    check_meta(es, meta)
    dev = es.device

    def f32(x) -> torch.Tensor:
        return torch.as_tensor(np.array(x, dtype=np.float32)).to(dev)

    templates = list(es.meta_states) if hasattr(es, "meta_states") else [es.state]
    states = []
    for packed, template in zip(tree["states"], templates, strict=True):
        opt = None
        if template.opt_state is not None:
            found = _find_adam(packed["opt_state"])
            if found is None or not isinstance(template.opt_state, AdamState):
                raise ValueError("only an optax Adam state carries across (optim.adam)")
            count, mu, nu = found
            opt = AdamState(int(np.asarray(count)), f32(mu), f32(nu))
        obs_stats = packed.get("obs_stats")
        states.append(ESState(
            params_flat=f32(packed["params_flat"]), opt_state=opt, seed=template.seed,
            generation=int(np.asarray(packed["generation"])), sigma=f32(packed["sigma"]),
            obs_stats=None if obs_stats is None else tuple(f32(x) for x in obs_stats)))
    restore_run(es, tree, meta, states, f32)
    if history is not None:
        es.history = list(history)
