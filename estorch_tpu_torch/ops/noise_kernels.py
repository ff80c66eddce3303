"""Streamed-noise kernels and their plain PyTorch versions.

Counterpart of ``estorch_tpu/ops/pallas_noise.py``.  Two functions read
member noise straight from the shared table and never materialize it:

- :func:`weighted_noise_sum` — the update reduction Σ_k w_k·table[o_k : o_k+dim];
- :func:`population_noise_matvec` — the noise term of the streamed MLP
  forward, y_i = c_i·(x_i @ E_i) with E_i the member's (d, h) table slice.

Each wrapper launches its hand-written CUDA kernel (``csrc/noise_kernels.cu``)
for tensors on a CUDA device, or raises; for tensors on the CPU it runs the
plain version beside it.  There is no fallback from the kernel to the plain
version.  ``launch_counts`` counts kernel launches, so a run can show that
it went through the kernels.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .noise import gather_rows

launch_counts = {"weighted_noise_sum": 0, "population_noise_matvec": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# update reduction: Σ_k w_k · table[o_k : o_k + dim]
# ---------------------------------------------------------------------------


def weighted_noise_sum_plain(table_data: torch.Tensor, offsets: torch.Tensor,
                             weights: torch.Tensor, dim: int) -> torch.Tensor:
    """Gather the n rows, then ``weights @ rows``.  Zeros when n = 0."""
    if offsets.shape[0] == 0:
        return torch.zeros((dim,), dtype=table_data.dtype, device=table_data.device)
    return weights.to(table_data.dtype) @ gather_rows(table_data, offsets, dim)


def weighted_noise_sum(table_data: torch.Tensor, offsets: torch.Tensor,
                       weights: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ_k weights_k · table[offsets_k : offsets_k + dim] → (dim,) float32.

    ``table_data`` (size,) float32, ``offsets`` (n,) int32, ``weights`` (n,)
    float32.  CUDA tensors launch the kernel; CPU tensors take the plain
    version.
    """
    if table_data.device.type == "cpu":
        return weighted_noise_sum_plain(table_data, offsets, weights, dim)
    if table_data.device.type != "cuda":
        raise ValueError(f"unsupported device {table_data.device}")
    dev = table_data.device
    n = int(offsets.shape[0])
    size = int(table_data.shape[0])
    _check("table_data", table_data, torch.float32, (size,), dev)
    _check("offsets", offsets, torch.int32, (n,), dev)
    _check("weights", weights, torch.float32, (n,), dev)
    if not 0 < dim <= size:
        raise ValueError(f"dim must be in (0, {size}], got {dim}")
    if n == 0:
        return torch.zeros((dim,), dtype=torch.float32, device=dev)
    from ._build import load_library

    lib = load_library()
    rows_per_chunk = lib.estorch_weighted_sum_rows_per_chunk()
    n_chunks = -(-n // rows_per_chunk)
    if n_chunks > 65535:
        raise ValueError(f"n = {n} rows exceeds the kernel's grid ({65535 * rows_per_chunk})")
    partials = torch.empty((n_chunks, dim), dtype=torch.float32, device=dev)
    out = torch.empty((dim,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.estorch_weighted_noise_sum(
            table_data.data_ptr(), size, offsets.data_ptr(), weights.data_ptr(),
            n, dim, partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(err, "weighted_noise_sum")
    launch_counts["weighted_noise_sum"] += 1
    return out


# ---------------------------------------------------------------------------
# streamed-forward noise term: y_i = c_i · (x_i @ E_i)
# ---------------------------------------------------------------------------


def population_noise_matvec_plain(table_data: torch.Tensor, offsets: torch.Tensor,
                                  c: torch.Tensor, x: torch.Tensor,
                                  layer_offset: int, d: int, h: int) -> torch.Tensor:
    """Gather each member's E_i as (n, d, h), then ``bmm``."""
    n = x.shape[0]
    e = gather_rows(table_data, offsets.to(torch.int64) + layer_offset, d * h).view(n, d, h)
    return c[:, None] * torch.bmm(x[:, None, :], e)[:, 0, :]


def population_noise_matvec(table_data: torch.Tensor, offsets: torch.Tensor,
                            c: torch.Tensor, x: torch.Tensor, layer_offset: int,
                            d: int, h: int) -> torch.Tensor:
    """y[i] = c[i] · (x[i] @ E_i), E_i = table[offsets[i] + layer_offset :
    … + d·h] viewed row-major as (d, h) — the layout ``ParamSpec`` gives a
    dense kernel.  ``offsets`` (n,) int32, ``c`` (n,) float32, ``x`` (n, d)
    float32 → (n, h) float32.
    """
    if table_data.device.type == "cpu":
        return population_noise_matvec_plain(table_data, offsets, c, x, layer_offset, d, h)
    if table_data.device.type != "cuda":
        raise ValueError(f"unsupported device {table_data.device}")
    dev = table_data.device
    n = int(x.shape[0])
    size = int(table_data.shape[0])
    _check("table_data", table_data, torch.float32, (size,), dev)
    _check("offsets", offsets, torch.int32, (n,), dev)
    _check("c", c, torch.float32, (n,), dev)
    _check("x", x, torch.float32, (n, d), dev)
    if d <= 0 or h <= 0 or d * h > size:
        raise ValueError(f"bad layer shape (d={d}, h={h}) for a table of {size}")
    if d * 4 > 227 * 1024:
        raise ValueError(f"d = {d} does not fit the kernel's shared-memory stage")
    y = torch.empty((n, h), dtype=torch.float32, device=dev)
    if n == 0:
        return y
    from ._build import load_library

    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.estorch_population_noise_matvec(
            table_data.data_ptr(), size, offsets.data_ptr(), c.data_ptr(),
            x.data_ptr(), n, d, h, int(layer_offset), y.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(err, "population_noise_matvec")
    launch_counts["population_noise_matvec"] += 1
    return y


# ---------------------------------------------------------------------------
# full streamed MLP forward (population-batched)
# ---------------------------------------------------------------------------


def flat_layer_offsets(params: dict) -> dict[str, dict[str, int]]:
    """Each leaf's start offset in the flat vector (sorted-key order, each
    leaf row-major) — the addresses of a member's ε in the table slice."""
    offsets: dict[str, dict[str, int]] = {}
    pos = 0
    for layer in sorted(params):
        for name in sorted(params[layer]):
            offsets.setdefault(layer, {})[name] = pos
            pos += params[layer][name].numel()
    return offsets


def mlp_streamed_apply(module: Any, shared_params: dict, table_data: torch.Tensor,
                       offsets: torch.Tensor, c: torch.Tensor, obs: torch.Tensor,
                       layer_offsets: dict[str, dict[str, int]]) -> torch.Tensor:
    """Population-batched ``MLPPolicy`` forward with member weights
    (shared + c_i·ε_i), ε_i streamed from the table.

    Each layer's shared ``x @ W`` is one ``torch.matmul`` over the whole
    population; the noise term is the :func:`population_noise_matvec`
    kernel; the bias noise is a gather of h floats per member.  This
    reorders the contractions of ``models.decomposed.mlp_decomposed_apply``.
    """
    from ..models.decomposed import _ordered_dense_names

    activation: Callable = module.activation
    x = obs
    for name in _ordered_dense_names(shared_params):
        w = shared_params[name]["kernel"]
        b = shared_params[name]["bias"]
        d, h = int(w.shape[0]), int(w.shape[1])
        noise_term = population_noise_matvec(
            table_data, offsets, c, x, layer_offsets[name]["kernel"], d, h)
        nb = gather_rows(table_data, offsets.to(torch.int64) + layer_offsets[name]["bias"], h)
        # in place on the fresh (n, h) matmul output: no temporary per add
        x = x @ w
        x += noise_term
        x += b
        x.addcmul_(c[:, None], nb)
        if name != "head":
            x = activation(x)
    if not module.discrete:
        x = torch.tanh(x) * module.action_scale
    return x
