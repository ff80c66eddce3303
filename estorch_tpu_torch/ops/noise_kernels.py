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
it went through the kernels.  Under a profiler each launch is the range
``estorch.noise_sum`` / ``estorch.noise_matvec``, opened around the launch
alone: a launch through ``ctypes`` is under no torch op, and is linked to
the innermost range open at the time (``obs/trace.py``).

The matvec kernel works on pairs of adjacent members (2p, 2p+1): where their
slices start at the same place, as every mirrored pair's do, it reads the
pair's noise once for both.  It finds that out from the offsets; the
contract above, the clamp of out-of-range starts and the plain version are
the same as for any other offsets.

The reduction kernel sums in float64 in an order of its own (rows split over
thread-block clusters, sorted by their clamped start where that saves
reads), so its float32 result is the plain version's bit for bit but at a
rounding tie; :func:`weighted_noise_sum_mapping` reads back how it splits a
shape.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..obs.trace import annotate
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


def _out_dtype(out_dtype: torch.dtype) -> torch.dtype:
    if out_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"out_dtype must be torch.float32 or torch.float64, got {out_dtype}")
    return out_dtype


def weighted_noise_sum_plain(table_data: torch.Tensor, offsets: torch.Tensor,
                             weights: torch.Tensor, dim: int,
                             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gather the n rows, then ``weights @ rows`` in float64, rounded to
    float32 once (or left in float64 with ``out_dtype=torch.float64``): the
    kernel's sum, in another order.  Zeros when n = 0."""
    out_dtype = _out_dtype(out_dtype)
    if offsets.shape[0] == 0:
        return torch.zeros((dim,), dtype=out_dtype, device=table_data.device)
    rows = gather_rows(table_data, offsets, dim).double()
    return (weights.double() @ rows).to(out_dtype)


def weighted_noise_sum(table_data: torch.Tensor, offsets: torch.Tensor,
                       weights: torch.Tensor, dim: int,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Σ_k weights_k · table[offsets_k : offsets_k + dim] → (dim,) float32,
    summed in float64 and rounded once, so the card and the CPU agree.
    ``out_dtype=torch.float64`` returns the float64 sum unrounded, for a
    caller that adds several such partial sums before its one rounding (the
    ranks of a multi-rank update).

    ``table_data`` (size,) float32, ``offsets`` (n,) int32, ``weights`` (n,)
    float32.  CUDA tensors launch the kernel; CPU tensors take the plain
    version.
    """
    out_dtype = _out_dtype(out_dtype)
    if table_data.device.type == "cpu":
        return weighted_noise_sum_plain(table_data, offsets, weights, dim, out_dtype)
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
        return torch.zeros((dim,), dtype=out_dtype, device=dev)
    from ._build import load_library

    lib = load_library()
    max_rows = lib.estorch_weighted_sum_max_rows()
    if n > max_rows:
        raise ValueError(f"n = {n} rows exceeds the kernel's limit ({max_rows})")
    # the kernel's scratch: the rows in its visiting order (16 bytes each) where it sorts
    scratch = torch.empty((n, 2), dtype=torch.int64, device=dev)
    out = torch.empty((dim,), dtype=out_dtype, device=dev)
    launch = (lib.estorch_weighted_noise_sum_f64 if out_dtype == torch.float64
              else lib.estorch_weighted_noise_sum)
    with annotate("estorch.noise_sum"), torch.cuda.device(dev):
        err = launch(
            table_data.data_ptr(), size, offsets.data_ptr(), weights.data_ptr(),
            n, dim, scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(err, "weighted_noise_sum")
    launch_counts["weighted_noise_sum"] += 1
    return out


def weighted_noise_sum_mapping(n: int, dim: int, table_size: int) -> dict:
    """How the CUDA kernel splits n rows of ``dim`` floats from a table of
    ``table_size``: ``cols`` columns a lane, ``row_groups`` R a block (8 / R
    warps side by side over a row, a window of 32·cols·8/R columns),
    ``cluster`` G blocks a window (a thread-block cluster over the rows),
    and ``sorted``, whether it visits the rows by clamped start (else by
    index).  The kernel's launcher picks it; this reads it back, for
    reports and tests.  Needs the kernels' library (nvcc)."""
    import ctypes

    from ._build import load_library

    m = (ctypes.c_int * 4)()
    if load_library().estorch_weighted_sum_mapping(n, dim, table_size, ctypes.addressof(m)):
        raise ValueError(f"no mapping for n={n}, dim={dim}, table_size={table_size}")
    return {"cols": m[0], "row_groups": m[3], "cluster": m[1], "sorted": bool(m[2])}


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
    y = torch.empty((n, h), dtype=torch.float32, device=dev)
    if n == 0:
        return y
    from ._build import load_library

    lib = load_library()
    with annotate("estorch.noise_matvec"), torch.cuda.device(dev):
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
