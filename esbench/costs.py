"""The benchmark's own counts of work and the card's peaks.

Operations and bytes come from a configuration's shapes and a generation's
offsets, never from the program, so a later change to the program cannot
move the yardstick.  A multiply-add is 2 FLOPs.  The peaks are NVIDIA's data
sheet for the H100 SXM, dense, at its 700 W limit: the port turns TF32 off,
so a float32 product's peak is the 67 TFLOP/s of the non-tensor-core path.
"""

from __future__ import annotations

import numpy as np

F32_PEAK_FLOPS = 67e12
HBM_PEAK_BYTES_PER_S = 3.35e12
F32_BYTES = 4
INT32_BYTES = 4

NATURE_CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
NATURE_FC = 512


def mlp_layers(obs_dim: int, hidden, action_dim: int) -> list[tuple[int, int]]:
    """The dense layers' (d, h) of an MLP policy."""
    sizes = [int(obs_dim)] + [int(h) for h in hidden] + [int(action_dim)]
    return list(zip(sizes[:-1], sizes[1:]))


def nature_cnn_layers(obs_shape, action_dim: int) -> list[dict]:
    """Each layer of the Nature CNN: its multiply-adds at every output
    position (``positions`` × ``d`` × ``h``)."""
    h, w, cin = (int(s) for s in obs_shape)
    out = []
    for feat, k, s in NATURE_CONVS:
        h, w = (h - k) // s + 1, (w - k) // s + 1
        out.append({"kind": "conv", "positions": h * w, "d": k * k * cin, "h": feat})
        cin = feat
    out.append({"kind": "dense", "positions": 1, "d": h * w * cin, "h": NATURE_FC})
    out.append({"kind": "dense", "positions": 1, "d": NATURE_FC, "h": int(action_dim)})
    return out


def policy_layers(config: dict, obs_shape) -> list[dict]:
    policy = config["policy"]
    if policy["kind"] == "mlp":
        return [{"kind": "dense", "positions": 1, "d": d, "h": h}
                for d, h in mlp_layers(obs_shape[-1], policy["hidden"], policy["action_dim"])]
    if policy["kind"] == "nature_cnn":
        return nature_cnn_layers(obs_shape, policy["action_dim"])
    raise ValueError(f"unknown policy kind {policy['kind']!r}")


def member_step_macs(config: dict, obs_shape) -> int:
    """Multiply-adds of one member's forward on one observation."""
    return sum(lay["positions"] * lay["d"] * lay["h"] for lay in policy_layers(config, obs_shape))


def generation_flops(config: dict, obs_shape, dim: int, alive_member_steps: int) -> float:
    """A generation's model FLOPs: 2 a multiply-add of the member forward at
    each alive member env step, plus the sample's and the update's
    2·rows·dim (rows: noise rows, a pair's when mirrored).  The streamed
    path's second product, VBN and the activations are not counted."""
    n = int(config["population_size"])
    rows = n // 2 if config.get("mirrored", True) else n
    return 2.0 * member_step_macs(config, obs_shape) * alive_member_steps + 2 * 2.0 * rows * dim


def distinct_floats(starts, length: int, size: int) -> int:
    """Floats of a table of ``size`` covered by the windows ``[s, s +
    length)``, each start clamped to ``[0, size − length]`` as the program
    clamps it."""
    s = np.unique(np.clip(np.asarray(starts, dtype=np.int64), 0, size - length))
    if s.size == 0:
        return 0
    # windows of one length, sorted: each adds up to the next one's start
    return int(np.minimum(np.diff(s), length).sum() + length)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the float32 peak and the bytes at the HBM peak."""
    return max(flops / F32_PEAK_FLOPS, nbytes / HBM_PEAK_BYTES_PER_S)


def matvec_bound_s(pair_offsets, layer_offset: int, n: int, d: int, h: int,
                   table_size: int) -> float:
    """One ``population_noise_matvec`` call, y_i = c_i·(x_i @ E_i) over n
    members: the distinct table bytes its offsets cover for this layer's
    slice (mirrored members share a pair's), plus x, c and y; 2·n·d·h
    FLOPs."""
    starts = np.asarray(pair_offsets, dtype=np.int64) + int(layer_offset)
    nbytes = (distinct_floats(starts, d * h, table_size) + n * (d + h + 1)) * F32_BYTES
    nbytes += n * INT32_BYTES
    return bound_s(2.0 * n * d * h, nbytes)


def reduction_bound_s(pair_offsets, dim: int, table_size: int) -> float:
    """One ``weighted_noise_sum`` call over the pairs' rows: the distinct
    table bytes of its rows plus weights, offsets and the output;
    2·rows·dim FLOPs."""
    rows = len(pair_offsets)
    nbytes = (distinct_floats(pair_offsets, dim, table_size) + rows + dim) * F32_BYTES
    nbytes += rows * INT32_BYTES
    return bound_s(2.0 * rows * dim, nbytes)
