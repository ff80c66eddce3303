#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (estorch_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. identity — the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the build of the kernels from ops/csrc in this checkout;
2. each kernel against its plain PyTorch version at the shapes of the main
   path, on a real 2^25-float noise table, with its device time (CUDA
   events around 30 calls queued back to back, inputs warm in L2 as on the
   main path), the plain version's time and the card's bound;
3. the main path: ES on Pendulum, MLP 64x64, population 4096, horizon 200,
   streamed forward + kernel update, 1 warm-up and 3 timed generations,
   with the kernels' launch counts read around that run, then one more
   generation under torch.profiler for the device's busy share;
4. the same two generations at a small size on the card and on the CPU
   (plain versions): the fitness and params must agree.

Then one JSON line of per-kernel numbers, the card line, and the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HORIZON = 200
POPULATION = 4096
POLICY = {"action_dim": 1, "hidden": (64, 64), "discrete": False, "action_scale": 2.0}
TABLE_SIZE = 1 << 25

# published peaks (NVIDIA data sheets): memory bytes/s, float32 non-tensor FLOP/s
CARD_PEAKS = {
    "H100 NVL": (3.9e12, 60e12),
    "H100 PCIe": (2.0e12, 51e12),
    "H100": (3.35e12, 67e12),  # SXM, the default for any other H100 name
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    return out.strip().splitlines()[0]


def card_peaks(name: str) -> tuple[float, float]:
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    fail(f"no published peaks for {name!r}")


def time_ms(torch, fn, reps: int = 30) -> float:
    """Device time of one call: ``reps`` calls back to back between two CUDA
    events, queued behind a device-side sleep so that the host's Python
    time per call is hidden (the events see only the device's work)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s at H100 clocks: the host queues ahead
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def union_floats(starts, length: int) -> int:
    """Distinct table floats read by slices [s, s + length): what this run's
    data needs (mirrored pairs share an offset, and slices can overlap)."""
    total, cur_lo, cur_hi = 0, None, None
    for s in sorted(int(v) for v in starts):
        if cur_hi is None or s > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = s, s + length
        else:
            cur_hi = max(cur_hi, s + length)
    return total + (cur_hi - cur_lo if cur_hi is not None else 0)


def profile_generation(torch, es) -> None:
    """One more generation under torch.profiler: the device's busy share of
    the wall time and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        es.train(1, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
                  reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    print(f"profile: one generation {wall:.4f} s wall under the profiler, device busy "
          f"{busy_s:.4f} s ({busy_s / wall:.3f} of wall)")
    for us, count, key in rows[:15]:
        print(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        import estorch_tpu_torch
    except ImportError as e:
        fail(f"cannot import estorch_tpu_torch from {HERE}: {e}")
    if not os.path.abspath(estorch_tpu_torch.__file__).startswith(HERE + os.sep):
        fail(f"estorch_tpu_torch comes from {estorch_tpu_torch.__file__}, not this checkout")
    from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, Pendulum, adam
    from estorch_tpu_torch.ops import _build
    from estorch_tpu_torch.ops import noise_kernels as nk
    from estorch_tpu_torch.ops.noise import make_noise_table, member_offsets, sample_pair_offsets
    from estorch_tpu_torch.ops.params import make_param_spec

    # ---- 1. identity and build -------------------------------------------
    card = card_line()
    name = torch.cuda.get_device_name(0)
    bw, f32 = card_peaks(name)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    try:
        _build.load_library()
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    print(f"kernels built in {_build.build_info['seconds']:.2f} s -> {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda")

    # ---- 2. kernels against their plain versions --------------------------
    table = make_noise_table(TABLE_SIZE, seed=0, device=dev).data
    gen = torch.Generator().manual_seed(1)
    params = MLPPolicy(**POLICY).init_params(Pendulum().obs_dim, gen)
    _, spec = make_param_spec(params)
    layer_offs = nk.flat_layer_offsets(params)
    dim = spec.dim
    n_pairs = POPULATION // 2

    # weighted_noise_sum: one launch a generation over the pair rows.
    # Tolerance: float32 sums over up to 2048 rows in another order than the
    # plain gather + matvec; |weights| <= 1, so |error| well under 1e-3.
    wns = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    for n in (n_pairs, 0, 1):
        offs = sample_pair_offsets(gen, n, TABLE_SIZE, dim).to(dev)
        w = (torch.rand(n, generator=gen) * 2 - 1).to(dev)
        got = nk.weighted_noise_sum(table, offs, w, dim)
        torch.cuda.synchronize()
        want = nk.weighted_noise_sum_plain(table, offs, w, dim)
        err = float((got - want).abs().max()) if dim else 0.0
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
            fail(f"weighted_noise_sum n={n} dim={dim}: max |err| {err:g}")
        print(f"weighted_noise_sum n={n} dim={dim}: max |err| {err:.3g} (tol atol 1e-3, rtol 1e-4)")
        if n != n_pairs:
            continue
        nbytes = 4 * (union_floats(offs.cpu(), dim) + 2 * n + dim)
        flops = 2 * n * dim
        bound = max(nbytes / bw, flops / f32) * 1e3
        ms = time_ms(torch, lambda: nk.weighted_noise_sum(table, offs, w, dim))
        plain_ms = time_ms(torch, lambda: nk.weighted_noise_sum_plain(table, offs, w, dim))
        print(f"  time {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB distinct)")
        wns.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, max_abs_err=err,
                   bound_by="bytes" if nbytes / bw >= flops / f32 else "operations")

    # population_noise_matvec: three launches an env step, one per layer.
    # Tolerance: float32 dot products of d <= 64 terms in another order.
    pair_offs = sample_pair_offsets(gen, n_pairs, TABLE_SIZE, dim)
    moffs = member_offsets(pair_offs).to(dev)
    c = (0.05 * torch.tensor([1.0, -1.0]).repeat(n_pairs)).to(dev)
    pnm = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
           "bytes": 0.0, "flops": 0.0}
    for lname, d, h in (("dense_0", 3, 64), ("dense_1", 64, 64), ("head", 64, 1)):
        x = torch.randn((POPULATION, d), generator=gen)
        x = (2 * x if lname == "dense_0" else torch.tanh(x)).to(dev)
        lo = layer_offs[lname]["kernel"]
        got = nk.population_noise_matvec(table, moffs, c, x, lo, d, h)
        torch.cuda.synchronize()
        want = nk.population_noise_matvec_plain(table, moffs, c, x, lo, d, h)
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            fail(f"population_noise_matvec ({d}, {h}): max |err| {err:g}")
        nbytes = 4 * (union_floats(pair_offs + lo, d * h) + 2 * POPULATION
                      + POPULATION * d + POPULATION * h)
        flops = 2 * POPULATION * d * h + POPULATION * h
        bound = max(nbytes / bw, flops / f32) * 1e3
        ms = time_ms(torch, lambda: nk.population_noise_matvec(table, moffs, c, x, lo, d, h))
        plain_ms = time_ms(
            torch, lambda: nk.population_noise_matvec_plain(table, moffs, c, x, lo, d, h))
        print(f"population_noise_matvec n={POPULATION} ({d}, {h}): max |err| {err:.3g} "
              f"(tol atol 1e-4, rtol 1e-4); time {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB distinct)")
        pnm["ms"] += ms
        pnm["plain_ms"] += plain_ms
        pnm["bound_ms"] += bound
        pnm["bytes"] += nbytes
        pnm["flops"] += flops
        pnm["max_abs_err"] = max(pnm["max_abs_err"], err)
    pnm["bound_by"] = "bytes" if pnm["bytes"] / bw >= pnm["flops"] / f32 else "operations"
    del table

    # ---- 3. the main path ---------------------------------------------------
    es = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=HORIZON), adam,
            population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
            optimizer_kwargs={"learning_rate": 1e-2}, streamed=True, noise_kernel=True)
    if es.device.type != "cuda":
        fail(f"ES ran on {es.device}")
    p0 = es.state.params_flat.clone()
    nk.reset_launch_counts()
    es.train(1, verbose=False)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    es.train(3, verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(nk.launch_counts)
    gens = len(es.history)
    steps = sum(r["env_steps"] for r in es.history[1:])
    for r in es.history:
        if r["n_failed"] or not all(math.isfinite(r[k])
                                    for k in ("reward_mean", "reward_max", "grad_norm")):
            fail(f"generation {r['generation']}: non-finite result {r}")
        print(f"gen {r['generation']}: reward mean {r['reward_mean']:.2f} max "
              f"{r['reward_max']:.2f}, n_valid {POPULATION - r['n_failed']}, "
              f"{r['env_steps_per_sec']:.0f} env-steps/s, {r['wall_time_s']:.4f} s")
    if gens != 4:
        fail(f"expected 4 generations, got {gens}")
    if torch.equal(p0, es.state.params_flat):
        fail("params did not change")
    want = {"population_noise_matvec": 3 * HORIZON * gens, "weighted_noise_sum": gens}
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    print(f"main path: {steps / dt:.0f} env-steps/s over 3 generations "
          f"({dt / 3:.4f} s a generation) on {card}; launches {launches}")
    gen_s = dt / 3
    kernel_s = (HORIZON * pnm["ms"] + wns["ms"]) / 1e3
    print(f"  kernels' share of a generation: {kernel_s / gen_s:.3f} "
          f"({HORIZON} x matvec step {pnm['ms']:.4f} ms + reduction {wns['ms']:.4f} ms)")

    profile_generation(torch, es)  # after the counts are read: not part of them

    # ---- 4. the card against the CPU's plain versions at a small size -----
    small = dict(population_size=64, sigma=0.05, policy_kwargs=POLICY,
                 optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 22,
                 streamed=True, noise_kernel=True)
    es_gpu = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=50), adam, **small)
    es_cpu = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=50), adam, device="cpu", **small)
    es_gpu.train(2, verbose=False)
    es_cpu.train(2, verbose=False)
    fit_err = max(abs(a["reward_mean"] - b["reward_mean"]) / abs(b["reward_mean"])
                  for a, b in zip(es_gpu.history, es_cpu.history))
    p_err = float((es_gpu.state.params_flat.cpu() - es_cpu.state.params_flat).abs().max())
    # float32 over 50 env steps and 2 Adam steps, summed in other orders
    if fit_err > 1e-4 or p_err > 1e-4:
        fail(f"card vs CPU: reward_mean rel err {fit_err:g}, params max |err| {p_err:g}")
    print(f"card vs CPU plain path (pop 64, horizon 50, 2 generations): reward_mean rel err "
          f"{fit_err:.3g} (tol 1e-4), params max |err| {p_err:.3g} (tol 1e-4)")

    # ---- report --------------------------------------------------------------
    kernels = [
        {"name": "weighted_noise_sum", "route": "cuda",
         "source": "estorch_tpu_torch/ops/csrc/noise_kernels.cu",
         "replaces": "estorch_tpu/ops/pallas_noise.py:90",
         "launches": launches["weighted_noise_sum"], "max_abs_err": wns["max_abs_err"],
         "ms": wns["ms"], "plain_ms": wns["plain_ms"], "bound_ms": wns["bound_ms"],
         "bound_by": wns["bound_by"], "library_ms": None,
         "shape": f"n={n_pairs} rows, dim={dim}"},
        {"name": "population_noise_matvec", "route": "cuda",
         "source": "estorch_tpu_torch/ops/csrc/noise_kernels.cu",
         "replaces": "estorch_tpu/ops/pallas_noise.py:201",
         "launches": launches["population_noise_matvec"], "max_abs_err": pnm["max_abs_err"],
         "ms": pnm["ms"], "plain_ms": pnm["plain_ms"], "bound_ms": pnm["bound_ms"],
         "bound_by": pnm["bound_by"], "library_ms": None,
         "shape": f"one env step: n={POPULATION} at (3,64)+(64,64)+(64,1)"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
