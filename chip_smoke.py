#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (estorch_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. identity — the card (nvidia-smi name and power limit), torch and CUDA
   versions, the build of the kernels from ops/csrc in this checkout, and
   the build of the C++ envpool from native/envpool.cpp (its pools of
   cartpole, pendulum and pong84 must be native);
2. each kernel against its plain PyTorch version at the shapes of the main
   path, on a real 2^25-float noise table, with its device time (CUDA
   events around 30 calls queued back to back, inputs warm in L2 as on the
   main path), the plain version's time and the card's bound.  The matvec
   is also checked on unmirrored offsets, an odd population and starts that
   need the clamp, timed cold (L2 flushed before each launch by writing and
   then reading a 256 MB buffer), and timed at shapes off the main path:
   the (256, 256) layer of the JAX bench's BIG config and the CartPole
   MLP64x64 layers; both kernels are also checked and timed at the shapes
   of phase 7's streamed paths (g) and (i); the reduction also at the
   pong84_conv shape (128 pair rows, dim 1,685,987, a 2^23-float table),
   warm and cold, at the host path's (m) shape (500 pair rows, dim
   4737, the host path's NumPy-built 2^25-float table), warm, and at the
   recurrent paths' shape (2048 pair rows, dim 25,153: RecurrentPolicy's
   defaults on Pendulum), warm and cold;
3. the main path: ES on Pendulum, MLP 64x64, population 4096, horizon 200,
   streamed forward + kernel update, 1 warm-up and 3 timed generations,
   with the kernels' launch counts read around that run, then one more
   generation under torch.profiler for the device's busy share;
4. two generations at a small size on the card and on the CPU (plain
   versions), for the streamed path and for each path of phase 5: the
   fitness and params must agree; then one run of each env added for phase
   7 (classic control, synthetic, planar locomotion and its two wrappers)
   at population 64, horizon 20, SGD: reward means and update directions
   must agree (1e-4, cosine 0.999); then pooled Pendulum (pop 32, horizon
   60, SGD: returns within 1e-4 relative, update cosine 0.999) and the
   NatureCNN population forward on 20 recorded pong84 observations at
   population 4 (logits within 1e-4 of their scale, TF32 off); then the
   host path (a torch MLP 64x64 with TorchVirtualBatchNorm, a
   ``rollout(policy)`` Pendulum agent, pop 32, horizon 60, 2 generations,
   Adam, 4 threads: returns within 1e-4 relative, update cosine 0.999) and
   one generation in process mode (4 forked workers beside the live CUDA
   context) against the CPU's threads (fitness within 1e-5 relative); then
   the recurrent paths of phase 10 at a small size: (n) GRU 64, (p) stacked
   LSTM 64 with a learned carry in bf16, (q) MLP 64x64 with VBN on the
   device path, (r) GRU 64 on pooled Pendulum;
5. the other paths at the width of phase 3, each through ``ES(...).train``
   with 1 warm-up and 3 timed generations, its launch counts read around
   that run and checked exactly, then one profiled generation: (a) the
   default standard forward with the plain update, (b) the standard forward
   with the kernel update, (c) decomposed in bf16 with the kernel update,
   (d) low rank 1 in bf16, (e) obs_norm on the streamed path (both kernels);
6. one generation of each path with ``eval_chunk=1024`` against the whole
   population, and the products alone over 1024 rows against 4096: which
   results depend on the chunk (reported, not held);
7. the env paths at full width, each through ``ES(...).train`` with 1
   warm-up and 3 timed generations (1 for (h)), its launch counts read
   around that run and checked exactly, then one profiled generation: (f)
   Cheetah2D, MLP 64x64, pop 1024, horizon 200 (the ``cheetah2d_device``
   recipe at the JAX bench's LOCO horizon), standard forward; (g) the same,
   streamed forward + kernel update; (h) the ``humanoid2d_pop10k`` recipe
   (Humanoid2D, MLP 256x256, pop 10240, rank-1 noise, obs_norm with 4 probe
   episodes, chunks of 1024) in bf16 at horizon 100; (i) SyntheticEnv
   (376 -> 256x256 -> 17), pop 4096, horizon 200, streamed forward + kernel
   update;
8. the pooled paths, each through ``ES(...).train`` with 1 warm-up and 3
   timed generations (1 for (l)), launch counts exact, then one profiled
   generation: (j) PooledAgent("pendulum", horizon=200), MLP 64x64, pop
   4096, the kernel update; (k) the same with ``double_buffer=True``; (l)
   the ``pong84_conv`` recipe (NatureCNN with VBN, pop 256, 84x84x4, action
   repeat 2, sticky 0.25, horizon 500), with the host-clock shares of the
   four parts of its env step timed apart for one generation;
9. the host path at full width, (m) host/pendulum/vbn64x64: the
   ``halfcheetah_vbn`` recipe's torch MLP 64x64 with TorchVirtualBatchNorm
   (frozen from 128 random-action observations), pop 1000, sigma 0.02,
   ``torch.optim.Adam`` lr 1e-2, weight decay 0.005, a 2^25 table, on a
   ``rollout(policy)`` agent over the port's NumPy Pendulum pool (the
   output times 2; the card machine has no MuJoCo, so obs/action dims are
   3/1, not 17/6), Pendulum's horizon 200, 8 forked workers rolling out
   on the CPU with the update on the card, 1 warm-up and 2 timed
   generations with the reduction's launches exact (1 a generation), and
   the same run with ``device="cpu"``; then the policies on the card: one
   generation with one worker on each device at population 250 (cut from
   1000: it steps one member at a time), the launches an env step
   over 4 members' rollouts, the device's busy share of one profiled
   generation at population 16 with 8 threads; and, at horizon 10, 8
   thread workers against one on each device;
10. the recurrent paths, each through ``ES(...).train`` with 1 warm-up and
   2 timed generations, the reduction's launches exact (1 a generation
   with ``noise_kernel``), then one profiled generation: (n)
   ``RecurrentPolicy`` at its defaults (hidden (64,), GRU 64, dim 25,153)
   on Pendulum, pop 4096, horizon 200, the kernel update; (o) the same
   with ``low_rank=1`` (the tree form); (p) LSTM 64, two layers, learned
   carry, bf16, the kernel update; (q) MLP 64x64 with VBN from 128
   reference steps on the device path, the kernel update; (r) (n)'s policy
   on ``PooledAgent("pendulum", horizon=200)``; (s) ``RecurrentNatureCNN``
   (GRU 256, dim 2,275,747) on the pong84_conv recipe's pooled pong, pop
   256, horizon 100 (cut from 500); then the memory check, the JAX
   package's RecallEnv recipe (GRU 8, pop 256, 80 generations) at seeds 0,
   1 and 2: ``evaluate_policy(64, seed=9)`` above 8.0 at two of them.

Then one JSON line of per-path numbers, one of per-kernel numbers (launches
from phase 3, and of the reduction in (j), (k), (m) and phase 10), the card
line, and the last line
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
GENERATIONS = 4  # 1 warm-up + 3 timed, in phases 3 and 5
STREAMED = {"streamed": True, "noise_kernel": True}
# phase 5's paths, beside phase 3's streamed one: ES options, and the kernel
# launches each makes in its GENERATIONS generations at HORIZON
PATHS = [
    ("a standard", {}, 0, 0),
    ("b standard+kernel update", {"noise_kernel": True}, GENERATIONS, 0),
    ("c decomposed bf16+kernel update",
     {"decomposed": True, "compute_dtype": "bfloat16", "noise_kernel": True}, GENERATIONS, 0),
    ("d low_rank 1 bf16", {"low_rank": 1, "compute_dtype": "bfloat16"}, 0, 0),
    ("e obs_norm streamed", {"obs_norm": True, **STREAMED}, GENERATIONS,
     3 * HORIZON * GENERATIONS),
]
# phase 7's env paths, each through ES(...).train: label, how to build it, the
# timed generations after 1 warm-up, and whether it runs the two kernels (the
# streamed forward's 3 matvec launches an env step and the update's 1
# reduction a generation)
LOCO_HORIZON = 200  # the JAX bench's LOCO row (bench.py:285)
LOCO10K_HORIZON = 100  # the JAX bench's LOCO10K rows (bench.py:287)
ENV_PATHS = [
    ("f loco/standard/f32", lambda tt, cf: cf.cheetah2d_device(
        agent_kwargs={"env": tt.Cheetah2D(), "horizon": LOCO_HORIZON}), 3, False),
    ("g loco/streamed/f32+nk", lambda tt, cf: cf.cheetah2d_device(
        agent_kwargs={"env": tt.Cheetah2D(), "horizon": LOCO_HORIZON}, **STREAMED), 3, True),
    ("h loco10k/lowrank1+obsnorm/bf16", lambda tt, cf: cf.humanoid2d_pop10k(
        agent_kwargs={"env": tt.Humanoid2D(), "horizon": LOCO10K_HORIZON},
        compute_dtype="bfloat16"), 1, False),
    ("i big/streamed/f32+nk", lambda tt, cf: tt.ES(
        tt.MLPPolicy, tt.DeviceAgent(tt.SyntheticEnv(), horizon=HORIZON), tt.adam,
        population_size=POPULATION, sigma=0.05, optimizer_kwargs={"learning_rate": 1e-2},
        policy_kwargs={"action_dim": 17, "hidden": (256, 256), "discrete": False,
                       "action_scale": 1.0}, **STREAMED), 3, True),
]
# phase 8's pooled paths: label, how to build it, the timed generations after
# 1 warm-up, and the reduction's launches a generation
POOLED_PATHS = [
    ("j pooled/pendulum/standard+nk", lambda tt, cf: tt.ES(
        tt.MLPPolicy, tt.PooledAgent("pendulum", horizon=HORIZON), tt.adam,
        population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
        optimizer_kwargs={"learning_rate": 1e-2}, noise_kernel=True), 3, 1),
    ("k pooled/pendulum/standard+nk/double_buffer", lambda tt, cf: tt.ES(
        tt.MLPPolicy, tt.PooledAgent("pendulum", horizon=HORIZON, double_buffer=True), tt.adam,
        population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
        optimizer_kwargs={"learning_rate": 1e-2}, noise_kernel=True), 3, 1),
    # (l) times 1 generation (2 before PR 7) to keep the script within its time
    ("l pooled/pong84_conv", lambda tt, cf: cf.pong84_conv(), 1, 0),
]
PONG_PAIRS, PONG_TABLE = 128, 1 << 23  # the pong84_conv recipe's update shape
# phase 9, (m): the halfcheetah_vbn recipe's policy and hyperparameters on a
# rollout(policy) agent over Pendulum (the card machine has no MuJoCo), at
# Pendulum's horizon of 200, timed in process mode (8 forked workers).  The
# 8 thread workers step a few hundred env-steps/s on either device, minutes
# a generation at 200 steps, so they are a side reading at horizon 10
HOST_POPULATION, HOST_HORIZON, HOST_WORKERS = 1000, 200, 8
HOST_SIDE_HORIZON = 10  # the thread workers' side readings
HOST_TIMED = 2  # generations after 1 warm-up
HOST_ONE_WORKER_POP = 250  # the one-worker generations step members one by one
HOST_RECIPE = dict(population_size=HOST_POPULATION, sigma=0.02, optimizer_kwargs={"lr": 1e-2},
                   weight_decay=0.005, table_size=TABLE_SIZE)
HOST_PAIRS, HOST_DIM = HOST_POPULATION // 2, 4737  # the update's shape: 3 -> 64x64 VBN -> 1
# phase 10, the recurrent paths (n)-(s): label, how to build it, the timed
# generations after 1 warm-up, and the reduction's launches a generation.
# RecurrentPolicy at its defaults (hidden (64,), GRU 64) on Pendulum is
# dim 25,153; the timed generations are cut to 2 and (s)'s horizon from 500
# to 100, the cuts printed on each path's line
REC_POLICY = {"action_dim": 1, "discrete": False, "action_scale": 2.0}
REC_TIMED = 2
REC_COMMON = dict(population_size=POPULATION, sigma=0.05, optimizer_kwargs={"learning_rate": 1e-2})
PONG_REC_HORIZON = 100  # cut from the pong84_conv recipe's 500
REC_PATHS = [
    ("n recurrent/pendulum/gru64+nk", lambda tt, cf: tt.ES(
        tt.RecurrentPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON), tt.adam,
        policy_kwargs=REC_POLICY, noise_kernel=True, **REC_COMMON), 1, "2 timed generations"),
    ("o recurrent/pendulum/gru64+lowrank1 (tree form)", lambda tt, cf: tt.ES(
        tt.RecurrentPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON), tt.adam,
        policy_kwargs=REC_POLICY, low_rank=1, **REC_COMMON), 0, "2 timed generations"),
    ("p recurrent/pendulum/lstm64x2+learned_carry/bf16+nk", lambda tt, cf: tt.ES(
        tt.RecurrentPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON), tt.adam,
        policy_kwargs=dict(REC_POLICY, cell="lstm", n_layers=2, learned_carry=True),
        compute_dtype="bfloat16", noise_kernel=True, **REC_COMMON), 1, "2 timed generations"),
    ("q device/pendulum/mlp64x64+vbn+nk", lambda tt, cf: tt.ES(
        tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON), tt.adam,
        policy_kwargs=dict(POLICY, use_vbn=True), vbn_batch=128, noise_kernel=True,
        **REC_COMMON), 1, "2 timed generations"),
    ("r pooled/pendulum/gru64+nk", lambda tt, cf: tt.ES(
        tt.RecurrentPolicy, tt.PooledAgent("pendulum", horizon=HORIZON), tt.adam,
        policy_kwargs=REC_POLICY, noise_kernel=True, **REC_COMMON), 1, "2 timed generations"),
    ("s pooled/pong84/recurrent_nature_cnn256", lambda tt, cf: cf.pong84_conv(
        policy=tt.RecurrentNatureCNN, policy_kwargs={"action_dim": 3, "gru_size": 256},
        agent_kwargs={"env_name": "pong84", "horizon": PONG_REC_HORIZON, "frame_stack": 4,
                      "action_repeat": 2, "sticky_prob": 0.25}), 0,
     f"2 timed generations; horizon {PONG_REC_HORIZON}, cut from 500"),
]
REC_PAIRS = POPULATION // 2  # the update's rows on (n) and (r)
# the memory check: the JAX package's recipe (tests/test_recurrent.py:104-119)
MEMORY_RECIPE = dict(population_size=256, sigma=0.1, optimizer_kwargs={"learning_rate": 5e-2},
                     policy_kwargs={"action_dim": 1, "hidden": (8,), "gru_size": 8,
                                    "discrete": False})
MEMORY_SEEDS, MEMORY_GENERATIONS, MEMORY_HORIZON = (0, 1, 2), 80, 16
L2_FLUSH_BYTES = 256 << 20  # written and read before each cold launch: five times the L2
# one env step's three launches before the pair-sharing redesign, as measured
# then on an H100 80GB HBM3 at 700 W: printed beside this run's time, never
# reported as this run's number
PREV_MATVEC_STEP_MS = 0.0242

# published peaks (NVIDIA data sheets): memory bytes/s, float32 non-tensor FLOP/s
CARD_PEAKS = {
    "H100 NVL": (3.9e12, 60e12),
    "H100 PCIe": (2.0e12, 51e12),
    "H100": (3.35e12, 67e12),  # SXM, the default for any other H100 name
}


T0 = time.perf_counter()


def phase(title: str) -> None:
    print(f"---- {title} (at {time.perf_counter() - T0:.1f} s)", flush=True)


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


def time_cold_ms(torch, fn, flush, reps: int = 20) -> float:
    """Device time of one call with the L2 flushed: before each launch the
    ``flush`` buffer is written, then read, so that the L2 holds none of the
    call's data and no dirty lines (written only, the L2 keeps dirty lines
    whose write-back the call's reads would pay for).  CUDA events go around
    the launch alone, and all of it is queued behind a device-side sleep, as
    in :func:`time_ms`, so only device time is counted."""
    sink = torch.empty((), dtype=flush.dtype, device=flush.device)

    def evict():
        flush.zero_()
        torch.sum(flush, dim=0, out=sink)

    for _ in range(3):
        evict()
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        evict()
        start.record()
        fn()
        end.record()
    events[-1][1].synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


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


def profile_generation(torch, es, top: int = 15, **train_kw) -> tuple[float, int]:
    """One more generation under torch.profiler: the device's busy share of
    the wall time and the kernels that take it.  Returns the busy seconds
    and the number of kernel launches (copies and fills not counted).

    Only the device's activity is recorded, and its events are summed raw:
    ``key_averages()`` builds a Python object an event (about 0.3 ms each),
    minutes for a locomotion generation's million launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        es.train(1, verbose=False, **train_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue  # host-side events: the runtime's launch calls
        row = by_name.setdefault(e.name(), [0, 0])
        row[0] += e.duration_ns()
        row[1] += 1
    rows = sorted(((ns / 1e3, count, name) for name, (ns, count) in by_name.items()),
                  reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    kernels = sum(r[1] for r in rows if not r[2].startswith(("Memcpy", "Memset")))
    print(f"profile: one generation {wall:.4f} s wall under the profiler, device busy "
          f"{busy_s:.4f} s ({busy_s / wall:.3f} of wall), {kernels} kernel launches")
    mv = [r for r in rows if "noise_matvec" in r[2]]
    print(f"  noise_matvec kernels: {sum(r[0] for r in mv) / 1e3:.3f} ms device time, "
          f"{sum(r[1] for r in mv)} launches")
    for us, count, key in rows[:top]:
        print(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
    return busy_s, kernels


def compare_card_cpu(torch, tt) -> None:
    """Phase 4: two generations at population 64, horizon 50, on the card
    and on the CPU (plain versions), for the streamed path and each of PATHS.

    float32 paths: reward_mean within 1e-4 relative and params within 1e-4
    (float32 over 50 env steps and 2 Adam steps, summed in other orders).
    bf16 paths at the tolerance tests/test_torch_paths.py holds them to
    against JAX: SGD, so the param change is the ascent direction;
    reward_mean within 1e-3 relative, the param changes' cosine >= 0.99.
    """
    for label, opts in [("streamed", STREAMED)] + [(p[0], p[1]) for p in PATHS]:
        bf16 = opts.get("compute_dtype") == "bfloat16"
        small = dict(population_size=64, sigma=0.05, policy_kwargs=POLICY,
                     optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 22, **opts)
        optimizer = tt.sgd if bf16 else tt.adam
        es_gpu = tt.ES(tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=50), optimizer,
                       **small)
        es_cpu = tt.ES(tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=50), optimizer,
                       device="cpu", **small)
        p0 = es_cpu.state.params_flat.clone()
        es_gpu.train(2, verbose=False)
        es_cpu.train(2, verbose=False)
        fit_err = max(abs(a["reward_mean"] - b["reward_mean"]) / abs(b["reward_mean"])
                      for a, b in zip(es_gpu.history, es_cpu.history))
        p_gpu = es_gpu.state.params_flat.cpu()
        if bf16:
            dg, dc = p_gpu - p0, es_cpu.state.params_flat - p0
            cos = float(dg @ dc / (dg.norm() * dc.norm()))
            if fit_err > 1e-3 or cos < 0.99:
                fail(f"card vs CPU, {label}: reward_mean rel err {fit_err:g}, cosine {cos:g}")
            print(f"card vs CPU, {label} (pop 64, horizon 50, 2 generations, SGD): reward_mean "
                  f"rel err {fit_err:.3g} (tol 1e-3), param change cosine {cos:.6f} (tol 0.99)")
        else:
            p_err = float((p_gpu - es_cpu.state.params_flat).abs().max())
            if fit_err > 1e-4 or p_err > 1e-4:
                fail(f"card vs CPU, {label}: reward_mean rel err {fit_err:g}, "
                     f"params max |err| {p_err:g}")
            print(f"card vs CPU, {label} (pop 64, horizon 50, 2 generations): reward_mean rel "
                  f"err {fit_err:.3g} (tol 1e-4), params max |err| {p_err:.3g} (tol 1e-4)")


def compare_envs_card_cpu(torch, tt) -> list[dict]:
    """Phase 4, the envs: two generations of each env added for phase 7 at
    population 64, horizon 20 (the CPU parity tests' horizon), MLP 64x64,
    SGD, on the card and on the CPU.  Held: reward means within 1e-4 of
    max(|mean|, 1), and the param changes' cosine >= 0.999.  The planar
    physics is chaotic, and the card rounds sin, cos, tanh and its sums
    otherwise than the CPU; with SGD the change is the ascent direction,
    which a rank swap of two near-equal members moves only a little.  The
    first run on an H100 80GB HBM3 measured at most 6.0e-7 and a cosine of
    0.9999998: the margins are for another card's cuBLAS choices."""
    envs = [("Acrobot", tt.Acrobot(), True), ("MountainCar", tt.MountainCar(), True),
            ("MountainCarContinuous", tt.MountainCarContinuous(), False),
            ("SyntheticEnv", tt.SyntheticEnv(), False), ("RecallEnv", tt.RecallEnv(), False),
            ("Swimmer2D", tt.Swimmer2D(), False), ("Hopper2D", tt.Hopper2D(), False),
            ("Walker2D", tt.Walker2D(), False), ("Humanoid2D", tt.Humanoid2D(), False),
            ("Cheetah2D", tt.Cheetah2D(), False),
            ("PositionOnly(Walker2D)", tt.PositionOnly(tt.Walker2D()), False),
            ("DeceptiveValley(Hopper2D)", tt.DeceptiveValley(tt.Hopper2D()), False)]
    out = []
    for label, env, discrete in envs:
        kw = dict(population_size=64, sigma=0.05, table_size=1 << 22,
                  optimizer_kwargs={"learning_rate": 1e-2},
                  policy_kwargs={"action_dim": env.action_dim, "hidden": (64, 64),
                                 "discrete": discrete, "action_scale": 1.0})
        es_gpu = tt.ES(tt.MLPPolicy, tt.DeviceAgent(env, horizon=20), tt.sgd, **kw)
        es_cpu = tt.ES(tt.MLPPolicy, tt.DeviceAgent(env, horizon=20), tt.sgd, device="cpu", **kw)
        p0 = es_cpu.state.params_flat.clone()
        es_gpu.train(2, verbose=False)
        es_cpu.train(2, verbose=False)
        fit_err = max(abs(a["reward_mean"] - b["reward_mean"]) / max(abs(b["reward_mean"]), 1.0)
                      for a, b in zip(es_gpu.history, es_cpu.history))
        same_steps = all(a["env_steps"] == b["env_steps"]
                         for a, b in zip(es_gpu.history, es_cpu.history))
        dg, dc = es_gpu.state.params_flat.cpu() - p0, es_cpu.state.params_flat - p0
        cos = float(dg @ dc / (dg.norm() * dc.norm()))
        p_err = float((dg - dc).abs().max())
        rec = {"env": label, "reward_mean_rel_err": fit_err, "cosine": cos,
               "params_max_abs_err": p_err, "same_alive_steps": same_steps}
        print(f"card vs CPU, {label} (pop 64, horizon 20, 2 generations, SGD): reward_mean "
              f"err {fit_err:.3g} (tol 1e-4), param change cosine {cos:.7f} (tol 0.999), "
              f"params max |err| {p_err:.3g}, alive steps equal {same_steps}")
        if not (fit_err <= 1e-4 and cos >= 0.999):
            fail(f"card vs CPU, {label}: {rec}")
        out.append(rec)
        del es_gpu, es_cpu
    return out


def run_env_paths(torch, tt, nk, card: str) -> list[dict]:
    """Phase 7: each of ENV_PATHS at full width through ``ES(...).train``:
    the launch counts are set to 0 just before its 1 + timed generations,
    read just after and held exact; then one profiled generation, whose
    kernel launches over horizon x chunks give the launches an env step."""
    from estorch_tpu_torch import configs

    paths = []
    for label, build, timed, kernels in ENV_PATHS:
        torch.cuda.empty_cache()
        es = build(tt, configs)
        if es.device.type != "cuda":
            fail(f"path {label} ran on {es.device}")
        horizon = es.config.horizon
        p0 = es.state.params_flat.clone()
        torch.cuda.synchronize()
        nk.reset_launch_counts()
        es.train(1, verbose=False)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        es.train(timed, verbose=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(nk.launch_counts)
        gens = 1 + timed
        want = {"weighted_noise_sum": gens if kernels else 0,
                "population_noise_matvec": 3 * horizon * gens if kernels else 0}
        if counts != want:
            fail(f"path {label}: launch counts {counts}, expected {want}")
        if len(es.history) != gens:
            fail(f"path {label}: expected {gens} generations, got {len(es.history)}")
        for r in es.history:
            if r["n_failed"] or not all(math.isfinite(r[k])
                                        for k in ("reward_mean", "reward_max", "grad_norm")):
                fail(f"path {label}, generation {r['generation']}: non-finite result {r}")
        if torch.equal(p0, es.state.params_flat):
            fail(f"path {label}: params did not change")
        steps = sum(r["env_steps"] for r in es.history[1:])
        gen_s = dt / timed
        chunks = es.population_size // es.engine.eval_chunk
        print(f"path {label}: {steps / dt:.0f} env-steps/s (alive) over {timed} generations "
              f"({gen_s:.4f} s a generation) on {card}; launches {counts}; reward mean "
              f"{es.history[0]['reward_mean']:.2f} -> {es.history[-1]['reward_mean']:.2f}")
        busy, launched = profile_generation(torch, es, top=8)  # not part of the counts
        per_step = launched / (horizon * chunks)
        print(f"  {launched} kernel launches in the profiled generation = {per_step:.1f} an env "
              f"step ({horizon} steps x {chunks} chunks); busy share {busy / gen_s:.3f}")
        paths.append({"path": label, "launches": counts, "env_steps_per_s": steps / dt,
                      "s_per_generation": gen_s, "device_busy_s": busy,
                      "busy_share": busy / gen_s, "kernel_launches_per_env_step": per_step,
                      "population": es.population_size, "horizon": horizon, "chunks": chunks})
        del es
    return paths


def run_paths(torch, tt, nk, card: str) -> list[dict]:
    """Phase 5: each of PATHS at full width through ``ES(...).train``: the
    launch counts are set to 0 just before its 1 + 3 generations, read just
    after and held exact; then one profiled generation.  One record a path."""
    paths = []
    for label, opts, want_wns, want_pnm in PATHS:
        torch.cuda.empty_cache()
        es = tt.ES(tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON), tt.adam,
                   population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
                   optimizer_kwargs={"learning_rate": 1e-2}, **opts)
        p0 = es.state.params_flat.clone()
        torch.cuda.synchronize()
        nk.reset_launch_counts()
        es.train(1, verbose=False)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        es.train(GENERATIONS - 1, verbose=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(nk.launch_counts)
        want = {"weighted_noise_sum": want_wns, "population_noise_matvec": want_pnm}
        if counts != want:
            fail(f"path {label}: launch counts {counts}, expected {want}")
        if len(es.history) != GENERATIONS:
            fail(f"path {label}: expected {GENERATIONS} generations, got {len(es.history)}")
        for r in es.history:
            if r["n_failed"] or not all(math.isfinite(r[k])
                                        for k in ("reward_mean", "reward_max", "grad_norm")):
                fail(f"path {label}, generation {r['generation']}: non-finite result {r}")
        if torch.equal(p0, es.state.params_flat):
            fail(f"path {label}: params did not change")
        steps = sum(r["env_steps"] for r in es.history[1:])
        gen_s = dt / (GENERATIONS - 1)
        print(f"path {label}: {steps / dt:.0f} env-steps/s over {GENERATIONS - 1} generations "
              f"({gen_s:.4f} s a generation) on {card}; launches {counts}; reward mean "
              f"{es.history[0]['reward_mean']:.2f} -> {es.history[-1]['reward_mean']:.2f}")
        busy, _ = profile_generation(torch, es, top=8)  # after the counts: not part of them
        paths.append({"path": label, "options": opts, "launches": counts,
                      "env_steps_per_s": steps / dt, "s_per_generation": gen_s,
                      "device_busy_s": busy, "busy_share": busy / gen_s})
        del es
    return paths


def chunk_invariance(torch, tt) -> list[dict]:
    """Phase 6: ``eval_chunk=1024`` against the whole population, one
    generation of each path at full width, and the products alone: does a
    member's result depend on how many rows one product covers?"""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    for d, h in ((3, 64), (64, 64), (64, 1)):
        x = torch.randn(POPULATION, d, generator=g).to(dev)
        w = torch.randn(d, h, generator=g).to(dev)
        wb = torch.randn(POPULATION, d, h, generator=g).to(dev)
        mm = torch.equal((x @ w)[:1024], x[:1024] @ w)
        bmm = torch.equal(torch.bmm(x[:, None], wb)[:1024], torch.bmm(x[:1024, None], wb[:1024]))
        print(f"rows 0..1023 of ({d}, {h}) products, alone vs within {POPULATION}: "
              f"x @ W bit-identical {mm}, bmm bit-identical {bmm}")
    out = []
    for label, opts in [("streamed", STREAMED)] + [(p[0], p[1]) for p in PATHS]:
        kw = dict(population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
                  optimizer_kwargs={"learning_rate": 1e-2}, **opts)
        whole = tt.ES(tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON), tt.adam,
                      **kw)
        chunked = tt.ES(tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON),
                        tt.adam, eval_chunk=1024, **kw)
        new_w, mw = whole.engine.generation_step(whole.state)
        new_c, mc = chunked.engine.generation_step(chunked.state)
        fw, fc = mw["fitness"], mc["fitness"]
        rec = {"path": label, "bit_identical": bool(torch.equal(fw, fc)),
               "fitness_max_rel": float(((fc - fw).abs() / fw.abs()).max()),
               "same_ranks": bool(torch.equal(torch.argsort(fw, stable=True),
                                              torch.argsort(fc, stable=True))),
               "params_max_abs": float((new_c.params_flat - new_w.params_flat).abs().max())}
        print(f"eval_chunk 1024 vs whole, {label}: {rec}")
        out.append(rec)
        del whole, chunked
    return out


def time_pong_reduction(torch, nk, bw: float, f32: float, flush) -> dict:
    """Phase 2: the reduction at the pong84_conv recipe's update shape, 128
    pair rows of dim 1,685,987 from a 2^23-float table, checked against the
    plain version and timed warm, cold and plain.  The table (33.5 MB) fits
    in the 50 MB L2, so the bound counts the distinct bytes; the kernel
    reads every row whole, 128 x dim floats, mostly from L2."""
    from estorch_tpu_torch import NatureCNN
    from estorch_tpu_torch.ops.noise import make_noise_table, sample_pair_offsets
    from estorch_tpu_torch.ops.params import make_param_spec

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    dim = make_param_spec(NatureCNN(3).init_params((84, 84, 4), gen))[1].dim
    table = make_noise_table(PONG_TABLE, seed=0, device=dev).data
    offs = sample_pair_offsets(gen, PONG_PAIRS, PONG_TABLE, dim)
    w = (torch.rand(PONG_PAIRS, generator=gen) * 2 - 1).to(dev)
    offs_dev = offs.to(dev)
    got = nk.weighted_noise_sum(table, offs_dev, w, dim)
    torch.cuda.synchronize()
    want = nk.weighted_noise_sum_plain(table, offs_dev, w, dim)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
        fail(f"weighted_noise_sum pong84 n={PONG_PAIRS} dim={dim}: max |err| {err:g}")
    distinct = 4 * (union_floats(offs, dim) + 2 * PONG_PAIRS + dim)
    read = 4 * (PONG_PAIRS * dim + 2 * PONG_PAIRS + dim)
    flops = 2 * PONG_PAIRS * dim
    bound = max(distinct / bw, flops / f32) * 1e3

    def kernel():
        return nk.weighted_noise_sum(table, offs_dev, w, dim)

    ms, cold = time_ms(torch, kernel), time_cold_ms(torch, kernel, flush)
    plain_ms = time_ms(torch, lambda: nk.weighted_noise_sum_plain(table, offs_dev, w, dim), reps=5)
    print(f"weighted_noise_sum pong84_conv n={PONG_PAIRS} dim={dim}: max |err| {err:.3g} (tol "
          f"atol 1e-3, rtol 1e-4); warm {ms:.4f} ms, cold {cold:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({distinct / 1e6:.1f} MB distinct; the kernel reads "
          f"{read / 1e6:.1f} MB, {read / bw * 1e3:.4f} ms at the HBM rate)")
    del table
    return {"shape": f"pong84_conv: n={PONG_PAIRS}, dim={dim}, table 2^23", "ms": ms,
            "cold_ms": cold, "plain_ms": plain_ms, "bound_ms": bound, "max_abs_err": err,
            "bytes_distinct": distinct, "bytes_read": read}


def compare_pooled_card_cpu(torch, tt) -> list[dict]:
    """Phase 4, the pooled path: (1) pooled Pendulum, population 32, horizon
    60, two generations with SGD on the card and on the CPU from the same
    pools: reward means within 1e-4 relative, the update direction's cosine
    >= 0.999; (2) the NatureCNN population forward (VBN, population 4) on 20
    recorded pong84 observations, card against CPU with TF32 off: logits
    within 1e-4 of their scale."""
    import numpy as np

    from estorch_tpu_torch.envs.atari_wrappers import AtariPreprocessPool
    from estorch_tpu_torch.envs.native_pool import NativeEnvPool
    from estorch_tpu_torch.envs.rollout import population_forward
    from estorch_tpu_torch.models import capture_reference_stats
    from estorch_tpu_torch.ops.params import make_param_spec

    kw = dict(population_size=32, sigma=0.05, table_size=1 << 22, policy_kwargs=POLICY,
              optimizer_kwargs={"learning_rate": 1e-2})
    agent = tt.PooledAgent("pendulum", horizon=60)
    es_gpu = tt.ES(tt.MLPPolicy, agent, tt.sgd, **kw)
    es_cpu = tt.ES(tt.MLPPolicy, agent, tt.sgd, device="cpu", **kw)
    p0 = es_cpu.state.params_flat.clone()
    es_gpu.train(2, verbose=False)
    es_cpu.train(2, verbose=False)
    fit_err = max(abs(a["reward_mean"] - b["reward_mean"]) / abs(b["reward_mean"])
                  for a, b in zip(es_gpu.history, es_cpu.history))
    dg, dc = es_gpu.state.params_flat.cpu() - p0, es_cpu.state.params_flat - p0
    cos = float(dg @ dc / (dg.norm() * dc.norm()))
    print(f"card vs CPU, pooled pendulum (pop 32, horizon 60, 2 generations, SGD): reward_mean "
          f"rel err {fit_err:.3g} (tol 1e-4), update cosine {cos:.7f} (tol 0.999)")
    if not (fit_err <= 1e-4 and cos >= 0.999):
        fail(f"card vs CPU, pooled pendulum: rel err {fit_err:g}, cosine {cos:g}")
    es_gpu.engine.close()
    es_cpu.engine.close()

    dev = tt.resolve_device("cuda")  # TF32 off
    pool = AtariPreprocessPool(NativeEnvPool("pong84", 4, seed=0), frame_stack=4,
                               action_repeat=2, sticky_prob=0.25, seed=0)
    rng = np.random.default_rng(0)
    frames = [pool.reset()]
    for _ in range(19):
        frames.append(pool.step(rng.integers(0, 3, (4, 1)).astype(np.float32))[0])
    pool.close()
    gen = torch.Generator().manual_seed(0)
    module = tt.NatureCNN(3)
    params = module.init_params((84, 84, 4), gen)
    flat, spec = make_param_spec(params)
    ref = torch.from_numpy(np.concatenate(frames[:8]).reshape(-1, 84, 84, 4))
    stats = capture_reference_stats(module, params, ref)
    thetas = flat + 0.02 * torch.randn((4, spec.dim), generator=gen)
    module.vbn_stats = stats
    fwd = population_forward(module, spec.unravel(thetas))
    want = torch.stack([fwd(torch.from_numpy(f)) for f in frames])
    module.vbn_stats = {k: {n: v.to(dev) for n, v in d.items()} for k, d in stats.items()}
    fwd = population_forward(module, spec.unravel(thetas.to(dev)))
    got = torch.stack([fwd(torch.from_numpy(f).to(dev)) for f in frames]).cpu()
    err = float((got - want).abs().max() / want.abs().max())
    print(f"card vs CPU, NatureCNN+VBN population forward (pop 4, 20 pong84 observations): "
          f"max |err| / max |logit| {err:.3g} (tol 1e-4)")
    if err > 1e-4:
        fail(f"card vs CPU, NatureCNN forward: {err:g}")
    convs = time_conv_forms(torch, tt, gen, dev)
    return [{"check": "pooled pendulum", "reward_mean_rel_err": fit_err, "cosine": cos},
            {"check": "naturecnn forward", "rel_err": err}, convs]


def time_conv_forms(torch, tt, gen, dev) -> dict:
    """The three convolutions of 256 members on one pong84 observation each,
    two ways on the same laid-out weights: the port's patch copy +
    ``torch.bmm`` (``NatureCNN.population_apply``) and one grouped
    ``F.conv2d`` (``groups`` = members).  Checked against each other, then
    timed (device time, ``time_ms``) and their kernel launches counted."""
    import torch.nn.functional as F

    from estorch_tpu_torch.ops.params import make_param_spec

    module = tt.NatureCNN(3, use_vbn=False)
    params = module.init_params((84, 84, 4), gen)
    flat, spec = make_param_spec(params)
    p = 256
    thetas = (flat + 0.02 * torch.randn((p, spec.dim), generator=gen)).to(dev)
    layout = module.population_layout(spec.unravel(thetas))
    obs = (torch.rand((p, 1, 84, 84, 4), generator=gen) < 0.05).float().to(dev)
    layers = []
    for i, (feat, k, stride) in enumerate(((32, 8, 4), (64, 4, 2), (64, 3, 1))):
        w, b = layout[f"conv_{i}"]
        layers.append((w.view(p * feat, -1, k, k), b.reshape(-1), stride))

    def grouped():
        x = obs[:, 0].permute(0, 3, 1, 2).reshape(1, p * 4, 84, 84)
        for w, b, stride in layers:
            x = F.relu(F.conv2d(x, w, b, stride=stride, groups=p))
        return x.view(p, 64, 7, 7)

    def port_forward():  # the port's whole forward: its convolutions, fc and head
        return module.population_apply(layout, obs)

    want = grouped().permute(0, 2, 3, 1).reshape(p, 1, -1)
    fc_w, fc_b = layout["fc"]
    head_w, head_b = layout["head"]
    via_grouped = torch.bmm(F.relu(torch.bmm(want, fc_w) + fc_b), head_w) + head_b
    got = port_forward()
    err = float((got - via_grouped).abs().max() / via_grouped.abs().max())
    if err > 1e-4:
        fail(f"NatureCNN convolutions, patch copy + bmm against grouped conv2d: {err:g}")
    ms_bmm = time_ms(torch, port_forward, reps=10)
    ms_grouped = time_ms(torch, grouped, reps=3)
    n_bmm, n_grouped = count_launches(torch, port_forward), count_launches(torch, grouped)
    print(f"NatureCNN, 256 members, one observation each: the port's forward (patch copy + "
          f"bmm convolutions, fc and head) {ms_bmm:.3f} ms in {n_bmm} kernel launches; the "
          f"convolutions alone as one grouped F.conv2d {ms_grouped:.3f} ms in {n_grouped} "
          f"launches; logits agree to {err:.3g}")
    return {"check": "conv forms, 256 members", "forward_bmm_ms": ms_bmm,
            "forward_bmm_launches": n_bmm, "convs_grouped_conv2d_ms": ms_grouped,
            "convs_grouped_conv2d_launches": n_grouped, "rel_err": err}


def count_launches(torch, fn) -> int:
    """Kernel launches (copies and fills not counted) of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA")
               and not e.name().startswith(("Memcpy", "Memset")))


class TimedPool:
    """A pool whose ``step`` adds its host-clock seconds to ``seconds``."""

    def __init__(self, pool):
        self.pool = pool
        self.seconds = 0.0

    def __getattr__(self, name):
        return getattr(self.pool, name)

    def step(self, actions):
        t0 = time.perf_counter()
        out = self.pool.step(actions)
        self.seconds += time.perf_counter() - t0
        return out


def pong_step_shares(torch, es) -> dict:
    """Phase 8 (l): one generation's env steps with its four parts timed
    apart on the host clock: the C++ pool step (the raw steps of the action
    repeat), the NumPy frame stack (the rest of the Atari wrapper's step),
    the host-to-device copy of the observation batch (synchronized), and
    the forward with the actions' copy back.  A pool of its own, seeded
    apart from the training pools, and this generation's members."""
    from estorch_tpu_torch.envs.atari_wrappers import AtariPreprocessPool
    from estorch_tpu_torch.envs.native_pool import NativeEnvPool
    from estorch_tpu_torch.envs.rollout import population_forward

    eng = es.engine
    dev = es.device
    fwd = population_forward(es.module, eng.materialize(es.state, eng.all_pair_offsets(es.state)))
    raw = TimedPool(NativeEnvPool("pong84", es.population_size, seed=es.seed + 7))
    pool = AtariPreprocessPool(raw, seed=es.seed + 7, **es.agent.prep)
    obs = pool.reset()
    parts = {"pool_step": 0.0, "frame_stack": 0.0, "h2d_copy": 0.0, "forward_and_actions": 0.0}
    torch.cuda.synchronize()
    for _ in range(es.config.horizon):
        t0 = time.perf_counter()
        x = torch.from_numpy(obs).to(dev, non_blocking=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        acts = torch.argmax(fwd(x), dim=-1).to(torch.float32).cpu().numpy()
        t2 = time.perf_counter()
        before = raw.seconds
        obs, _, _ = pool.step(acts)
        t3 = time.perf_counter()
        cpp = raw.seconds - before
        parts["h2d_copy"] += t1 - t0
        parts["forward_and_actions"] += t2 - t1
        parts["pool_step"] += cpp
        parts["frame_stack"] += t3 - t2 - cpp
    pool.close()
    total = sum(parts.values())
    print(f"  (l) one generation's {es.config.horizon} env steps timed apart: {total:.3f} s; "
          + ", ".join(f"{k} {v:.3f} s ({v / total:.3f})" for k, v in parts.items())
          + f"; observation batch {obs.nbytes / 1e6:.1f} MB")
    return {"seconds": parts, "total_s": total, "obs_batch_mb": obs.nbytes / 1e6}


def run_pooled_paths(torch, tt, nk, card: str) -> list[dict]:
    """Phase 8: each of POOLED_PATHS through ``ES(...).train``: the launch
    counts are set to 0 just before its 1 + timed generations, read just
    after and held exact; then one profiled generation (device busy counts
    the copies too), whose launches over the horizon give the launches an
    env step; for (l) the step's parts timed apart."""
    from estorch_tpu_torch import configs

    paths = []
    for label, build, timed, wns_per_gen in POOLED_PATHS:
        torch.cuda.empty_cache()
        es = build(tt, configs)
        if es.device.type != "cuda" or es.backend != "pooled":
            fail(f"path {label} ran on {es.device}, backend {es.backend}")
        if not es.engine.pool.is_native:
            fail(f"path {label}: the pool is not the C++ envpool")
        horizon = es.config.horizon
        p0 = es.state.params_flat.clone()
        torch.cuda.synchronize()
        nk.reset_launch_counts()
        es.train(1, verbose=False)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        es.train(timed, verbose=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(nk.launch_counts)
        gens = 1 + timed
        want = {"weighted_noise_sum": wns_per_gen * gens, "population_noise_matvec": 0}
        if counts != want:
            fail(f"path {label}: launch counts {counts}, expected {want}")
        if len(es.history) != gens:
            fail(f"path {label}: expected {gens} generations, got {len(es.history)}")
        for r in es.history:
            if r["n_failed"] or not all(math.isfinite(r[k])
                                        for k in ("reward_mean", "reward_max", "grad_norm")):
                fail(f"path {label}, generation {r['generation']}: non-finite result {r}")
        if torch.equal(p0, es.state.params_flat):
            fail(f"path {label}: params did not change")
        steps = sum(r["env_steps"] for r in es.history[1:])
        gen_s = dt / timed
        print(f"path {label}: {steps / dt:.0f} env-steps/s (alive) over {timed} generations "
              f"({gen_s:.4f} s a generation) on {card}; launches {counts}; reward mean "
              f"{es.history[0]['reward_mean']:.2f} -> {es.history[-1]['reward_mean']:.2f}")
        busy, launched = profile_generation(torch, es, top=8)  # not part of the counts
        per_step = launched / horizon
        print(f"  {launched} kernel launches in the profiled generation = {per_step:.1f} an env "
              f"step ({horizon} steps); busy share {busy / gen_s:.3f}")
        rec = {"path": label, "launches": counts, "env_steps_per_s": steps / dt,
               "s_per_generation": gen_s, "device_busy_s": busy, "busy_share": busy / gen_s,
               "kernel_launches_per_env_step": per_step, "population": es.population_size,
               "horizon": horizon, "param_dim": es.spec.dim}
        if label.startswith("l"):
            rec["step_parts"] = pong_step_shares(torch, es)
        paths.append(rec)
        es.engine.close()
        del es
    return paths

class PendulumRolloutAgent:
    """A reference-style ``rollout(policy)`` agent: one Pendulum episode of
    ``horizon`` steps in the port's NumPy pool, the policy's output times 2
    as the torque.  Observations go to the policy's device and actions come
    back with ``.cpu()``, as the reference contract asks of a card run."""

    def __init__(self, horizon: int = HOST_HORIZON):
        from estorch_tpu_torch.envs.native_pool import NumpyEnvPool

        self.pool = NumpyEnvPool("pendulum", 1)
        self.horizon = horizon

    def rollout(self, policy):
        import torch

        device = next(policy.parameters()).device
        obs = self.pool.reset()
        total = 0.0
        with torch.no_grad():
            for _ in range(self.horizon):
                action = 2.0 * policy(torch.from_numpy(obs).to(device))
                obs, reward, _ = self.pool.step(action.cpu().numpy())
                total += float(reward[0])
        self.last_episode_steps = self.horizon
        return total


def host_es(tt, device=None, horizon: int = HOST_HORIZON, **over):
    """The (m) configuration through ``ES(...)``, its VBN frozen from 128
    random-action Pendulum observations (the same batch on every device)."""
    import numpy as np
    import torch

    from estorch_tpu_torch import configs
    from estorch_tpu_torch.envs.native_pool import NumpyEnvPool

    kw = dict(HOST_RECIPE, **over)
    es = tt.ES(configs._torch_mlp(3, 1, hidden=(64, 64), vbn=True), PendulumRolloutAgent,
               torch.optim.Adam, device=device, agent_kwargs={"horizon": horizon}, **kw)
    pool, rng = NumpyEnvPool("pendulum", 1, seed=0), np.random.default_rng(0)
    frames = [pool.reset()]
    for _ in range(127):
        frames.append(pool.step(rng.uniform(-2, 2, (1, 1)).astype(np.float32))[0])
    es.engine.freeze_vbn(np.concatenate(frames))
    return es


def time_host_reduction(torch, nk, bw: float, f32: float) -> dict:
    """Phase 2: the reduction at the host path's update shape (m): 500 pair
    rows of dim 4737 from the host path's NumPy-built 2^25-float table, at
    the SeedSequence offsets of generation 0, checked against the plain
    version and timed warm and plain."""
    import numpy as np

    dev = torch.device("cuda")
    table = torch.from_numpy(
        np.random.default_rng(0).standard_normal(TABLE_SIZE, dtype=np.float32)).to(dev)
    rng = np.random.default_rng(np.random.SeedSequence(entropy=0, spawn_key=(0,)))
    offs = rng.integers(0, TABLE_SIZE - HOST_DIM + 1, size=HOST_PAIRS, dtype=np.int64)
    offs_dev = torch.from_numpy(offs.astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.uniform(-1, 1, HOST_PAIRS).astype(np.float32)).to(dev)
    got = nk.weighted_noise_sum(table, offs_dev, w, HOST_DIM)
    torch.cuda.synchronize()
    want = nk.weighted_noise_sum_plain(table, offs_dev, w, HOST_DIM)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
        fail(f"weighted_noise_sum host n={HOST_PAIRS} dim={HOST_DIM}: max |err| {err:g}")
    nbytes = 4 * (union_floats(offs, HOST_DIM) + 2 * HOST_PAIRS + HOST_DIM)
    flops = 2 * HOST_PAIRS * HOST_DIM
    bound = max(nbytes / bw, flops / f32) * 1e3
    ms = time_ms(torch, lambda: nk.weighted_noise_sum(table, offs_dev, w, HOST_DIM))
    plain_ms = time_ms(torch, lambda: nk.weighted_noise_sum_plain(table, offs_dev, w, HOST_DIM))
    print(f"weighted_noise_sum host (m) n={HOST_PAIRS} dim={HOST_DIM}: max |err| {err:.3g} (tol "
          f"atol 1e-3, rtol 1e-4); warm {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB distinct)")
    del table
    return {"shape": f"host (m): n={HOST_PAIRS}, dim={HOST_DIM}, table 2^25 (NumPy)", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "max_abs_err": err}


def compare_host_card_cpu(torch, tt) -> list[dict]:
    """Phase 4, the host path: the (m) policy with VBN at population 32,
    horizon 60, two generations with Adam, on the card and on the CPU: the
    returns within 1e-4 relative, the update's cosine >= 0.999 (the card's
    matmuls and the reduction round otherwise than the CPU's).  Then one
    generation in process mode (4 forked workers) after CUDA is up, against
    the CPU's thread workers: fitness within 1e-5 relative (both roll out on
    the CPU; the forked children never touch CUDA)."""
    import numpy as np

    small = dict(population_size=32, table_size=1 << 22, horizon=60)
    es_gpu, es_cpu = host_es(tt, **small), host_es(tt, device="cpu", **small)
    if es_gpu.device.type != "cuda" or es_gpu.engine.table.device.type != "cuda":
        fail(f"host path ran on {es_gpu.device}")
    p0 = es_cpu.state.params_flat.clone()
    es_gpu.train(2, n_proc=4, verbose=False)
    es_cpu.train(2, n_proc=4, verbose=False)
    fit_err = max(abs(a["reward_mean"] - b["reward_mean"]) / abs(b["reward_mean"])
                  for a, b in zip(es_gpu.history, es_cpu.history))
    dg, dc = es_gpu.state.params_flat.cpu() - p0, es_cpu.state.params_flat - p0
    cos = float(dg @ dc / (dg.norm() * dc.norm()))
    print(f"card vs CPU, host path (VBN 64x64, pop 32, horizon 60, 2 generations, Adam, 4 "
          f"threads): reward_mean rel err {fit_err:.3g} (tol 1e-4), update cosine {cos:.7f} "
          f"(tol 0.999)")
    if not (fit_err <= 1e-4 and cos >= 0.999):
        fail(f"card vs CPU, host path: rel err {fit_err:g}, cosine {cos:g}")
    es_gpu.engine.close()
    es_cpu.engine.close()

    es_proc = host_es(tt, worker_mode="process", **small)
    es_thr = host_es(tt, device="cpu", **small)
    try:
        es_proc.engine.set_n_proc(4)
        es_thr.engine.set_n_proc(4)
        got = es_proc.engine.evaluate(es_proc.state).fitness
        want = es_thr.engine.evaluate(es_thr.state).fitness
    finally:
        es_proc.engine.close()
        es_thr.engine.close()
    proc_err = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"process mode on the card's ES (4 forked workers, CUDA initialized) vs CPU threads: "
          f"fitness rel err {proc_err:.3g} (tol 1e-5)")
    if not np.all(np.isfinite(got)) or proc_err > 1e-5:
        fail(f"process mode after CUDA init: fitness rel err {proc_err:g}, {got}")
    return [{"check": "host path", "reward_mean_rel_err": fit_err, "cosine": cos},
            {"check": "host process mode after CUDA init", "fitness_rel_err": proc_err}]


def run_host_path(torch, tt, nk, card: str) -> dict:
    """Phase 9, (m) host/pendulum/vbn64x64 at horizon ``HOST_HORIZON``:
    ``HOST_WORKERS`` forked workers (rollouts on the CPU, the table, center
    and update on the card), 1 warm-up and ``HOST_TIMED`` timed generations,
    the reduction's launches counted around that run (1 a generation), and
    the same run with device="cpu".  Then the policies on the card: one
    generation with one worker on each device at the full horizon and
    population ``HOST_ONE_WORKER_POP`` (cut from 1000); the
    launches an env step over 4 members' rollouts; the device's busy share
    of one profiled generation at population 16 with ``HOST_WORKERS``
    threads, against the generation before it, unprofiled (a whole
    generation's events would take the profiler minutes); and, at horizon
    ``HOST_SIDE_HORIZON``, ``HOST_WORKERS`` threads against one worker on
    each device, for the threads' scaling."""
    from estorch_tpu_torch.host.engine import call_rollout, load_flat

    def timed_run(device, n_proc: int, timed: int, warm: int = 1,
                  **over) -> tuple[dict, object]:
        es = host_es(tt, device=device, **over)
        p0 = es.state.params_flat.clone()
        if device is None:
            torch.cuda.synchronize()
            nk.reset_launch_counts()
        if warm:
            es.train(warm, n_proc=n_proc, verbose=False)
        t0 = time.perf_counter()
        es.train(timed, n_proc=n_proc, verbose=False)
        if device is None:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for r in es.history:
            if r["n_failed"] or not all(math.isfinite(r[k])
                                        for k in ("reward_mean", "reward_max", "grad_norm")):
                fail(f"path (m) on {device or 'cuda'}, generation {r['generation']}: {r}")
        if torch.equal(p0.cpu(), es.state.params_flat.cpu()):
            fail(f"path (m) on {device or 'cuda'}: params did not change")
        steps = sum(r["env_steps"] for r in es.history[warm:])
        return {"env_steps_per_s": steps / dt, "s_per_generation": dt / timed,
                "reward_mean": [r["reward_mean"] for r in es.history]}, es

    def report(what: str, rec: dict) -> None:
        print(f"  {what}: {rec['env_steps_per_s']:.0f} env-steps/s "
              f"({rec['s_per_generation']:.3f} s a generation)")

    label = "m host/pendulum/vbn64x64"
    rec, es = timed_run(None, HOST_WORKERS, HOST_TIMED, worker_mode="process")
    counts = dict(nk.launch_counts)
    want = {"weighted_noise_sum": 1 + HOST_TIMED, "population_noise_matvec": 0}
    if counts != want:
        fail(f"path {label}: launch counts {counts}, expected {want}")
    es.engine.close()
    print(f"path {label}, horizon {HOST_HORIZON}: {rec['env_steps_per_s']:.0f} env-steps/s over "
          f"{HOST_TIMED} generations ({rec['s_per_generation']:.3f} s a generation), "
          f"{HOST_WORKERS} forked CPU workers, the update on {card}; launches {counts}; reward "
          f"mean {rec['reward_mean'][0]:.2f} -> {rec['reward_mean'][-1]:.2f}")
    cpu, es_cpu = timed_run("cpu", HOST_WORKERS, 1, worker_mode="process")
    es_cpu.engine.close()
    report(f"the same with device=\"cpu\", 1 timed generation", cpu)

    # the policies on the card, at the full horizon
    single = {}
    for device in (None, "cpu"):
        one, es_one = timed_run(device, 1, 1, warm=0, population_size=HOST_ONE_WORKER_POP)
        if device is None:
            policy, agent = es_one.engine._workers[0]
            state = es_one.state

            def four_members():
                for i in range(4):
                    load_flat(policy, es_one.engine.member_params(state, i))
                    call_rollout(agent, policy)

            per_step = count_launches(torch, four_members) / (4 * HOST_HORIZON)
        es_one.engine.close()
        single[device or "cuda"] = one
        report(f"one worker, policies on {device or 'cuda'}, 1 generation at population "
               f"{HOST_ONE_WORKER_POP} (cut from {HOST_POPULATION})", one)
    small = host_es(tt, population_size=16)
    small.train(1, n_proc=HOST_WORKERS, verbose=False)
    wall = small.history[-1]["wall_time_s"]
    busy, launched = profile_generation(torch, small, top=8, n_proc=HOST_WORKERS)
    small.engine.close()
    print(f"  {per_step:.2f} kernel launches an env step (4 members' rollouts); population 16, "
          f"{HOST_WORKERS} threads, profiled: {launched} launches, busy {busy:.4f} s against "
          f"{wall:.3f} s for the unprofiled generation before it ({busy / wall:.3f})")

    # the thread workers, a side reading at horizon HOST_SIDE_HORIZON
    side = {}
    for device in (None, "cpu"):
        for n_proc in (HOST_WORKERS, 1):
            got, es_side = timed_run(device, n_proc, 1, warm=0, horizon=HOST_SIDE_HORIZON)
            es_side.engine.close()
            side[f"{device or 'cuda'}_{n_proc}"] = got
            report(f"horizon {HOST_SIDE_HORIZON}, {n_proc} thread worker(s) on "
                   f"{device or 'cuda'}, 1 generation", got)
    return {"path": label, "launches": counts, **rec, "kernel_launches_per_env_step": per_step,
            "busy_share_pop16": busy / wall, "device_busy_s_pop16": busy,
            "population": HOST_POPULATION, "horizon": HOST_HORIZON,
            "workers": HOST_WORKERS, "worker_mode": "process", "param_dim": HOST_DIM,
            "cpu": cpu, "one_worker": {"population": HOST_ONE_WORKER_POP, **single},
            "threads_side_reading": {"horizon": HOST_SIDE_HORIZON, **side}}


def time_recurrent_reduction(torch, nk, table, bw: float, f32: float, flush) -> dict:
    """Phase 2: the reduction at the recurrent paths' update shape (n), (r):
    2048 pair rows of dim 25,153 (RecurrentPolicy's defaults on Pendulum)
    from the cell's 2^25-float table, checked against the plain version and
    timed warm, cold and plain; the bound counts this run's distinct
    bytes."""
    from estorch_tpu_torch import Pendulum, RecurrentPolicy
    from estorch_tpu_torch.ops.noise import sample_pair_offsets
    from estorch_tpu_torch.ops.params import make_param_spec

    dev = table.device
    gen = torch.Generator().manual_seed(11)
    dim = make_param_spec(RecurrentPolicy(**REC_POLICY).init_params(Pendulum().obs_dim, gen))[1].dim
    offs = sample_pair_offsets(gen, REC_PAIRS, TABLE_SIZE, dim)
    w = (torch.rand(REC_PAIRS, generator=gen) * 2 - 1).to(dev)
    offs_dev = offs.to(dev)
    got = nk.weighted_noise_sum(table, offs_dev, w, dim)
    torch.cuda.synchronize()
    want = nk.weighted_noise_sum_plain(table, offs_dev, w, dim)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
        fail(f"weighted_noise_sum recurrent n={REC_PAIRS} dim={dim}: max |err| {err:g}")
    nbytes = 4 * (union_floats(offs, dim) + 2 * REC_PAIRS + dim)
    flops = 2 * REC_PAIRS * dim
    bound = max(nbytes / bw, flops / f32) * 1e3

    def kernel():
        return nk.weighted_noise_sum(table, offs_dev, w, dim)

    ms, cold = time_ms(torch, kernel), time_cold_ms(torch, kernel, flush)
    plain_ms = time_ms(torch, lambda: nk.weighted_noise_sum_plain(table, offs_dev, w, dim))
    print(f"weighted_noise_sum recurrent (n), (r) n={REC_PAIRS} dim={dim}: max |err| {err:.3g} "
          f"(tol atol 1e-3, rtol 1e-4); warm {ms:.4f} ms ({bound / ms:.0%} of bound), cold "
          f"{cold:.4f} ms ({bound / cold:.0%}), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
          f"({nbytes / 1e6:.1f} MB distinct)")
    return {"shape": f"recurrent (n), (r): n={REC_PAIRS}, dim={dim}, table 2^25", "ms": ms,
            "cold_ms": cold, "plain_ms": plain_ms, "bound_ms": bound, "max_abs_err": err,
            "bound_by": "bytes" if nbytes / bw >= flops / f32 else "operations",
            "library_ms": None}


def compare_recurrent_card_cpu(torch, tt) -> list[dict]:
    """Phase 4, the recurrent paths at a small size, card against CPU: (n)
    GRU 64 with the kernel update, (p) stacked LSTM 64 with a learned carry
    in bf16, (q) MLP 64x64 with VBN from 128 reference steps, each on
    Pendulum at population 64, horizon 50, two generations; (r) GRU 64 on
    pooled Pendulum at population 32, horizon 60.  float32: reward means
    within 1e-4 relative, params within 1e-4 (Adam); bf16 and pooled: SGD,
    reward means within 1e-3 (bf16) or 1e-4 relative, the param changes'
    cosine >= 0.99 (bf16) or 0.999."""
    cases = [
        ("n gru64+nk", tt.RecurrentPolicy, REC_POLICY, {"noise_kernel": True}, "device"),
        ("p lstm64x2+learned/bf16+nk", tt.RecurrentPolicy,
         dict(REC_POLICY, cell="lstm", n_layers=2, learned_carry=True),
         {"noise_kernel": True, "compute_dtype": "bfloat16"}, "device"),
        ("q mlp64x64+vbn+nk", tt.MLPPolicy, dict(POLICY, use_vbn=True), {"noise_kernel": True},
         "device"),
        ("r pooled gru64+nk", tt.RecurrentPolicy, REC_POLICY, {"noise_kernel": True}, "pooled"),
    ]
    out = []
    for label, policy, pk, opts, backend in cases:
        bf16 = opts.get("compute_dtype") == "bfloat16"
        pooled = backend == "pooled"
        kw = dict(population_size=32 if pooled else 64, sigma=0.05, table_size=1 << 22,
                  policy_kwargs=pk, optimizer_kwargs={"learning_rate": 1e-2}, **opts)
        optimizer = tt.sgd if bf16 or pooled else tt.adam
        if pooled:
            agent = tt.PooledAgent("pendulum", horizon=60)
        else:
            agent = tt.DeviceAgent(tt.Pendulum(), horizon=50)
        es_gpu = tt.ES(policy, agent, optimizer, **kw)
        es_cpu = tt.ES(policy, agent, optimizer, device="cpu", **kw)
        if es_gpu.device.type != "cuda":
            fail(f"card vs CPU, {label}: ran on {es_gpu.device}")
        p0 = es_cpu.state.params_flat.clone()
        es_gpu.train(2, verbose=False)
        es_cpu.train(2, verbose=False)
        fit_err = max(abs(a["reward_mean"] - b["reward_mean"]) / abs(b["reward_mean"])
                      for a, b in zip(es_gpu.history, es_cpu.history))
        dg, dc = es_gpu.state.params_flat.cpu() - p0, es_cpu.state.params_flat - p0
        cos = float(dg @ dc / (dg.norm() * dc.norm()))
        p_err = float((dg - dc).abs().max())
        rec = {"check": f"recurrent {label}", "reward_mean_rel_err": fit_err, "cosine": cos,
               "params_max_abs_err": p_err}
        print(f"card vs CPU, {label}: reward_mean rel err {fit_err:.3g}, update cosine "
              f"{cos:.7f}, params max |err| {p_err:.3g}")
        if bf16:
            ok = fit_err <= 1e-3 and cos >= 0.99
        elif pooled:
            ok = fit_err <= 1e-4 and cos >= 0.999
        else:
            ok = fit_err <= 1e-4 and p_err <= 1e-4
        if not ok:
            fail(f"card vs CPU, {label}: {rec}")
        if pooled:
            es_gpu.engine.close()
            es_cpu.engine.close()
        out.append(rec)
    return out


def run_recurrent_paths(torch, tt, nk, card: str) -> tuple[list[dict], dict]:
    """Phase 10: each of REC_PATHS through ``ES(...).train``: the launch
    counts set to 0 just before its 1 + REC_TIMED generations, read just
    after and held exact (the reduction's launches a generation; no
    matvec); then one profiled generation (busy share, kernel launches an
    env step).  Then the memory check: the JAX package's RecallEnv recipe
    (GRU 8, pop 256, 80 generations, horizon 16) at seeds 0, 1 and 2,
    ``evaluate_policy(64, seed=9)`` each; it holds when the mean is above
    8.0 at two of the three (ES on this task can settle on one sign of the
    signal, a mean near 6: tests/test_torch_recurrent.py's slow memory
    test shows it on the CPU)."""
    from estorch_tpu_torch import configs

    paths = []
    for label, build, wns_per_gen, cuts in REC_PATHS:
        torch.cuda.empty_cache()
        es = build(tt, configs)
        if es.device.type != "cuda":
            fail(f"path {label} ran on {es.device}")
        horizon = es.config.horizon
        p0 = es.state.params_flat.clone()
        torch.cuda.synchronize()
        nk.reset_launch_counts()
        es.train(1, verbose=False)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        es.train(REC_TIMED, verbose=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(nk.launch_counts)
        gens = 1 + REC_TIMED
        want = {"weighted_noise_sum": wns_per_gen * gens, "population_noise_matvec": 0}
        if counts != want:
            fail(f"path {label}: launch counts {counts}, expected {want}")
        if len(es.history) != gens:
            fail(f"path {label}: expected {gens} generations, got {len(es.history)}")
        for r in es.history:
            if r["n_failed"] or not all(math.isfinite(r[k])
                                        for k in ("reward_mean", "reward_max", "grad_norm")):
                fail(f"path {label}, generation {r['generation']}: non-finite result {r}")
        if torch.equal(p0, es.state.params_flat):
            fail(f"path {label}: params did not change")
        steps = sum(r["env_steps"] for r in es.history[1:])
        gen_s = dt / REC_TIMED
        chunks = 1 if es.backend == "pooled" else es.population_size // es.engine.eval_chunk
        print(f"path {label} (dim {es.spec.dim}, pop {es.population_size}, horizon {horizon}; "
              f"cut: {cuts}): {steps / dt:.0f} env-steps/s (alive) ({gen_s:.4f} s a "
              f"generation) on {card}; launches {counts}; reward mean "
              f"{es.history[0]['reward_mean']:.2f} -> {es.history[-1]['reward_mean']:.2f}")
        busy, launched = profile_generation(torch, es, top=8)  # not part of the counts
        per_step = launched / (horizon * chunks)
        print(f"  {launched} kernel launches in the profiled generation = {per_step:.1f} an env "
              f"step; busy share {busy / gen_s:.3f}")
        paths.append({"path": label, "launches": counts, "env_steps_per_s": steps / dt,
                      "s_per_generation": gen_s, "device_busy_s": busy,
                      "busy_share": busy / gen_s, "kernel_launches_per_env_step": per_step,
                      "population": es.population_size, "horizon": horizon,
                      "param_dim": es.spec.dim, "cuts": cuts})
        if es.backend == "pooled":
            es.engine.close()
        del es

    means = []
    for seed in MEMORY_SEEDS:
        t0 = time.perf_counter()
        es = tt.ES(tt.RecurrentPolicy, tt.DeviceAgent(tt.RecallEnv(), horizon=MEMORY_HORIZON),
                   tt.adam, seed=seed, **MEMORY_RECIPE)
        es.train(MEMORY_GENERATIONS, verbose=False)
        ev = es.evaluate_policy(64, seed=9)
        means.append(ev["mean"])
        print(f"memory check, RecallEnv GRU 8 pop 256, {MEMORY_GENERATIONS} generations, seed "
              f"{seed}: evaluate_policy(64, seed=9) mean {ev['mean']:.3f} (min {ev['min']:.3f}, "
              f"max {ev['max']:.3f}) in {time.perf_counter() - t0:.1f} s")
    passed = sum(m > 8.0 for m in means)
    if passed < 2:
        fail(f"memory check: means {means}, above 8.0 at {passed} of {len(means)} seeds")
    memory = {"check": "RecallEnv memory, GRU 8, pop 256, 80 generations",
              "seeds": list(MEMORY_SEEDS), "means": means, "above_8": passed}
    return paths, memory


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
    from estorch_tpu_torch import (ES, CartPole, Cheetah2D, DeviceAgent, MLPPolicy, Pendulum,
                                   SyntheticEnv, adam)
    from estorch_tpu_torch.ops import _build
    from estorch_tpu_torch.ops import noise_kernels as nk
    from estorch_tpu_torch.ops.noise import make_noise_table, member_offsets, sample_pair_offsets
    from estorch_tpu_torch.ops.params import make_param_spec

    # ---- 1. identity and build -------------------------------------------
    phase("1. identity and build")
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
    from estorch_tpu_torch.envs import native_pool
    t_build = time.perf_counter()
    try:
        envpool_lib = native_pool.build()
    except RuntimeError as e:
        fail(f"envpool build: {e}")
    for env_name in ("cartpole", "pendulum", "pong84"):
        pool = native_pool.NativeEnvPool(env_name, 4)
        if not pool.is_native or pool.reset().shape != (4, pool.obs_dim):
            fail(f"the {env_name} pool is not the C++ envpool")
        pool.close()
    print(f"envpool built in {time.perf_counter() - t_build:.2f} s -> {envpool_lib}; "
          "cartpole, pendulum and pong84 pools are native")
    dev = torch.device("cuda")

    # ---- 2. kernels against their plain versions --------------------------
    phase("2. kernels against their plain versions")
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
    # Tolerance: float32 dot products of d <= 256 terms in another order.
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def check_matvec(label, offs, c, x, lo, d, h) -> float:
        got = nk.population_noise_matvec(table, offs, c, x, lo, d, h)
        torch.cuda.synchronize()
        want = nk.population_noise_matvec_plain(table, offs, c, x, lo, d, h)
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            fail(f"population_noise_matvec {label} n={x.shape[0]} ({d}, {h}): max |err| {err:g}")
        return err

    def time_matvec(label, pair_offs, lo, d, h) -> dict:
        """Mirrored members of ``pair_offs`` at one layer: checked, then
        timed warm, cold and plain, beside the bound of this run's data."""
        n = 2 * pair_offs.shape[0]
        moffs = member_offsets(pair_offs).to(dev)
        c = (0.05 * torch.tensor([1.0, -1.0]).repeat(n // 2)).to(dev)
        x = torch.randn((n, d), generator=gen)
        x = (2 * x if d < 8 else torch.tanh(x)).to(dev)
        err = check_matvec(f"{label} mirrored", moffs, c, x, lo, d, h)
        nbytes = 4 * (union_floats(pair_offs + lo, d * h) + 2 * n + n * d + n * h)
        flops = 2 * n * d * h + n * h
        bound = max(nbytes / bw, flops / f32) * 1e3

        def kernel():
            return nk.population_noise_matvec(table, moffs, c, x, lo, d, h)

        ms, cold = time_ms(torch, kernel), time_cold_ms(torch, kernel, flush)
        plain_ms = time_ms(
            torch, lambda: nk.population_noise_matvec_plain(table, moffs, c, x, lo, d, h))
        # warm reads come from L2 and may beat the HBM bound: no share then
        share = ("warm, L2-resident" if ms < bound else f"warm {bound / ms:.0%} of bound")
        print(f"population_noise_matvec {label} n={n} ({d}, {h}): max |err| {err:.3g} "
              f"(tol atol 1e-4, rtol 1e-4); warm {ms:.4f} ms ({share}), cold {cold:.4f} ms "
              f"({bound / cold:.0%} of bound), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB distinct)")
        return {"layer": label, "n": n, "d": d, "h": h, "ms": ms, "cold_ms": cold,
                "plain_ms": plain_ms, "bound_ms": bound, "max_abs_err": err,
                "bytes": nbytes, "flops": flops}

    pair_offs = sample_pair_offsets(gen, n_pairs, TABLE_SIZE, dim)
    layers = [time_matvec(lname, pair_offs, layer_offs[lname]["kernel"], d, h)
              for lname, d, h in (("dense_0", 3, 64), ("dense_1", 64, 64), ("head", 64, 1))]
    # the same layers on other offset patterns: each member its own slice,
    # an odd population, and starts that need the clamp (negative, past the end)
    errs = [layer["max_abs_err"] for layer in layers]
    for lname, d, h in (("dense_0", 3, 64), ("dense_1", 64, 64), ("head", 64, 1)):
        lo = layer_offs[lname]["kernel"]
        x = torch.tanh(torch.randn((POPULATION, d), generator=gen)).to(dev)
        c = (0.05 * torch.randn(POPULATION, generator=gen)).to(dev)
        rand = sample_pair_offsets(gen, POPULATION, TABLE_SIZE, dim).to(dev)
        odd = member_offsets(pair_offs).to(dev)[:-1]
        # slice starts at and past the edges: counted from the end, clamped
        # to 0 or to size - d*h, or in range; a pair may draw two different
        # starts that clamp to the same slice
        length = d * h
        edges = torch.tensor([-7, -length, -TABLE_SIZE - 100, 0, 3, TABLE_SIZE - length,
                              TABLE_SIZE - length + 5, TABLE_SIZE + 99]) - lo
        wild = edges[torch.randint(0, len(edges), (POPULATION,), generator=gen)]
        wild = wild.to(torch.int32).to(dev)
        for label, offs in (("unmirrored", rand), ("odd n", odd), ("clamped", wild)):
            k = offs.shape[0]
            err = check_matvec(f"{lname} {label}", offs, c[:k], x[:k], lo, d, h)
            errs.append(err)
            print(f"population_noise_matvec {lname} {label} n={k} ({d}, {h}): max |err| "
                  f"{err:.3g} (tol atol 1e-4, rtol 1e-4)")
    pnm = {k: sum(layer[k] for layer in layers)
           for k in ("ms", "cold_ms", "plain_ms", "bound_ms", "bytes", "flops")}
    pnm["bound_by"] = "bytes" if pnm["bytes"] / bw >= pnm["flops"] / f32 else "operations"
    print(f"population_noise_matvec one env step: warm {pnm['ms']:.4f} ms, cold "
          f"{pnm['cold_ms']:.4f} ms ({pnm['bound_ms'] / pnm['cold_ms']:.0%} of the "
          f"{pnm['bound_ms']:.4f} ms bound); before the redesign {PREV_MATVEC_STEP_MS} ms "
          f"warm (an earlier run, not this one)")

    # off the main path, timed with no target: the BIG config's hidden layer,
    # whose distinct noise is nearly the whole table, and CartPole MLP64x64
    extra = [time_matvec("big dense_1", sample_pair_offsets(gen, n_pairs, TABLE_SIZE, 256 * 256),
                         0, 256, 256)]
    cp_params = MLPPolicy(action_dim=2, hidden=(64, 64), discrete=True).init_params(
        CartPole().obs_dim, gen)
    cp_offs = nk.flat_layer_offsets(cp_params)
    cp_pairs = sample_pair_offsets(gen, n_pairs, TABLE_SIZE, make_param_spec(cp_params)[1].dim)
    for lname, d, h in (("dense_0", 4, 64), ("dense_1", 64, 64), ("head", 64, 2)):
        extra.append(time_matvec(f"cartpole {lname}", cp_pairs, cp_offs[lname]["kernel"], d, h))
    # the shapes of phase 7's streamed paths: (g) Cheetah2D MLP 64x64 at
    # n = 1024, whose head (64, 6) takes the narrow mapping, and (i)
    # SyntheticEnv MLP 256x256 at n = 4096; and the reduction at their dims
    wns["other_shapes"] = []
    for plabel, env, hidden, pop in (("g cheetah", Cheetah2D(), (64, 64), 1024),
                                     ("i synthetic", SyntheticEnv(), (256, 256), POPULATION)):
        env_params = MLPPolicy(action_dim=env.action_dim, hidden=hidden, discrete=False
                               ).init_params(env.obs_dim, gen)
        env_offs = nk.flat_layer_offsets(env_params)
        env_dim = make_param_spec(env_params)[1].dim
        env_pairs = sample_pair_offsets(gen, pop // 2, TABLE_SIZE, env_dim)
        sizes = (env.obs_dim,) + hidden + (env.action_dim,)
        names = [f"dense_{i}" for i in range(len(hidden))] + ["head"]
        for lname, d, h in zip(names, sizes[:-1], sizes[1:]):
            extra.append(time_matvec(f"{plabel} {lname}", env_pairs,
                                     env_offs[lname]["kernel"], d, h))
        w = (torch.rand(pop // 2, generator=gen) * 2 - 1).to(dev)
        offs = env_pairs.to(dev)
        got = nk.weighted_noise_sum(table, offs, w, env_dim)
        torch.cuda.synchronize()
        want = nk.weighted_noise_sum_plain(table, offs, w, env_dim)
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
            fail(f"weighted_noise_sum {plabel} n={pop // 2} dim={env_dim}: max |err| {err:g}")
        ms = time_ms(torch, lambda: nk.weighted_noise_sum(table, offs, w, env_dim))
        plain_ms = time_ms(torch, lambda: nk.weighted_noise_sum_plain(table, offs, w, env_dim))
        nbytes = 4 * (union_floats(env_pairs, env_dim) + 2 * (pop // 2) + env_dim)
        bound = max(nbytes / bw, 2 * (pop // 2) * env_dim / f32) * 1e3
        print(f"weighted_noise_sum {plabel} n={pop // 2} dim={env_dim}: max |err| {err:.3g} "
              f"(tol atol 1e-3, rtol 1e-4); time {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB distinct)")
        wns["other_shapes"].append({"shape": f"{plabel}: n={pop // 2}, dim={env_dim}", "ms": ms,
                                    "plain_ms": plain_ms, "bound_ms": bound,
                                    "max_abs_err": err})
        wns["max_abs_err"] = max(wns["max_abs_err"], err)
    pnm["max_abs_err"] = max(errs + [e["max_abs_err"] for e in extra])
    pong_wns = time_pong_reduction(torch, nk, bw, f32, flush)
    wns["other_shapes"].append(pong_wns)
    wns["max_abs_err"] = max(wns["max_abs_err"], pong_wns["max_abs_err"])
    host_wns = time_host_reduction(torch, nk, bw, f32)
    wns["other_shapes"].append(host_wns)
    wns["max_abs_err"] = max(wns["max_abs_err"], host_wns["max_abs_err"])
    rec_wns = time_recurrent_reduction(torch, nk, table, bw, f32, flush)
    wns["other_shapes"].append(rec_wns)
    wns["max_abs_err"] = max(wns["max_abs_err"], rec_wns["max_abs_err"])
    del flush
    del table

    # ---- 3. the main path ---------------------------------------------------
    phase("3. the main path")
    es = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=HORIZON), adam,
            population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
            optimizer_kwargs={"learning_rate": 1e-2}, **STREAMED)
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
    if gens != GENERATIONS:
        fail(f"expected {GENERATIONS} generations, got {gens}")
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

    busy3, _ = profile_generation(torch, es)  # after the counts are read: not part of them
    del es

    # ---- 4. the card against the CPU's plain versions at a small size -----
    phase("4. card against CPU")
    compare_card_cpu(torch, estorch_tpu_torch)
    env_cmp = compare_envs_card_cpu(torch, estorch_tpu_torch)
    env_cmp += compare_pooled_card_cpu(torch, estorch_tpu_torch)
    env_cmp += compare_host_card_cpu(torch, estorch_tpu_torch)
    env_cmp += compare_recurrent_card_cpu(torch, estorch_tpu_torch)

    # ---- 5. the slice's other paths at full width ----------------------------
    phase("5. the other paths")
    paths = [{"path": "streamed (phase 3)", "options": STREAMED, "launches": launches,
              "env_steps_per_s": steps / dt, "s_per_generation": gen_s,
              "device_busy_s": busy3, "busy_share": busy3 / gen_s}]
    paths += run_paths(torch, estorch_tpu_torch, nk, card)

    # ---- 6. eval_chunk against the whole population ----------------------------
    phase("6. eval_chunk")
    chunking = chunk_invariance(torch, estorch_tpu_torch)

    # ---- 7. the env paths at full width ------------------------------------------
    phase("7. the env paths")
    paths += run_env_paths(torch, estorch_tpu_torch, nk, card)

    # ---- 8. the pooled paths ------------------------------------------------------
    phase("8. the pooled paths")
    pooled = run_pooled_paths(torch, estorch_tpu_torch, nk, card)
    paths += pooled

    # ---- 9. the host path at full width ---------------------------------------------
    phase("9. the host path")
    host = run_host_path(torch, estorch_tpu_torch, nk, card)
    paths.append(host)

    # ---- 10. recurrent policies and device-path VBN ----------------------------------
    phase("10. recurrent")
    recurrent, memory = run_recurrent_paths(torch, estorch_tpu_torch, nk, card)
    paths += recurrent
    env_cmp.append(memory)

    # ---- report --------------------------------------------------------------
    phase("report")
    kernels = [
        {"name": "weighted_noise_sum", "route": "cuda",
         "source": "estorch_tpu_torch/ops/csrc/noise_kernels.cu",
         "replaces": "estorch_tpu/ops/pallas_noise.py:90",
         "launches": launches["weighted_noise_sum"], "max_abs_err": wns["max_abs_err"],
         "ms": wns["ms"], "plain_ms": wns["plain_ms"], "bound_ms": wns["bound_ms"],
         "bound_by": wns["bound_by"], "library_ms": None,
         "shape": f"n={n_pairs} rows, dim={dim}", "other_shapes": wns["other_shapes"],
         "launches_pooled": {p["path"]: p["launches"]["weighted_noise_sum"] for p in pooled},
         "launches_host": {host["path"]: host["launches"]["weighted_noise_sum"]},
         "launches_recurrent": {p["path"]: p["launches"]["weighted_noise_sum"]
                                for p in recurrent}},
        {"name": "population_noise_matvec", "route": "cuda",
         "source": "estorch_tpu_torch/ops/csrc/noise_kernels.cu",
         "replaces": "estorch_tpu/ops/pallas_noise.py:201",
         "launches": launches["population_noise_matvec"], "max_abs_err": pnm["max_abs_err"],
         "ms": pnm["ms"], "cold_ms": pnm["cold_ms"], "plain_ms": pnm["plain_ms"], "bound_ms": pnm["bound_ms"],
         "bound_by": pnm["bound_by"], "library_ms": None,
         "shape": f"one env step: n={POPULATION} at (3,64)+(64,64)+(64,1)",
         "layers": [{k: layer[k] for k in ("layer", "n", "d", "h", "ms", "cold_ms",
                                           "plain_ms", "bound_ms")}
                    for layer in layers + extra]},
    ]
    print(json.dumps({"paths": paths, "eval_chunk": chunking, "card_vs_cpu_envs": env_cmp}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
