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
   defaults on Pendulum), warm and cold, and at the async fold's shape
   (1000 member rows of dim 4737 from 2 dispatches), warm;
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
   device path, (r) GRU 64 on pooled Pendulum; then the novelty family
   and IW-ES: (t) NSR-ES streamed + kernel update at population 64,
   horizon 20, 3 generations (meta indices equal, archive sum and params
   within 1e-5 relative), (v) IW-ES at population 64 with reuse forced by
   Adam 1e-5 (``reused_prev`` equal, params within 1e-5), and a host
   NS-ES on phase 9's ``rollout(policy)`` Pendulum agent at population 32,
   2 generations (meta indices equal, reward means within 1e-4, update
   cosine 0.999); then the fold: three CPU live ``train_async`` runs'
   event logs (pop 32, horizon 60, a straggler folded late) each replayed
   on the card and on the CPU (params within 1e-6 of their largest entry,
   one reduction launch an update); then a CPU checkpoint of the streamed path
   (population 64, horizon 50, generation 2) restored on the card, the
   state bit for bit, and continued 2 generations on each (reward means
   within 1e-4 relative, params within 1e-4);
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
   warm-up and 2 timed generations (1 for (h)), its launch counts read
   around that run and checked exactly, then one profiled generation: (f)
   Cheetah2D, MLP 64x64, pop 1024, horizon 200 (the ``cheetah2d_device``
   recipe at the JAX bench's LOCO horizon), standard forward; (g) the same,
   streamed forward + kernel update; (h) the ``humanoid2d_pop10k`` recipe
   (Humanoid2D, MLP 256x256, pop 10240, rank-1 noise, obs_norm with 4 probe
   episodes, chunks of 1024) in bf16 at horizon 50; (i) SyntheticEnv
   (376 -> 256x256 -> 17), pop 4096, horizon 200, streamed forward + kernel
   update;
8. the pooled paths, each through ``ES(...).train`` with 1 warm-up and 3
   timed generations (1 for (l)), launch counts exact, then one profiled
   generation: (j) PooledAgent("pendulum", horizon=200), MLP 64x64, pop
   4096, the kernel update; (k) the same with ``double_buffer=True``; (l)
   the ``pong84_conv`` recipe (NatureCNN with VBN, pop 256, 84x84x4, action
   repeat 2, sticky 0.25, horizon 100, cut from 500), with the host-clock shares of the
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
   generation with one worker on each device at population 64 (cut from
   1000: it steps one member at a time), the launches an env step
   over 4 members' rollouts, the device's busy share of one profiled
   generation at population 16 with 8 threads; and, at horizon 10 and
   population 124, 8 thread workers against one on each device;
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
   1 and 2: ``evaluate_policy(64, seed=9)`` above 8.0 at two of them;
11. the novelty family and IW-ES, each through ``Cls(...).train`` with 1
   warm-up and its timed generations, launch counts exact (3 matvec
   launches an env step of the population's evaluation with the streamed
   forward, 1 reduction a generation with the kernel update, none in the
   center episode), the four split parts (evaluate, k-NN + ranks, update,
   center episode) on the host clock, then one profiled generation: (t)
   NSR-ES (k 10, M 3) at the main path's settings, then 3 more generations
   in turns with the main path's fused generation; (u) NSRA-ES (weight
   1.0) with the ``cheetah2d_device`` recipe's policy and env, streamed +
   kernel update, pop 1024, horizon 200, 1 timed generation (cut from 3); (v)
   IW-ES (``reuse_window=2``, ``ess_min=0.5``) on the standard forward at
   Adam 2.5e-4, each generation's ESS, at least one timed generation
   reusing, the two reuse reductions' device time from a profile and from
   CUDA events (``apply_weights_reuse`` with one old generation, its Adam
   step included); (w)
   NS-ES on ``PooledAgent("pendulum", horizon=200)``, the kernel update,
   2 timed generations;
12. barrier-free generations, each path through ``ES(...).train_async``
   against ``train`` in turns from the same state: (x) the overlap
   scheduler on the main path's cell and (y) on (j), 1 warm-up then 3
   generations a call A B B A, params and reward means bit-identical to
   ``train``'s and launch counts exact; (z) the fold on (m) with 8 forked
   workers under a ``ChaosPlan.generate`` straggler plan, 1 warm-up and 3
   updates against ``train`` under the same plan, with env-steps/s,
   updates/s, ``overlap_efficiency``, ``stale_reuse_ratio``, the
   accounting and 1 reduction launch an update, then its event logs
   replayed on the card bit-identical to the live run and a second replay
   profiled for the fold's device time; (z') the JAX bench's async A/B at
   its selfcheck shape (sync and async twice each, generations/s); the
   hub's cost (``ESTORCH_OBS=0`` against on) on the cell and on (j);
13. crash-safe training on the main path's cell (``run_crash_safe``): (aa)
   a checkpoint after 1 + 2 generations, its bytes, the sync save's, the
   async save's blocking and draining and the restore's times, then 2
   resumed generations bit-identical to an uninterrupted 5 with exact
   launches; (ab) ``run_resilient`` through a crash in a save and a
   poisoned update, bit-identical to the clean run; (ac) the
   ``Supervisor`` driving spawned children to generation 8 through a
   SIGKILL and a silent wedge, its final checkpoint bit-identical to the
   in-process run, records 0-7 each once, the time from each death to the
   next child's first generation, and ``obs summarize``'s lines;
14. performance attribution on the main path's cell (``run_attribution``),
   its training in a process of its own so that its ES loads the kernels:
   (ad) a manifest and a JSONL of 1 + 3 generations, record 0 with
   ``cost_model`` and the ``noise_kernels`` compile event, ``obs profile``
   (a subprocess) rating the ``device`` phase's achieved FLOP/s and
   bytes/s against the H100 SXM data sheet, and the steady generations
   rated by phase and whole; (ae) ``obs trace`` validated, and one more
   generation under ``obs.trace.trace`` whose torch.profiler trace names
   1 reduction and 600 matvec launches; (af) ``obs serve-metrics`` scraped
   once, parsed and validated; (ag) ``obs regress --phases`` on two
   3-generation runs of the cell in turns (the verdict printed, not
   gated) and the profile, regress and hist selfchecks;
15. serving on the card (``run_serving``): (ah) the cell's bundle, its
   predict bit-equal to ``ES.predict``, card against CPU, bf16 within its
   measured bound, the served forward alone (host wall against the card's
   busy time); (ai) ``python -m estorch_tpu_torch.serve`` in fresh
   processes: 64 served rows bit-equal, ``/reload``, the SIGTERM drain,
   spawn-to-ready and first-request latency cold and with ``--warm``,
   batch 1 against dynamic batching with the forward's share of each
   leg; (aj) the same at the JAX serving demo's width (MLP 6144 x 6144).  Neither kernel runs in serving: their
   launch counts over (ah) stay 0;
16. scenarios on the card (``run_scenarios``): (ak) the main path's cell
   under ``default_distribution(Pendulum(), n_variants=10, spread=0.3,
   obs_noise=0.05, seed=1)`` (docs/scenarios.md's recipe), 1 warm-up and 3
   timed generations beside phase 3's cell: env-steps/s, busy share, both
   kernels' exact launches, every variant covered, the twins' variants
   equal, and the kernel launches an env step equal at n_variants 1, 10
   and 1000; (al) (g)'s Cheetah2D streamed configuration under drawn chain
   scales, 1 + 1 generations, its launches an env step beside (g)'s; (am)
   ``PBTController(n_centers=3, explore_every=2, seed=7)`` with a
   ``tunable_optimizer`` on the cell, 4 generations a center, replayed bit
   for bit.  Phase 4 also holds a randomized generation with observation
   noise, and Cheetah2D under drawn scales, on the card against the CPU;
17. the fleet on the card (``run_fleet``): phase 15's cell bundle behind
   the real ``python -m estorch_tpu_torch.serve route --fleet fleet.json``
   (2 replica processes on the card, the router and the supervisor in a
   process that maps no torch library): (ao) a declared ``kill_replica``
   under 48 connections with zero client errors, the breaker opened, a
   respawn with ``compiles_at_load == 0`` answering its sibling's bits,
   then a declared ``wedge_replica`` (SIGSTOP) in a fleet whose
   supervisor runs from the files (``fleet_wedge_child``), escalated to
   SIGKILL and respawned within the router's timeouts; (an) 64 rows
   through the router bit-equal to ``ES.predict``, the ready lines naming
   the card, each replica's memory, the file-run router answering the
   same bits without torch; (ar) the file-run collector over the live
   fleet, ``obs dash``/``slow``/``trace --store`` on its store, and ``obs
   autoscale`` (a dry run on a capacity sweep of the router) replayed bit
   for bit; (ap) a re-export promoted and a moved bundle aborted on the
   parity gate; (aq) ``POST /scale`` 2 -> 3 -> 2 under load, the added
   slot warm, zero errors through the drain; (as) req/s and p50/p99
   through 3 replicas and 1 behind the router, and 1 direct.  Neither
   kernel launches in this process (the replicas are other processes).

Then one JSON line of per-path numbers (with phase 13's under
``crash_safe``, phase 14's under ``attribution``, phase 15's under
``serving``, phase 16's under ``scenarios`` and phase 17's under
``fleet``), one of per-kernel numbers (launches from phase 3, and of the
reduction in (j), (k), (m), phases 10-13, and of both kernels in phases
16 and 17),
the card line, and the last line
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
# the JAX bench's LOCO10K rows run 400 (bench.py:287): cut to 100 in PR 4,
# to 50 to make room for phase 13
LOCO10K_HORIZON = 50
ENV_PATHS = [
    # (f) and (g) time 2 generations (3 before phase 13)
    ("f loco/standard/f32", lambda tt, cf: cf.cheetah2d_device(
        agent_kwargs={"env": tt.Cheetah2D(), "horizon": LOCO_HORIZON}), 2, False),
    ("g loco/streamed/f32+nk", lambda tt, cf: cf.cheetah2d_device(
        agent_kwargs={"env": tt.Cheetah2D(), "horizon": LOCO_HORIZON}, **STREAMED), 2, True),
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
# (l)'s horizon, cut from the pong84_conv recipe's 500 (to 250, then to 100,
# as (s)'s, to make room for phase 17)
PONG_CONV_HORIZON = 100
POOLED_PATHS = [
    ("j pooled/pendulum/standard+nk", lambda tt, cf: tt.ES(
        tt.MLPPolicy, tt.PooledAgent("pendulum", horizon=HORIZON), tt.adam,
        population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
        optimizer_kwargs={"learning_rate": 1e-2}, noise_kernel=True), 3, 1),
    ("k pooled/pendulum/standard+nk/double_buffer", lambda tt, cf: tt.ES(
        tt.MLPPolicy, tt.PooledAgent("pendulum", horizon=HORIZON, double_buffer=True), tt.adam,
        population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
        optimizer_kwargs={"learning_rate": 1e-2}, noise_kernel=True), 3, 1),
    # (l) times 1 generation at horizon 100, a fifth of the recipe's 500, to keep
    # the script within its time
    ("l pooled/pong84_conv", lambda tt, cf: cf.pong84_conv(
        agent_kwargs={"env_name": "pong84", "horizon": PONG_CONV_HORIZON, "frame_stack": 4,
                      "action_repeat": 2, "sticky_prob": 0.25}), 1, 0),
]
PONG_PAIRS, PONG_TABLE = 128, 1 << 23  # the pong84_conv recipe's update shape
# phase 9, (m): the halfcheetah_vbn recipe's policy and hyperparameters on a
# rollout(policy) agent over Pendulum (the card machine has no MuJoCo), at
# Pendulum's horizon of 200, timed in process mode (8 forked workers).  The
# 8 thread workers step a few hundred env-steps/s on either device, minutes
# a generation at 200 steps, so they are a side reading at horizon 10
HOST_POPULATION, HOST_HORIZON, HOST_WORKERS = 1000, 200, 8
HOST_SIDE_HORIZON = 10  # the thread workers' side readings
# their population, cut from 1000 to 250 to make room for phase 12, then to
# 124 (mirrored sampling needs it even) for phase 17
HOST_SIDE_POP = 124
HOST_TIMED = 2  # generations after 1 warm-up
# the one-worker generations step members one by one (cut from 250, then 128)
HOST_ONE_WORKER_POP = 64
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
# phase 11, the novelty family and IW-ES (t)-(w), each through Cls(...).train:
# label, how to build it, the timed generations after 1 warm-up, the matvec
# launches an env step of the population's evaluation and the reduction's
# launches a generation, and the cuts.  The center episode runs the standard
# forward: no kernel.  (v) runs the standard forward (the JAX package rejects
# streamed/noise_kernel for IW-ES) at Adam 2.5e-4, under σ/√dim ≈ 7.5e-4,
# where the ESS guard admits the earlier generations at population 4096
NOVELTY = dict(k=10, meta_population_size=3)
FUSED_TURNS = 3  # (t) against the fused generation, in turns
IW_LR = 2.5e-4
REUSE_REPS = 10  # calls of each reuse reduction in its profile
CHEETAH_RECIPE = dict(population_size=1024, sigma=0.08, optimizer_kwargs={"learning_rate": 2e-2},
                      policy_kwargs={"action_dim": 6, "hidden": (64, 64), "discrete": False,
                                     "action_scale": 1.0})  # configs.cheetah2d_device
NOVELTY_PATHS = [
    ("t novelty/pendulum/nsr_es/streamed+nk", lambda tt: tt.NSR_ES(
        tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON), tt.adam,
        population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
        optimizer_kwargs={"learning_rate": 1e-2}, **STREAMED, **NOVELTY), 3, 3, 1, "none"),
    ("u novelty/cheetah2d/nsra_es/streamed+nk", lambda tt: tt.NSRA_ES(
        tt.MLPPolicy, tt.DeviceAgent(tt.Cheetah2D(), horizon=LOCO_HORIZON), tt.adam,
        weight=1.0, **CHEETAH_RECIPE, **STREAMED, **NOVELTY), 1, 3, 1,
     f"1 timed generation, cut from 3; horizon {LOCO_HORIZON} as (g)"),
    ("v iw/pendulum/standard", lambda tt: tt.IW_ES(
        tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON), tt.adam,
        population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
        optimizer_kwargs={"learning_rate": IW_LR}, reuse_window=2, ess_min=0.5), 3, 0, 0,
     "none"),
    ("w novelty/pooled_pendulum/ns_es+nk", lambda tt: tt.NS_ES(
        tt.MLPPolicy, tt.PooledAgent("pendulum", horizon=HORIZON), tt.adam,
        population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
        optimizer_kwargs={"learning_rate": 1e-2}, noise_kernel=True, **NOVELTY), 2, 0, 1,
     "2 timed generations"),
]
# phase 12, ES(...).train_async against train, in turns from the same state:
# (x) overlap on the streamed cell, (y) overlap on pooled Pendulum (j), (z)
# the fold on the host path (m) with its 8 forked workers under a straggler
# plan, (z') the JAX bench's async A/B shape (bench.py:1021-1024, selfcheck)
ASYNC_TIMED = 3  # generations (updates) a timed call, after 1 warm-up
FOLD_STALE = 400  # phase 2's fold shape: members of the older dispatch
Z_STRAGGLER = dict(straggler_every=2, straggler_sleep_s=2.0, straggler_jitter_s=1.0)
BENCH_AB = dict(gens=14, population=16, n_proc=2, straggler_every=2, sleep_s=0.25,
                jitter_s=0.15, work_s=0.002, max_stale=4096)
BENCH_AB_REPEATS = 2
L2_FLUSH_BYTES = 256 << 20  # written and read before each cold launch: five times the L2
# one env step's three launches before the pair-sharing redesign, as measured
# then on an H100 80GB HBM3 at 700 W: printed beside this run's time, never
# reported as this run's number
PREV_MATVEC_STEP_MS = 0.0242

# published peaks (NVIDIA data sheets): memory bytes/s, float32 and float64
# non-tensor FLOP/s (weighted_noise_sum accumulates in float64)
CARD_PEAKS = {
    "H100 NVL": (3.9e12, 60e12, 30e12),
    "H100 PCIe": (2.0e12, 51e12, 26e12),
    "H100": (3.35e12, 67e12, 34e12),  # SXM, the default for any other H100 name
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


def card_peaks(name: str) -> tuple[float, float, float]:
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


def device_events(torch, fn) -> list[tuple[str, int]]:
    """``(name, duration ns)`` of each device event torch.profiler records
    around one call of ``fn``: kernels, copies and fills, not the host-side
    events (the runtime's launch calls).  Only the device's activity is
    recorded and its events are read raw: ``key_averages()`` builds a Python
    object an event (about 0.3 ms each), minutes for a locomotion
    generation's million launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")]


def kernel_launches(events) -> int:
    """The kernel launches among :func:`device_events`' events (copies and
    fills not counted)."""
    return sum(1 for name, _ in events if not name.startswith(("Memcpy", "Memset")))


def profile_generation(torch, es, top: int = 15, **train_kw) -> tuple[float, int]:
    """One more generation under torch.profiler: the device's busy share of
    the wall time and the kernels that take it.  Returns the busy seconds
    and the number of kernel launches."""
    wall = 0.0

    def one_generation():
        nonlocal wall
        t0 = time.perf_counter()
        es.train(1, verbose=False, **train_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = device_events(torch, one_generation)
    by_name: dict[str, list] = {}
    for name, ns in events:
        row = by_name.setdefault(name, [0, 0])
        row[0] += ns
        row[1] += 1
    rows = sorted(((ns / 1e3, count, name) for name, (ns, count) in by_name.items()),
                  reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    kernels = kernel_launches(events)
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


def time_pong_reduction(torch, nk, bw: float, f64: float, flush) -> dict:
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
    bound = max(distinct / bw, flops / f64) * 1e3

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
    n_bmm, n_grouped = (kernel_launches(device_events(torch, f)) for f in (port_forward, grouped))
    print(f"NatureCNN, 256 members, one observation each: the port's forward (patch copy + "
          f"bmm convolutions, fc and head) {ms_bmm:.3f} ms in {n_bmm} kernel launches; the "
          f"convolutions alone as one grouped F.conv2d {ms_grouped:.3f} ms in {n_grouped} "
          f"launches; logits agree to {err:.3g}")
    return {"check": "conv forms, 256 members", "forward_bmm_ms": ms_bmm,
            "forward_bmm_launches": n_bmm, "convs_grouped_conv2d_ms": ms_grouped,
            "convs_grouped_conv2d_launches": n_grouped, "rel_err": err}


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
        self.last_obs = obs
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


def host_table(torch):
    """The host path's noise table on the card: NumPy-built, 2^25 floats."""
    import numpy as np

    return torch.from_numpy(
        np.random.default_rng(0).standard_normal(TABLE_SIZE, dtype=np.float32)).cuda()


def time_host_reduction(torch, nk, table, bw: float, f64: float) -> dict:
    """Phase 2: the reduction at the host path's update shape (m): 500 pair
    rows of dim 4737 from the host path's NumPy-built 2^25-float table, at
    the SeedSequence offsets of generation 0, checked against the plain
    version and timed warm and plain."""
    import numpy as np

    dev = torch.device("cuda")
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
    bound = max(nbytes / bw, flops / f64) * 1e3
    ms = time_ms(torch, lambda: nk.weighted_noise_sum(table, offs_dev, w, HOST_DIM))
    plain_ms = time_ms(torch, lambda: nk.weighted_noise_sum_plain(table, offs_dev, w, HOST_DIM))
    print(f"weighted_noise_sum host (m) n={HOST_PAIRS} dim={HOST_DIM}: max |err| {err:.3g} (tol "
          f"atol 1e-3, rtol 1e-4); warm {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB distinct)")
    return {"shape": f"host (m): n={HOST_PAIRS}, dim={HOST_DIM}, table 2^25 (NumPy)", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "max_abs_err": err}


def time_fold_reduction(torch, nk, table, bw: float, f64: float) -> dict:
    """Phase 2: the reduction at the async fold's shape on the host path:
    one row a member of a batch of HOST_POPULATION (m) members from 2
    dispatches (the older one's last FOLD_STALE members, the newer one's
    first HOST_POPULATION - FOLD_STALE; a mirrored pair's two rows share
    their offset), dim 4737, the host table, weights w·λ·s·c in [-1, 1]:
    checked against the plain version, timed warm and plain."""
    import numpy as np

    dev = torch.device("cuda")
    pair_offs = [np.random.default_rng(np.random.SeedSequence(entropy=0, spawn_key=(d,))).integers(
        0, TABLE_SIZE - HOST_DIM + 1, size=HOST_PAIRS, dtype=np.int64) for d in (0, 1)]
    members = ([(0, i) for i in range(HOST_POPULATION - FOLD_STALE, HOST_POPULATION)]
               + [(1, i) for i in range(HOST_POPULATION - FOLD_STALE)])
    offs = np.array([pair_offs[d][i // 2] for d, i in members], np.int64)
    n = offs.shape[0]
    offs_dev = torch.from_numpy(offs.astype(np.int32)).to(dev)
    w = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, n).astype(np.float32)).to(dev)
    got = nk.weighted_noise_sum(table, offs_dev, w, HOST_DIM)
    torch.cuda.synchronize()
    want = nk.weighted_noise_sum_plain(table, offs_dev, w, HOST_DIM)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
        fail(f"weighted_noise_sum fold n={n} dim={HOST_DIM}: max |err| {err:g}")
    nbytes = 4 * (union_floats(offs, HOST_DIM) + 2 * n + HOST_DIM)
    flops = 2 * n * HOST_DIM
    bound = max(nbytes / bw, flops / f64) * 1e3
    ms = time_ms(torch, lambda: nk.weighted_noise_sum(table, offs_dev, w, HOST_DIM))
    plain_ms = time_ms(torch, lambda: nk.weighted_noise_sum_plain(table, offs_dev, w, HOST_DIM))
    print(f"weighted_noise_sum fold (z) n={n} member rows from 2 dispatches, dim={HOST_DIM}: max "
          f"|err| {err:.3g} (tol atol 1e-3, rtol 1e-4); warm {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB distinct)")
    return {"shape": f"fold (z): n={n} member rows from 2 dispatches ({FOLD_STALE} stale), "
                     f"dim={HOST_DIM}, table 2^25 (NumPy)",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "max_abs_err": err}


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

            per_step = kernel_launches(device_events(torch, four_members)) / (4 * HOST_HORIZON)
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
            got, es_side = timed_run(device, n_proc, 1, warm=0, horizon=HOST_SIDE_HORIZON,
                                     population_size=HOST_SIDE_POP)
            es_side.engine.close()
            side[f"{device or 'cuda'}_{n_proc}"] = got
            report(f"horizon {HOST_SIDE_HORIZON}, population {HOST_SIDE_POP}, {n_proc} "
                   f"thread worker(s) on {device or 'cuda'}, 1 generation", got)
    return {"path": label, "launches": counts, **rec, "kernel_launches_per_env_step": per_step,
            "busy_share_pop16": busy / wall, "device_busy_s_pop16": busy,
            "population": HOST_POPULATION, "horizon": HOST_HORIZON,
            "workers": HOST_WORKERS, "worker_mode": "process", "param_dim": HOST_DIM,
            "cpu": cpu, "one_worker": {"population": HOST_ONE_WORKER_POP, **single},
            "threads_side_reading": {"horizon": HOST_SIDE_HORIZON, "population": HOST_SIDE_POP,
                                     **side}}


def time_recurrent_reduction(torch, nk, table, bw: float, f64: float, flush) -> dict:
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
    bound = max(nbytes / bw, flops / f64) * 1e3

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
            "bound_by": "bytes" if nbytes / bw >= flops / f64 else "operations",
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


class PendulumBCAgent(PendulumRolloutAgent):
    """:class:`PendulumRolloutAgent` returning ``(reward, bc)``, as the
    reference's novelty agents do: the BC is the last observation's (cos θ,
    sin θ)."""

    def rollout(self, policy):
        total = super().rollout(policy)
        return total, self.last_obs[0, :2].copy()


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def compare_novelty_card_cpu(torch, tt) -> list[dict]:
    """Phase 4, the novelty family and IW-ES at a small size, card against
    CPU: (t) NSR-ES streamed with the kernel update at population 64,
    horizon 20, 3 generations (the meta indices equal; the archive sum and
    every center's params within 1e-5 relative); (v) IW-ES at population 64
    with reuse forced by Adam 1e-5, 4 generations (the ``reused_prev`` flags
    equal, each generation's gradient norm within 1e-5 relative, params
    within 2e-7, a fiftieth of one Adam step); a host NS-ES on phase 9's
    ``rollout(policy)`` Pendulum agent returning (reward, last (cos θ,
    sin θ)) at population 32, horizon 60, 2 generations, Adam (meta indices
    equal, reward means within 1e-4 relative, each center's update cosine
    >= 0.999)."""
    out = []
    small = dict(population_size=64, sigma=0.05, policy_kwargs=POLICY, table_size=1 << 22)
    sides = []
    for device in ("cuda", "cpu"):
        es = tt.NSR_ES(tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=20), tt.adam,
                       device=device, optimizer_kwargs={"learning_rate": 1e-2}, **small,
                       **STREAMED, **NOVELTY)
        es.train(3, verbose=False)
        sides.append(es)
    gpu, cpu = sides
    same_meta = [r["meta_index"] for r in gpu.history] == [r["meta_index"] for r in cpu.history]
    p_err = max(_rel(a.params_flat.cpu(), b.params_flat)
                for a, b in zip(gpu.meta_states, cpu.meta_states))
    a_gpu, a_cpu = float(gpu.archive.bcs.sum()), float(cpu.archive.bcs.sum())
    a_err = abs(a_gpu - a_cpu) / max(abs(a_cpu), 1e-30)
    rec = {"check": "t NSR-ES streamed+nk, pop 64, horizon 20, 3 generations",
           "meta_indices": [r["meta_index"] for r in gpu.history], "meta_indices_equal": same_meta,
           "params_rel_err": p_err, "archive_sum_rel_err": a_err}
    print(f"card vs CPU, (t) NSR-ES: meta indices {rec['meta_indices']} equal {same_meta}, "
          f"params rel err {p_err:.3g} (tol 1e-5), archive sum rel err {a_err:.3g} (tol 1e-5)")
    if not (same_meta and p_err <= 1e-5 and a_err <= 1e-5):
        fail(f"card vs CPU, (t) NSR-ES: {rec}")
    out.append(rec)

    sides = []
    for device in ("cuda", "cpu"):
        es = tt.IW_ES(tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=20), tt.adam,
                      device=device, optimizer_kwargs={"learning_rate": 1e-5}, reuse_window=2,
                      **small)
        es.train(4, verbose=False)
        sides.append(es)
    gpu, cpu = sides
    flags = [r["reused_prev"] for r in gpu.history]
    same = flags == [r["reused_prev"] for r in cpu.history]
    # Adam moves each coordinate about lr a step whatever the gradient's
    # size, so the params alone would hide a reuse term of the wrong scale:
    # the ascent direction's norm, reuse terms included, is held generation
    # by generation, and the params to one float32 ulp at |θ| < 2 (the
    # init's largest is 1.28), a fiftieth of one step
    g_err = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                for a, b in zip(gpu.history, cpu.history))
    p_err = float((gpu.state.params_flat.cpu() - cpu.state.params_flat).abs().max())
    rec = {"check": "v IW-ES, pop 64, Adam 1e-5, 4 generations", "reused_prev": flags,
           "reused_prev_equal": same, "grad_norm_rel_err": g_err, "params_max_abs_err": p_err,
           "ess": [r["ess"] for r in gpu.history]}
    print(f"card vs CPU, (v) IW-ES: reused_prev {flags} equal {same}, ESS {rec['ess']}, "
          f"grad norm rel err {g_err:.3g} (tol 1e-5), params max |err| {p_err:.3g} (tol 2e-7)")
    if not (same and any(flags) and g_err <= 1e-5 and p_err <= 2e-7):
        fail(f"card vs CPU, (v) IW-ES: {rec}")
    out.append(rec)

    from estorch_tpu_torch import configs

    sides = []
    for device in ("cuda", "cpu"):
        es = tt.NS_ES(configs._torch_mlp(3, 1, hidden=(64, 64)), PendulumBCAgent,
                      torch.optim.Adam, device=device, agent_kwargs={"horizon": 60},
                      population_size=32, sigma=0.02, optimizer_kwargs={"lr": 1e-2},
                      table_size=1 << 22, **NOVELTY)
        p0 = [s.params_flat.cpu().clone() for s in es.meta_states]
        es.train(2, n_proc=4, verbose=False)
        es.engine.close()
        sides.append((es, p0))
    (gpu, p0), (cpu, _) = sides
    same_meta = [r["meta_index"] for r in gpu.history] == [r["meta_index"] for r in cpu.history]
    fit_err = max(abs(a["reward_mean"] - b["reward_mean"]) / abs(b["reward_mean"])
                  for a, b in zip(gpu.history, cpu.history))
    cos = 1.0
    for a, b, p in zip(gpu.meta_states, cpu.meta_states, p0):
        dg, dc = a.params_flat.cpu() - p, b.params_flat - p
        if float(dc.norm()) > 0:
            cos = min(cos, float(dg @ dc / (dg.norm() * dc.norm())))
    rec = {"check": "host NS-ES, rollout(policy) Pendulum, pop 32, horizon 60, 2 generations",
           "meta_indices_equal": same_meta, "reward_mean_rel_err": fit_err, "cosine": cos}
    print(f"card vs CPU, host NS-ES: meta indices equal {same_meta}, reward_mean rel err "
          f"{fit_err:.3g} (tol 1e-4), update cosine {cos:.7f} (tol 0.999)")
    if not (same_meta and fit_err <= 1e-4 and cos >= 0.999):
        fail(f"card vs CPU, host NS-ES: {rec}")
    out.append(rec)
    return out


def split_against_fused(torch, tt, ns) -> dict:
    """(t)'s split generation against the fused generation of the main
    path's ES (the same policy, env, population and options), in turns, a
    generation each, FUSED_TURNS rounds: the host's speed drifts up to 2x
    between phases, so only generations timed in turns compare."""
    fused = tt.ES(tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON), tt.adam,
                  population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
                  optimizer_kwargs={"learning_rate": 1e-2}, **STREAMED)
    fused.train(1, verbose=False)  # warm-up
    times = {"fused": [], "split": []}
    for _ in range(FUSED_TURNS):
        for key, es in (("fused", fused), ("split", ns)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            es.train(1, verbose=False)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
    centers = [r["phases"]["archive"] for r in ns.history[-FUSED_TURNS:]]
    ratios = [s / f for s, f in zip(times["split"], times["fused"])]
    print(f"  in turns with the fused generation ({FUSED_TURNS} rounds): fused "
          f"{', '.join(f'{t:.4f}' for t in times['fused'])} s, split "
          f"{', '.join(f'{t:.4f}' for t in times['split'])} s (ratios "
          f"{', '.join(f'{r:.2f}' for r in ratios)}); the split's center episode "
          f"{', '.join(f'{c:.4f}' for c in centers)} s")
    return {**times, "ratios": ratios, "center_s": centers}


def run_novelty_paths(torch, tt, nk, card: str) -> list[dict]:
    """Phase 11: each of NOVELTY_PATHS through ``Cls(...).train``: the launch
    counts set to 0 just before its 1 + timed generations, read just after
    and held exact (the matvec 3 an env step of the population's evaluation
    with the streamed forward, the reduction 1 a generation with the kernel
    update; the center episode none); the split parts of each timed
    generation on the host clock (the record's spans ``eval``,
    ``novelty_knn``, ``update``, ``archive``: evaluate, k-NN + ranks,
    update, center episode); then one profiled generation.  (v) must reuse an earlier
    generation in a timed one; its two reuse reductions are timed from a
    profile at the path's shape."""
    paths = []
    for label, build, timed, mv_per_step, wns_per_gen, cuts in NOVELTY_PATHS:
        torch.cuda.empty_cache()
        t_build = time.perf_counter()
        es = build(tt)
        if es.device.type != "cuda":
            fail(f"path {label} ran on {es.device}")
        novelty = hasattr(es, "meta_states")
        horizon = es.config.horizon
        build_s = time.perf_counter() - t_build
        p0 = [s.params_flat.clone() for s in (es.meta_states if novelty else [es.state])]
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
        want = {"weighted_noise_sum": wns_per_gen * gens,
                "population_noise_matvec": mv_per_step * horizon * gens}
        if counts != want:
            fail(f"path {label}: launch counts {counts}, expected {want}")
        if len(es.history) != gens:
            fail(f"path {label}: expected {gens} generations, got {len(es.history)}")
        for r in es.history:
            if r["n_failed"] or not all(math.isfinite(r[k])
                                        for k in ("reward_mean", "reward_max", "grad_norm")):
                fail(f"path {label}, generation {r['generation']}: non-finite result {r}")
        after = [s.params_flat for s in (es.meta_states if novelty else [es.state])]
        if all(torch.equal(a, b) for a, b in zip(p0, after)):
            fail(f"path {label}: params did not change")
        steps = sum(r["env_steps"] for r in es.history[1:])
        gen_s = dt / timed
        chunks = 1 if es.backend == "pooled" else es.population_size // es.engine.eval_chunk
        rec = {"path": label, "algorithm": type(es).__name__, "launches": counts,
               "env_steps_per_s": steps / dt, "s_per_generation": gen_s,
               "population": es.population_size, "horizon": horizon,
               "param_dim": es.spec.dim, "cuts": cuts, "construction_s": build_s}
        extra = ""
        if novelty:
            # the record's spans: evaluate, k-NN + ranks, update, center episode
            parts = {k: statistics.fmean(r["phases"][k] for r in es.history[1:])
                     for k in ("eval", "novelty_knn", "update", "archive")}
            rec.update(split_s=parts, meta_indices=[r["meta_index"] for r in es.history],
                       archive_size=len(es.archive))
            extra = "; split " + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items())
        else:
            rec.update(ess=[r["ess"] for r in es.history],
                       reused_gens=[r["reused_gens"] for r in es.history],
                       learning_rate=IW_LR)
            if not any(r["reused_gens"] >= 1 for r in es.history[1:]):
                fail(f"path {label}: no timed generation reused an earlier one: "
                     f"ESS {rec['ess']}, ess_min*n {0.5 * es.population_size}")
            extra = f"; Adam {IW_LR}, ESS {rec['ess']}, reused_gens {rec['reused_gens']}"
        print(f"path {label} (dim {es.spec.dim}, pop {es.population_size}, horizon {horizon}; "
              f"cut: {cuts}): {steps / dt:.0f} env-steps/s (alive members) ({gen_s:.4f} s a "
              f"generation) on {card}; launches {counts}; reward mean "
              f"{es.history[0]['reward_mean']:.2f} -> {es.history[-1]['reward_mean']:.2f}{extra}")
        busy, launched = profile_generation(torch, es, top=8)  # not part of the counts
        per_step = launched / (horizon * chunks)
        center = "; the center episode included" if novelty else ""
        print(f"  {launched} kernel launches in the profiled generation = {per_step:.1f} an env "
              f"step of the population ({horizon} steps x {chunks} chunks{center}); busy share "
              f"{busy / gen_s:.3f}")
        rec.update(device_busy_s=busy, busy_share=busy / gen_s,
                   kernel_launches_per_env_step=per_step)
        if label.startswith("t"):
            rec["in_turns_with_fused"] = split_against_fused(torch, tt, es)
        if not novelty:
            st, entry = es.state, es._prev[-1]
            d_vec = (entry[0] - st.params_flat) / float(st.sigma)
            rows = entry[2].shape[0]
            old_w = torch.full((rows,), 1e-4, device=es.device)
            w = torch.zeros(es.population_size, device=es.device)
            rec["reuse_device_ms"] = {}
            for name, fn in (("noise_stats", lambda: es.engine.noise_stats(entry[2], d_vec)),
                             ("apply_weights_reuse", lambda: es.engine.apply_weights_reuse(
                                 st, w, entry[2], old_w, d_vec[None], torch.tensor([1e-4])))):
                fn()  # warm
                events = device_events(torch, lambda: [fn() for _ in range(REUSE_REPS)])
                ms = sum(ns for _, ns in events) / 1e6 / REUSE_REPS if events else None
                rec["reuse_device_ms"][name] = ms
                shown = "not measured (no device events)" if ms is None else f"{ms:.4f} ms"
                print(f"  reuse reduction {name} ({rows} rows of dim {es.spec.dim}): device time "
                      f"{shown} a call, from a profile of {REUSE_REPS} calls")
        if es.backend == "pooled":
            es.engine.close()
        paths.append(rec)
        del es
    return paths


def with_chaos(events_or_plan) -> None:
    """Arm a chaos plan for this process and the workers it forks (a fresh
    fire-once state); None disarms it."""
    from estorch_tpu_torch.resilience import chaos

    if events_or_plan is None:
        os.environ.pop(chaos.CHAOS_ENV, None)
    elif isinstance(events_or_plan, list):
        os.environ[chaos.CHAOS_ENV] = json.dumps({"events": events_or_plan})
    else:
        os.environ[chaos.CHAOS_ENV] = events_or_plan.to_json()
    chaos.reset_cache()


def accounting(es) -> dict:
    """The fold's zero-silent-drop check on its last event log."""
    log = es.async_event_log
    consumed = sum(len(u["consumed"]) for u in log.updates)
    dispatched = len(log.dispatches) * es.population_size
    return {"dispatched": dispatched, "consumed": consumed, "discarded": len(log.discarded),
            "lost": len(log.lost), "folded": sum(r["async"]["folded"] for r in es.history
                                                 if "async" in r),
            "ok": dispatched == consumed + len(log.discarded) + len(log.lost)}


def rel_max(a, b) -> float:
    """Largest difference over the largest entry of ``b``."""
    return float((a.cpu() - b.cpu()).abs().max() / b.cpu().abs().max())


def compare_fold_card_cpu(torch, tt, nk, n_logs: int = 3) -> list[dict]:
    """Phase 4, the fold: ``n_logs`` live fold runs of the (m) policy at
    population 32, horizon 60, 4 thread workers on the CPU with a straggler
    folded late, each run's event log replayed on the card and on the CPU:
    one reduction launch an update on the card, params within 1e-6 of their
    largest entry (the kernel and the plain gather + product sum in other
    orders, each in float64 and rounded once, so the update is the same
    float32 vector on both; the Adam steps in float32, on each device's own
    kernels), the async blocks' counts equal.
    Each live run times its own stragglers, so each log is another batch
    mix: the importance ratios of every mix must agree across devices."""
    small = dict(population_size=32, table_size=1 << 22, horizon=60)
    keys = ("consumed", "fresh", "folded", "max_staleness", "consumed_dispatches")
    out = []
    for i in range(n_logs):
        with_chaos([{"kind": "straggler", "gen": 1, "member": 5, "sleep_s": 0.5}])
        try:
            live = host_es(tt, device="cpu", **small)
            live.train_async(4, n_proc=4, verbose=False)
        finally:
            with_chaos(None)
        log = json.loads(json.dumps(live.async_event_log.to_dict()))
        folded = sum(r["async"]["folded"] for r in live.history)
        es_gpu, es_cpu = host_es(tt, **small), host_es(tt, device="cpu", **small)
        torch.cuda.synchronize()
        nk.reset_launch_counts()
        es_gpu.train_async(4, replay=log, verbose=False)
        torch.cuda.synchronize()
        counts = dict(nk.launch_counts)
        es_cpu.train_async(4, replay=log, verbose=False)
        err = rel_max(es_gpu.state.params_flat, es_cpu.state.params_flat)
        same = all(a["async"][k] == b["async"][k]
                   for a, b in zip(es_gpu.history, es_cpu.history) for k in keys)
        print(f"card vs CPU, the fold, log {i + 1} of {n_logs} (VBN 64x64, pop 32, horizon 60, "
              f"a CPU live run's log of 4 updates, {folded} results folded late, replayed): "
              f"params rel err {err:.3g} (tol 1e-6), launches {counts}, async blocks equal {same}")
        if err > 1e-6 or not same or folded == 0 or counts != {"weighted_noise_sum": 4,
                                                               "population_noise_matvec": 0}:
            fail(f"card vs CPU, the fold, log {i + 1}: rel err {err:g}, blocks equal {same}, "
                 f"folded {folded}, launches {counts}")
        for es in (live, es_gpu, es_cpu):
            es.engine.close()
        out.append({"check": f"the fold, replayed, log {i + 1}", "params_rel_err": err,
                    "folded": folded, "launches": counts})
    return out


def overlap_in_turns(torch, nk, label: str, build, per_gen: dict) -> dict:
    """``train`` (A) and the overlap scheduler (B) from the same seed, 1
    warm-up generation each, then ASYNC_TIMED generations a call in turns
    A B B A: the launch counts of each call exact, the params and reward
    means of A and B equal bit for bit after each round."""
    a, b = build(), build()
    if a.device.type != "cuda":
        fail(f"path {label} ran on {a.device}")
    a.train(1, verbose=False)
    b.train_async(1, verbose=False)
    want = {k: v * ASYNC_TIMED for k, v in per_gen.items()}
    times = {"train": [], "overlap": []}
    for i, (key, es) in enumerate((("train", a), ("overlap", b), ("overlap", b), ("train", a))):
        torch.cuda.synchronize()
        nk.reset_launch_counts()
        t0 = time.perf_counter()
        if key == "train":
            es.train(ASYNC_TIMED, verbose=False)
        else:
            es.train_async(ASYNC_TIMED, strategy="overlap", verbose=False)
        torch.cuda.synchronize()
        times[key].append((time.perf_counter() - t0) / ASYNC_TIMED)
        if dict(nk.launch_counts) != want:
            fail(f"path {label}, {key}: launch counts {dict(nk.launch_counts)}, expected {want}")
        if i in (1, 3):
            if not torch.equal(a.state.params_flat, b.state.params_flat):
                fail(f"path {label}: overlap params differ from train's "
                     f"(rel {rel_max(b.state.params_flat, a.state.params_flat):g})")
            if [r["reward_mean"] for r in a.history] != [r["reward_mean"] for r in b.history]:
                fail(f"path {label}: overlap reward means differ from train's")
    steps = statistics.fmean(r["env_steps"] for r in a.history[1:])
    ratio = statistics.fmean(times["train"]) / statistics.fmean(times["overlap"])
    phases = sorted({k for r in b.history for k in r["phases"]})
    print(f"path {label}: train {', '.join(f'{t:.4f}' for t in times['train'])} s a generation, "
          f"overlap {', '.join(f'{t:.4f}' for t in times['overlap'])} s (A B B A); overlap "
          f"{ratio:.3f}x train's speed; params bit-identical; launches {want} a call; overlap "
          f"spans {phases}")
    for es in (a, b):
        if es.backend == "pooled":
            es.engine.close()
    return {"path": label, "strategy": "overlap", "s_per_generation": times,
            "env_steps_per_s": {k: steps / statistics.fmean(v) for k, v in times.items()},
            "overlap_speedup": ratio, "bit_identical": True, "launches_per_call": want}


def run_fold_path(torch, tt, nk, card: str) -> dict:
    """(z): the fold on the host path (m), 8 forked workers, under a
    ``ChaosPlan.generate`` straggler plan, against ``train`` under the same
    plan, in turns (train first): 1 warm-up and ASYNC_TIMED generations or
    updates each.  Then the fold's two logs (warm-up, timed) replayed on
    the card: params bit-identical to the live run; a second replay of the
    timed log under the profiler gives the fold's device time an update."""
    from estorch_tpu_torch.resilience.chaos import ChaosPlan

    label = "z host/pendulum/vbn64x64 fold"
    plan = ChaosPlan.generate(seed=0, n_generations=40, population_size=HOST_POPULATION,
                              **Z_STRAGGLER)
    out = {"path": label, "strategy": "fold", "workers": HOST_WORKERS,
           "worker_mode": "process", "straggler_plan": Z_STRAGGLER}
    for key in ("train", "fold"):
        with_chaos(plan)
        es = host_es(tt, worker_mode="process")
        try:
            run = es.train if key == "train" else es.train_async
            run(1, n_proc=HOST_WORKERS, verbose=False)
            warm_log = es.async_event_log.to_dict() if key == "fold" else None
            torch.cuda.synchronize()
            nk.reset_launch_counts()
            t0 = time.perf_counter()
            run(ASYNC_TIMED, n_proc=HOST_WORKERS, verbose=False)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            es.engine.close()
            with_chaos(None)
        counts = dict(nk.launch_counts)
        if counts != {"weighted_noise_sum": ASYNC_TIMED, "population_noise_matvec": 0}:
            fail(f"path {label}, {key}: launch counts {counts}, expected 1 reduction an update")
        timed = es.history[1:]
        for r in es.history:
            if not all(math.isfinite(r[k]) for k in ("reward_mean", "grad_norm")):
                fail(f"path {label}, {key}, update {r['generation']}: {r}")
        steps = sum(r["env_steps"] for r in timed)
        out[key] = {"env_steps_per_s": steps / dt, "updates_per_s": ASYNC_TIMED / dt,
                    "s_per_update": dt / ASYNC_TIMED, "launches": counts,
                    "reward_mean": [r["reward_mean"] for r in es.history]}
        if key == "fold":
            acc = accounting(es)
            snap = es.obs.counters.snapshot()
            out["fold"].update(accounting=acc,
                               overlap_efficiency=snap.get("overlap_efficiency"),
                               stale_reuse_ratio=snap.get("stale_reuse_ratio"),
                               async_blocks=[r["async"] for r in timed])
            if not acc["ok"]:
                fail(f"path {label}: accounting broken {acc}")
            live, timed_log = es, es.async_event_log.to_dict()
        print(f"path {label}, {key}: {steps / dt:.0f} env-steps/s, {ASYNC_TIMED / dt:.4f} "
              f"updates/s ({dt / ASYNC_TIMED:.3f} s an update) under the straggler plan "
              f"{Z_STRAGGLER}; launches {counts}")
    f = out["fold"]
    print(f"  fold: overlap_efficiency {f['overlap_efficiency']}, stale_reuse_ratio "
          f"{f['stale_reuse_ratio']}, accounting {f['accounting']}; "
          f"{f['updates_per_s'] / out['train']['updates_per_s']:.3f}x train's updates/s")

    replay = host_es(tt)
    replay.train_async(1, replay=warm_log, verbose=False)
    replay.train_async(ASYNC_TIMED, replay=timed_log, verbose=False)
    if not torch.equal(replay.state.params_flat, live.state.params_flat):
        fail(f"path {label}: the replay differs from the live run "
             f"(rel {rel_max(replay.state.params_flat, live.state.params_flat):g})")
    again = host_es(tt)
    again.train_async(1, replay=warm_log, verbose=False)
    events = device_events(torch, lambda: again.train_async(ASYNC_TIMED, replay=timed_log,
                                                            verbose=False))
    if not torch.equal(again.state.params_flat, live.state.params_flat):
        fail(f"path {label}: the profiled replay differs from the live run")
    fold_ms = sum(ns for _, ns in events) / 1e6 / ASYNC_TIMED if events else None
    red_ms = (sum(ns for n, ns in events if "sum_partials" in n) / 1e6 / ASYNC_TIMED
              if events else None)
    shown = ("not measured (no device events)" if fold_ms is None else
             f"{fold_ms:.4f} ms an update (the reduction {red_ms:.4f} ms)")
    print(f"  replay of the live run's logs on {card}: params bit-identical; device time of "
          f"the fold + Adam step {shown}, from a profile of a second replay")
    for es in (replay, again):
        es.engine.close()
    out.update(replay_bit_identical=True, fold_device_ms=fold_ms,
               reduction_device_ms=red_ms, launches=f["launches"],
               launches_per_update=f["launches"]["weighted_noise_sum"] / ASYNC_TIMED)
    return out


class BenchQuadAgent:
    """The JAX bench's async A/B agent (bench.py ``_tiny_host_es``): fitness
    -‖θ‖², and ``work_s`` of sleep a rollout."""

    def rollout(self, policy):
        import torch

        with torch.no_grad():
            r = -float((torch.nn.utils.parameters_to_vector(policy.parameters()) ** 2).sum())
        time.sleep(BENCH_AB["work_s"])
        self.last_episode_steps = 1
        return r


def bench_tiny_policy():
    import torch

    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(), torch.nn.Linear(8, 2))


def run_bench_ab(torch, tt) -> dict:
    """(z'): the JAX bench's async A/B at its selfcheck shape: 14
    generations, population 16, 2 thread workers, a straggler every 2
    generations of 0.25 s + [0, 0.15) s, 0.002 s of work a rollout;
    sync and async legs in turns, BENCH_AB_REPEATS each, a fresh ES and a
    fresh plan a leg; generations/s of each and the ratio of medians."""
    from estorch_tpu_torch.resilience.chaos import ChaosPlan

    cfg = BENCH_AB
    plan = ChaosPlan.generate(seed=0, n_generations=cfg["gens"],
                              straggler_every=cfg["straggler_every"],
                              straggler_sleep_s=cfg["sleep_s"],
                              straggler_jitter_s=cfg["jitter_s"], population_size=cfg["population"])
    rates = {"sync": [], "async": []}
    accs = []
    for _ in range(BENCH_AB_REPEATS):
        for mode in ("sync", "async"):
            with_chaos(plan)
            es = tt.ES(bench_tiny_policy(), BenchQuadAgent, torch.optim.Adam,
                       population_size=cfg["population"], sigma=0.05, seed=0,
                       optimizer_kwargs={"lr": 0.01}, table_size=1 << 12)
            try:
                t0 = time.perf_counter()
                if mode == "async":
                    es.train_async(cfg["gens"], n_proc=cfg["n_proc"], verbose=False,
                                   max_stale=cfg["max_stale"])
                else:
                    es.train(cfg["gens"], n_proc=cfg["n_proc"], verbose=False)
                dt = time.perf_counter() - t0
            finally:
                with_chaos(None)
                es.engine.close()
            rates[mode].append(cfg["gens"] / dt)
            if mode == "async":
                accs.append(accounting(es))
    if not all(a["ok"] for a in accs) or not sum(a["folded"] for a in accs):
        fail(f"path z' bench async A/B: accounting {accs}")
    ratio = statistics.median(rates["async"]) / statistics.median(rates["sync"])
    print(f"path z' bench async A/B ({cfg}; the policies on the card): sync "
          f"{', '.join(f'{r:.3f}' for r in rates['sync'])} generations/s, async "
          f"{', '.join(f'{r:.3f}' for r in rates['async'])}; ratio of medians {ratio:.3f} (the "
          f"JAX bench's gate 1.25); accounting {accs}")
    return {"path": "z' bench async A/B", "cfg": cfg, "generations_per_s": rates,
            "ratio": ratio, "accounting": accs}


def hub_cost(torch, tt, nk) -> list[dict]:
    """The hub's cost: the streamed cell and (j), each built with
    ESTORCH_OBS=0 (off) and by default (on), 1 warm-up generation, then
    ASYNC_TIMED generations a call in turns off, on, on, off."""
    out = []
    for label, build in (("streamed cell", lambda: tt.ES(
            tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON), tt.adam,
            population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
            optimizer_kwargs={"learning_rate": 1e-2}, **STREAMED)),
            ("j pooled/pendulum/standard+nk", lambda: POOLED_PATHS[0][1](tt, None))):
        os.environ["ESTORCH_OBS"] = "0"
        try:
            off = build()
        finally:
            os.environ.pop("ESTORCH_OBS")
        on = build()
        if off.obs.enabled or not on.obs.enabled:
            fail(f"hub cost, {label}: ESTORCH_OBS=0 did not turn the hub off")
        times = {"off": [], "on": []}
        for es in (off, on):
            es.train(1, verbose=False)
        for key, es in (("off", off), ("on", on), ("on", on), ("off", off)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            es.train(ASYNC_TIMED, verbose=False)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) / ASYNC_TIMED)
        if any(r["phases"] for r in off.history) or not all(r["phases"] for r in on.history):
            fail(f"hub cost, {label}: phases present with the hub off or missing with it on")
        ratio = statistics.fmean(times["on"]) / statistics.fmean(times["off"])
        print(f"hub cost, {label}: off {', '.join(f'{t:.4f}' for t in times['off'])} s a "
              f"generation, on {', '.join(f'{t:.4f}' for t in times['on'])} s; on / off "
              f"{ratio:.4f}")
        for es in (off, on):
            if es.backend == "pooled":
                es.engine.close()
        out.append({"path": label, "s_per_generation": times, "on_over_off": ratio})
    return out


def run_async_paths(torch, tt, nk, card: str) -> dict:
    """Phase 12: each path through ``ES(...).train_async`` against
    ``train``: (x), (y), (z), (z') and the hub's cost."""
    paths = [overlap_in_turns(torch, nk, "x overlap/streamed cell", lambda: tt.ES(
        tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON), tt.adam,
        population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
        optimizer_kwargs={"learning_rate": 1e-2}, **STREAMED),
        {"weighted_noise_sum": 1, "population_noise_matvec": 3 * HORIZON})]
    paths.append(overlap_in_turns(torch, nk, "y overlap/pooled pendulum (j)",
                                  lambda: POOLED_PATHS[0][1](tt, None),
                                  {"weighted_noise_sum": 1, "population_noise_matvec": 0}))
    paths.append(run_fold_path(torch, tt, nk, card))
    paths.append(run_bench_ab(torch, tt))
    return {"paths": paths, "hub_cost": hub_cost(torch, tt, nk)}


# phase 13, crash-safe training on the main path's cell: the supervised run's
# target, checkpoint interval, chaos (a SIGKILL before generation 4 and a
# silent wedge before 6) and heartbeat staleness limit (a generation takes
# 0.15-0.5 s; a restarted child's setup beats between its steps)
SUP_TARGET = 8
SUP_EVERY = 2
SUP_STALE_S = 15.0


def streamed_cell():
    """The main path's cell, built on the card: phase 13's supervised
    children build it from this module (``"chip_smoke:streamed_cell"``)."""
    from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, Pendulum, adam

    return ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=HORIZON), adam,
              population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
              optimizer_kwargs={"learning_rate": 1e-2}, **STREAMED)


def same_state(a, b) -> bool:
    """Two device states bit for bit (params, Adam's moments and count, σ,
    generation), on whatever devices they are."""
    return (torch_equal(a.params_flat, b.params_flat)
            and torch_equal(a.opt_state.mu, b.opt_state.mu)
            and torch_equal(a.opt_state.nu, b.opt_state.nu)
            and a.opt_state.count == b.opt_state.count and a.generation == b.generation
            and torch_equal(a.sigma, b.sigma))


def torch_equal(x, y) -> bool:
    import torch

    return bool(torch.equal(x.cpu(), y.cpu()))


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def compare_checkpoint_card_cpu(torch, tt) -> dict:
    """Phase 4, the checkpoint across devices: the streamed path at
    population 64, horizon 50, two generations on the CPU, checkpointed,
    restored on the card (the state bit for bit) and continued two
    generations on each, at phase 4's float32 tolerance (reward_mean within
    1e-4 relative, params within 1e-4)."""
    import shutil
    import tempfile

    from estorch_tpu_torch.utils import restore_checkpoint, save_checkpoint

    small = dict(population_size=64, sigma=0.05, policy_kwargs=POLICY,
                 optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 22, **STREAMED)

    def make(device):
        return tt.ES(tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=50), tt.adam,
                     device=device, **small)

    cpu, card = make("cpu"), make(None)
    cpu.train(2, verbose=False)
    path = tempfile.mkdtemp(prefix="chip_smoke_ck_")
    try:
        save_checkpoint(cpu, path)
        restore_checkpoint(card, path)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    if card.state.params_flat.device.type != "cuda" or not same_state(card.state, cpu.state):
        fail("a CPU checkpoint restored on the card is not the CPU's state")
    card.train(2, verbose=False)
    cpu.train(2, verbose=False)
    fit_err = max(abs(a["reward_mean"] - b["reward_mean"]) / abs(b["reward_mean"])
                  for a, b in zip(card.history[2:], cpu.history[2:]))
    p_err = float((card.state.params_flat.cpu() - cpu.state.params_flat).abs().max())
    if fit_err > 1e-4 or p_err > 1e-4 or len(card.history) != 4:
        fail(f"CPU checkpoint continued on the card: reward_mean rel err {fit_err:g}, "
             f"params max |err| {p_err:g}")
    print(f"card vs CPU, a CPU checkpoint at generation 2 restored on the card (bit for bit) "
          f"and continued 2 generations: reward_mean rel err {fit_err:.3g} (tol 1e-4), "
          f"params max |err| {p_err:.3g} (tol 1e-4)")
    return {"check": "CPU checkpoint continued on the card", "reward_mean_rel_err": fit_err,
            "params_max_abs_err": p_err}


def watch_records(path: str, stop, seen: list) -> None:
    """Note the time at which each line lands in the supervised run's
    JSONL (a generation's end in a child), until ``stop`` is set."""
    n = 0
    while not stop.is_set():
        try:
            with open(path) as f:
                lines = f.read().count("\n")
        except OSError:
            lines = 0
        now = time.time()
        seen.extend([now] * (lines - n))
        n = max(n, lines)
        time.sleep(0.02)


def run_crash_safe(torch, tt, nk, card: str) -> dict:
    """Phase 13 on the main path's cell (both kernels):

    (aa) a checkpoint after 1 + 2 generations: its bytes on disk, the sync
    save's time, the async save's time blocking the loop and its drain,
    the restore's time; the async checkpoint restores to the state at its
    call, and the restored run continued 2 generations is the uninterrupted
    run of 5 bit for bit, with the launches exact (600 matvec + 1 reduction
    a generation);

    (ab) ``run_resilient`` with a crash in the save at ``es.generation`` 2
    and a poisoned update at generation 3: skipped 1, rejected 1, the clean
    run's params bit for bit;

    (ac) the ``Supervisor`` with spawned children built by
    ``"chip_smoke:streamed_cell"``, target 8, a checkpoint every 2, a
    SIGKILL before generation 4 and a 600 s silent wedge before 6: two
    restarts (exit -SIGKILL, then a stale heartbeat), the final checkpoint
    the in-process run of 8 bit for bit, records 0-7 each once, the time
    from each death being noticed to the next child's first generation,
    and ``obs summarize``'s lines.
    """
    import shutil
    import tempfile
    import threading

    from estorch_tpu_torch.resilience import ChaosPlan, Supervisor, run_resilient
    from estorch_tpu_torch.utils import (PeriodicCheckpointer, restore_checkpoint,
                                         save_checkpoint)

    out: dict = {"path": "crash-safe training (phase 13)", "cell": "streamed (phase 3)"}
    work = tempfile.mkdtemp(prefix="chip_smoke_crash_")
    try:
        # (aa) -------------------------------------------------------------
        a = streamed_cell()
        a.train(1, verbose=False)  # warm-up
        a.train(2, verbose=False)
        torch.cuda.synchronize()
        at3 = a.state
        sync_dir, async_dir = os.path.join(work, "sync"), os.path.join(work, "async")
        t0 = time.perf_counter()
        save_checkpoint(a, sync_dir)
        sync_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        handle = save_checkpoint(a, async_dir, asynchronous=True)
        block_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        handle.wait()
        drain_ms = (time.perf_counter() - t0) * 1e3
        b = streamed_cell()
        restore_checkpoint(b, async_dir)
        if not same_state(b.state, at3):
            fail("(aa) the async checkpoint does not hold the state at its call")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_checkpoint(b, sync_dir)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        nk.reset_launch_counts()
        b.train(2, verbose=False)
        resumed = dict(nk.launch_counts)
        a.train(2, verbose=False)
        want = {"population_noise_matvec": 2 * 3 * HORIZON, "weighted_noise_sum": 2}
        if resumed != want:
            fail(f"(aa) resumed launches {resumed}, expected {want}")
        if not torch.equal(a.state.params_flat, b.state.params_flat) or \
                [r["reward_mean"] for r in a.history] != [r["reward_mean"] for r in b.history]:
            fail("(aa) the resumed run is not the uninterrupted run of 5 bit for bit")
        nbytes = dir_bytes(sync_dir)
        print(f"(aa) checkpoint at generation 3: {nbytes} bytes on disk; sync save "
              f"{sync_ms:.2f} ms, async save {block_ms:.2f} ms blocking + {drain_ms:.2f} ms "
              f"drain, restore {restore_ms:.2f} ms (host clock, {card}); resumed 2 "
              f"generations bit-identical to the uninterrupted 5, launches {resumed}")
        out["checkpoint"] = {"bytes": nbytes, "sync_save_ms": sync_ms,
                             "async_block_ms": block_ms, "async_drain_ms": drain_ms,
                             "restore_ms": restore_ms, "resumed_launches": resumed,
                             "bit_identical": True}

        # (ab) -------------------------------------------------------------
        with_chaos([{"kind": "ckpt_crash", "gen": 2}, {"kind": "nan_update", "gen": 3}])
        try:
            r = streamed_cell()
            ck = PeriodicCheckpointer(r, os.path.join(work, "ab"), every=1, max_to_keep=2)
            t0 = time.perf_counter()
            run_resilient(r, 5, checkpointer=ck)
            torch.cuda.synchronize()
            ab_s = time.perf_counter() - t0
        finally:
            with_chaos(None)
        skipped = r.obs.counters.get("generations_skipped")
        rejected = r.obs.counters.get("generations_rejected")
        if skipped != 1 or rejected != 1 or not torch.equal(r.state.params_flat,
                                                           a.state.params_flat):
            fail(f"(ab) run_resilient: skipped {skipped}, rejected {rejected}, params "
                 f"equal {torch.equal(r.state.params_flat, a.state.params_flat)}")
        print(f"(ab) run_resilient, ckpt_crash at es.generation 2 and nan_update at 3: "
              f"generations_skipped {skipped}, generations_rejected {rejected}, params "
              f"bit-identical to the clean run of 5; {ab_s:.2f} s for 5 generations with "
              "a save each")
        out["run_resilient"] = {"generations_skipped": skipped, "generations_rejected": rejected,
                                "seconds": ab_s, "bit_identical": True}
        del r

        # (ac) -------------------------------------------------------------
        a.train(SUP_TARGET - a.generation, verbose=False)  # the in-process run of 8
        root = os.path.join(work, "sup")
        plan = [{"kind": "die", "gen": 4}, {"kind": "wedge", "gen": 6, "sleep_s": 600.0}]
        with_chaos(ChaosPlan(plan, ledger=os.path.join(work, "chaos_ledger")))
        stop, seen = threading.Event(), []
        watcher = threading.Thread(target=watch_records,
                                   args=(os.path.join(root, "run.jsonl"), stop, seen))
        watcher.start()
        t0 = time.time()
        try:
            sup = Supervisor("chip_smoke:streamed_cell", root, SUP_TARGET, every=SUP_EVERY,
                             max_restarts=3, backoff_s=0.1, poll_s=0.25,
                             stale_after_s=SUP_STALE_S, startup_grace_s=240.0)
            res = sup.run()
        finally:
            stop.set()
            watcher.join()
            with_chaos(None)
        sup_s = time.time() - t0
        restarts = res["restarts"]
        if not res["ok"] or len(restarts) != 2 or restarts[0]["exitcode"] != -9 \
                or "stale" not in restarts[1]["reason"]:
            fail(f"(ac) supervisor: {res}")
        restore_checkpoint(b, res["checkpoint"])
        if b.generation != SUP_TARGET or not same_state(b.state, a.state):
            fail(f"(ac) the supervised run's final checkpoint ({res['checkpoint']}) is not "
                 f"the in-process train({SUP_TARGET}) bit for bit")
        with open(os.path.join(root, "run.jsonl")) as f:
            gens = [json.loads(line)["generation"] for line in f if line.strip()]
        if gens != list(range(SUP_TARGET)):
            fail(f"(ac) records {gens}, expected 0..{SUP_TARGET - 1} each once")
        to_first = [next((t for t in seen if t > rs["ts"]), float("nan")) - rs["ts"]
                    for rs in restarts]
        summ = subprocess.run([sys.executable, "-m", "estorch_tpu_torch.obs", "summarize",
                               os.path.join(root, "run.jsonl")], cwd=HERE,
                              capture_output=True, text=True, timeout=120)
        if summ.returncode != 0 or "restarts         2" not in summ.stdout:
            fail(f"(ac) obs summarize: {summ.stdout} {summ.stderr}")
        lines = [ln for ln in summ.stdout.splitlines()
                 if ln.startswith(("resilience", "restarts", "diagnosis"))]
        resil = json.load(open(os.path.join(root, "manifest.json")))["resilience"]
        for i, (rs, dt) in enumerate(zip(restarts, to_first)):
            print(f"(ac) restart {i + 1}: {rs['reason']}; death noticed -> the next child's "
                  f"first generation {dt:.2f} s")
        print(f"(ac) supervised run to {SUP_TARGET}: {sup_s:.1f} s, final checkpoint "
              f"bit-identical to the in-process run, records 0-{SUP_TARGET - 1} each once, "
              f"counters {resil['counters']}")
        for ln in lines:
            print(f"  obs summarize: {ln}")
        out["supervisor"] = {"seconds": sup_s, "restarts": [
            {"reason": rs["reason"], "exitcode": rs["exitcode"], "to_first_generation_s": dt}
            for rs, dt in zip(restarts, to_first)], "counters": resil["counters"],
            "summarize": lines, "bit_identical": True}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------
# phase 14, performance attribution on the main path's cell: the run's own
# records (cost model, compile ledger, spans) through the obs CLI
# ---------------------------------------------------------------------


def attribution_child(run_dir: str) -> None:
    """Phase 14's training, in a process of its own (``python -c "import
    chip_smoke; chip_smoke.attribution_child(DIR)"``), so that the cell's
    ES is the first in its process to load the kernels and its first record
    carries the ``noise_kernels`` compile event.  Writes the manifest and
    ``run.jsonl`` (1 warm-up + 3 generations), one more generation under
    ``obs.trace.trace`` into ``trace/``, two 3-generation runs of the cell
    from one state in turns (``a.jsonl``, ``b.jsonl``), and ``child.json``
    (the launch counts)."""
    from estorch_tpu_torch.obs import JsonlSink
    from estorch_tpu_torch.obs.trace import trace
    from estorch_tpu_torch.ops import noise_kernels as nk

    t0 = time.perf_counter()
    steps = {}
    es = streamed_cell()
    steps["cell built"] = time.perf_counter() - t0
    es.write_manifest(os.path.join(run_dir, "manifest.json"))
    sink = JsonlSink(os.path.join(run_dir, "run.jsonl"))
    nk.reset_launch_counts()
    es.train(GENERATIONS, log_fn=sink, verbose=False)
    sink.close()
    launches = dict(nk.launch_counts)
    steps["1 + 3 generations"] = time.perf_counter() - t0
    nk.reset_launch_counts()
    with trace(os.path.join(run_dir, "trace")):
        es.train(1, verbose=False)
    traced = dict(nk.launch_counts)
    steps["traced generation, trace written"] = time.perf_counter() - t0
    pair = (streamed_cell(), streamed_cell())  # one seed: one state
    sinks = [JsonlSink(os.path.join(run_dir, n)) for n in ("a.jsonl", "b.jsonl")]
    for _ in range(3):
        for cell, s in zip(pair, sinks):
            cell.train(1, log_fn=s, verbose=False)
    for s in sinks:
        s.close()
    steps["two cells, 3 generations each"] = time.perf_counter() - t0
    with open(os.path.join(run_dir, "child.json"), "w") as f:
        json.dump({"launches": launches, "traced_launches": traced, "steps_s": steps,
                   "compile_time_s": es.compile_time_s,
                   "pair_compile_time_s": [c.compile_time_s for c in pair]}, f)


def _rates(row: dict, peak_f: float, peak_b: float) -> str:
    return (f"{row['flops_per_s'] / 1e9:.3f} GFLOP/s ({row['flops_per_s'] / peak_f:.5%} of "
            f"{peak_f / 1e12:g} TFLOP/s), {row['bytes_per_s'] / 1e9:.3f} GB/s "
            f"({row['bytes_per_s'] / peak_b:.4%} of {peak_b / 1e12:g} TB/s)")


def run_attribution(torch, card: str, name: str) -> dict:
    """Phase 14 on the main path's cell, from the run's own records:

    (ad) the cell's run (:func:`attribution_child`) into a run directory
    with its manifest and JSONL: record 0 carries ``cost_model`` and a
    ``noise_kernels`` compile event with ``cached`` set; ``obs profile``
    (a subprocess) rates the ``device`` phase against the roofline the
    manifest's card picks (the H100 SXM data sheet on an H100 80GB HBM3),
    and the steady generations (the warm-up left out) are rated from the
    same records, by phase and over the whole generation;

    (ae) ``obs trace`` of the JSONL validates clean, and the torch.profiler
    trace of one more generation (``obs.trace.trace``) names 1
    ``weighted_noise_sum`` and 600 matvec launches, phase 3's exact counts;

    (af) ``obs serve-metrics`` on the run directory at ``--port 0``,
    scraped once: the exposition parses and its histograms validate;

    (ag) ``obs regress --phases --json`` on two 3-generation runs of the
    cell from one state, in turns: a verdict that parses and names the
    phases (not gated on a pass: times spread up to 2x between runs); the
    ``profile``, ``regress`` (median and tail) and ``hist`` selfchecks exit 0.
    """
    import contextlib
    import io
    import shutil
    import tempfile
    import urllib.request

    from estorch_tpu_torch.obs import __main__ as obs_cli
    from estorch_tpu_torch.obs.export.prometheus import (histogram_series, parse_exposition,
                                                         samples_by_name,
                                                         validate_histogram_series)
    from estorch_tpu_torch.obs.export.traceevent import validate_trace
    from estorch_tpu_torch.obs.profile import find_cost_model, phase_cost_for, profile_records
    from estorch_tpu_torch.obs.profile.roofline import is_h100_sxm

    t_start = time.perf_counter()
    out: dict = {"path": "attribution (phase 14)", "cell": "streamed (phase 3)"}
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_attr_")
    sidecar = None
    try:
        # ---- (ad) the run, its records and obs profile ----------------------
        env = dict(os.environ, ESTORCH_OBS="1",
                   ESTORCH_OBS_HEARTBEAT=os.path.join(run_dir, "heartbeat.json"))
        env.pop("ESTORCH_CHAOS", None)
        child = subprocess.run(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.attribution_child({run_dir!r})"],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
        if child.returncode != 0:
            fail(f"(ad) the attribution run exited {child.returncode}\n{child.stderr[-3000:]}")
        with open(os.path.join(run_dir, "child.json")) as f:
            facts = json.load(f)
        print(f"(ad) the run's process: {time.perf_counter() - t_start:.1f} s, in it "
              + ", ".join(f"{k} at {v:.1f} s" for k, v in facts["steps_s"].items()))
        # (af)'s sidecar starts now: its import overlaps with (ad) and (ae)
        pf = os.path.join(run_dir, "port.json")
        sidecar = subprocess.Popen([sys.executable, "-m", "estorch_tpu_torch.obs",
                                    "serve-metrics", "--run-dir", run_dir, "--port", "0",
                                    "--port-file", pf], cwd=HERE, stdout=subprocess.DEVNULL,
                                   stderr=subprocess.PIPE, text=True)
        want = {"population_noise_matvec": 3 * HORIZON * GENERATIONS,
                "weighted_noise_sum": GENERATIONS}
        if facts["launches"] != want:
            fail(f"(ad) launch counts {facts['launches']}, expected {want}")
        jsonl = os.path.join(run_dir, "run.jsonl")
        with open(jsonl) as f:
            records = [json.loads(line) for line in f if line.strip()]
        if len(records) != GENERATIONS or "cost_model" not in records[0]:
            fail(f"(ad) {len(records)} records; record 0 keys {sorted(records[0])}")
        evs = [e for e in records[0].get("compile_events", [])
               if e.get("program") == "noise_kernels"]
        if len(evs) != 1 or not isinstance(evs[0].get("cached"), bool):
            fail(f"(ad) record 0's compile events {records[0].get('compile_events')}")
        if any("compile_events" in r for r in records[1:]):
            fail("(ad) a compile event after the first record")
        if facts["pair_compile_time_s"] != [0.0, 0.0]:
            fail(f"(ad) later cells recorded the load again: {facts['pair_compile_time_s']}")
        ev = evs[0]
        print(f"(ad) record 0: cost_model and the noise_kernels compile event {ev}; "
              f"compile_time_s {facts['compile_time_s']:.4f} s")
        spans = [(r["phases"]["device"], r["phases"]["dispatch"]) for r in records]
        print("  spans a generation: device " + ", ".join(f"{d * 1e3:.3f}" for d, _ in spans)
              + " ms; dispatch " + ", ".join(f"{x:.4f}" for _, x in spans) + " s")
        model = find_cost_model(records)
        steps = records[0]["env_steps"]
        per_gen = phase_cost_for(model, "device", env_steps=steps, n_generations=1)
        print(f"  model: {per_gen['flops'] / 1e9:.4f} GFLOP and {per_gen['bytes'] / 1e9:.4f} GB "
              f"a generation ({model['flops_per_env_step']} FLOP an env step x {steps} steps "
              f"+ sample + update)")
        proc = subprocess.run([sys.executable, "-m", "estorch_tpu_torch.obs", "profile", jsonl,
                               "--json"], cwd=HERE, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            fail(f"(ad) obs profile exited {proc.returncode}\n{proc.stderr[-3000:]}")
        prof = json.loads(proc.stdout.strip().splitlines()[-1])
        if is_h100_sxm(name) and prof.get("basis") != "h100_sxm_datasheet_f32":
            fail(f"(ad) roofline basis {prof.get('basis')!r} on {name}")
        peak_f = prof["roofline"]["peak_flops_per_s"]
        peak_b = prof["roofline"]["peak_bytes_per_s"]
        dev = prof["phases"].get("device")
        if not dev or "flops_per_s" not in dev:
            fail(f"(ad) no rated device phase: {prof['phases']}")
        print(f"  obs profile ({prof['generations']} generations, warm-up included), basis "
              f"{prof['basis']}, on {card}:")
        if peak_f and peak_b:
            print(f"    device phase {dev['seconds']:.4f} s: {_rates(dev, peak_f, peak_b)}")
        else:
            print(f"    device phase {dev['seconds']:.4f} s: {dev['flops_per_s'] / 1e9:.3f} "
                  f"GFLOP/s, {dev['bytes_per_s'] / 1e9:.3f} GB/s (no roofline for this card)")
        for pname, row in prof["phases"].items():
            print(f"    {pname:<10} share {row['share']:.4f}, {row['seconds']:.4f} s")
        # the steady generations, rated from the same records, model and roofline
        roof = {"platform": prof["platform"], "basis": prof["basis"],
                "peak_flops_per_s": peak_f, "peak_bytes_per_s": peak_b}
        steady = profile_records(records[1:], roof, cost_model=model)
        wall = sum(r["wall_time_s"] for r in records[1:])
        gen_rate = {"flops_per_s": per_gen["flops"] * len(records[1:]) / wall,
                    "bytes_per_s": per_gen["bytes"] * len(records[1:]) / wall}
        sdev = steady["phases"]["device"]
        if peak_f and peak_b:
            print(f"  steady ({len(records) - 1} generations, {wall / (len(records) - 1):.4f} s "
                  f"each): device phase {sdev['seconds']:.4f} s, {_rates(sdev, peak_f, peak_b)}; "
                  f"whole generation {_rates(gen_rate, peak_f, peak_b)}")
        out.update(compile_event=ev, compile_time_s=facts["compile_time_s"],
                   model_per_generation=per_gen, basis=prof["basis"],
                   profile_device=dev, steady_device=sdev, steady_generation=gen_rate,
                   steady_s_per_generation=wall / (len(records) - 1),
                   steady_shares={k: v["share"] for k, v in steady["phases"].items()})

        # ---- (ae) obs trace, and the torch.profiler trace's kernels ------------
        trace_json = os.path.join(run_dir, "trace.json")
        if obs_cli.main(["trace", jsonl, "-o", trace_json]) != 0:
            fail("(ae) obs trace failed")
        with open(trace_json) as f:
            problems = validate_trace(json.load(f))
        if problems:
            fail(f"(ae) obs trace output invalid: {problems[:5]}")
        (tpath,) = [os.path.join(run_dir, "trace", p)
                    for p in os.listdir(os.path.join(run_dir, "trace"))]
        with open(tpath) as f:
            kernels = [e["name"] for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
        counted = {"weighted_noise_sum": sum("weighted_sum_partials" in k for k in kernels),
                   "population_noise_matvec": sum("noise_matvec" in k for k in kernels)}
        want1 = {"weighted_noise_sum": 1, "population_noise_matvec": 3 * HORIZON}
        if counted != want1 or facts["traced_launches"] != want1:
            fail(f"(ae) traced kernels {counted}, counted launches "
                 f"{facts['traced_launches']}, expected {want1}")
        print(f"(ae) obs trace valid; torch.profiler trace of one generation: {counted} "
              f"({len(kernels)} kernel launches in all) at {time.perf_counter() - t_start:.1f} s")
        out["trace_kernels"] = counted
        out["trace_kernel_launches"] = len(kernels)

        # ---- (af) serve-metrics, scraped once ---------------------------------
        deadline = time.monotonic() + 120
        while not os.path.exists(pf):
            if sidecar.poll() is not None or time.monotonic() > deadline:
                fail(f"(af) serve-metrics did not start: {sidecar.stderr.read()[-2000:]}")
            time.sleep(0.1)
        with open(pf) as f:
            port = json.load(f)["port"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            body = r.read().decode()
        samples = parse_exposition(body)
        problems = validate_histogram_series(samples)
        if problems:
            fail(f"(af) scraped histograms invalid: {problems[:5]}")
        vals = samples_by_name(samples)
        n_hist = len(histogram_series(samples))
        print(f"(af) /metrics: {len(samples)} samples, {n_hist} histograms, estorch_up "
              f"{vals.get('estorch_up')}, env_steps {vals.get('estorch_env_steps')}: parses "
              f"and validates, at {time.perf_counter() - t_start:.1f} s")
        out["scrape"] = {"samples": len(samples), "histograms": n_hist,
                         "up": vals.get("estorch_up")}

        # ---- (ag) obs regress --phases, and the selfchecks ---------------------
        # the CLI's main in this process (the subcommand's own code and exit
        # codes: 0 pass, 1 regression or unreadable input) saves a torch import
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = obs_cli.main(["regress", os.path.join(run_dir, "a.jsonl"), "--baseline",
                               os.path.join(run_dir, "b.jsonl"), "--phases", "--json"])
        if rc not in (0, 1):
            fail(f"(ag) obs regress --phases exited {rc}")
        verdict = json.loads(text.getvalue().strip().splitlines()[-1])
        if verdict.get("verdict") not in ("pass", "regress") or not verdict.get("phases"):
            fail(f"(ag) regress verdict {verdict}")
        print(f"(ag) regress --phases (a in turns with b, 3 generations each): "
              f"{verdict['verdict']}, regressed {verdict['regressed_phases']}; " + ", ".join(
                  f"{k} {v['current_median_s']:.4f}/{v['baseline_median_s']:.4f} s "
                  f"({v['slowdown_pct']:+.1f} %, band {v['band_pct']} %)"
                  for k, v in verdict["phases"].items()))
        for argv in (["profile", "--selfcheck"], ["regress", "--selfcheck"],
                     ["regress", "--tail", "--selfcheck"], ["hist", "--selfcheck"]):
            if obs_cli.main(argv) != 0:
                fail(f"(ag) obs {' '.join(argv)} failed")
        out["regress_phases"] = {"verdict": verdict["verdict"],
                                 "regressed": verdict["regressed_phases"],
                                 "phases": verdict["phases"]}
    finally:
        if sidecar is not None:
            sidecar.terminate()
            sidecar.wait(timeout=30)
        shutil.rmtree(run_dir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_start
    print(f"phase 14: {out['phase_s']:.1f} s on {card}")
    return out


# phase 15, serving on the card: the cell's bundle through the predictor,
# the batcher and the HTTP server, then the JAX serving demo's width
# ---------------------------------------------------------------------

SERVE_MAX_BATCH = 64  # the ladder's top, the anchor bucket
SERVE_LOAD_S = 2.5  # each run_load leg, as the JAX demo's
DEMO_HIDDEN = 6144  # tests/test_serve.py:775: 37.8 M params, 151 MB of f32 weights
DEMO_TABLE = 1 << 26


def spawn_server(bundle: str, max_batch: int, *extra: str):
    """``python -m estorch_tpu_torch.serve`` on the card in a new process:
    (process, its ready line, seconds from spawn to the ready line)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "estorch_tpu_torch.serve", "--bundle", bundle, "--port", "0",
         "--max-batch", str(max_batch), "--beat-interval", "0.5", *extra],
        cwd=HERE, stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if not line:
        proc.wait(timeout=30)
        fail(f"the server exited {proc.returncode} before its ready line")
    return proc, json.loads(line), time.perf_counter() - t0


def stop_server(proc) -> tuple[int, dict]:
    """SIGTERM, then the exit code and the final counter line."""
    import signal

    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    return proc.returncode, json.loads(out.strip().splitlines()[-1])


def first_request_ms(url: str, obs: list) -> float:
    """The first request of a fresh server, alone on one connection."""
    from estorch_tpu_torch.serve.loadgen import run_load

    res = run_load(url, conns=1, total=1, duration_s=60.0, obs=obs, collect_latencies=True)
    if res["errors"] or res["shed"]:
        fail(f"first request failed: {res}")
    return res["latencies_s"][0] * 1e3


def served_rows(url: str, obs) -> tuple:
    """Each row of ``obs`` as one request (6 connections, mixed buckets):
    the answers as float32 rows, and the run's errors + shed."""
    import numpy as np

    from estorch_tpu_torch.serve.loadgen import run_load

    res = run_load(url, conns=6, total=len(obs), duration_s=120.0,
                   obs_list=[o.tolist() for o in obs], collect_responses=True)
    rows = np.asarray([r["action"] if r else [np.nan] for r in res["responses"]], np.float32)
    return rows, res["errors"] + res["shed"]


def _loaded_leg(url: str, conns: int, max_batch: int, obs: list, label: str, leg: str) -> dict:
    """``run_load`` closed loop on a running server for ``SERVE_LOAD_S``:
    throughput, p50, p99, the leg's own mean batch, and the batched
    forward's share of the leg's wall time (the batcher's
    ``predict_time_s_total``: the forward on the card and the answer's
    copy back), which says how much of a request's time the card's work
    takes and how much the host's.  Gated on errors and shed only."""
    from estorch_tpu_torch.serve import ServeClient
    from estorch_tpu_torch.serve.loadgen import run_load

    keys = ("batches_total", "batched_requests_total", "predict_time_s_total")
    with ServeClient(url) as c:
        before = c.stats()["counters"]
    res = run_load(url, conns=conns, duration_s=SERVE_LOAD_S, obs=obs)
    with ServeClient(url) as c:
        after = c.stats()["counters"]
    n, rows, fwd_s = (after.get(k, 0) - before.get(k, 0) for k in keys)
    if res["errors"] or res["shed"]:
        fail(f"({label}) {leg} leg: errors {res['errors']}, shed {res['shed']}")
    out = {"conns": conns, "max_batch": max_batch, "requests": res["requests"],
           "throughput_rps": res["throughput_rps"], "p50_ms": res["latency_ms"]["p50"],
           "p99_ms": res["latency_ms"]["p99"], "mean_batch": round(rows / n, 3) if n else None,
           "forward_ms_per_batch": round(fwd_s / n * 1e3, 4) if n else None,
           "forward_share": round(fwd_s / res["duration_s"], 4)}
    print(f"({label}) {leg}: {out['throughput_rps']} req/s, p50 {out['p50_ms']} ms, p99 "
          f"{out['p99_ms']} ms over {out['requests']} requests ({conns} conns, max batch "
          f"{max_batch}, mean batch {out['mean_batch']}); batched forward "
          f"{out['forward_ms_per_batch']} ms a batch, {out['forward_share']:.1%} of the leg")
    return out


def dynamic_leg(url: str, obs: list, label: str) -> dict:
    """Dynamic batching on a running ``--max-batch 64`` server: 48
    connections (:func:`_loaded_leg`)."""
    return _loaded_leg(url, 48, SERVE_MAX_BATCH, obs, label, "dynamic")


def batch1_leg(bundle: str, obs: list, label: str) -> dict:
    """The batch-size-1 baseline in a fresh ``--max-batch 1`` server, one
    connection (:func:`_loaded_leg`)."""
    proc, ready, _ = spawn_server(bundle, 1)
    try:
        out = _loaded_leg(ready["url"], 1, 1, obs, label, "batch1")
        rc, final = stop_server(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    if rc != 0 or not final["clean"]:
        fail(f"({label}) the batch-1 server exited {rc}")
    return out


def run_serving(torch, tt, nk, card: str, name: str, fleet_dir: str) -> dict:
    """Phase 15, serving on the card: no kernel of the port runs in serving
    (the center's standard forward is cuBLAS), so the kernels' launch
    counts over (ah)-(ai)'s in-process serving must stay 0.

    (ah) the main path's cell trained 1 + 2 generations and exported
    (``serve_bf16``, with the warm replay of a 64 ladder on the card):
    ``Bundle.predict`` bit-equal (``tobytes``) to ``ES.predict`` for one
    observation and an anchor batch of 64; the bundle on the card against
    the same bundle on the CPU within 1e-6 of the output's scale (float32
    products in another order); the bf16 batcher's measured divergence per
    bucket, each kept bucket within ``BF16_DIVERGENCE_BOUND``, and a bf16
    answer within it; the served forward alone at 1 and 64 rows, host wall
    against the card's busy time (:func:`served_forward`);

    (ai) ``python -m estorch_tpu_torch.serve`` in a fresh process on the
    card (``--max-batch 64``): the ready line names the card; the verified
    and excluded buckets; spawn-to-ready and the first request's latency,
    cold and with ``--warm``; 64 distinct observations through ``run_load``
    bit-equal to ``ES.predict`` on the anchor batch; ``/reload`` to the
    best member's bundle, answering bit-equal to ``ES.predict(use_best=
    True)``; SIGTERM with 12 requests in flight drains them all (exit 0,
    nothing shed, real answers); batch 1 against dynamic batching, each
    leg with the batched forward's share of its wall time;

    (aj) the JAX serving demo's width (MLP 6144 x 6144, table 2^26, pop 4,
    one generation): the served forward alone, 64 served rows bit-equal to
    ``ES.predict``, and batch 1 against dynamic batching (gated on errors
    and shed only).

    The cell's bundle stays in ``fleet_dir`` for phase 17, beside a
    re-export of the same parameters, an export with one parameter moved
    by 1e-3, the anchor batch and ``ES.predict``'s answers to it.
    """
    import shutil
    import tempfile
    import threading

    import numpy as np

    from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, Pendulum, adam
    from estorch_tpu_torch.obs.manifest import describe_device
    from estorch_tpu_torch.serve import BF16_DIVERGENCE_BOUND, ServeClient, load_bundle
    from estorch_tpu_torch.serve.warm import build_serving_batcher

    t_start = time.perf_counter()
    out: dict = {"path": "serving (phase 15)", "cell": "streamed (phase 3)"}
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    rng = np.random.default_rng(15)
    obs_list = [0.1, 0.2, 0.3]
    try:
        # (ah) ----------------------------------------------------------------
        es = streamed_cell()
        es.train(3, verbose=False)
        t0 = time.perf_counter()
        bundle = es.export_bundle(os.path.join(fleet_dir, FLEET_BUNDLES[0]), version="cell-g3",
                                  warm=True, warm_max_batch=SERVE_MAX_BATCH, serve_bf16=True)
        best = es.export_bundle(os.path.join(work, "best"), use_best=True, version="cell-best")
        out["export_s"] = time.perf_counter() - t0
        nk.reset_launch_counts()
        b = load_bundle(bundle)
        if b.device != es.device or b.params["head"]["kernel"].device.type != es.device.type:
            fail(f"(ah) load_bundle put the bundle on {b.device}, not {es.device}")
        one = rng.standard_normal(3).astype(np.float32)
        anchor = rng.standard_normal((SERVE_MAX_BATCH, 3)).astype(np.float32)
        for label, x in (("one observation", one), ("anchor batch", anchor)):
            got, want = b.predict(x).cpu().numpy(), es.predict(x).cpu().numpy()
            if got.tobytes() != want.tobytes():
                fail(f"(ah) Bundle.predict != ES.predict for {label}: "
                     f"max |err| {np.abs(got - want).max():g}")
        ref = es.predict(anchor).cpu().numpy()
        if b.batched_predict_fn()(anchor).tobytes() != ref.tobytes():
            fail("(ah) the batcher's program != ES.predict at the anchor shape")
        cpu = load_bundle(bundle, device="cpu").predict(anchor).numpy()
        card_cpu = float(np.abs(cpu - ref).max() / np.abs(ref).max())
        if not card_cpu <= 1e-6:
            fail(f"(ah) the bundle on the card vs the CPU: {card_cpu:g} of scale > 1e-6")
        warm = b.warm_info
        print(f"(ah) bundle exported in {out['export_s']:.2f} s (warm replay {warm['warm_s']} s "
              f"on {warm['device_kind']}: buckets {warm['buckets']}, excluded "
              f"{warm['buckets_excluded']}); Bundle.predict == ES.predict bit for bit (one "
              f"observation, batch {SERVE_MAX_BATCH}); card vs CPU {card_cpu:.3g} of scale "
              "(tol 1e-6)")
        qb = build_serving_batcher(b, max_batch=SERVE_MAX_BATCH, dtype="bf16")
        try:
            div = {int(k): v for k, v in qb.quant_divergence.items()}
            if any(div[k] > BF16_DIVERGENCE_BOUND for k in qb.quant_buckets):
                fail(f"(ah) a kept bf16 bucket past the bound: {div}")
            got16 = qb.predict(one, timeout=30.0)
            ref1 = float(np.abs(ref).max())
            want16 = _pad_predict(es, one, SERVE_MAX_BATCH)
            err16 = float(np.abs(got16 - want16).max()) / ref1
            if not err16 <= BF16_DIVERGENCE_BOUND:
                fail(f"(ah) a bf16 answer {err16:g} of scale past {BF16_DIVERGENCE_BOUND}")
        finally:
            qb.close()
        print(f"(ah) bf16: divergence by bucket {div}, kept {list(qb.quant_buckets)}, excluded "
              f"{list(qb.quant_buckets_excluded)}; an answer {err16:.3g} of scale (bound "
              f"{BF16_DIVERGENCE_BOUND})")
        out.update(card_vs_cpu=card_cpu, bf16_divergence=div, bf16_answer_err=err16,
                   warm_block={k: warm[k] for k in ("buckets", "buckets_excluded", "warm_s")})
        launches = dict(nk.launch_counts)
        if any(launches.values()):
            fail(f"(ah) serving launched the port's kernels: {launches}")
        out["serving_launches"] = launches
        out["forward_alone"] = served_forward(torch, b, "ah")

        # (ai) ----------------------------------------------------------------
        proc, ready, spawn_s = spawn_server(bundle, SERVE_MAX_BATCH, "--port-file",
                                            os.path.join(work, "port.json"))
        try:
            dev = ready["device"]
            if dev != describe_device(es.device) or dev["kind"] != name:
                fail(f"(ai) the ready line names {dev}, not {name}")
            cold_first = first_request_ms(ready["url"], obs_list)
            rows, bad = served_rows(ready["url"], anchor)
            if bad or rows.tobytes() != ref.tobytes():
                fail(f"(ai) served rows != ES.predict on the anchor batch ({bad} errors+shed)")
            dyn = dynamic_leg(ready["url"], obs_list, "ai")
            with ServeClient(ready["url"]) as c:
                if c.reload(best)["version"] != "cell-best":
                    fail("(ai) /reload did not swap the bundle")
                x = anchor[:1]
                got = np.asarray(c.predict(x[0]), np.float32)
                stats = c.stats()
            want = _pad_predict(es, x[0], max(stats["buckets"]), use_best=True)
            if got.tobytes() != want.tobytes():
                fail("(ai) after /reload the answer != ES.predict(use_best=True)")
            # SIGTERM with 12 requests in flight: each gets a real answer
            clients = [ServeClient(ready["url"], timeout_s=60) for _ in range(12)]
            for c in clients:
                c.health()
            results, errors = [None] * 12, []

            def client(i):
                try:
                    results[i] = clients[i].predict(anchor[i])
                except Exception as e:  # noqa: BLE001 — failed on below
                    errors.append((i, repr(e)))
                finally:
                    clients[i].close()

            threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
            for t in threads:
                t.start()
            time.sleep(0.02)
            rc, final = stop_server(proc)
            for t in threads:
                t.join(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        shed = final["counters"].get("shed_total", 0)
        want12 = es.predict(np.concatenate(
            [anchor[:12], np.zeros((SERVE_MAX_BATCH - 12, 3), np.float32)]),
            use_best=True).cpu().numpy()[:12]
        if (errors or rc != 0 or not final["clean"] or shed
                or np.asarray(results, np.float32).tobytes() != want12.tobytes()):
            fail(f"(ai) SIGTERM drain: exit {rc}, clean {final['clean']}, shed {shed}, "
                 f"errors {errors}")
        print(f"(ai) server on {dev['kind']}: ready {spawn_s:.2f} s after spawn (startup_s "
              f"{ready['cold_start']['startup_s']}, compiles_at_load "
              f"{ready['cold_start']['compiles_at_load']}), buckets {ready['buckets']}, excluded "
              f"{ready['buckets_excluded']}; first request {cold_first:.2f} ms; 64 rows bit-equal "
              "to ES.predict; /reload answered as ES.predict(use_best=True); SIGTERM drained 12 "
              "in flight (exit 0, 0 shed)")
        wproc, wready, wspawn_s = spawn_server(bundle, SERVE_MAX_BATCH, "--warm")
        try:
            warm_first = first_request_ms(wready["url"], obs_list)
            wrc, wfinal = stop_server(wproc)
        finally:
            if wproc.poll() is None:
                wproc.kill()
                wproc.wait(timeout=30)
        if wrc != 0 or not wfinal["clean"]:
            fail(f"(ai) the --warm server exited {wrc}")
        print(f"(ai) --warm: ready {wspawn_s:.2f} s after spawn, first request "
              f"{warm_first:.2f} ms")
        out.update(buckets=ready["buckets"], buckets_excluded=ready["buckets_excluded"],
                   spawn_to_ready_s={"cold": spawn_s, "warm": wspawn_s},
                   first_request_ms={"cold": cold_first, "warm": warm_first},
                   compiles_at_load=ready["cold_start"]["compiles_at_load"],
                   warm_status=ready["cold_start"]["warm"])
        b1 = batch1_leg(bundle, obs_list, "ai")
        out["load_cell"] = {"batch1": b1, "dynamic": dyn,
                            "ratio": dyn["throughput_rps"] / b1["throughput_rps"]}
        # phase 17's canaries: the same parameters re-exported, and one
        # parameter moved (the parity gate's target)
        es.export_bundle(os.path.join(fleet_dir, FLEET_BUNDLES[1]), version="cell-g3-reexport")
        center = es.state.params_flat
        moved = center.clone()
        moved[7] += 1e-3
        es.state = es.state._replace(params_flat=moved)
        es.export_bundle(os.path.join(fleet_dir, FLEET_BUNDLES[2]), version="cell-g3-moved")
        es.state = es.state._replace(params_flat=center)
        np.save(os.path.join(fleet_dir, "anchor.npy"), anchor)
        np.save(os.path.join(fleet_dir, "ref.npy"), ref)
        del es, b

        # (aj) ----------------------------------------------------------------
        big = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=8), adam, population_size=4,
                 sigma=0.05, table_size=DEMO_TABLE,
                 policy_kwargs=dict(POLICY, hidden=(DEMO_HIDDEN, DEMO_HIDDEN)),
                 optimizer_kwargs={"learning_rate": 1e-2})
        big.train(1, verbose=False)
        big_bundle = big.export_bundle(os.path.join(work, "big"), version="demo")
        big_ref = big.predict(anchor).cpu().numpy()
        big_forward = served_forward(torch, load_bundle(big_bundle), "aj")
        proc, ready, big_spawn_s = spawn_server(big_bundle, SERVE_MAX_BATCH)
        try:
            big_first = first_request_ms(ready["url"], obs_list)
            rows, bad = served_rows(ready["url"], anchor)
            dyn = dynamic_leg(ready["url"], obs_list, "aj")
            rc, final = stop_server(proc)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        if bad or rc != 0 or rows.tobytes() != big_ref.tobytes():
            fail(f"(aj) served rows at width {DEMO_HIDDEN} != ES.predict ({bad} errors+shed, "
                 f"exit {rc})")
        print(f"(aj) MLP {DEMO_HIDDEN}x{DEMO_HIDDEN} ({big.spec.dim:,} params): ready "
              f"{big_spawn_s:.2f} s after spawn, buckets {ready['buckets']}, excluded "
              f"{ready['buckets_excluded']}, first request {big_first:.2f} ms; 64 rows "
              "bit-equal to ES.predict")
        out["big"] = {"params": big.spec.dim, "buckets": ready["buckets"],
                      "buckets_excluded": ready["buckets_excluded"],
                      "spawn_to_ready_s": big_spawn_s, "first_request_ms": big_first,
                      "forward_alone": big_forward, "load": {"dynamic": dyn}}
        b1 = batch1_leg(big_bundle, obs_list, "aj")
        out["big"]["load"].update(batch1=b1, ratio=dyn["throughput_rps"] / b1["throughput_rps"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_start
    print(f"phase 15: {out['phase_s']:.1f} s on {card}")
    return out


def served_forward(torch, bundle, label: str, reps: int = 50) -> dict:
    """The served batched forward (``Bundle.batched_predict_fn``: the
    observations copied to the card, normalize, the policy, the answer
    copied back) in this process, alone, at the two served shapes, 1 row
    and ``SERVE_MAX_BATCH`` rows: host wall a call over ``reps`` calls
    (after 3 warm-up calls), then the card's busy time a call from
    torch.profiler's device events over ``reps`` more.  Set beside a load
    leg's ``forward_ms_per_batch``, it says how much of the forward under
    load is the card's work, how much the host's dispatch, and how much
    waiting (the GIL, shared with the handler threads)."""
    import numpy as np

    fn = bundle.batched_predict_fn()
    out = {}
    for rows in (1, SERVE_MAX_BATCH):
        x = np.random.default_rng(rows).standard_normal((rows,) + bundle.obs_shape).astype(
            np.float32)
        for _ in range(3):
            fn(x)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(x)
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
        events = device_events(torch, lambda: [fn(x) for _ in range(reps)])
        busy_ms = sum(ns for _, ns in events) / reps / 1e6
        out[rows] = {"wall_ms": wall_ms, "device_ms": busy_ms,
                     "kernels": kernel_launches(events) / reps}
        print(f"({label}) forward alone at {rows} rows: {wall_ms:.4f} ms a call on the host's "
              f"clock, card busy {busy_ms:.4f} ms ({busy_ms / wall_ms:.1%}), "
              f"{out[rows]['kernels']:.1f} kernels a call")
    return out


def _pad_predict(es, obs, anchor: int, use_best: bool = False):
    """``ES.predict`` of one observation in row 0 of an ``anchor``-sized
    zero-padded batch: the reference for a lone served request (the batcher
    pads into a verified bucket, whose rows equal the anchor's)."""
    import numpy as np

    pad = np.zeros((anchor,) + np.shape(obs), np.float32)
    pad[0] = obs
    return es.predict(pad, use_best=use_best).cpu().numpy()[0]


# ---------------------------------------------------------------------
# phase 16, scenarios on the card: the cell under docs/scenarios.md's own
# recipe, (g) under drawn chain scales, and PBT on the cell
# ---------------------------------------------------------------------

SCENARIO_VARIANTS = 10  # docs/scenarios.md's recipe
SCENARIO_SWEEP = (1, 10, 1000)  # n_variants whose launches an env step must be equal


def scenario_cell(tt, n_variants: int = SCENARIO_VARIANTS, **over):
    """The main path's cell under ``default_distribution(Pendulum(),
    n_variants, spread=0.3, obs_noise=0.05, seed=1)``, on the card."""
    from estorch_tpu_torch.scenarios import default_distribution

    kw = dict(population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
              optimizer_kwargs={"learning_rate": 1e-2}, **STREAMED)
    kw.update(over)
    dist = default_distribution(tt.Pendulum(), n_variants=n_variants, spread=0.3,
                                obs_noise=0.05, seed=1)
    optimizer = kw.pop("optimizer", tt.adam)
    if not isinstance(optimizer, type) and hasattr(optimizer, "init"):
        kw.pop("optimizer_kwargs")
    return tt.ES(tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON), optimizer,
                 scenarios=dist, **kw)


def _check_records(label: str, es) -> None:
    for r in es.history:
        if r["n_failed"] or not all(math.isfinite(r[k])
                                    for k in ("reward_mean", "reward_max", "grad_norm")):
            fail(f"{label}, generation {r['generation']}: non-finite result {r}")
        blk = r.get("scenarios")
        if not blk or sum(blk["counts"]) != es.population_size:
            fail(f"{label}, generation {r['generation']}: scenarios block {blk}")


def launches_per_env_step(torch, es, reps: int = 3) -> float:
    """Kernel launches an env step of one engine generation (1 chunk), from
    torch.profiler's device events, after ``es``'s warm-up generation.  The
    engine's generation alone: ``ES.train``'s record keeps a new best's
    params, a data-dependent handful of launches outside it.  The profiler
    now and then drops events and never adds one (on an H100, one of 15
    profiles of the scenario cell's ~22,700 launches read 74 short, and
    this script's read up to 39 short), so the count is the largest of
    ``reps`` profiles of the same generation."""
    return max(kernel_launches(device_events(torch, lambda: es.engine.generation_step(es.state)))
               for _ in range(reps)) / es.config.horizon


def dispatched_ops(torch, es) -> int:
    """The aten ops one engine generation dispatches (a ``TorchDispatchMode``
    count: exact, where the profiler's kernel count can lose events)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        es.engine.generation_step(es.state)
    torch.cuda.synchronize()
    return Count.n


def compare_scenarios_card_cpu(torch, tt) -> list[dict]:
    """Phase 4, scenarios: a randomized generation on the card against the
    CPU, at the bound phase 4 holds the device path to.  (1) The cell's
    recipe with observation noise (streamed + kernel update, population 64,
    horizon 50, Adam, 2 generations): reward_mean within 1e-4 relative and
    params within 1e-4, as the float32 paths of ``compare_card_cpu``.  The
    noise is an integer hash of the state, equal on both devices, then
    Box-Muller's log, sqrt and cos, which each device rounds its own way
    (a few ulps: the normals are compared at 1e-5).  (2) Cheetah2D under
    drawn chain scales at population 64, horizon 20, SGD, held as
    ``compare_envs_card_cpu`` holds the envs (reward means within 1e-4 of
    max(|mean|, 1), update cosine 0.999)."""
    from estorch_tpu_torch.scenarios import default_distribution
    from estorch_tpu_torch.scenarios.env import obs_noise_normals

    out = []
    g = torch.Generator().manual_seed(0)
    ids = torch.stack([torch.randint(0, 1 << 24, (4096,), generator=g),
                       torch.randint(0, 1000, (4096,), generator=g)], 1).to(torch.float32)
    z_cpu = obs_noise_normals(ids, 17)
    z_gpu = obs_noise_normals(ids.cuda(), 17).cpu()
    z_err = float((z_gpu - z_cpu).abs().max())
    print(f"card vs CPU, observation-noise normals (4096 rows x 17): max |err| {z_err:.3g} "
          "(tol 1e-5)")
    if not z_err <= 1e-5:
        fail(f"card vs CPU, observation-noise normals: max |err| {z_err:g}")
    dist = default_distribution(tt.Pendulum(), n_variants=SCENARIO_VARIANTS, spread=0.3,
                                obs_noise=0.05, seed=1)
    small = dict(population_size=64, sigma=0.05, policy_kwargs=POLICY, scenarios=dist,
                 optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 22, **STREAMED)
    es_gpu = tt.ES(tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=50), tt.adam, **small)
    es_cpu = tt.ES(tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=50), tt.adam,
                   device="cpu", **small)
    es_gpu.train(2, verbose=False)
    es_cpu.train(2, verbose=False)
    fit_err = max(abs(a["reward_mean"] - b["reward_mean"]) / abs(b["reward_mean"])
                  for a, b in zip(es_gpu.history, es_cpu.history))
    p_err = float((es_gpu.state.params_flat.cpu() - es_cpu.state.params_flat).abs().max())
    same_blocks = all(a["scenarios"]["counts"] == b["scenarios"]["counts"]
                      for a, b in zip(es_gpu.history, es_cpu.history))
    rec = {"env": "scenarios: cell recipe with obs noise", "reward_mean_rel_err": fit_err,
           "params_max_abs_err": p_err, "same_variant_counts": same_blocks,
           "noise_normals_max_abs_err": z_err}
    print(f"card vs CPU, scenarios (cell recipe, obs noise, pop 64, horizon 50, 2 generations): "
          f"reward_mean rel err {fit_err:.3g} (tol 1e-4), params max |err| {p_err:.3g} "
          f"(tol 1e-4), variant counts equal {same_blocks}")
    if not (fit_err <= 1e-4 and p_err <= 1e-4 and same_blocks):
        fail(f"card vs CPU, scenarios: {rec}")
    out.append(rec)
    env = tt.Cheetah2D()
    kw = dict(population_size=64, sigma=0.05, table_size=1 << 22,
              scenarios=default_distribution(env, n_variants=SCENARIO_VARIANTS, spread=0.3,
                                             seed=1),
              optimizer_kwargs={"learning_rate": 1e-2},
              policy_kwargs={"action_dim": env.action_dim, "hidden": (64, 64),
                             "discrete": False, "action_scale": 1.0})
    es_gpu = tt.ES(tt.MLPPolicy, tt.DeviceAgent(env, horizon=20), tt.sgd, **kw)
    es_cpu = tt.ES(tt.MLPPolicy, tt.DeviceAgent(env, horizon=20), tt.sgd, device="cpu", **kw)
    p0 = es_cpu.state.params_flat.clone()
    es_gpu.train(2, verbose=False)
    es_cpu.train(2, verbose=False)
    fit_err = max(abs(a["reward_mean"] - b["reward_mean"]) / max(abs(b["reward_mean"]), 1.0)
                  for a, b in zip(es_gpu.history, es_cpu.history))
    dg, dc = es_gpu.state.params_flat.cpu() - p0, es_cpu.state.params_flat - p0
    cos = float(dg @ dc / (dg.norm() * dc.norm()))
    rec = {"env": "scenarios: Cheetah2D chain scales", "reward_mean_rel_err": fit_err,
           "cosine": cos, "params_max_abs_err": float((dg - dc).abs().max())}
    print(f"card vs CPU, scenarios Cheetah2D (pop 64, horizon 20, 2 generations, SGD): "
          f"reward_mean err {fit_err:.3g} (tol 1e-4), param change cosine {cos:.7f} "
          "(tol 0.999)")
    if not (fit_err <= 1e-4 and cos >= 0.999):
        fail(f"card vs CPU, scenarios Cheetah2D: {rec}")
    out.append(rec)
    return out


def run_scenarios(torch, tt, nk, card: str, cell: dict, g_path: dict) -> dict:
    """Phase 16: (ak) the cell under the docs' recipe, 1 warm-up and 3 timed
    generations: env-steps/s and busy share beside phase 3's unrandomized
    cell (``cell``) in this run, both kernels' exact launches (600 matvec
    and 1 reduction a generation), every variant covered, the twins'
    variants equal, and the launches an env step from a profiled generation
    at n_variants 1, 10 and 1000 (equal); (al) (g)'s Cheetah2D streamed
    configuration under ``default_distribution(Cheetah2D(), 10, spread=0.3,
    seed=1)``, 1 + 1 generations, launches exact, then the launches an env
    step beside (g)'s (``g_path``) from its profiled generation, and exactly
    from one generation of each at horizon 20; (am) ``PBTController(n_centers=3, explore_every=2,
    seed=7)`` with a ``tunable_optimizer`` on the cell, 4 generations a
    center, replayed bit for bit on a fresh ES."""
    import numpy as np

    from estorch_tpu_torch import configs
    from estorch_tpu_torch.scenarios import (PBTController, default_distribution,
                                             tunable_optimizer, variant_of_bc)

    t_phase = time.perf_counter()
    out: dict = {"path": "scenarios (phase 16)", "cell": "streamed (phase 3)"}

    # (ak) the cell under scenarios
    torch.cuda.empty_cache()
    es = scenario_cell(tt)
    if es.device.type != "cuda":
        fail(f"(ak) ran on {es.device}")
    p0 = es.state.params_flat.clone()
    torch.cuda.synchronize()
    nk.reset_launch_counts()
    es.train(1, verbose=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    es.train(GENERATIONS - 1, verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(nk.launch_counts)
    want = {"population_noise_matvec": 3 * HORIZON * GENERATIONS,
            "weighted_noise_sum": GENERATIONS}
    if counts != want:
        fail(f"(ak) launch counts {counts}, expected {want}")
    _check_records("(ak)", es)
    if torch.equal(p0, es.state.params_flat):
        fail("(ak) params did not change")
    covered = sorted({v for r in es.history for v, c in enumerate(r["scenarios"]["counts"]) if c})
    if covered != list(range(SCENARIO_VARIANTS)):
        fail(f"(ak) variants covered {covered}")
    steps = sum(r["env_steps"] for r in es.history[1:])
    gen_s = dt / (GENERATIONS - 1)
    ev = es.engine.evaluate(es.state)  # after the counts: not part of them
    v = variant_of_bc(ev.bc)
    if not np.array_equal(v[0::2], v[1::2]):
        fail("(ak) the twins of a pair ran different variants")
    busy, _ = profile_generation(torch, es, top=8)
    per_step = {SCENARIO_VARIANTS: launches_per_env_step(torch, es)}
    ops = {SCENARIO_VARIANTS: dispatched_ops(torch, es)}
    ak = {"launches": counts, "env_steps_per_s": steps / dt, "s_per_generation": gen_s,
          "device_busy_s": busy, "busy_share": busy / gen_s, "variants_covered": len(covered),
          "twins_share_variants": True,
          "vs_cell": {"env_steps_per_s": cell["env_steps_per_s"],
                      "busy_share": cell["busy_share"],
                      "kernel_launches_per_env_step_profiled": cell[
                          "kernel_launches_per_env_step"]},
          "reward_mean": [r["reward_mean"] for r in es.history]}
    print(f"(ak) scenarios cell: {steps / dt:.0f} env-steps/s over 3 generations ({gen_s:.4f} s a "
          f"generation) on {card}, busy share {busy / gen_s:.3f}; phase 3's cell "
          f"{cell['env_steps_per_s']:.0f} env-steps/s, busy {cell['busy_share']:.3f}; launches "
          f"{counts}; {len(covered)} variants covered; twins share variants")
    del es
    for nv in SCENARIO_SWEEP + (0,):  # 0: the cell without scenarios
        if nv == SCENARIO_VARIANTS:
            continue
        torch.cuda.empty_cache()
        es = (scenario_cell(tt, n_variants=nv) if nv else tt.ES(
            tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=HORIZON), tt.adam,
            population_size=POPULATION, sigma=0.05, policy_kwargs=POLICY,
            optimizer_kwargs={"learning_rate": 1e-2}, **STREAMED))
        es.train(1, verbose=False)
        torch.cuda.synchronize()
        per_step[nv] = launches_per_env_step(torch, es)
        ops[nv] = dispatched_ops(torch, es)
        del es
    ak["kernel_launches_per_env_step"] = {str(k): per_step[k] for k in SCENARIO_SWEEP}
    ak["cell_kernel_launches_per_env_step"] = per_step[0]
    ak["aten_ops_per_generation"] = {str(k): ops[k] for k in SCENARIO_SWEEP + (0,)}
    print(f"(ak) kernel launches an env step of an engine generation at n_variants "
          f"{SCENARIO_SWEEP}: {[per_step[k] for k in SCENARIO_SWEEP]} (aten ops a generation "
          f"{[ops[k] for k in SCENARIO_SWEEP]}); the cell without scenarios {per_step[0]} "
          f"({ops[0]})")
    if len({per_step[k] for k in SCENARIO_SWEEP}) != 1 or len({ops[k] for k in SCENARIO_SWEEP}) != 1:
        fail(f"(ak) launches an env step depend on the variant count: {per_step}, aten ops "
             f"{ops}")
    out["ak"] = ak

    # (al) (g) under drawn chain scales
    torch.cuda.empty_cache()
    env = tt.Cheetah2D()
    es = configs.cheetah2d_device(
        agent_kwargs={"env": env, "horizon": LOCO_HORIZON},
        scenarios=default_distribution(env, n_variants=SCENARIO_VARIANTS, spread=0.3, seed=1),
        **STREAMED)
    nk.reset_launch_counts()
    es.train(1, verbose=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    es.train(1, verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(nk.launch_counts)
    want = {"population_noise_matvec": 3 * LOCO_HORIZON * 2, "weighted_noise_sum": 2}
    if counts != want:
        fail(f"(al) launch counts {counts}, expected {want}")
    _check_records("(al)", es)
    es_steps = es.history[1]["env_steps"]
    busy, launched = profile_generation(torch, es, top=6)
    al_step = launched / LOCO_HORIZON
    del es
    # the launches an env step exactly: at horizon 200 a generation's ~150,000
    # launches overflow what the profiler keeps; at 20 it keeps every one
    exact = {}
    for label, dist in (("g", None), ("al", default_distribution(
            env, n_variants=SCENARIO_VARIANTS, spread=0.3, seed=1))):
        es = configs.cheetah2d_device(agent_kwargs={"env": env, "horizon": 20},
                                      scenarios=dist, **STREAMED)
        es.train(1, verbose=False)
        torch.cuda.synchronize()
        exact[label] = launches_per_env_step(torch, es)
        del es
    out["al"] = {"launches": counts, "env_steps_per_s": es_steps / dt,
                 "s_per_generation": dt, "busy_share": busy / dt,
                 "kernel_launches_per_env_step_profiled_h200": al_step,
                 "kernel_launches_per_env_step_h20": exact["al"],
                 "g_kernel_launches_per_env_step_h20": exact["g"],
                 "vs_g": {k: g_path[k] for k in ("env_steps_per_s", "s_per_generation",
                                                 "busy_share", "kernel_launches_per_env_step")}}
    print(f"(al) Cheetah2D streamed under chain scales: {es_steps / dt:.0f} env-steps/s (alive), "
          f"{dt:.4f} s a generation; launches {counts}; kernel launches an env step at horizon "
          f"20 {exact['al']:.2f} against (g)'s {exact['g']:.2f} (profiled at 200: "
          f"{al_step:.1f} against (g)'s {g_path['kernel_launches_per_env_step']:.1f})")

    # (am) PBT on the cell, replayed
    def pbt_es():
        return scenario_cell(tt, optimizer=tunable_optimizer(learning_rate=1e-2))

    torch.cuda.empty_cache()
    es = pbt_es()
    nk.reset_launch_counts()
    t0 = time.perf_counter()
    log = PBTController(es, n_centers=3, explore_every=2, seed=7).run(4, verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(nk.launch_counts)
    want = {"population_noise_matvec": 3 * HORIZON * 12, "weighted_noise_sum": 12}
    if counts != want:
        fail(f"(am) launch counts {counts}, expected {want}")
    _check_records("(am)", es)
    live = [s.params_flat.clone() for s in es.meta_states]
    del es
    es = pbt_es()
    t1 = time.perf_counter()
    PBTController(es, n_centers=3, explore_every=2, seed=7).run(
        4, verbose=False, replay=json.loads(json.dumps(log)))
    torch.cuda.synchronize()
    dt_replay = time.perf_counter() - t1
    same = all(torch.equal(a, b.params_flat) for a, b in zip(live, es.meta_states))
    if not same:
        fail("(am) the PBT replay is not bit-identical to the live run")
    exploits = [e for e in log["events"] if e["type"] == "exploit"]
    out["am"] = {"launches": counts, "s_live": dt, "s_replay": dt_replay,
                 "exploits": len(exploits), "best_center": log["final"]["best_center"],
                 "hypers": log["final"]["hypers"], "replay_bit_identical": True}
    print(f"(am) PBT 3 centers x 4 generations on the cell: {dt:.2f} s live, {dt_replay:.2f} s "
          f"replayed bit-identical; {len(exploits)} exploits, best center "
          f"{log['final']['best_center']}, hypers {log['final']['hypers']}; launches {counts}")
    del es
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 16: {out['phase_s']:.1f} s on {card}")
    return out


# ---------------------------------------------------------------------
# phase 17, the fleet on the card: phase 15's cell bundle behind the real
# ``serve route --fleet``, its chaos, rollouts, scaling and observability
# ---------------------------------------------------------------------

FLEET_BUNDLES = ("cell", "reexport", "moved")  # phase 15 exports them into the fleet dir
FLEET_SERVE = {"max_batch": SERVE_MAX_BATCH}  # fleet.json's serve block: device cuda by default
FLEET_CONNS = 48  # (ao)'s and (as)'s closed loop, as phase 15's dynamic leg
FLEET_KILL_LOAD_S = 6.0  # (ao): the load across the declared SIGKILL
FLEET_LEG_S = SERVE_LOAD_S  # (as): each leg
FLEET_ROUTER = {"retry_budget": 2, "breaker_open_s": 0.5, "upstream_timeout_s": 10.0,
                "poll_interval_s": 0.25, "poll_timeout_s": 1.0}
FLEET_SLO_MS = 50.0  # (ar)'s capacity sweep: p99 at or under this, per offered rate
FLEET_ROLLOUT = {"shadow_fraction": 0.9, "min_shadow": 24, "parity_samples": 8,
                 "window_s": 30.0}
# the wedge's fleet: the JAX package's wedge test's timeouts (tests/test_fleet.py:741)
WEDGE_ROUTER = {"breaker_open_s": 0.5, "poll_interval_s": 0.25, "poll_timeout_s": 1.0,
                "upstream_timeout_s": 3.0}
WEDGE_CONNS = 16
WEDGE_RESPAWN = {"backoff_s": 0.2, "wedge_kill_s": 2.0}


def _http_json(url: str, payload=None, timeout: float = 30.0):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    headers = {"Content-Type": "application/json"} if data is not None else {}
    with urllib.request.urlopen(urllib.request.Request(url, data, headers),
                                timeout=timeout) as r:
        return json.loads(r.read())


def _poll_until(fn, timeout_s: float, what: str, step_s: float = 0.1):
    """``fn()``'s first truthy value within ``timeout_s`` (an HTTP error
    counts as not yet); fails the script on the timeout."""
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        try:
            got = fn()
        except (OSError, ValueError):
            got = None
        if got:
            return got
        time.sleep(step_s)
    fail(f"timed out after {timeout_s} s waiting for {what}")


def _router_failures(url: str, last: int = 6) -> list:
    """The router's sampled failed legs (``/traces``: an error is always
    sampled), for a failure message."""
    try:
        segs = _http_json(url + "/traces?since=0", timeout=10.0)["segments"]
    except (OSError, ValueError, KeyError):
        return []
    bad = [(x["name"], x["attrs"]) for x in segs
           if (x.get("attrs") or {}).get("error") or (x.get("attrs") or {}).get("status", 200) >= 500]
    return bad[-last:]


def _stop_group(proc, grace_s: float = 60.0) -> None:
    """Stop a fleet started in a session of its own: SIGTERM to its process
    group (the supervisor drains and stops its replicas), then SIGKILL to
    whatever is left of the group.  A supervisor killed alone would leave
    its replicas running."""
    import signal

    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            break
        try:
            proc.wait(timeout=grace_s if sig == signal.SIGTERM else 30.0)
        except subprocess.TimeoutExpired:
            pass


def _ready_lines(workdir: str, slot: str) -> list[dict]:
    """The ready lines a slot's replicas printed, first spawn first."""
    out = []
    with open(os.path.join(workdir, f"{slot}.log")) as f:
        for line in f:
            if line.startswith('{"ready"'):
                out.append(json.loads(line))
    return out


class _Background:
    """Closed-loop load through ``addr`` in half-second windows until
    stopped (each window a ``run_load``), errors and shed summed."""

    def __init__(self, addr: str, obs: list, conns: int = 8):
        import threading

        from estorch_tpu_torch.serve.loadgen import run_load

        self.addr = addr
        self.res = {"requests": 0, "errors": 0, "shed": 0}
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                r = run_load(addr, conns=conns, duration_s=0.5, obs=obs, timeout_s=60.0)
                for k in self.res:
                    self.res[k] += r[k]

        self._t = threading.Thread(target=loop, daemon=True)
        self._t.start()

    def stop(self, label: str) -> dict:
        self._stop.set()
        self._t.join(timeout=120)
        if self._t.is_alive() or self.res["errors"] or self.res["shed"] \
                or not self.res["requests"]:
            fail(f"{label}: the background load {self.res}; failed legs "
                 f"{_router_failures('http://' + self.addr)}")
        return self.res


class _SlotWatch:
    """``GET /scale`` every 0.1 s: each slot's state over time, for the
    seconds from a replica's death seen to its respawn answering."""

    def __init__(self, url: str):
        import threading

        self.rows: list[tuple[float, dict]] = []
        self._stop = threading.Event()

        def loop():
            while not self._stop.is_set():
                try:
                    s = _http_json(url + "/scale", timeout=5.0)
                    self.rows.append((time.perf_counter(),
                                      {x["name"]: x["state"] for x in s["slots"]}))
                except (OSError, ValueError):
                    pass
                self._stop.wait(0.1)

        self._t = threading.Thread(target=loop, daemon=True)
        self._t.start()

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=30)

    def outage(self, name: str) -> tuple[float, float] | None:
        """(first time ``name`` was seen not up, first time up after it)."""
        down = None
        for t, states in self.rows:
            if down is None and states.get(name) != "up":
                down = t
            elif down is not None and states.get(name) == "up":
                return down, t
        return None


def _fleet_leg(addr: str, obs: list, label: str) -> dict:
    """(as): ``run_load`` closed loop, ``FLEET_CONNS`` connections for
    ``FLEET_LEG_S``; gated on errors and shed only."""
    from estorch_tpu_torch.serve.loadgen import run_load

    res = run_load(addr, conns=FLEET_CONNS, duration_s=FLEET_LEG_S, obs=obs, timeout_s=60.0)
    if res["errors"] or res["shed"]:
        fail(f"(as) {label}: errors {res['errors']}, shed {res['shed']}; failed legs "
             f"{_router_failures('http://' + addr)}")
    out = {"conns": FLEET_CONNS, "requests": res["requests"],
           "throughput_rps": res["throughput_rps"], "p50_ms": res["latency_ms"]["p50"],
           "p99_ms": res["latency_ms"]["p99"]}
    print(f"(as) {label}: {out['throughput_rps']} req/s, p50 {out['p50_ms']} ms, p99 "
          f"{out['p99_ms']} ms over {out['requests']} requests ({FLEET_CONNS} conns)")
    return out


def _file_run_router_probe(addrs: dict, fleet_json: str, obs) -> dict:
    """The router and the fleet supervisor loaded as files in a fresh
    process (tests/test_fleet.py:447-525's probe): a Router over the live
    replicas answers ``obs``, and the process has imported neither torch
    nor any package."""
    probe = (
        "import importlib.util, json, sys, time, urllib.request\n"
        "def load(p):\n"
        "    spec = importlib.util.spec_from_file_location('m' + str(abs(hash(p))), p)\n"
        "    m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); return m\n"
        f"router_mod = load({os.path.join(HERE, 'estorch_tpu_torch', 'serve', 'router.py')!r})\n"
        f"fleet_mod = load({os.path.join(HERE, 'estorch_tpu_torch', 'serve', 'fleet.py')!r})\n"
        f"cfg = fleet_mod.load_fleet_config({fleet_json!r})\n"
        f"router = router_mod.Router({sorted(addrs.items())!r}, port=0)\n"
        "router.start_background()\n"
        "url = f'http://{router.host}:{router.port}/predict'\n"
        "answers = []\n"
        f"for o in {[list(map(float, o)) for o in obs]!r}:\n"
        "    req = urllib.request.Request(url, json.dumps({'obs': o}).encode(),"
        " {'Content-Type': 'application/json'})\n"
        "    for _ in range(100):\n"
        "        try:\n"
        "            answers.append(json.loads(urllib.request.urlopen(req, timeout=30).read())"
        "['action']); break\n"
        "        except OSError:\n"
        "            time.sleep(0.1)\n"
        "router.shutdown(drain=False)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'estorch_tpu', 'estorch_tpu_torch'))\n"
        "print(json.dumps({'answers': answers, 'loaded': bad, 'replicas': cfg['replicas']}))\n")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                       timeout=120, cwd=HERE)
    if r.returncode != 0:
        fail(f"(an) the file-run router probe exited {r.returncode}: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def fleet_wedge_child(fleet_json: str, workdir: str) -> None:
    """The wedge leg's supervisor process (run by phase 17 as ``python -c
    "import chip_smoke; chip_smoke.fleet_wedge_child(...)"``): the fleet
    and the loadgen loaded as files, never torch or the package.  It
    starts the fleet on the card, declares ``wedge_replica`` (a SIGSTOP of
    replica 0 half a second into serving) under closed-loop load, waits
    for the escalation to SIGKILL and the respawn, and prints one JSON
    line of what happened, with the modules it loaded."""
    import importlib.util

    def load(name: str, *rel: str):
        spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, *rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    fleet_mod = load("_fleet", "estorch_tpu_torch", "serve", "fleet.py")
    loadgen = load("_loadgen", "estorch_tpu_torch", "serve", "loadgen.py")
    fleet = fleet_mod.Fleet(fleet_mod.load_fleet_config(fleet_json), workdir, port=0)
    t0 = time.perf_counter()
    fleet.start()
    out: dict = {}
    try:
        if not fleet.wait_ready(300):
            out["error"] = f"not ready: {fleet.status()}"
            return
        out["spawn_to_ready_s"] = time.perf_counter() - t0
        os.environ["ESTORCH_CHAOS"] = json.dumps({
            "events": [{"kind": "wedge_replica", "at_s": 0.5, "replica": 0}],
            "ledger": os.path.join(workdir, "chaos_ledger")})
        fleet.arm_chaos()
        load_res = loadgen.run_load(f"{fleet.router.host}:{fleet.router.port}", conns=WEDGE_CONNS,
                                    duration_s=6.0, obs=[0.1, 0.2, 0.3], timeout_s=60.0)
        out["load"] = {k: load_res[k] for k in ("requests", "errors", "shed",
                                                "throughput_rps", "latency_ms")}
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if (fleet.router.counters.get("fleet_wedge_kills_total")
                    and fleet.slots[0].state == "up"):
                break
            time.sleep(0.1)
        ev = {}
        for e in fleet.events:
            key = e["event"] if e["event"] != "replica_killed" else f"killed:{e['reason']}"
            if e.get("replica") == "r0":
                ev.setdefault(key, []).append(e["ts"])
        out["events"] = ev
        out["wedge_kills"] = fleet.router.counters.get("fleet_wedge_kills_total")
        out["r0_state"] = fleet.slots[0].state
        out["r0_restarts"] = fleet.slots[0].restarts
        out["router"] = {r.name: r.snapshot()["requests"] for r in fleet.router.replicas()}
    finally:
        final = fleet.shutdown()
        out["clean"] = final["clean"]
        out["loaded"] = sorted(k for k in sys.modules if k.split(".")[0] in (
            "torch", "numpy", "jax", "estorch_tpu", "estorch_tpu_torch"))
        print(json.dumps(out, default=float), flush=True)


def run_wedge(fleet_dir: str, bundle: str) -> dict:
    """(ao), the wedge: :func:`fleet_wedge_child` in a fresh process on
    the card, gated on zero client errors, an escalation to SIGKILL within
    the router's poll timeout plus ``wedge_kill_s`` (with 2 s of slack for
    the ticks), a respawn back up, no answer waiting past one
    ``upstream_timeout_s`` and a retry, and a supervisor that never
    imported torch."""
    cfg = os.path.join(fleet_dir, "wedge.json")
    with open(cfg, "w") as f:
        json.dump({"schema": 1, "bundle": bundle, "replicas": 2,
                   "serve": FLEET_SERVE, "router": WEDGE_ROUTER,
                   "respawn": WEDGE_RESPAWN}, f)
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke; chip_smoke.fleet_wedge_child(sys.argv[1], sys.argv[2])",
         cfg, os.path.join(fleet_dir, "wedge_run")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE,
        start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        stdout, stderr = "", "timed out after 600 s"
    finally:
        _stop_group(proc, grace_s=30.0)
    lines = stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"(ao) the wedge's supervisor exited {proc.returncode}: {stderr[-2000:]}")
    out = json.loads(lines[-1])
    if "error" in out:
        fail(f"(ao) wedge: {out['error']}")
    ev = out["events"]
    bound = (WEDGE_ROUTER["poll_interval_s"] + WEDGE_ROUTER["poll_timeout_s"]
             + WEDGE_RESPAWN["wedge_kill_s"] + 2.0)
    try:
        t_wedge = ev["chaos_wedge_replica"][0]
        t_kill = ev["killed:wedged"][0]
        t_up = [t for t in ev["replica_up"] if t > t_kill][0]
    except (KeyError, IndexError):
        fail(f"(ao) wedge: the escalation did not happen: {out}")
    load = out["load"]
    max_ms = load["latency_ms"]["max"]
    if (load["errors"] or load["shed"] or not out["wedge_kills"] or out["r0_state"] != "up"
            or t_kill - t_wedge > bound or max_ms > WEDGE_ROUTER["upstream_timeout_s"] * 1e3
            + 2000.0 or not out["clean"]):
        fail(f"(ao) wedge: {out} (escalation {t_kill - t_wedge:.2f} s against {bound} s)")
    if out["loaded"]:
        fail(f"(an) the wedge's supervisor imported {out['loaded']}")
    res = {"spawn_to_ready_s": out["spawn_to_ready_s"], "wedge_to_kill_s": t_kill - t_wedge,
           "kill_to_up_s": t_up - t_kill, "escalation_bound_s": bound, "load": load,
           "router_requests": out["router"]}
    print(f"(ao) wedge_replica (SIGSTOP of r0 holding its CUDA context) under {WEDGE_CONNS} conns: "
          f"escalated to SIGKILL {res['wedge_to_kill_s']:.2f} s after the wedge (bound "
          f"{bound:.2f} s), respawned up {res['kill_to_up_s']:.2f} s after the kill; "
          f"{load['requests']} requests, 0 errors, p99 {load['latency_ms']['p99']} ms, max "
          f"{max_ms} ms (upstream timeout {WEDGE_ROUTER['upstream_timeout_s']} s); the "
          "supervisor (fleet.py and loadgen.py as files) never imported torch")
    return res


def run_fleet(torch, tt, nk, card: str, name: str, fleet_dir: str) -> dict:
    """Phase 17, the fleet on the card: phase 15's cell bundle (the cell
    trained 1 + 2 generations, exported warm at ``--max-batch 64``, with a
    re-export and one with a parameter moved) behind the real ``python -m
    estorch_tpu_torch.serve route --fleet fleet.json``, its replicas on the
    card (``serve.device`` defaults to ``cuda``).  No kernel of the port
    runs in serving; this process's launch counts stay 0 (the replicas are
    other processes).

    (ao) ``ESTORCH_CHAOS`` ``kill_replica`` at ``at_s`` 2.0 (counted from
    the fleet's readiness) under ``run_load`` through the router (48
    connections, 6 s): zero client errors, the breaker opened, the
    respawned replica up with ``compiles_at_load == 0`` and answering its
    sibling's bits, the seconds from the death seen to the respawn up;
    then ``wedge_replica`` in a fleet of its own (:func:`run_wedge`);
    (an) 64 distinct observations through the router bit-equal to
    ``ES.predict`` on the anchor batch, ``/stats`` naming both replicas,
    the ready lines naming the card (with each replica's memory), the
    supervisor process mapping no torch library, and the file-run router
    and fleet answering the same bits without importing torch;
    (ar) the file-run collector over the router and both replicas for 10
    ticks while a capacity sweep runs through the router; ``obs dash
    --once --json`` with every target up, ``obs slow --store`` naming a
    trace, ``obs trace --store`` joining router legs to replica requests,
    and ``obs autoscale`` (dry run, the sweep's capacity model) replayed
    bit for bit with ``--replay``;
    (ap) ``POST /rollout`` of the re-export, promoted with parity passing,
    then of the moved bundle, aborted on the parity gate; every replica
    then answers with the incumbent's bits;
    (aq) ``POST /scale`` 2 -> 3 -> 2 under load: the added slot's
    ``compiles_at_load == 0``, zero client errors across the drain-then-
    retire;
    (as) req/s and p50/p99 (48 connections, 2.5 s each) through 3 replicas
    behind the router, through 1, and of that 1 replica direct.
    """
    import numpy as np

    from estorch_tpu_torch.obs.manifest import describe_device
    from estorch_tpu_torch.serve.loadgen import capacity_sweep, write_capacity_artifact

    t_start = time.perf_counter()
    nk.reset_launch_counts()
    bundle, reexport, moved = (os.path.join(fleet_dir, b) for b in FLEET_BUNDLES)
    anchor = np.load(os.path.join(fleet_dir, "anchor.npy"))
    ref = np.load(os.path.join(fleet_dir, "ref.npy"))
    obs = [0.1, 0.2, 0.3]
    want_dev = describe_device(torch.device("cuda"))
    out: dict = {"path": "fleet (phase 17)", "bundle": "phase 15's cell, max batch 64"}
    workdir = os.path.join(fleet_dir, "run")
    cfg = os.path.join(fleet_dir, "fleet.json")
    with open(cfg, "w") as f:
        json.dump({"schema": 1, "bundle": bundle, "replicas": 2,
                   "serve": FLEET_SERVE, "router": FLEET_ROUTER,
                   "respawn": {"backoff_s": 0.2}, "rollout": FLEET_ROLLOUT}, f)
    env = {**os.environ, "ESTORCH_CHAOS": json.dumps({
        "events": [{"kind": "kill_replica", "at_s": 2.0, "replica": 1}],
        "ledger": os.path.join(fleet_dir, "chaos_ledger")})}
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "estorch_tpu_torch.serve", "route", "--fleet",
                             cfg, "--port", "0", "--workdir", workdir],
                            cwd=HERE, env=env, stdout=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        line = proc.stdout.readline()
        if not line:
            proc.wait(timeout=30)
            fail(f"(an) the fleet exited {proc.returncode} before its ready line")
        ready = json.loads(line)
        url = ready["url"]
        addr = url.split("://", 1)[1]
        router_ready_s = time.perf_counter() - t0
        _poll_until(lambda: _http_json(url + "/scale")["actual"] == 2, 300, "2 replicas up")
        up_s = time.perf_counter() - t0
        two_mib = (free0 - torch.cuda.mem_get_info()[0]) / (1 << 20)

        # (ao) the declared kill, 2 s after the fleet came up ---------------
        watch = _SlotWatch(url)
        from estorch_tpu_torch.serve.loadgen import run_load

        load = run_load(addr, conns=FLEET_CONNS, duration_s=FLEET_KILL_LOAD_S, obs=obs,
                        timeout_s=60.0)
        _poll_until(lambda: watch.outage("r1"), 300, "r1's respawn")
        watch.stop()
        down_t, up_t = watch.outage("r1")
        stats = _http_json(url + "/stats")
        opens = stats["counters"].get("router_breaker_opens_total", 0)
        reps = {r["name"]: r for r in stats["replicas"]}
        if load["errors"] or load["shed"] or not opens:
            fail(f"(ao) kill_replica under load: errors {load['errors']}, shed {load['shed']}, "
                 f"breaker opens {opens}; the router's counters {stats['counters']}; failed "
                 f"legs {_router_failures(url)}")
        _poll_until(lambda: all(r["breaker"] == "closed" and r.get("ok") for r in
                                _http_json(url + "/stats")["replicas"]), 60, "both breakers")
        stats = _http_json(url + "/stats")
        reps = {r["name"]: r for r in stats["replicas"]}
        r1_ready = _ready_lines(workdir, "r1")
        cold = _http_json(f"http://{reps['r1']['address']}/stats")["cold_start"]
        if len(r1_ready) < 2 or cold["compiles_at_load"] != 0:
            fail(f"(ao) the respawn: {len(r1_ready)} ready lines, cold start {cold}")
        direct = {n: served_rows(r["address"], anchor) for n, r in reps.items()}
        if any(bad for _, bad in direct.values()) or \
                direct["r0"][0].tobytes() != direct["r1"][0].tobytes():
            fail("(ao) the respawned replica's answers differ from its sibling's")
        out["ao"] = {"load": {k: load[k] for k in ("requests", "errors", "shed",
                                                   "throughput_rps", "latency_ms")},
                     "breaker_opens": opens, "down_seen_to_up_s": up_t - down_t,
                     "respawn_startup_s": r1_ready[-1]["cold_start"]["startup_s"],
                     "respawn_compiles_at_load": cold["compiles_at_load"]}
        print(f"(ao) kill_replica r1 at 2.0 s under {FLEET_CONNS} conns: {load['requests']} "
              f"requests, 0 errors, 0 shed, p99 {load['latency_ms']['p99']} ms, max "
              f"{load['latency_ms']['max']} ms; breaker opens {opens}; r1 down seen to "
              f"respawned up {up_t - down_t:.2f} s (startup_s "
              f"{out['ao']['respawn_startup_s']}), compiles_at_load 0, 64 rows equal to r0's")
        out["ao"]["wedge"] = run_wedge(fleet_dir, bundle)

        # (an) answers, names, the card, the supervisor without torch -------
        rows, bad = served_rows(addr, anchor)
        if bad or rows.tobytes() != ref.tobytes():
            fail(f"(an) 64 rows through the router != ES.predict on the anchor batch ({bad})")
        if sorted(reps) != ["r0", "r1"]:
            fail(f"(an) /stats names {sorted(reps)}")
        readies = {s: _ready_lines(workdir, s) for s in ("r0", "r1")}
        for s, lines in readies.items():
            for rl in lines:
                if rl["device"] != want_dev or rl["device"]["kind"] != name:
                    fail(f"(an) {s}'s ready line names {rl['device']}, not {name}")
        with open(f"/proc/{proc.pid}/maps") as f:
            maps = f.read()
        mapped = sorted({p for p in ("libtorch", "libc10", "libcuda", "libcudart")
                         if p in maps})
        if mapped:
            fail(f"(an) the fleet's supervisor maps {mapped}")
        probe = _file_run_router_probe({n: r["address"] for n, r in reps.items()}, cfg,
                                       anchor[:8])
        got = np.asarray(probe["answers"], np.float32)
        if probe["loaded"] or got.tobytes() != ref[:8].tobytes():
            fail(f"(an) the file-run router: loaded {probe['loaded']}, answers equal "
                 f"{got.tobytes() == ref[:8].tobytes()}")
        memory = {s: [{**(rl["memory"] or {}), "pid": rl["pid"]} for rl in lines]
                  for s, lines in readies.items()}
        out["an"] = {"router_ready_s": router_ready_s, "two_up_s": up_s, "memory": memory,
                     "card_mib_two_replicas": two_mib,
                     "startup_s": {s: [rl["cold_start"]["startup_s"] for rl in lines]
                                   for s, lines in readies.items()}}
        print(f"(an) fleet of 2 on {name}: router ready {router_ready_s:.2f} s, both replicas "
              f"up {up_s:.2f} s after the spawn (startup_s {out['an']['startup_s']}); 64 rows "
              "through the router bit-equal to ES.predict; /stats names r0, r1; the "
              "supervisor maps no torch or CUDA library; the file-run router answered 8 rows "
              "bit-equal, importing nothing of torch or the package")
        print(f"  the card's free memory fell {two_mib:.0f} MiB from before the spawn to both "
              f"replicas up ({two_mib / 2:.0f} MiB a replica: its CUDA context, torch's "
              "allocator and the bundle)")
        for s, ms in memory.items():
            for m in ms:
                print(f"  {s} pid {m['pid']}: torch reserved {m.get('reserved_mib')} MiB, card "
                      f"free {m.get('card_free_mib')} of {m.get('card_total_mib')} MiB at its "
                      "ready line")

        # (ar) observability over the live fleet ------------------------------
        store = os.path.join(fleet_dir, "store")
        targets = os.path.join(fleet_dir, "targets.json")
        with open(targets, "w") as f:
            json.dump({"schema": 1, "interval_s": 0.5, "targets": [
                {"name": "router", "url": url + "/metrics", "timeout_s": 2.0},
                *({"name": n, "url": f"http://{r['address']}/metrics", "timeout_s": 2.0}
                  for n, r in sorted(reps.items()))]}, f)
        collector = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "estorch_tpu_torch", "obs", "agg",
                                          "collector.py"),
             "--targets", targets, "--store", store, "--ticks", "10", "--interval", "0.5",
             "--port", "0"], cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            sweep = capacity_sweep(addr, slo_ms=FLEET_SLO_MS, rps_ladder=[25.0, 100.0, 400.0, 1600.0],
                                   rung_duration_s=1.0, conns=16, obs=obs)
            cout, cerr = collector.communicate(timeout=120)
        finally:
            if collector.poll() is None:
                collector.kill()
                collector.wait(timeout=30)
        if collector.returncode != 0:
            fail(f"(ar) the collector exited {collector.returncode}: {cerr[-2000:]}")

        def obs_cli(*argv, ok=(0,)):
            r = subprocess.run([sys.executable, "-m", "estorch_tpu_torch.obs", *argv],
                               cwd=HERE, capture_output=True, text=True, timeout=120)
            if r.returncode not in ok:
                fail(f"(ar) obs {' '.join(argv)} exited {r.returncode}: {r.stderr[-2000:]}")
            return r

        cap = os.path.join(fleet_dir, "capacity.json")
        if sweep["max_rps_at_slo"] is None:
            fail(f"(ar) the capacity sweep met its SLO at no rung: {sweep['rungs']}")
        write_capacity_artifact(sweep, cap, bundle=bundle)
        obs_cli("autoscale", "--store", store, "--capacity", cap, "--fleet-admin", addr,
                "--ticks", "3", "--interval", "0.3", "--window", "60", "--dry-run")
        log = os.path.join(store, "autoscale_decisions.jsonl")
        replay = json.loads(obs_cli("autoscale", "--replay", log).stdout)
        dash = json.loads(obs_cli("dash", "--store", store, "--once", "--json").stdout)
        ups = {row["target"]: row["up"] for row in dash["targets"]}
        if ups != {"router": True, "r0": True, "r1": True}:
            fail(f"(ar) obs dash: {ups}")
        slow = json.loads(obs_cli("slow", "--store", store, "--json").stdout)
        trace_path = os.path.join(fleet_dir, "fleet_trace.json")
        obs_cli("trace", "--store", store, "-o", trace_path)
        with open(trace_path) as f:
            tr = json.load(f)
        flows = [e for e in tr["traceEvents"] if e.get("ph") == "s"]
        if not slow["traces"] or not flows or not replay["ok"] or replay["decisions"] < 1:
            fail(f"(ar) slow names {len(slow['traces'])} traces, trace --store "
                 f"{len(flows)} cross-process edges, replay {replay}")
        with open(log) as f:
            verdicts = [json.loads(ln)["verdict"] for ln in f if ln.strip()]
        out["ar"] = {"targets_up": ups, "slow_traces": len(slow["traces"]),
                     "slow_q_ms": (slow["q_s"] or 0.0) * 1e3, "trace_flows": len(flows),
                     "traces": tr["otherData"]["traces"], "capacity": sweep["max_rps_at_slo"],
                     "sweep": sweep["rungs"], "decisions": replay["decisions"],
                     "verdicts": [(v["action"], v["desired"], v["reason"]) for v in verdicts]}
        print(f"(ar) collector (file run) 10 ticks over router + 2 replicas: dash shows all "
              f"up; obs slow names {len(slow['traces'])} traces (p{slow['quantile'] * 100:g} "
              f"{out['ar']['slow_q_ms']:.2f} ms); obs trace --store joined "
              f"{tr['otherData']['traces']} traces with {len(flows)} router -> replica edges; "
              f"capacity sweep {[(r['offered_rps'], r['ok']) for r in sweep['rungs']]} -> "
              f"max_rps_at_slo {sweep['max_rps_at_slo']}; autoscale (dry run) "
              f"{out['ar']['verdicts']}, replayed bit-exact")

        # (ap) two rollouts ---------------------------------------------------
        def rollout(path: str, **req) -> dict:
            bg = _Background(addr, obs)
            res = _http_json(url + "/rollout", {"path": path, **req})
            if not res.get("ok"):
                fail(f"(ap) POST /rollout {path}: {res}")
            ro = _poll_until(lambda: (lambda r: r if r["state"] == "idle" and r["last"]
                                      else None)(_http_json(url + "/rollout")), 120,
                             "the rollout's end", step_s=0.2)
            bg.stop(f"(ap) rollout of {os.path.basename(path)}")
            return ro["last"]

        # the tail gate is not what (ap) holds: a wide band keeps the
        # latency spread of a few dozen shadow probes from deciding
        good = rollout(reexport, min_band_pct=100.0)
        if not good.get("promoted") or good["evidence"]["parity_samples"] < \
                FLEET_ROLLOUT["parity_samples"]:
            fail(f"(ap) the re-export was not promoted: {good}")
        bad_ro = rollout(moved)
        if not bad_ro.get("aborted") or bad_ro.get("reason") != "parity":
            fail(f"(ap) the moved bundle was not aborted on parity: {bad_ro}")
        for n, r in reps.items():
            rows, badn = served_rows(r["address"], anchor)
            if badn or rows.tobytes() != ref.tobytes():
                fail(f"(ap) after the rollouts {n} answers other bits")
        out["ap"] = {"promoted": {k: good["evidence"][k] for k in (
                         "canary_samples", "incumbent_samples", "parity_samples")},
                     "aborted": {"reason": bad_ro["reason"],
                                 "mismatched": bad_ro["evidence"]["mismatched"],
                                 "parity_samples": bad_ro["evidence"]["parity_samples"]}}
        print(f"(ap) rollout of the re-export promoted ({out['ap']['promoted']}); of the "
              f"moved bundle aborted on parity ({bad_ro['evidence']['mismatched']} of "
              f"{bad_ro['evidence']['parity_samples']} mismatched); every replica then "
              "answers the incumbent's bits")

        # (aq) scale 2 -> 3 -> 2 under load, then (as) -------------------------
        def scaled(n: int, what: str) -> dict:
            return _poll_until(lambda: (lambda s: s if s["actual"] == n and s["desired"] == n
                                        and not s["in_progress"] and s["last"] else None)(
                _http_json(url + "/scale")), 300, what, step_s=0.2)

        bg = _Background(addr, obs)
        if not _http_json(url + "/scale", {"replicas": 3}).get("accepted"):
            fail("(aq) POST /scale 3 was not accepted")
        up3 = scaled(3, "3 replicas")
        res_up = bg.stop("(aq) scale 2 -> 3")
        added = up3["last"]["added"]
        if len(added) != 1 or added[0]["compiles_at_load"] != 0:
            fail(f"(aq) the added slot: {added}")
        legs = {"router_3": _fleet_leg(addr, obs, f"3 replicas through the router on {card}")}
        bg = _Background(addr, obs)
        if not _http_json(url + "/scale", {"replicas": 2}).get("accepted"):
            fail("(aq) POST /scale 2 was not accepted")
        down2 = scaled(2, "back to 2 replicas")
        res_down = bg.stop("(aq) scale 3 -> 2")
        retired = down2["last"]["retired"]
        if len(retired) != 1 or not retired[0]["drained"] or retired[0]["exitcode"] != 0:
            fail(f"(aq) the retired slot: {retired}")
        out["aq"] = {"scale_up_s": up3["last"]["duration_s"], "added": added,
                     "scale_down_s": down2["last"]["duration_s"], "retired": retired,
                     "load_up": res_up, "load_down": res_down}
        print(f"(aq) scale 2 -> 3 in {up3['last']['duration_s']} s ({added[0]['replica']} "
              f"compiles_at_load 0), 3 -> 2 in {down2['last']['duration_s']} s "
              f"({retired[0]['replica']} drained, exit 0); {res_up['requests']} + "
              f"{res_down['requests']} requests under load, 0 errors")
        if not _http_json(url + "/scale", {"replicas": 1}).get("accepted"):
            fail("(as) POST /scale 1 was not accepted")
        scaled(1, "1 replica")
        last = [r for r in _http_json(url + "/stats")["replicas"] if not r["retiring"]]
        legs["router_1"] = _fleet_leg(addr, obs, f"1 replica through the router on {card}")
        legs["direct_1"] = _fleet_leg(last[0]["address"], obs,
                                      f"1 replica direct ({last[0]['name']}) on {card}")
        out["as"] = legs
        print(f"(as) {card}: 1 replica direct {legs['direct_1']['throughput_rps']} req/s, "
              f"through the router {legs['router_1']['throughput_rps']} req/s, 3 replicas "
              f"through the router {legs['router_3']['throughput_rps']} req/s")

        # the drain ----------------------------------------------------------
        import signal

        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
        final = json.loads(rest.strip().splitlines()[-1])
        if proc.returncode != 0 or not final["clean"]:
            fail(f"(as) the fleet's SIGTERM drain: exit {proc.returncode}, {final}")
    finally:
        _stop_group(proc)
    launches = dict(nk.launch_counts)
    if any(launches.values()):
        fail(f"phase 17 launched the port's kernels in this process: {launches}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_start
    print(f"phase 17: {out['phase_s']:.1f} s on {card}")
    return out


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
    bw, f32, f64 = card_peaks(name)
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
    # Tolerance: float64 sums over up to 2048 rows in another order than the
    # plain gather + matvec, each rounded to float32 once; |weights| <= 1, so
    # |error| well under 1e-3 (in practice 0: both round to the same float).
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
        bound = max(nbytes / bw, flops / f64) * 1e3
        ms = time_ms(torch, lambda: nk.weighted_noise_sum(table, offs, w, dim))
        plain_ms = time_ms(torch, lambda: nk.weighted_noise_sum_plain(table, offs, w, dim))
        print(f"  time {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB distinct)")
        wns.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, max_abs_err=err,
                   bound_by="bytes" if nbytes / bw >= flops / f64 else "operations")

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
        bound = max(nbytes / bw, 2 * (pop // 2) * env_dim / f64) * 1e3
        print(f"weighted_noise_sum {plabel} n={pop // 2} dim={env_dim}: max |err| {err:.3g} "
              f"(tol atol 1e-3, rtol 1e-4); time {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB distinct)")
        wns["other_shapes"].append({"shape": f"{plabel}: n={pop // 2}, dim={env_dim}", "ms": ms,
                                    "plain_ms": plain_ms, "bound_ms": bound,
                                    "max_abs_err": err})
        wns["max_abs_err"] = max(wns["max_abs_err"], err)
    pnm["max_abs_err"] = max(errs + [e["max_abs_err"] for e in extra])
    pong_wns = time_pong_reduction(torch, nk, bw, f64, flush)
    wns["other_shapes"].append(pong_wns)
    wns["max_abs_err"] = max(wns["max_abs_err"], pong_wns["max_abs_err"])
    htable = host_table(torch)
    for host_wns in (time_host_reduction(torch, nk, htable, bw, f64),
                     time_fold_reduction(torch, nk, htable, bw, f64)):
        wns["other_shapes"].append(host_wns)
        wns["max_abs_err"] = max(wns["max_abs_err"], host_wns["max_abs_err"])
    del htable
    rec_wns = time_recurrent_reduction(torch, nk, table, bw, f64, flush)
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

    busy3, launched3 = profile_generation(torch, es)  # after the counts: not part of them
    print(f"  {launched3 / HORIZON:.1f} kernel launches an env step")
    del es

    # ---- 4. the card against the CPU's plain versions at a small size -----
    phase("4. card against CPU")
    compare_card_cpu(torch, estorch_tpu_torch)
    env_cmp = compare_envs_card_cpu(torch, estorch_tpu_torch)
    env_cmp += compare_pooled_card_cpu(torch, estorch_tpu_torch)
    env_cmp += compare_host_card_cpu(torch, estorch_tpu_torch)
    env_cmp += compare_recurrent_card_cpu(torch, estorch_tpu_torch)
    env_cmp += compare_novelty_card_cpu(torch, estorch_tpu_torch)
    env_cmp += compare_fold_card_cpu(torch, estorch_tpu_torch, nk)
    env_cmp.append(compare_checkpoint_card_cpu(torch, estorch_tpu_torch))
    env_cmp += compare_scenarios_card_cpu(torch, estorch_tpu_torch)

    # ---- 5. the slice's other paths at full width ----------------------------
    phase("5. the other paths")
    paths = [{"path": "streamed (phase 3)", "options": STREAMED, "launches": launches,
              "env_steps_per_s": steps / dt, "s_per_generation": gen_s,
              "device_busy_s": busy3, "busy_share": busy3 / gen_s,
              "kernel_launches_per_env_step": launched3 / HORIZON}]
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

    # ---- 11. the novelty family and IW-ES ---------------------------------------------
    phase("11. novelty")
    novelty = run_novelty_paths(torch, estorch_tpu_torch, nk, card)
    paths += novelty

    # ---- 12. barrier-free generations ------------------------------------------------
    phase("12. train_async")
    async_paths = run_async_paths(torch, estorch_tpu_torch, nk, card)
    fold = next(p for p in async_paths["paths"] if p.get("strategy") == "fold")

    # ---- 13. crash-safe training ---------------------------------------------------
    phase("13. crash-safe training")
    crash_safe = run_crash_safe(torch, estorch_tpu_torch, nk, card)

    # ---- 14. performance attribution --------------------------------------------
    phase("14. attribution")
    attribution = run_attribution(torch, card, name)

    # ---- 15. serving ----------------------------------------------------------
    phase("15. serving")
    import shutil
    import tempfile

    fleet_dir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    serving = run_serving(torch, estorch_tpu_torch, nk, card, name, fleet_dir)

    # ---- 16. scenarios ----------------------------------------------------------
    phase("16. scenarios")
    g_path = next(p for p in paths if p["path"].startswith("g "))
    scenarios = run_scenarios(torch, estorch_tpu_torch, nk, card, paths[0], g_path)

    # ---- 17. the fleet ------------------------------------------------------------
    phase("17. the fleet")
    try:
        fleet = run_fleet(torch, estorch_tpu_torch, nk, card, name, fleet_dir)
    finally:
        shutil.rmtree(fleet_dir, ignore_errors=True)

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
                                for p in recurrent},
         "launches_novelty": {p["path"]: p["launches"]["weighted_noise_sum"]
                              for p in novelty},
         "launches_async": {fold["path"]: fold["launches"]["weighted_noise_sum"]},
         "launches_per_fold_update": fold["launches_per_update"],
         "launches_resumed": crash_safe["checkpoint"]["resumed_launches"]["weighted_noise_sum"],
         "launches_serving": serving["serving_launches"].get("weighted_noise_sum", 0),
         "launches_scenarios": {k: scenarios[k]["launches"]["weighted_noise_sum"]
                                for k in ("ak", "al", "am")},
         "launches_fleet": fleet["launches"].get("weighted_noise_sum", 0)},
        {"name": "population_noise_matvec", "route": "cuda",
         "source": "estorch_tpu_torch/ops/csrc/noise_kernels.cu",
         "replaces": "estorch_tpu/ops/pallas_noise.py:201",
         "launches": launches["population_noise_matvec"], "max_abs_err": pnm["max_abs_err"],
         "ms": pnm["ms"], "cold_ms": pnm["cold_ms"], "plain_ms": pnm["plain_ms"], "bound_ms": pnm["bound_ms"],
         "bound_by": pnm["bound_by"], "library_ms": None,
         "shape": f"one env step: n={POPULATION} at (3,64)+(64,64)+(64,1)",
         "layers": [{k: layer[k] for k in ("layer", "n", "d", "h", "ms", "cold_ms",
                                           "plain_ms", "bound_ms")}
                    for layer in layers + extra],
         "launches_novelty": {p["path"]: p["launches"]["population_noise_matvec"]
                              for p in novelty},
         "launches_resumed": crash_safe["checkpoint"]["resumed_launches"][
             "population_noise_matvec"],
         "launches_serving": serving["serving_launches"].get("population_noise_matvec", 0),
         "launches_scenarios": {k: scenarios[k]["launches"]["population_noise_matvec"]
                                for k in ("ak", "al", "am")},
         "launches_fleet": fleet["launches"].get("population_noise_matvec", 0)},
    ]
    print(json.dumps({"paths": paths, "eval_chunk": chunking, "card_vs_cpu_envs": env_cmp,
                      "async": async_paths, "crash_safe": crash_safe,
                      "attribution": attribution, "serving": serving,
                      "scenarios": scenarios, "fleet": fleet}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
