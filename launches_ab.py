#!/usr/bin/env python3
"""Kernel launches an env step of the unrandomized paths, in two checkouts.

    python3 launches_ab.py OTHER_CHECKOUT [--device cuda|cpu]

Runs this checkout's ``estorch_tpu_torch`` and OTHER_CHECKOUT's (e.g. the
parent commit unpacked with ``git archive`` into the git-ignored ``build/``)
each in a process of its own, in turns (this, other, other, this), and
prints one JSON line a run and whether every count agrees.  A run takes one
engine generation of each path after a warm-up generation and divides by
the horizon:

- on the card (``--device cuda``, the default): the kernel launches among
  torch.profiler's device events (copies and fills not counted), at the
  paths' full widths: ``chip_smoke.py`` phase 3's cell (Pendulum, MLP
  64x64, population 4096, streamed + kernel update), phase 5's (a) (the
  same, standard forward, plain update), phase 7's (f) and (g) (Cheetah2D,
  MLP 64x64, population 1024, standard, and streamed + kernel update), at
  horizon 20: a locomotion generation at horizon 200 is about 150,000
  launches, past what the profiler keeps (it dropped 6 of a generation's
  600 matvec launches there), and at 20 it keeps every one;
- on the CPU (``--device cpu``): the aten ops the generation dispatches
  (views included), at population 16 and horizon 10, for the same four
  paths and the other classic-control envs.

The counts do not depend on the data, so one run a checkout decides; the
turns only show that they repeat.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _paths(tt, device: str):
    big = device == "cuda"
    pop, h, loco_pop = (4096, 20, 1024) if big else (16, 10, 16)
    mlp = {"hidden": (64, 64) if big else (8,)}
    pend = dict(mlp, action_dim=1, discrete=False, action_scale=2.0)
    streamed = {"streamed": True, "noise_kernel": True}
    rows = [("cell streamed", tt.Pendulum(), pend, pop, streamed),
            ("a standard", tt.Pendulum(), pend, pop, {}),
            ("f cheetah standard", tt.Cheetah2D(), dict(mlp, action_dim=6, discrete=False),
             loco_pop, {}),
            ("g cheetah streamed", tt.Cheetah2D(), dict(mlp, action_dim=6, discrete=False),
             loco_pop, streamed)]
    if not big:
        for name in ("CartPole", "Acrobot", "MountainCar"):
            env = getattr(tt, name)()
            rows.append((name, env, dict(mlp, action_dim=env.action_dim, discrete=True), pop, {}))
        rows.append(("MountainCarContinuous", tt.MountainCarContinuous(),
                     dict(mlp, action_dim=1, discrete=False), pop, {}))
    return rows, h


def child(root: str, device: str) -> None:
    sys.path.insert(0, root)
    import torch

    import estorch_tpu_torch as tt

    if not os.path.abspath(tt.__file__).startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"estorch_tpu_torch comes from {tt.__file__}, not {root}")
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    rows, horizon = _paths(tt, device)
    out = {}
    for label, env, policy, pop, opts in rows:
        es = tt.ES(tt.MLPPolicy, tt.DeviceAgent(env, horizon=horizon), tt.adam, device=device,
                   population_size=pop, sigma=0.05, policy_kwargs=policy, telemetry=False,
                   optimizer_kwargs={"learning_rate": 1e-2},
                   table_size=(1 << 25) if device == "cuda" else (1 << 16), **opts)
        es.train(1, verbose=False)
        if device == "cuda":
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                es.engine.generation_step(es.state)
                torch.cuda.synchronize()
            n = sum(1 for e in prof.profiler.kineto_results.events()
                    if str(e.device_type()).endswith("CUDA")
                    and not e.name().startswith(("Memcpy", "Memset")))
        else:
            from torch.utils._python_dispatch import TorchDispatchMode

            class Count(TorchDispatchMode):
                n = 0

                def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                    Count.n += 1
                    return func(*args, **(kwargs or {}))

            with Count():
                es.engine.generation_step(es.state)
            n = Count.n
        out[label] = n / horizon
        del es
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    print(json.dumps({"root": root, "device": name, "per_env_step": out}))


def main() -> None:
    args = sys.argv[1:]
    if args and args[0] == "--child":
        child(args[1], args[2])
        return
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    if len(args) != 1:
        raise SystemExit(__doc__)
    other = os.path.abspath(args[0])
    runs = []
    for root in (HERE, other, other, HERE):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                               device], capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            raise SystemExit(f"run in {root} failed:\n{proc.stderr[-4000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line)["per_env_step"])
    same = all(r == runs[0] for r in runs)
    print(json.dumps({"equal": same}))
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
