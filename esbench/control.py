"""The readings that a cell's limits are set from, at the cell's own size.

    python -m esbench.control --workload <cell> --seeds 1,2,3 [--control-seeds 3]
                              [--device cuda:0] [--out FILE]

For each seed: the program's first ``steps`` generations through
``ES.train`` (as a run's set-up drives them) against the plain reference in float32,
which gives the lower readings; for the first ``--control-seeds`` seeds
also the control (the reference in the program's place, every product's
operands rounded to TF32) and the half-batch fault (the reference in the
program's place with the update and the loss over half the pairs), each
against the float32 reference, which give the upper readings.  A state
left unchanged reads 1 on ``grad_gap`` and ``change_gap`` by their
definition and needs no run.  One JSON line a seed, and the whole in
``--out``.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

from esbench import loader


def _free(torch, device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _members_apart(a, b) -> int:
    """Members whose first-step returns differ by more than 1e-5 of the
    larger: a discrete action flipped somewhere in their episode."""
    import torch

    return int((torch.abs(a - b) > 1e-5 * torch.maximum(a.abs(), b.abs())).sum())


def seed_readings(cell: str, seed: int, device, with_control: bool,
                  config_override: dict | None = None, look_block: int = 0,
                  look_float64: bool = False) -> dict:
    """One seed's readings: ``{"lower": ..., "control": ..., "half_batch":
    ...}``; with ``look_block`` also ``"look"``, the reference against itself
    run in blocks of that many members (other products' shapes, so other
    roundings), and with ``look_float64`` ``"float64"``, the float32
    reference against the same in float64: witnesses of what rounding alone
    does to the numbers."""
    import torch

    import estorch_tpu_torch as tt
    from esbench import envs, run
    from esbench.reference import compare
    from esbench.reference.es import ReferenceES

    workload = loader.load_workload(cell)
    config = loader.load_config(workload["config"])
    if config_override:
        config = {**config, **config_override}
    env = envs.make_env(config["env"])
    block = int(workload["reference_block"])
    t = time.perf_counter()
    es, program = run.program_steps(tt, config, workload, env, seed, device)
    del es
    _free(torch, device)
    out = {"seed": seed, "program_s": time.perf_counter() - t}

    def steps(block_override: int = 0, given=None, **kw):
        t = time.perf_counter()
        ref = ReferenceES(config, seed, env, device=device, block=block_override or block, **kw)
        got = compare.reference_steps(ref, int(workload["steps"]), given)
        layout = ref.layout
        del ref
        _free(torch, device)
        return got, layout, time.perf_counter() - t

    # a discrete policy's side is judged by the float32 reference replaying
    # that side's actions; a continuous one's by the plain reference
    discrete = program["actions"] is not None
    reference, layout, out["reference_s"] = steps(given=program["actions"])
    out["lower"] = compare.readings(program, reference, layout)
    plain = steps()[0] if discrete and (look_block or look_float64 or with_control) else reference
    out["losses"] = {"program": program["losses"], "reference": reference["losses"]}
    if look_block:
        look, _, _ = steps(block_override=look_block)
        out["look"] = compare.readings(look, plain, layout)
        out["look_members"] = _members_apart(look["fitness0"], plain["fitness0"])
    if look_float64:
        exact, _, _ = steps(precision="float64")
        out["float64"] = compare.readings(plain, exact, layout)
        out["float64_members"] = _members_apart(plain["fitness0"], exact["fitness0"])

    def judged(side):
        """The float32 reference that judges a side put in the program's place."""
        return steps(given=side["actions"])[0] if discrete else plain

    if with_control:
        control, _, out["control_s"] = steps(precision="tf32")
        out["control"] = compare.readings(control, judged(control), layout)
        out["control_members"] = _members_apart(control["fitness0"], plain["fitness0"])
        out["losses"]["control"] = control["losses"]
        half, _, _ = steps(fault="half_batch")
        out["half_batch"] = compare.readings(half, judged(half), layout)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m esbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--look-block", type=int, default=0,
                   help="also run the reference in blocks of this many members")
    p.add_argument("--look-float64", action="store_true",
                   help="also hold the float32 reference against one in float64")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = loader.check_name(args.workload)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("esbench.control: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        row = seed_readings(cell, seed, args.device, i < args.control_seeds,
                            look_block=args.look_block, look_float64=args.look_float64)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": cell, "rows": rows}
    for key in ("lower", "look", "float64", "control", "half_batch"):
        got = [r[key] for r in rows if key in r]
        if got:
            summary[key] = {k: (min(g[k] for g in got), max(g[k] for g in got))
                            for k in got[0]}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
