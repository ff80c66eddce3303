"""Run one cell of the benchmark once and print its JSON line.

    python -m esbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run builds the cell's ``ES`` on ``cuda:0`` from the seed, drives it
through its first ``steps`` generations (the set-up: every shape and
kernel of the window warmed, and the steps the reference follows), then with
``--trace 0`` times whole generations of ``ES.train`` for ``--seconds``
and reports the cell's end-to-end metrics; with ``--trace 1`` it traces
``trace_generations`` generations (and two more with spans around the
program's functions that the per-layer metrics read) and reports the cell's per-layer metrics.  Once
the window has closed and the peak memory is read, the program is freed
and the plain reference (``reference/``) runs the same first generations
from the same seed; the comparison decides ``correct``.

A run that finds no card, or fewer than the cell asks for, exits 2 and
prints no result; so does one that finds JAX or the JAX package loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python gets

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from esbench import loader  # noqa: E402

SPAN_GENERATIONS = 2  # traced with spans around the metrics' entries
FORBIDDEN = ("jax", "jaxlib", "flax", "estorch_tpu")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    flax's or the JAX package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    root = Path(__file__).resolve().parent.parent / "build" / "esbench_cache"
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(root / sub)


@dataclasses.dataclass
class Context:
    """What a per-layer metric's ``read(ctx)`` reads."""

    config: dict
    workload: dict
    population: int
    horizon: int
    chunks: int  # rollout chunks a generation
    obs_shape: tuple
    dim: int
    layout: list  # the flat params' (layer, leaf, shape, start)
    generations: list  # generation numbers in the traced window
    trace: object  # esbench.trace.Trace of the traced window
    span_trace: object  # the same for the generations traced with the entries' spans
    span_generations: list
    pair_offsets: object  # generation -> (rows,) numpy offsets, the benchmark's own draws


def build_es(tt, config: dict, workload: dict, env, seed: int, device):
    """The cell's ``ES``, as a user of the port builds it."""
    policy = config["policy"]
    opt = config["optimizer"]
    if policy["kind"] == "mlp":
        module, kwargs = tt.MLPPolicy, {"action_dim": policy["action_dim"],
                                        "hidden": tuple(policy["hidden"]),
                                        "discrete": policy["discrete"],
                                        "action_scale": policy["action_scale"]}
    else:
        module, kwargs = tt.NatureCNN, {"action_dim": policy["action_dim"],
                                        "use_vbn": policy["use_vbn"]}
    return tt.ES(
        module, tt.DeviceAgent(env, horizon=int(config["horizon"])), tt.adam,
        population_size=int(config["population_size"]), sigma=float(config["sigma"]),
        device=device, policy_kwargs=kwargs,
        optimizer_kwargs={k: opt[k] for k in ("learning_rate", "b1", "b2", "eps")},
        seed=seed, table_size=int(config["table_size"]),
        eval_chunk=int(workload["eval_chunk"]),
        weight_decay=float(config.get("weight_decay", 0.0)),
        mirrored=bool(config.get("mirrored", True)),
        streamed=workload["forward"] == "streamed",
        noise_kernel=workload["update"] == "kernel",
        telemetry=False)


def program_steps(tt, config: dict, workload: dict, env, seed: int, device):
    """Build the cell's ``ES`` and drive it through its first ``steps``
    generations with ``ES.train``: ``(es, what the comparison reads of
    them)``, the mean returns, the first gradient as Adam was given it
    (from Adam's first moment) and the params before and after."""
    es = build_es(tt, config, workload, env, seed, device)
    theta0 = es.state.params_flat.detach().cpu().clone()
    losses, grad0, actions = [], None, []
    recording = hasattr(env, "record")
    for step in range(int(workload["steps"])):
        rec: list = []
        if recording:
            env.record = []
        es.train(1, verbose=False, log_fn=rec.append)
        if recording:
            actions.append(taken_actions(env.record, int(config["population_size"])))
            env.record = None
        losses.append(float(rec[-1]["reward_mean"]))
        if step == 0:
            b1 = float(config["optimizer"]["b1"])
            grad0 = (es.state.opt_state.mu.detach().cpu() / (1.0 - b1)).clone()
    return es, {"losses": losses, "grad0": grad0, "theta0": theta0,
                "theta": es.state.params_flat.detach().cpu().clone(),
                "actions": actions if recording else None}


def taken_actions(steps: list, n: int):
    """A generation's actions as its env recorded them, one (chunk,)
    tensor an env step, the rollout's chunks in turn: (n, horizon), member
    by member."""
    import torch

    a = torch.stack(steps).cpu()  # (chunks · horizon, chunk)
    chunk = a.shape[1]
    return a.view(n // chunk, -1, chunk).permute(0, 2, 1).reshape(n, -1)


def host_snapshot() -> dict:
    """What the host did so far, for the note on a window: this process's
    CPU seconds, its involuntary context switches and its full garbage
    collections."""
    import resource

    return {"cpu_s": time.process_time(),
            "involuntary_switches": resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw,
            "gc_full": gc.get_stats()[2]["collections"]}


def host_note(before: dict, after: dict, wall: float, gen_s: list) -> str:
    """One line on what the host did in a window of ``wall`` seconds whose
    generations took ``gen_s`` seconds each by the host clock."""
    moved = {k: round(after[k] - before[k], 4) for k in before}
    gens = sorted(gen_s)
    spread = (f"generations min {gens[0]:.4f} median {gens[len(gens) // 2]:.4f} "
              f"max {gens[-1]:.4f} s" if gens else "no generations")
    return f"esbench: window host {moved} over {wall:.3f} s; {spread}"


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device="cuda:0",
             t0: float | None = None, config_override: dict | None = None) -> dict:
    """One run of ``cell``: ``{"result": the JSON line's object, "checks":
    the compared numbers with their limits, "stderr": lines}``.  Tests
    call it on the CPU with ``config_override`` (smaller sizes)."""
    import numpy as np
    import torch

    import estorch_tpu_torch as tt
    from esbench import envs
    from esbench.reference import compare
    from esbench.reference.es import ReferenceES

    t0 = T0 if t0 is None else t0
    workload = loader.load_workload(cell)
    config = loader.load_config(workload["config"])
    if config_override:
        config = {**config, **config_override}
    env = envs.make_env(config["env"])
    device = torch.device(device)
    n, horizon = int(config["population_size"]), int(config["horizon"])

    es, program = program_steps(tt, config, workload, env, seed, device)
    _sync(torch, device)
    setup_s = time.perf_counter() - t0

    records: list = []
    notes: list = []
    result_metrics: dict = {}
    device_facts: dict = {}
    breakdown = None
    if not trace:
        host_before = host_snapshot()
        start = time.perf_counter()
        ends = [start]
        while True:
            es.train(1, verbose=False, log_fn=records.append)
            ends.append(time.perf_counter())
            if ends[-1] - start >= seconds:
                break
        _sync(torch, device)
        wall = time.perf_counter() - start
        notes.append(host_note(host_before, host_snapshot(), wall,
                               [b - a for a, b in zip(ends, ends[1:])]))
        work = len(records) * n * horizon
        memory = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
        result_metrics = {
            "setup_s": {"value": setup_s, "unit": "s"},
            "env_steps_per_s": {"value": work / wall, "unit": "env-steps/s"},
            "peak_mem_gib": {"value": memory / 2**30, "unit": "GiB"},
        }
    else:
        from esbench import trace as tr

        gens_a = int(workload["trace_generations"])
        first = es.generation

        clock: list = []

        def window():
            clock.append(time.perf_counter())
            for _ in range(gens_a):
                es.train(1, verbose=False, log_fn=records.append)
            _sync(torch, device)
            clock.append(time.perf_counter())

        trace_a = tr.capture(window)
        wall = clock[1] - clock[0]
        # more generations, with spans around the entries the metrics read
        per_layer = [(m, loader.load_metric(m["name"]))
                     for m in loader.cell_metrics(loader.load_benchmark(), cell)[1]]
        entries = sorted({e for _, mod in per_layer for e in getattr(mod, "ENTRIES", ())})
        span_first = es.generation
        trace_b = tr.capture(lambda: (es.train(SPAN_GENERATIONS, verbose=False),
                                      _sync(torch, device)), entries)
        memory = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
        device_facts = {"busy_s": trace_a.busy_s(), "window_s": trace_a.window_s}
        notes.append(f"esbench: traced events {trace_a.counts}; with spans {trace_b.counts}")
        notes.append("esbench: spans (calls, device ops) " + str(
            {e.rpartition(":")[2]: (len(trace_b.spans.get(e, ())), len(trace_b.under([e])))
             for e in entries}) + f"; device ops without a launch "
            f"{sum(1 for d in trace_b.in_window() if trace_b.launch_time(d) is None)}; "
            f"runtime clock offset {trace_b.offset} ns")
        breakdown = {"device_ops": trace_a.top_ops(), "idle_gaps": trace_a.idle_gaps()}
    steps_gap = abs(sum(int(r["env_steps"]) for r in records) - len(records) * n * horizon)
    attempted = len(records) + int(workload["steps"]) + (SPAN_GENERATIONS if trace else 0)
    failed = sum(1 for r in records if r.get("n_failed"))
    chunks = n // es.engine.eval_chunk
    del es
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = ReferenceES(config, seed, env, device=device, block=int(workload["reference_block"]))
    reference = compare.reference_steps(ref, int(workload["steps"]), program["actions"])
    notes.append(f"esbench: set-up {setup_s:.3f} s, window {wall:.3f} s over "
                 f"{len(records)} generations, reference {time.perf_counter() - t_ref:.3f} s")
    values = compare.readings(program, reference, ref.layout)
    values["steps_gap"] = float(steps_gap)
    correct, checks = compare.verdict(values, workload["limits"])

    if trace:
        ctx = Context(
            config=config, workload=workload, population=n, horizon=horizon,
            chunks=chunks, obs_shape=ref.obs_shape, dim=ref.dim, layout=ref.layout,
            generations=list(range(first, span_first)),
            trace=trace_a, span_trace=trace_b,
            span_generations=list(range(span_first, span_first + SPAN_GENERATIONS)),
            pair_offsets=lambda g: ref.draws(g)[0].numpy().astype(np.int64))
        for m, mod in per_layer:
            value = mod.read(ctx)
            if value is not None and math.isfinite(value):
                result_metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    del ref
    gc.collect()

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(memory)}
    dev.update(device_facts)
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": result_metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines = notes + [f"check {k} {c['value']!r} limit {c['limit']!r}"
                     for k, c in checks.items()]
    return {"result": result, "checks": checks, "stderr": lines}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m esbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = loader.check_name(args.workload)
    set_cache_dirs()
    import torch

    chips = int(loader.cell_entry(loader.load_benchmark(), cell).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"esbench: the cell {cell} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda:0")
    found = forbidden_modules()
    if found:
        print(f"esbench: JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 2
    for line in out["stderr"]:
        print(line, file=sys.stderr)
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
