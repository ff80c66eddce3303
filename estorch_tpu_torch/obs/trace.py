"""Device-trace hooks (counterpart of ``estorch_tpu/obs/trace.py``;
``utils/profiler.py`` re-exports them).

Span telemetry (``obs/spans.py``) answers "which phase got slower" on
every run; these helpers are the heavyweight next step when a phase needs
opening up:

- ``trace(logdir)``: a ``torch.profiler`` trace (CPU and, where there is a
  card, CUDA activity) of everything inside the with-block, written into
  ``logdir`` as a Chrome trace (``*.pt.trace.json``; Perfetto and
  ``chrome://tracing`` open it): each kernel a launch, by name;
- ``timed_generations(es, n)``: per-generation wall time after a warm-up,
  with the run's ``compile_time_s`` (the native builds at first use,
  ``ops/_build.py``);
- ``annotate(name)``: ``torch.profiler.record_function``, so host-side
  phases show up inside the trace.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of everything inside the with-block, written to
    ``logdir/<unix ms>.<pid>.pt.trace.json`` when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the trace
    prof.export_chrome_trace(
        os.path.join(logdir, f"{int(time.time() * 1e3)}.{os.getpid()}.pt.trace.json"))


def annotate(name: str):
    """A host-phase range visible in the trace (a no-op off-trace)."""
    import torch

    return torch.profiler.record_function(name)


def timed_generations(es, n: int = 5, warmup: int = 1) -> dict:
    """Run ``n`` timed generations after ``warmup`` untimed ones; returns
    aggregate timing stats.  ``es.train`` waits for each generation's
    metrics on the host, so the wall clock measures executed work, not
    queued launches."""
    es.train(warmup, verbose=False)
    t0 = time.perf_counter()
    es.train(n, verbose=False)
    wall = time.perf_counter() - t0
    recs = es.history[-n:]
    steps = sum(r["env_steps"] for r in recs)
    return {
        "generations": n,
        "wall_s": wall,
        "gen_per_sec": n / wall,
        "env_steps": steps,
        "env_steps_per_sec": steps / wall,
        "mean_gen_wall_s": wall / n,
        "compile_time_s": es.compile_time_s,
    }
