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
- ``annotate(name)``: a named range on the profiler's CPU timeline while
  a profiler collects, so host-side phases show up inside the trace; off
  it, one flag read and a shared no-op.

The port's own ranges are ``estorch.<phase>``, flat: the engine's
``sample``, ``eval``, ``rank`` and ``update`` (``parallel/engine.py``
``ESEngine.generation_step``), the rollout's ``forward`` and ``step`` each
env step (``envs/rollout.py``), the kernel launches ``noise_matvec`` and
``noise_sum`` (``ops/noise_kernels.py``), and every span of the hub
(``obs/spans.py``: ``dispatch``, ``device``, ``host_sync``, ``record`` on
the device backend), whether the hub is on or off.

A range is an ordinary (not a user-scope) record function: it puts no
event on the device's timeline, where a user annotation's copy would read
as device work, and it sits on the op-correlation stack, so a kernel
launched under no torch op (through ``ctypes``) is linked to the innermost
range open at its launch; the kernel wrappers open theirs around the
launch alone.
"""

from __future__ import annotations

import contextlib
import os
import time

NULL_RANGE = contextlib.nullcontext()  # what annotate() returns off-trace
_profiler = None  # torch.autograd.profiler, bound at the first flag read


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


def profiling() -> bool:
    """Whether a torch profiler is collecting: one flag read."""
    global _profiler
    if _profiler is None:
        import torch.autograd.profiler

        _profiler = torch.autograd.profiler
    return _profiler._is_profiler_enabled


def annotate(name: str):
    """A range named ``name`` on the profiler's CPU timeline while a
    profiler collects, else the shared no-op :data:`NULL_RANGE`.  A range
    may be entered again once it has exited, so a loop can make its ranges
    once."""
    if not profiling():
        return NULL_RANGE
    from torch._C._profiler import _RecordFunctionFast

    return _RecordFunctionFast(name)


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
