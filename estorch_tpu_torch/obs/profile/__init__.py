"""Per-phase performance attribution of a run (``obs profile``).

Counterpart of ``estorch_tpu/obs/profile/`` (stdlib and NumPy only; the
port keeps its own copy): phase spans become achieved FLOP/s and bytes/s
against a platform roofline, and the compile ledger keeps each build's
facts.

- :mod:`costmodel` — analytic FLOPs/bytes a phase from the run's config;
- :mod:`roofline`  — the H100 SXM data sheet, the TPU v5e data sheet, or
  a measured CPU calibration;
- :mod:`ledger`    — compile events riding JSONL, Prometheus, Perfetto;
- :mod:`report`    — the ``obs profile`` CLI body and its selfcheck.

In the port a compile is a native library's build and load at first use:
``ops/_build.py``'s CUDA kernels (program ``noise_kernels``) and
``envs/native_pool.py``'s envpool (program ``envpool``).  Torch compiles
nothing ahead of time, so these are the only programs in the ledger.
"""

from .costmodel import (FUSED_PHASES, MODELED_PHASES, compiled_cost_facts,
                        generation_cost, phase_cost_for)
from .ledger import CompileLedger, collect_compile_events, ledger_counters
from .report import (find_cost_model, format_profile, profile_records,
                     selfcheck)
from .roofline import (H100_SXM_ROOFLINE, TPU_V5E_ROOFLINE, measure_cpu_roofline,
                       platform_roofline)

__all__ = [
    "FUSED_PHASES",
    "MODELED_PHASES",
    "CompileLedger",
    "H100_SXM_ROOFLINE",
    "TPU_V5E_ROOFLINE",
    "collect_compile_events",
    "compiled_cost_facts",
    "find_cost_model",
    "format_profile",
    "generation_cost",
    "ledger_counters",
    "measure_cpu_roofline",
    "phase_cost_for",
    "platform_roofline",
    "profile_records",
    "selfcheck",
]
