"""Operator-facing surfaces over the obs hub.

Counterpart of ``estorch_tpu/obs/export/`` (stdlib only; the port keeps
its own copy of each module):

- **prometheus** — Prometheus text exposition encoder + validating parser
  over ``Counters.snapshot()`` and heartbeat freshness, byte-identical to
  the JAX package's for the same counters and histograms;
- **sidecar** — a stdlib-only metrics process over a run directory
  (``python -m estorch_tpu_torch.obs serve-metrics --run-dir D``;
  file-runnable without the package), composing the supervisor's
  published cross-restart totals with the live child's heartbeat;
- **traceevent** — ``obs trace run.jsonl`` → Perfetto/Chrome trace-event
  JSON: per-generation phase lanes, restart boundaries, a compiles lane,
  manifest-keyed process provenance;
- **regress** — ``obs regress``: robust medians + a learned noise band,
  per phase (``--phases``) or at a tail quantile (``--tail``), refusing
  to compare measurements taken on different platforms.

prometheus, sidecar and regress import nothing of the package either
(the sidecar's file-run mode loads its siblings by path).
"""

from .prometheus import (GAUGE_NAMES, histogram_series, is_gauge,
                         metric_name, parse_exposition, render_exposition,
                         samples_by_name, validate_histogram_series)
from .regress import (compare, compare_files, compare_tail,
                      compare_tail_files, load_measurement)
from .sidecar import (COUNTERS_FILENAME, MetricsSidecar, compose_hists,
                      compose_totals, publish_counters,
                      read_published_counters)
from .traceevent import export_trace, validate_trace, write_trace

__all__ = [
    "GAUGE_NAMES",
    "is_gauge",
    "metric_name",
    "parse_exposition",
    "render_exposition",
    "samples_by_name",
    "histogram_series",
    "validate_histogram_series",
    "compare",
    "compare_files",
    "compare_tail",
    "compare_tail_files",
    "load_measurement",
    "COUNTERS_FILENAME",
    "MetricsSidecar",
    "compose_totals",
    "compose_hists",
    "publish_counters",
    "read_published_counters",
    "export_trace",
    "validate_trace",
    "write_trace",
]
