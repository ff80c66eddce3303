"""Observability of ES runs: counterpart of ``estorch_tpu/obs``.

- spans (``spans.py``): per-phase timers merged into each generation
  record as ``phases``, fenced on CUDA events for device work; the hub
  also carries the compile ledger and the run's cost model;
- counters and gauges (``counters.py``): env steps, rejected generations,
  rollout failures, the async scheduler's accounting, peak RSS;
- histograms (``hist.py``): queue waits, staleness, per-phase durations,
  with exemplars, exports and cross-restart merges;
- flight recorder and heartbeat (``recorder.py``);
- record sinks (``sinks.py``), the run manifest (``manifest.py``) and the
  run summarizer (``summarize.py``);
- performance attribution (``profile/``): the analytic cost model, the
  H100 roofline, the compile ledger and ``obs profile``;
- export (``export/``): Prometheus exposition and the ``serve-metrics``
  sidecar, the Perfetto export (``obs trace``) and the ``obs regress``
  gate;
- device traces (``trace.py``): ``torch.profiler`` around a block.

The submodules ``summarize`` and ``trace`` keep their names here: their
functions are ``obs.summarize.summarize`` and ``obs.trace.trace`` (also
``utils.trace``).

``python -m estorch_tpu_torch.obs`` runs ``summarize``, ``trace``,
``profile``, ``regress``, ``hist`` and ``serve-metrics``.  The JAX
package's fleet subcommands wait for ROADMAP.md port item 9.
"""

from . import export  # noqa: F401  (prometheus/sidecar/trace/regress)
from .counters import Counters, NullCounters
from .export import (MetricsSidecar, export_trace, parse_exposition, render_exposition,
                     validate_trace)
from .hist import Histogram, Histograms, NullHistograms
from .manifest import collect_manifest, load_manifest, write_manifest
from .recorder import (HEARTBEAT_ENV, STALE_AFTER_S, FlightRecorder, Heartbeat,
                       describe_heartbeat, read_heartbeat)
from .sinks import (JsonlSink, JsonlWriter, MultiSink, MultiWriter, TensorBoardSink,
                    TensorBoardWriter)
from .spans import NULL_TELEMETRY, OBS_DISABLE_ENV, Telemetry, resolve_telemetry
from .trace import annotate, timed_generations

__all__ = [
    "Counters", "FlightRecorder", "HEARTBEAT_ENV", "Heartbeat", "Histogram", "Histograms",
    "JsonlSink", "JsonlWriter", "MetricsSidecar", "MultiSink", "MultiWriter",
    "NULL_TELEMETRY", "NullCounters", "NullHistograms", "OBS_DISABLE_ENV", "STALE_AFTER_S",
    "TensorBoardSink", "TensorBoardWriter", "Telemetry", "annotate", "collect_manifest",
    "describe_heartbeat", "export", "export_trace", "load_manifest", "parse_exposition",
    "read_heartbeat", "render_exposition", "resolve_telemetry", "timed_generations",
    "validate_trace", "write_manifest",
]
