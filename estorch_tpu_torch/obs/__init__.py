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
- device traces (``trace.py``): ``torch.profiler`` around a block;
- fleet aggregation (``agg/``): the collector, its time-series store and
  SLO rules, the dash, distributed-trace assembly and the autoscaler
  (stdlib-only, each runnable as a file without this package).

The submodules ``summarize`` and ``trace`` keep their names here: their
functions are ``obs.summarize.summarize`` and ``obs.trace.trace`` (also
``utils.trace``).

``python -m estorch_tpu_torch.obs`` runs ``summarize``, ``trace`` (and
``trace --fleet/--store``), ``profile``, ``regress``, ``hist``,
``serve-metrics``, ``collect``, ``dash``, ``slow`` and ``autoscale``.
"""

# PEP 562: importing the package imports no torch (the hub, the manifest
# and the device traces do, and load at first use), so the stdlib-only
# fleet layers under it start without torch
from .._lazy import lazy_names

_LAZY_FROM = {
    "counters": ("Counters", "NullCounters"),
    "export": ("MetricsSidecar", "export_trace", "parse_exposition", "render_exposition",
               "validate_trace"),
    "hist": ("Histogram", "Histograms", "NullHistograms"),
    "manifest": ("collect_manifest", "load_manifest", "write_manifest"),
    "recorder": ("HEARTBEAT_ENV", "STALE_AFTER_S", "FlightRecorder", "Heartbeat",
                 "describe_heartbeat", "read_heartbeat"),
    "sinks": ("JsonlSink", "JsonlWriter", "MultiSink", "MultiWriter", "TensorBoardSink",
              "TensorBoardWriter"),
    "spans": ("NULL_TELEMETRY", "OBS_DISABLE_ENV", "Telemetry", "resolve_telemetry"),
    "trace": ("annotate", "timed_generations"),
}
_SUBMODULES = ("agg", "counters", "export", "hist", "manifest", "profile", "recorder", "sinks",
               "spans", "summarize", "trace", "tracing")
__getattr__, __dir__ = lazy_names(
    __name__, globals(), {n: m for m, ns in _LAZY_FROM.items() for n in ns}, _SUBMODULES)

__all__ = [
    "Counters", "FlightRecorder", "HEARTBEAT_ENV", "Heartbeat", "Histogram", "Histograms",
    "JsonlSink", "JsonlWriter", "MetricsSidecar", "MultiSink", "MultiWriter",
    "NULL_TELEMETRY", "NullCounters", "NullHistograms", "OBS_DISABLE_ENV", "STALE_AFTER_S",
    "TensorBoardSink", "TensorBoardWriter", "Telemetry", "annotate", "collect_manifest",
    "describe_heartbeat", "export", "export_trace", "load_manifest", "parse_exposition",
    "read_heartbeat", "render_exposition", "resolve_telemetry", "timed_generations",
    "validate_trace", "write_manifest",
]
