"""Observability of ES runs: counterpart of ``estorch_tpu/obs``' hub.

- spans (``spans.py``): per-phase timers merged into each generation
  record as ``phases``, fenced on CUDA events for device work;
- counters and gauges (``counters.py``): env steps, rejected generations,
  rollout failures, the async scheduler's accounting, peak RSS;
- histograms (``hist.py``): queue waits, staleness, per-phase durations;
- flight recorder and heartbeat (``recorder.py``);
- record sinks (``sinks.py``), the run manifest (``manifest.py``) and the
  run summarizer (``summarize.py``, ``python -m estorch_tpu_torch.obs
  summarize``).

The JAX package's ``obs/profile/``, ``trace.py`` and ``export/`` wait for
ROADMAP.md port item 6b.
"""

from .counters import Counters, NullCounters
from .hist import Histogram, Histograms, NullHistograms
from .manifest import collect_manifest, load_manifest, write_manifest
from .recorder import (HEARTBEAT_ENV, STALE_AFTER_S, FlightRecorder, Heartbeat,
                       describe_heartbeat, read_heartbeat)
from .sinks import JsonlSink, MultiSink, TensorBoardSink
from .spans import NULL_TELEMETRY, OBS_DISABLE_ENV, Telemetry, resolve_telemetry

__all__ = [
    "Counters", "FlightRecorder", "HEARTBEAT_ENV", "Heartbeat", "Histogram", "Histograms",
    "JsonlSink", "MultiSink", "NULL_TELEMETRY", "NullCounters", "NullHistograms",
    "OBS_DISABLE_ENV", "STALE_AFTER_S", "TensorBoardSink", "Telemetry", "collect_manifest",
    "describe_heartbeat", "load_manifest", "read_heartbeat", "resolve_telemetry",
    "write_manifest",
]
