"""Observability of ES runs: counterpart of ``estorch_tpu/obs``' hub.

- spans (``spans.py``): per-phase timers merged into each generation
  record as ``phases``, fenced on CUDA events for device work;
- counters and gauges (``counters.py``): env steps, rejected generations,
  rollout failures, the async scheduler's accounting, peak RSS;
- histograms (``hist.py``): queue waits, staleness, per-phase durations;
- flight recorder and heartbeat (``recorder.py``).

The JAX package's manifest, sinks, ``summarize``/``export`` and
``obs/profile/`` wait for ROADMAP.md port item 6.
"""

from .counters import Counters, NullCounters
from .hist import Histogram, Histograms, NullHistograms
from .recorder import HEARTBEAT_ENV, FlightRecorder, Heartbeat
from .spans import NULL_TELEMETRY, OBS_DISABLE_ENV, Telemetry, resolve_telemetry

__all__ = [
    "Counters", "FlightRecorder", "HEARTBEAT_ENV", "Heartbeat", "Histogram", "Histograms",
    "NULL_TELEMETRY", "NullCounters", "NullHistograms", "OBS_DISABLE_ENV", "Telemetry",
    "resolve_telemetry",
]
