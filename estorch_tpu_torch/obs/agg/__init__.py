"""estorch_tpu_torch.obs.agg — fleet-scope observability.

Counterpart of ``estorch_tpu/obs/agg`` (the port's own copies; code
equal but for ``autoscale.append_decision``).  Every surface below this package observes ONE process; this
package is the plane that watches N of them at once and remembers what
it saw:

- **store** — local append-only time-series store: windowed JSONL
  segments (tmp+rename commits, retention by segment count), reset-aware
  counter rates, and histogram-backed quantiles over stored history via
  ``obs/hist.py`` snapshot merges;
- **collector** — the scrape daemon (``python -m estorch_tpu_torch.obs
  collect``): many Prometheus endpoints + heartbeat run-dirs per tick,
  per-target timeouts and consecutive-failure state, everything through
  the one validating parser; exposes its own ``/metrics`` and
  ``/alerts``;
- **rules** — declarative SLO/alert rules (``rules.json``: threshold,
  absence, multi-window burn-rate over histogram-derived p99s) with
  firing/resolved transitions appended to an alerts ledger;
- **dash** — ``obs dash``: the fleet as one terminal table (per-target
  up/down, stored-history latency quantiles, queue depth, recompiles,
  desired-vs-actual replica convergence, active alerts);
- **autoscale** — ``obs autoscale``: the closed control loop: a pure
  policy step over the
  store's signals + a measured capacity artifact, actuating the
  fleet's ``POST /scale`` and appending every decision to a
  bit-exactly replayable log.

Every module is stdlib-only and file-runnable without the package (run
as a file it loads the port's own siblings by path and never imports
torch): the fleet plane must keep answering while the runtime it
watches, a replica's CUDA context, is hung.
"""

from .collector import (Collector, Target, load_targets, scrape_prometheus,
                        scrape_run_dir, validate_targets)
from .autoscale import (Autoscaler, AutoscaleError, decide, load_capacity,
                        read_decisions, replay, validate_capacity)
from .dash import fleet_snapshot, render
from .rules import RulesEngine, load_rules, read_ledger, validate_rules
from .store import SeriesStore

__all__ = [
    "Autoscaler",
    "AutoscaleError",
    "decide",
    "load_capacity",
    "read_decisions",
    "replay",
    "validate_capacity",
    "Collector",
    "Target",
    "load_targets",
    "validate_targets",
    "scrape_prometheus",
    "scrape_run_dir",
    "SeriesStore",
    "RulesEngine",
    "load_rules",
    "validate_rules",
    "read_ledger",
    "fleet_snapshot",
    "render",
]
