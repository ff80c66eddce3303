"""Record sinks: where the per-generation records go.

Counterpart of ``estorch_tpu/obs/sinks.py`` (stdlib only, the port's own
copy).  Each sink is a ``train(log_fn=...)`` callable taking one record:

- :class:`JsonlSink`: one JSON object a line, appended and line-buffered,
  so a killed run loses at most its last, torn line (``obs summarize``
  drops it);
- :class:`TensorBoardSink`: scalars through ``torch.utils.tensorboard``
  (optional), the nested ``phases`` as ``es/phase/<name>``;
- :class:`MultiSink`: fan-out to several sinks, with an optional echo.

Every rank of a multi-rank run holds the same records, so a
:class:`JsonlSink` appends only on rank 0 (``leader_only``,
``parallel/multihost.py``).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Sequence

from ..parallel.multihost import leader_only


class JsonlSink:
    """Append each generation record as one JSON line."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)

    @leader_only
    def __call__(self, record: dict) -> None:
        self._fh.write(json.dumps(record, default=float) + "\n")

    def close(self) -> None:
        self._fh.close()

    @staticmethod
    def read(path: str) -> list[dict]:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]


class TensorBoardSink:
    """Scalars to TensorBoard via ``torch.utils.tensorboard`` (optional)."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:  # tensorboard is not installed
            raise ImportError(
                "TensorBoardSink needs the tensorboard package; use "
                "JsonlSink in this environment") from e
        self._w = SummaryWriter(logdir)

    def __call__(self, record: dict) -> None:
        step = record.get("generation", 0)
        for k, v in record.items():
            if isinstance(v, (int, float)) and k != "generation":
                self._w.add_scalar(f"es/{k}", v, step)
            elif k == "phases" and isinstance(v, dict):
                for phase, dur in v.items():
                    if isinstance(dur, (int, float)):
                        self._w.add_scalar(f"es/phase/{phase}", dur, step)

    def close(self) -> None:
        self._w.close()


class MultiSink:
    """Fan a record out to several sinks; optionally echo to stdout."""

    def __init__(self, sinks: Sequence[Callable[[dict], None]], echo: bool = False):
        self.writers = list(sinks)
        self.echo = echo

    def __call__(self, record: dict) -> None:
        for w in self.writers:
            w(record)
        if self.echo:
            print(f"gen {record.get('generation', '?'):>4}  "
                  f"max {record.get('reward_max', float('nan')):9.2f}  "
                  f"mean {record.get('reward_mean', float('nan')):9.2f}  "
                  f"steps/s {record.get('env_steps_per_sec', 0):,.0f}")

    def close(self) -> None:
        for w in self.writers:
            if hasattr(w, "close"):
                w.close()


# the JAX package's historical names (``utils/metrics.py``)
JsonlWriter = JsonlSink
TensorBoardWriter = TensorBoardSink
MultiWriter = MultiSink
