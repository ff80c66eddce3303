"""The device agent: names a batched env and a horizon.

Counterpart of ``JaxAgent`` in ``estorch_tpu/envs/agent.py``.  The engine
runs the rollouts itself; the agent steps nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class DeviceAgent:
    """Wraps a batched device env (``envs/base.py``) for the engine."""

    env: Any
    horizon: int | None = None

    @property
    def rollout_horizon(self) -> int:
        return int(self.horizon or self.env.default_horizon)
