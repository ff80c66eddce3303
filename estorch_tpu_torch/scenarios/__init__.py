"""estorch_tpu_torch.scenarios — domain randomization and PBT on the card.

Counterpart of ``estorch_tpu/scenarios`` (docs/scenarios.md):

* :class:`ScenarioParams` — the members' drawn physics constants by name,
  one value a member (params.py);
* :class:`ScenarioDistribution` / :func:`default_distribution` — seeded
  procedural randomization, deterministic in ``(seed, variant)``
  (distribution.py; the port's own stream, ``ops/noise.py``);
* :class:`ScenarioEnv` — any parameterized native env family rolled out
  under a per-episode drawn variant, the params riding the env state, so
  the number of variants changes values, never launches (env.py);
* per-variant fitness accounting for ``record["scenarios"]`` and ``obs
  summarize`` (fitness.py);
* :class:`PBTController` / :func:`tunable_optimizer` — population-based
  self-tuning of sigma / learning rate with a deterministic, bit-exactly
  replayable event log (pbt.py; the optimizer in ``optim.py``).

Wiring: ``ES(scenarios=<distribution>)`` (algo/es.py).
"""

from .distribution import LogRange, Range, ScenarioDistribution, default_distribution
from .env import ScenarioEnv, variant_of_bc
from .fitness import merge_scenario_blocks, scenario_fitness_block, worst_variant_callout
from .params import OBS_NOISE, ScenarioParams, scenario_field_names
from .pbt import PBTController, tunable_optimizer

__all__ = [
    "LogRange",
    "OBS_NOISE",
    "PBTController",
    "Range",
    "ScenarioDistribution",
    "ScenarioEnv",
    "ScenarioParams",
    "default_distribution",
    "merge_scenario_blocks",
    "scenario_fitness_block",
    "scenario_field_names",
    "tunable_optimizer",
    "variant_of_bc",
    "worst_variant_callout",
]
