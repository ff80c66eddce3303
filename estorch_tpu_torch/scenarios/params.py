"""ScenarioParams — the members' drawn physics constants, by name.

Counterpart of ``estorch_tpu/scenarios/params.py``.  The native envs are
frozen dataclasses of Python floats, right for one scenario.  Under a
scenario distribution each member runs its own variant, so a parameterized
family's ``step_p`` takes the constants as tensors of one value a member,
shape (n,): the number of variants changes these values, never the
operations an env step launches.  Which names exist is fixed by the
distribution; the values ride the env state (``scenarios/env.py``).
"""

from __future__ import annotations

from typing import Iterator, Mapping

# every env family accepts this name on top of its own SCENARIO_FIELDS: an
# additive observation-noise scale, applied by ScenarioEnv (the env's
# dynamics never see it)
OBS_NOISE = "obs_noise"


class ScenarioParams(Mapping):
    """Immutable name → value mapping with sorted keys.  A value is a
    tensor of one value a member, shape (n,), or one variant's 0-d value."""

    __slots__ = ("_values",)

    def __init__(self, values: Mapping):
        self._values = {str(k): values[k] for k in sorted(values)}

    def __getitem__(self, name: str):
        return self._values[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def get(self, name: str, default=None):
        return self._values.get(name, default)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self._values)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in self._values.items())
        return f"ScenarioParams({inner})"


def scenario_field_names(env) -> tuple[str, ...]:
    """The names a distribution may randomize for ``env``: the family's
    declared ``SCENARIO_FIELDS`` plus the generic ``obs_noise``.  Raises
    with a pointer when the env family was never parameterized."""
    fields = getattr(env, "SCENARIO_FIELDS", None)
    if fields is None:
        raise ValueError(
            f"{type(env).__name__} declares no SCENARIO_FIELDS — only the "
            "parameterized native families (Pendulum, CartPole, Acrobot, "
            "MountainCar[Continuous], the locomotion chains) support "
            "scenario randomization (docs/scenarios.md)"
        )
    return tuple(fields) + (OBS_NOISE,)
