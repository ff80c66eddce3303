"""ScenarioDistribution — seeded, declarative domain randomization.

Counterpart of ``estorch_tpu/scenarios/distribution.py``.  A distribution
is a dict of per-parameter ranges (uniform or log-uniform) plus
``(n_variants, seed)``.  Variant ``v``'s parameters come from the ``(seed,
v)`` stream (``ops/noise.py`` ``scenario_variant_generator``), drawn on the
CPU: deterministic across generations, members, processes and devices, so
a scenario is a name a run's manifest carries and a replay reproduces.

The port's stream is its own, not threefry: one ``spec_json`` names other
constants here than in the JAX package, and each package reproduces its
own exactly (tests hand the JAX package's drawn table over through
``interop.scenario_distribution_from_jax``).  :meth:`ScenarioDistribution.
draw_all` is the ``(n_variants,)`` table per name, computed once; an env
reads a member's variant out of it (:meth:`ScenarioDistribution.draw` with
a tensor of variants), so the number of variants changes values, never the
operations a generation launches.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.noise import scenario_variant_generator
from .params import OBS_NOISE, ScenarioParams, scenario_field_names

SPEC_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class Range:
    """Uniform (or, with ``log=True``, log-uniform) draw in [lo, hi]."""

    lo: float
    hi: float
    log: bool = False

    def __post_init__(self):
        if not (math.isfinite(self.lo) and math.isfinite(self.hi)):
            raise ValueError(f"range bounds must be finite, got {self}")
        if self.lo > self.hi:
            raise ValueError(f"need lo <= hi, got {self}")
        if self.log and self.lo <= 0:
            raise ValueError(
                f"log-uniform needs lo > 0, got {self} — use a linear "
                "Range for parameters that may reach zero")

    def value(self, u: torch.Tensor) -> torch.Tensor:
        """The range's float32 value at uniform draws ``u`` in [0, 1), with
        the JAX package's operations."""
        if self.log:
            llo, lhi = math.log(self.lo), math.log(self.hi)
            return torch.exp(llo + u * (lhi - llo))
        return self.lo + u * (self.hi - self.lo)


def LogRange(lo: float, hi: float) -> Range:  # noqa: N802 (the JAX package's name)
    """Log-uniform range — the right prior for scale-like constants
    (masses, gains) whose plausible values span octaves."""
    return Range(lo, hi, log=True)


def _as_range(name: str, r) -> Range:
    if isinstance(r, Range):
        return r
    if isinstance(r, (tuple, list)) and len(r) == 2:
        return Range(float(r[0]), float(r[1]))
    raise TypeError(
        f"range for {name!r} must be a Range/LogRange or a (lo, hi) "
        f"pair, got {r!r}")


class ScenarioDistribution:
    """≥1 procedurally-drawn variants of one env family's constants."""

    def __init__(self, ranges: dict, n_variants: int = 10, seed: int = 0):
        if not ranges:
            raise ValueError("a ScenarioDistribution needs at least one "
                             "parameter range")
        if int(n_variants) < 1:
            raise ValueError(f"n_variants must be >= 1, got {n_variants}")
        self.ranges: dict[str, Range] = {
            str(k): _as_range(str(k), v) for k, v in ranges.items()}
        self.n_variants = int(n_variants)
        self.seed = int(seed)
        self.names: tuple[str, ...] = tuple(sorted(self.ranges))
        self._table: torch.Tensor | None = None  # (n_variants, names), CPU

    # ---- validation ------------------------------------------------------

    def validate_for(self, env) -> None:
        """Every randomized name must be one the env family declared (or
        the generic ``obs_noise``) — a typo'd constant silently drawing
        into nowhere would be a scenario that never happens."""
        allowed = set(scenario_field_names(env))
        unknown = [n for n in self.names if n not in allowed]
        if unknown:
            raise ValueError(
                f"{type(env).__name__} has no scenario parameter(s) "
                f"{unknown}; it declares {sorted(allowed)}")

    # ---- draws -----------------------------------------------------------

    def table(self) -> torch.Tensor:
        """The ``(n_variants, len(names))`` float32 table of every
        variant's draws, on the CPU: row ``v`` holds one uniform draw a
        name, in sorted-name order, from variant ``v``'s generator, mapped
        into its range.  Computed once."""
        if self._table is None:
            u = torch.stack([
                torch.rand((len(self.names),), generator=scenario_variant_generator(self.seed, v),
                           dtype=torch.float32)
                for v in range(self.n_variants)])
            self._table = torch.stack(
                [self.ranges[n].value(u[:, i]) for i, n in enumerate(self.names)], dim=1)
        return self._table

    def draw(self, variant) -> ScenarioParams:
        """Variant ``variant``'s parameters, deterministic in ``(seed,
        variant)`` only: 0-d tensors for an int, or (n,) tensors on the
        variants' device for an integer tensor of n variants (a gather
        from :meth:`table`)."""
        table = self.table()
        if isinstance(variant, torch.Tensor):
            rows = table.to(variant.device)[variant.long()]
            return ScenarioParams({n: rows[..., i] for i, n in enumerate(self.names)})
        row = table[int(variant)]
        return ScenarioParams({n: row[i] for i, n in enumerate(self.names)})

    def draw_all(self) -> ScenarioParams:
        """All variants stacked: each value has a leading ``(n_variants,)``
        axis."""
        table = self.table()
        return ScenarioParams({n: table[:, i] for i, n in enumerate(self.names)})

    def draw_concrete(self, variant: int) -> dict[str, float]:
        """Host-side Python floats for one variant."""
        row = self.table()[int(variant)]
        return {n: float(row[i]) for i, n in enumerate(self.names)}

    # ---- provenance ------------------------------------------------------

    def spec_json(self) -> dict:
        """The manifest-ready spec: distribution schema + draw seed — a
        bundle carrying this names the scenarios it was trained under,
        exactly (the draw is deterministic in this spec alone)."""
        return {
            "schema": SPEC_SCHEMA,
            "n_variants": self.n_variants,
            "seed": self.seed,
            "ranges": {
                n: {"lo": r.lo, "hi": r.hi, "log": r.log}
                for n, r in self.ranges.items()
            },
        }

    @classmethod
    def from_json(cls, spec: dict) -> "ScenarioDistribution":
        if spec.get("schema") != SPEC_SCHEMA:
            raise ValueError(
                f"unknown scenario spec schema {spec.get('schema')!r}")
        ranges = {
            n: Range(float(r["lo"]), float(r["hi"]), bool(r.get("log")))
            for n, r in spec["ranges"].items()
        }
        return cls(ranges, n_variants=int(spec["n_variants"]),
                   seed=int(spec["seed"]))

    def __repr__(self) -> str:
        return (f"ScenarioDistribution(n_variants={self.n_variants}, "
                f"seed={self.seed}, names={list(self.names)})")


def default_distribution(env, n_variants: int = 10, spread: float = 0.3,
                         obs_noise: float = 0.0, seed: int = 0
                         ) -> ScenarioDistribution:
    """±``spread`` uniform ranges around every declared constant of
    ``env`` (scale families randomize around 1.0), plus an optional
    additive observation-noise scale in [0, ``obs_noise``]."""
    if not 0.0 < spread < 1.0:
        raise ValueError(f"spread must be in (0, 1), got {spread}")
    scenario_field_names(env)  # the families-without-SCENARIO_FIELDS error
    defaults = env.scenario_defaults()
    ranges: dict[str, Range] = {}
    for name, d in defaults.items():
        lo, hi = d * (1.0 - spread), d * (1.0 + spread)
        ranges[name] = Range(min(lo, hi), max(lo, hi))
    if obs_noise > 0.0:
        ranges[OBS_NOISE] = Range(0.0, float(obs_noise))
    dist = ScenarioDistribution(ranges, n_variants=n_variants, seed=seed)
    dist.validate_for(env)
    return dist
