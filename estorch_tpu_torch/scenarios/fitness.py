"""Per-variant fitness accounting: the record["scenarios"] block.

The port's copy of ``estorch_tpu/scenarios/fitness.py`` (NumPy only, the
same code).  The variant id rides the BC channel (``ScenarioEnv.behavior``
appends it as the last column), so one O(population) host pass per
generation turns the fitness vector into a per-variant breakdown — the
data ``python -m estorch_tpu_torch.obs summarize``'s scenarios section and
the PBT objective (``scenarios/pbt.py``) consume.
"""

from __future__ import annotations

import math

import numpy as np


def scenario_fitness_block(fitness, variants, n_variants: int) -> dict:
    """``{"n_variants", "counts", "mean", "best"}`` for one generation.

    ``variants`` is the BC variant column (floats carrying small ints);
    a variant no member drew this generation gets count 0 and NaN stats
    (JSON-legal — the schema treats NaN like a failed generation's
    reward).  NaN FITNESS (failed rollouts) is excluded from mean/best
    but still counted in ``counts`` — coverage is about assignment, not
    success."""
    fitness = np.asarray(fitness, np.float64)
    idx = np.asarray(np.rint(np.asarray(variants, np.float64)), np.int64)
    n_variants = int(n_variants)
    counts = [0] * n_variants
    means: list[float] = [math.nan] * n_variants
    bests: list[float] = [math.nan] * n_variants
    for v in range(n_variants):
        sel = fitness[idx == v]
        counts[v] = int(sel.size)
        finite = sel[np.isfinite(sel)]
        if finite.size:
            means[v] = float(finite.mean())
            bests[v] = float(finite.max())
    return {
        "n_variants": n_variants,
        "counts": counts,
        "mean": means,
        "best": bests,
    }


def merge_scenario_blocks(blocks: list[dict]) -> dict | None:
    """Fold per-generation blocks into one run-level view: count-weighted
    per-variant means, run-best bests, summed counts.  Blocks with
    mismatched ``n_variants`` (a mixed file) fold at the largest width.
    Returns None for an empty list."""
    blocks = [b for b in blocks if isinstance(b, dict)
              and isinstance(b.get("n_variants"), int)]
    if not blocks:
        return None
    width = max(int(b["n_variants"]) for b in blocks)
    counts = np.zeros(width, np.int64)
    wsum = np.zeros(width, np.float64)  # Σ mean·count over finite means
    wcnt = np.zeros(width, np.float64)
    best = np.full(width, -np.inf)
    for b in blocks:
        c = np.asarray(b.get("counts", []), np.float64)
        m = np.asarray(b.get("mean", []), np.float64)
        bb = np.asarray(b.get("best", []), np.float64)
        n = min(width, c.size, m.size, bb.size)
        counts[:n] += c[:n].astype(np.int64)
        ok = np.isfinite(m[:n]) & (c[:n] > 0)
        wsum[:n][ok] += m[:n][ok] * c[:n][ok]
        wcnt[:n][ok] += c[:n][ok]
        okb = np.isfinite(bb[:n])
        best[:n][okb] = np.maximum(best[:n][okb], bb[:n][okb])
    means = np.where(wcnt > 0, wsum / np.maximum(wcnt, 1), np.nan)
    return {
        "n_variants": width,
        "counts": [int(c) for c in counts],
        "mean": [float(m) for m in means],
        "best": [float(b) if np.isfinite(b) else math.nan for b in best],
    }


def worst_variant_callout(block: dict, mad_factor: float = 2.0
                          ) -> dict | None:
    """The laggard diagnosis: the variant whose mean fitness trails the
    family median by more than ``mad_factor`` × the cross-variant MAD
    (None when no variant lags, or when spread is degenerate — a zero
    MAD would call out any noise at all)."""
    means = np.asarray(block.get("mean", []), np.float64)
    finite = means[np.isfinite(means)]
    if finite.size < 3:
        return None
    med = float(np.median(finite))
    mad = float(np.median(np.abs(finite - med)))
    if mad <= 0:
        return None
    worst_v = int(np.nanargmin(np.where(np.isfinite(means), means, np.inf)))
    worst = float(means[worst_v])
    lag = med - worst
    if lag <= mad_factor * mad:
        return None
    return {
        "variant": worst_v,
        "mean": worst,
        "family_median": med,
        "cross_variant_mad": mad,
        "lag_in_mads": float(lag / mad),
    }
