"""Findings-count ratchet: per-rule debt that can only shrink.

The baseline answers "which EXACT findings are grandfathered"; the
ratchet answers a coarser question the lockset rules need: "how many
findings is each rule allowed, total?"  Identity-keyed baselining is
too brittle for race findings — refactoring a guarded region moves the
snippet and would force a baseline edit even when the debt is unchanged
— so CI pins a committed per-rule count instead:

* more findings than the recorded count -> regression, exit 1.  New
  race debt cannot land, full stop.
* fewer findings than the recorded count -> STALE, exit 2.  Whoever
  fixed a race must also lower the recorded count (``--write-ratchet``)
  so the improvement is locked in and cannot silently regress later.
* equal -> quiet.

The ratchet file is JSON, checked in next to the baseline::

    {"version": 1, "counts": {"R18": 0, "R19": 0, ...}}

Only rules listed in ``counts`` are ratcheted; other rules stay on the
identity baseline.  ``--changed`` runs skip the ratchet entirely — a
partial tree undercounts everything and would report every rule stale.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from .findings import Finding


@dataclass
class RatchetResult:
    # (rule, recorded, actual) — actual > recorded: new debt, exit 1
    regressions: list[tuple[str, int, int]] = field(default_factory=list)
    # (rule, recorded, actual) — actual < recorded: lower the count
    stale: list[tuple[str, int, int]] = field(default_factory=list)

    def ok(self) -> bool:
        return not self.regressions and not self.stale


def count_findings(findings: list[Finding],
                   rule_ids: list[str]) -> dict[str, int]:
    counts = {rid: 0 for rid in rule_ids}
    for f in findings:
        if f.rule in counts:
            counts[f.rule] += 1
    return counts


def load_ratchet(path: str) -> dict[str, int]:
    """Missing file -> empty ratchet (nothing pinned, nothing checked)."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return {str(k): int(v) for k, v in data.get("counts", {}).items()}


def save_ratchet(path: str, counts: dict[str, int]) -> None:
    payload = {"version": 1, "counts": dict(sorted(counts.items()))}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def check_ratchet(recorded: dict[str, int],
                  findings: list[Finding]) -> RatchetResult:
    """Compare actual per-rule totals against the recorded ceiling for
    every ratcheted rule.  Findings are counted whether or not the
    baseline suppressed them — the ratchet bounds TOTAL debt."""
    actual = count_findings(findings, list(recorded))
    res = RatchetResult()
    for rid in sorted(recorded):
        have, allow = actual[rid], recorded[rid]
        if have > allow:
            res.regressions.append((rid, allow, have))
        elif have < allow:
            res.stale.append((rid, allow, have))
    return res
