"""Baseline (suppression) file: grandfathered findings, checked in.

The baseline lets the lint gate turn on strict TODAY while existing
findings are burned down deliberately: a finding whose identity
``(rule, file, symbol, snippet)`` appears in the baseline is suppressed;
a baseline entry matching nothing is reported STALE so fixed findings
cannot leave dead suppressions behind (the round-trip
``tests/test_analysis.py`` exercises exactly that cycle).

Every entry carries a human ``reason`` — a baseline is a justified debt
ledger, not a mute button.  Identity is line-number-free on purpose:
editing code above a grandfathered finding must not invalidate it.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from .findings import Finding


def _norm(path: str) -> str:
    return os.path.normpath(path).replace(os.sep, "/")


@dataclass(frozen=True)
class BaselineEntry:
    rule: str
    file: str
    symbol: str
    snippet: str
    reason: str = ""

    def key(self) -> tuple[str, str, str, str]:
        return (self.rule, _norm(self.file), self.symbol, self.snippet)


@dataclass
class ApplyResult:
    unsuppressed: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    stale: list[BaselineEntry] = field(default_factory=list)


@dataclass
class Baseline:
    entries: list[BaselineEntry] = field(default_factory=list)

    def apply(self, findings: list[Finding]) -> ApplyResult:
        by_key = {e.key(): e for e in self.entries}
        res = ApplyResult()
        matched: set[tuple] = set()
        for f in findings:
            k = (f.rule, _norm(f.file), f.symbol, f.snippet)
            if k in by_key:
                matched.add(k)
                res.suppressed.append(f)
            else:
                res.unsuppressed.append(f)
        res.stale = [e for e in self.entries if e.key() not in matched]
        return res

    def unjustified(self) -> list[BaselineEntry]:
        return [e for e in self.entries if not e.reason.strip()]


def load_baseline(path: str) -> Baseline:
    """Missing file -> empty baseline (strict-by-default for new repos)."""
    if not os.path.exists(path):
        return Baseline()
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    entries = []
    for raw in data.get("entries", []):
        entries.append(BaselineEntry(
            rule=raw["rule"], file=raw["file"], symbol=raw["symbol"],
            snippet=raw["snippet"], reason=raw.get("reason", "")))
    return Baseline(entries)


def save_baseline(path: str, findings: list[Finding],
                  reason: str = "") -> Baseline:
    """Write findings as baseline entries.  The default ``reason`` is
    EMPTY on purpose: auto-written entries report as UNJUSTIFIED until a
    human edits in why each one is allowed to stay."""
    entries = []
    seen: set[tuple] = set()
    for f in findings:
        k = (f.rule, _norm(f.file), f.symbol, f.snippet)
        if k in seen:
            continue
        seen.add(k)
        entries.append(BaselineEntry(
            rule=f.rule, file=_norm(f.file), symbol=f.symbol,
            snippet=f.snippet, reason=reason))
    payload = {
        "version": 1,
        "entries": [vars(e) for e in entries],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return Baseline(entries)
