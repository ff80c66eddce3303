"""Finding: one diagnostic emitted by an esguard rule.

A finding pins a (rule, file, line) triple plus everything a reader needs
to act on it without re-running the analyzer: severity, the offending
source line, a one-line message, and a concrete fix hint.  The identity
used for baseline suppression is deliberately line-number-free —
``(rule, file, symbol, snippet)`` — so unrelated edits above a
grandfathered finding don't invalidate the baseline entry.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable

# ordered weakest → strongest; CLI sorts strongest first
SEVERITIES = ("info", "warning", "error")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # "R01"
    file: str  # path as given to the analyzer (repo-relative in CI)
    line: int  # 1-based
    col: int  # 0-based (ast convention)
    severity: str  # one of SEVERITIES
    message: str  # what is wrong, one line
    hint: str  # how to fix it, one line
    symbol: str  # enclosing function qualname ("<module>" at top level)
    snippet: str  # stripped source line — part of the baseline identity

    def key(self) -> tuple[str, str, str, str]:
        """Baseline identity: stable across pure line-number drift."""
        return (self.rule, self.file, self.symbol, self.snippet)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (
            f"{self.file}:{self.line}:{self.col}: {self.rule} "
            f"[{self.severity}] {self.message}\n"
            f"    {self.snippet}\n"
            f"    hint: {self.hint}"
        )


def sort_findings(findings: Iterable[Finding]) -> list[Finding]:
    """Strongest severity first, then file/line for stable output."""
    return sorted(
        findings,
        key=lambda f: (
            -SEVERITIES.index(f.severity), f.file, f.line, f.rule),
    )


def findings_to_json(findings: Iterable[Finding]) -> str:
    return json.dumps(
        [f.to_dict() for f in findings], indent=2, sort_keys=True)
