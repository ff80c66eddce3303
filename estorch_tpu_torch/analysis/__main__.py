"""esguard CLI for the port: ``python -m estorch_tpu_torch.analysis [paths...]``.

It runs with the port's own config (``config.package_config``: the
baseline and ratchet beside this module), never the repo's
``pyproject.toml``.

Exit codes: 0 clean; 1 unsuppressed findings or a ratchet regression;
2 ledger problems only (stale/unjustified baseline entries or a stale
ratchet count with an otherwise-clean tree); 3 bad invocation.

``--format=json`` (or the legacy ``--json`` flag) emits the full
machine-readable report CI archives as an artifact.  ``--changed
<git-range>`` analyzes only the ``.py`` files touched in that range —
the fast PR path — and skips the ratchet plus stale-entry checks, which
are only meaningful against the whole tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from .baseline import Baseline, load_baseline, save_baseline
from .config import load_config
from .engine import all_rules, analyze_paths, default_jobs
from .findings import sort_findings
from .ratchet import (RatchetResult, check_ratchet, count_findings,
                      load_ratchet, save_ratchet)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m estorch_tpu_torch.analysis",
        description="esguard for the torch port: static analysis "
                    "(RNG/capture/host/lockset hazards)")
    p.add_argument("paths", nargs="*", default=["estorch_tpu_torch"],
                   help="files or directories (default: estorch_tpu_torch)")
    p.add_argument("--changed", default=None, metavar="GIT_RANGE",
                   help="analyze only .py files changed in this git "
                        "range (e.g. origin/main...HEAD); skips the "
                        "ratchet and stale-baseline checks")
    p.add_argument("--format", default=None, dest="fmt",
                   choices=["text", "json"],
                   help="report format (default: text)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="alias for --format=json")
    p.add_argument("--jobs", type=int, default=None, metavar="N",
                   help="process-pool width for per-file analysis "
                        f"(default: min(cpus, 8) = {default_jobs()})")
    p.add_argument("--config", default=None, metavar="PYPROJECT",
                   help="a file with a [tool.esguard] table "
                        "(default: the port's own config, "
                        "analysis/config.py)")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="baseline JSON (overrides config)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any configured baseline")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current findings to the baseline and exit 0")
    p.add_argument("--ratchet", default=None, metavar="PATH",
                   help="ratchet JSON (overrides config)")
    p.add_argument("--no-ratchet", action="store_true",
                   help="ignore any configured ratchet")
    p.add_argument("--write-ratchet", action="store_true",
                   help="pin current per-rule totals for the rules the "
                        "ratchet file already lists (all active rules "
                        "when the file is new) and exit 0")
    p.add_argument("--select", default=None, metavar="IDS",
                   help="comma-separated rule ids to run (e.g. R01,R05)")
    p.add_argument("--ignore", default=None, metavar="IDS",
                   help="comma-separated rule ids to skip")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    return p


def changed_files(git_range: str) -> list[str] | None:
    """``.py`` files touched in the range that still exist (deletions
    have nothing to analyze).  None on git failure -> exit 3 upstream."""
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", "-z", git_range, "--", "*.py"],
            capture_output=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    names = [n for n in out.stdout.decode("utf-8", "replace").split("\0")
             if n]
    return [n for n in names if os.path.exists(n)]


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    rules = all_rules()

    if args.list_rules:
        for r in rules:
            print(f"{r.id}  {r.name:26s} [{r.severity}/{r.scope}] "
                  f"{r.description}")
        return 0

    cfg = load_config(args.config)
    ids = cfg.rule_ids([r.id for r in rules])
    if args.select:
        ids = [i for i in ids if i in args.select.split(",")]
    if args.ignore:
        ids = [i for i in ids if i not in args.ignore.split(",")]
    active = [r for r in rules if r.id in ids]
    if not active:
        print("esguard: no rules selected", file=sys.stderr)
        return 3

    fmt = "json" if args.as_json else (args.fmt or "text")

    paths = args.paths
    if args.changed is not None:
        paths = changed_files(args.changed)
        if paths is None:
            print(f"esguard: git diff failed for range "
                  f"{args.changed!r}", file=sys.stderr)
            return 3
        if not paths:
            if fmt == "json":
                print(json.dumps({"rules": ids, "findings": [],
                                  "suppressed": [], "stale_baseline": [],
                                  "unjustified_baseline": [],
                                  "ratchet": None, "changed": []},
                                 indent=2, sort_keys=True))
            else:
                print("esguard: no changed python files in "
                      f"{args.changed}")
            return 0

    findings = sort_findings(analyze_paths(
        paths, rules=active, exclude=cfg.exclude, jobs=args.jobs))

    baseline_path = args.baseline or cfg.baseline_path()
    if args.no_baseline:
        baseline_path = None
    ratchet_path = args.ratchet or cfg.ratchet_path()
    if args.no_ratchet or args.changed is not None:
        ratchet_path = None

    if args.write_baseline:
        if baseline_path is None:
            print("esguard: --write-baseline needs --baseline or a "
                  "config baseline", file=sys.stderr)
            return 3
        save_baseline(baseline_path, findings)
        print(f"esguard: wrote {len(findings)} entr"
              f"{'y' if len(findings) == 1 else 'ies'} to {baseline_path} "
              "— add a `reason` to each before committing")
        return 0

    if args.write_ratchet:
        ratchet_path = args.ratchet or cfg.ratchet_path()
        if ratchet_path is None:
            print("esguard: --write-ratchet needs --ratchet or a "
                  "config ratchet", file=sys.stderr)
            return 3
        recorded = load_ratchet(ratchet_path)
        pin_ids = sorted(recorded) if recorded else ids
        counts = count_findings(findings, pin_ids)
        save_ratchet(ratchet_path, counts)
        print(f"esguard: pinned {len(counts)} rule count"
              f"{'' if len(counts) == 1 else 's'} in {ratchet_path}")
        return 0

    baseline = (load_baseline(baseline_path)
                if baseline_path is not None else Baseline())
    res = baseline.apply(findings)
    unjustified = baseline.unjustified()
    # a partial tree makes every untouched baseline entry look stale
    if args.changed is not None:
        res.stale = []
        unjustified = []

    ratchet_res = RatchetResult()
    if ratchet_path is not None:
        ratchet_res = check_ratchet(load_ratchet(ratchet_path), findings)

    if fmt == "json":
        print(json.dumps({
            "rules": ids,
            "findings": [f.to_dict() for f in res.unsuppressed],
            "suppressed": [f.to_dict() for f in res.suppressed],
            "stale_baseline": [vars(e) for e in res.stale],
            "unjustified_baseline": [vars(e) for e in unjustified],
            "ratchet": None if ratchet_path is None else {
                "path": ratchet_path,
                "regressions": [
                    {"rule": r, "recorded": a, "actual": b}
                    for r, a, b in ratchet_res.regressions],
                "stale": [
                    {"rule": r, "recorded": a, "actual": b}
                    for r, a, b in ratchet_res.stale],
            },
            "changed": (paths if args.changed is not None else None),
        }, indent=2, sort_keys=True))
    else:
        for f in res.unsuppressed:
            print(f.render())
        for e in res.stale:
            print(f"STALE baseline entry: {e.rule} {e.file} [{e.symbol}] "
                  f"`{e.snippet}` — the finding is gone; delete the entry")
        for e in unjustified:
            print(f"UNJUSTIFIED baseline entry: {e.rule} {e.file} "
                  f"[{e.symbol}] — add a `reason`")
        for rid, allow, have in ratchet_res.regressions:
            print(f"RATCHET regression: {rid} has {have} finding"
                  f"{'' if have == 1 else 's'}, ceiling is {allow} — "
                  "fix the new ones; the count cannot grow")
        for rid, allow, have in ratchet_res.stale:
            print(f"STALE ratchet count: {rid} has {have}, recorded "
                  f"{allow} — lock the improvement in with "
                  "--write-ratchet")
        n = len(res.unsuppressed)
        print(f"esguard: {n} finding{'' if n == 1 else 's'} "
              f"({len(res.suppressed)} baselined, {len(res.stale)} stale, "
              f"{len(findings)} total) across rules {','.join(ids)}")

    if res.unsuppressed or ratchet_res.regressions:
        return 1
    if res.stale or unjustified or ratchet_res.stale:
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
