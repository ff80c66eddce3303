"""obs CLI: ``python -m estorch_tpu_torch.obs summarize``.

  summarize <run.jsonl> [--heartbeat PATH] [--manifest PATH] [--json]
      Per-phase time share, throughput trend, stall diagnosis, resilience
      counters and supervisor restarts of a training run's JSONL (the
      ``train(log_fn=JsonlSink(...))`` output).  A ``heartbeat.json`` and
      a ``manifest.json`` beside the JSONL are picked up when no path is
      given; a torn final line (a killed writer) is dropped with a note.

  summarize --heartbeat PATH
      The liveness of a process that writes no records.

  summarize --selfcheck
      Hold the golden record against the schema and the pipeline against
      synthetic runs.

The JAX package's other subcommands wait for the port: ``trace``,
``profile``, ``regress``, ``hist`` and ``serve-metrics`` for ROADMAP.md
port item 6b; ``collect``, ``dash``, ``slow`` and ``autoscale`` for item 9.

Exit codes: 0 ok; 1 selfcheck problems or unreadable input; 3 bad usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .summarize import format_summary, load_records_tolerant, selfcheck, summarize

# the JAX package's other subcommands, and the port's queue item each waits for
NOT_PORTED = {"trace": "6b", "profile": "6b", "regress": "6b", "hist": "6b",
              "serve-metrics": "6b", "collect": "9", "dash": "9", "slow": "9",
              "autoscale": "9"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m estorch_tpu_torch.obs",
                                description="observability tooling of the port")
    sub = p.add_subparsers(dest="cmd")
    s = sub.add_parser("summarize", help="per-phase share and stall diagnosis of a run")
    s.add_argument("jsonl", nargs="?", default=None,
                   help="run JSONL (one generation record per line)")
    s.add_argument("--heartbeat", default=None, metavar="PATH",
                   help="heartbeat file (default: heartbeat.json beside the JSONL)")
    s.add_argument("--manifest", default=None, metavar="PATH",
                   help="run manifest with the supervisor's restarts and counters "
                        "(default: manifest.json beside the JSONL)")
    s.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable summary on stdout")
    s.add_argument("--selfcheck", action="store_true",
                   help="validate the golden record and the pipeline, then exit")
    return p


def _beside(jsonl: str, explicit: str | None, name: str) -> str | None:
    if explicit is not None:
        return explicit
    cand = os.path.join(os.path.dirname(os.path.abspath(jsonl)), name)
    return cand if os.path.exists(cand) else None


def _cmd_summarize(args) -> int:
    if args.selfcheck:
        problems = selfcheck()
        for pr in problems:
            print(f"selfcheck: {pr}", file=sys.stderr)
        if problems:
            return 1
        print("obs selfcheck: OK (record schema + summarize pipeline)")
        return 0
    if not args.jsonl:
        if args.heartbeat:
            s = summarize([], heartbeat_path=args.heartbeat)
            print(json.dumps(s, default=float) if args.as_json else format_summary(s))
            return 0
        print("summarize needs a run JSONL (or --heartbeat PATH, or --selfcheck)",
              file=sys.stderr)
        return 3
    try:
        records, dropped = load_records_tolerant(args.jsonl)
    except (OSError, ValueError) as e:
        print(f"cannot read {args.jsonl}: {e}", file=sys.stderr)
        return 1
    if dropped:
        print(f"note: dropped a truncated final line in {args.jsonl} (crash artifact)",
              file=sys.stderr)
    s = summarize(records,
                  heartbeat_path=_beside(args.jsonl, args.heartbeat, "heartbeat.json"),
                  manifest_path=_beside(args.jsonl, args.manifest, "manifest.json"))
    print(json.dumps(s, default=float) if args.as_json else format_summary(s))
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] and argv[0] in NOT_PORTED:
        print(f"obs {argv[0]} is not ported yet (ROADMAP.md, port queue item "
              f"{NOT_PORTED[argv[0]]}); the port has: summarize", file=sys.stderr)
        return 3
    args = build_parser().parse_args(argv)
    if args.cmd == "summarize":
        return _cmd_summarize(args)
    build_parser().print_help()
    return 3


if __name__ == "__main__":
    sys.exit(main())
