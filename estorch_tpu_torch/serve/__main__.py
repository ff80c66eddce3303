"""serve CLI: ``python -m estorch_tpu_torch.serve --bundle <dir>``.

Counterpart of ``python -m estorch_tpu.serve``, with its flags, except
that ``--cpu-devices`` (which pins XLA's CPU layout) becomes ``--device``:
the server runs on ``cuda`` unless ``--device cpu`` is given, and a
missing card is an error, never a silent fallback.

``serve route --fleet fleet.json`` runs the fleet instead: the front
router (serve/router.py) and the supervisor of its replicas
(serve/fleet.py); ``serve route --replicas name=host:port,...`` routes
over replicas run elsewhere.  Both are stdlib-only and dispatch before
any torch-importing module of this package loads.

``--supervised`` wraps the server in the watchdog
(resilience/supervisor.py): heartbeat-staleness + exit-status restarts
with exponential backoff; SIGTERM to the supervisor forwards to the
child, which drains and exits cleanly.

Exit codes: 0 clean drain; 1 drain left work behind / supervision gave
up; 2 bad bundle, device or arguments.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m estorch_tpu_torch.serve",
        description="serve a policy bundle over HTTP; `route --fleet "
                    "fleet.json` runs the fleet's front router instead")
    p.add_argument("--bundle", required=True, metavar="DIR",
                   help="bundle directory written by export_bundle")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321,
                   help="0 picks an ephemeral port (see --port-file)")
    p.add_argument("--max-batch", type=int, default=32,
                   help="bucket ladder top (power of two); 1 = the "
                        "batch-size-1 baseline")
    p.add_argument("--max-wait-ms", type=float, default=4.0,
                   help="batching window from the first queued request")
    p.add_argument("--max-queue", type=int, default=256,
                   help="admission-control queue bound (full => 503)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; 'cpu' "
                        "serves on the CPU)")
    p.add_argument("--warm", action="store_true",
                   help="run the serving bucket once before READY when "
                        "it is the only one (the verification runs the "
                        "others); flatter first-request latency")
    p.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                   help="serving compute dtype; bf16 is the quantized "
                        "fast path — refused (exit 2 / 409) unless the "
                        "bundle opted in at export and its measured "
                        "divergence stays inside the documented bound")
    p.add_argument("--port-file", default=None, metavar="PATH",
                   help="atomically write {host,port,pid} JSON once bound")
    p.add_argument("--run-dir", default=None, metavar="DIR",
                   help="per-process observability dir: sampled trace "
                        "segments flush to <DIR>/traces.jsonl")
    p.add_argument("--beat-interval", type=float, default=2.0,
                   help="idle heartbeat period (ESTORCH_OBS_HEARTBEAT)")
    p.add_argument("--supervised", action="store_true",
                   help="run under the resilience watchdog (heartbeat "
                        "staleness + crash restarts)")
    p.add_argument("--supervise-root", default="serve_run", metavar="DIR",
                   help="supervision state dir (heartbeat, manifest)")
    p.add_argument("--max-restarts", type=int, default=5)
    p.add_argument("--stale-after-s", type=float, default=30.0)
    p.add_argument("--startup-grace-s", type=float, default=120.0)
    return p


def main(argv=None) -> int:
    import time

    t0 = time.monotonic()  # startup_s covers the torch import + load
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "route":
        # the fleet's front door: router + optional fleet supervisor,
        # dispatched before the bundle-serving machinery loads
        from .router import main as route_main

        return route_main(argv[1:])
    args = build_parser().parse_args(argv)
    args._t0_monotonic = t0
    # config validation BEFORE anything heavy (and before --supervised
    # spawns): a bad --max-batch or a missing card must be exit 2 with one
    # line, not a traceback — or a supervised child crash-looping through
    # max_restarts
    from .batcher import bucket_sizes

    try:
        bucket_sizes(args.max_batch)
    except ValueError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    from ..utils.backend import resolve_device

    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    from .bundle import BundleError
    from .server import run_server, run_supervised

    try:
        if args.supervised:
            return run_supervised(args, argv)
        return run_server(args)
    except BundleError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
