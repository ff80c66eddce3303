"""esguard for the torch port: static analysis of ``estorch_tpu_torch``.

The port's own copy of the JAX package's analyzer (``estorch_tpu/
analysis/``, which it does not import), module for module.  The failure
modes that matter here — draws from torch's global generator breaking
mirrored sampling and replay, host syncs in a rollout's per-step loop or
in captured code, unbounded waits wedging a worker, timings that measure
a launch — are invisible to unit tests until the card makes them
expensive.  esguard catches them at AST level, on the CPU, in seconds:

    python -m estorch_tpu_torch.analysis estorch_tpu_torch/                # human
    python -m estorch_tpu_torch.analysis --format=json estorch_tpu_torch/  # machine
    python -m estorch_tpu_torch.analysis --changed origin/main...HEAD      # PR path

It runs with its own config (``config.package_config``: its baseline and
ratchet beside this module), never the repo's ``pyproject.toml``.

The rules whose trigger is not JAX's are the JAX analyzer's, unchanged
(R05, R06, R08, R09, R11, R12, R13, R15, R17–R23).  The eight that fire
only on JAX constructs there have torch forms here, under the same ids:

* R01 global-rng-draw         — torch.randn/rand/... or .normal_()/...
                                with no generator=, or torch.manual_seed
                                in library code
* R02 host-sync-in-hot-path   — .item()/.cpu()/float(t)/cuda.synchronize()
                                in CUDA-graph or torch.compile captured
                                code, or in a rollout's per-step loop
* R03 impure-capture          — print/time/np.random/closure mutation in
                                captured code (runs at capture only)
* R04 grad-mode-forward       — a rollout/serving forward outside
                                no_grad()/inference_mode()
* R05 untimed-subprocess-wait — proc.wait()/communicate() without timeout
* R06 signature-probe-default — inspect.signature fallback that guesses
* R07 unfenced-device-timing  — perf_counter delta around card work with
                                no synchronize/event fence
* R08 swallowed-fault         — pass-only except outside teardown/probes
* R09 nonmonotonic-span-clock — wall-clock deltas timing spans/ages
* R10 loop-invariant-host-copy — a loop-invariant host value copied to
                                the card inside a loop
* R11 blocking-wait-in-scheduler — unbounded queue.get/thread.join/
                                conn.recv in an event-loop hot path
* R12 gauge-shaped-latency    — perf_counter/monotonic duration recorded
                                via a last-write-wins gauge
* R13 untimed-network-call    — urlopen/HTTPConnection/create_connection
                                without timeout=
* R14 compile-in-request-path — torch.compile/torch.jit/cpp_extension.load
                                or the ops/_build.py loader in a request
                                handler or a non-load-time loop
* R15 unbounded-retry         — network retry loop with no attempt bound
                                or no backoff between attempts
* R16 per-variant-launches    — a loop over scenario variants launching
                                device work per variant
* R17 unfenced-cross-host-barrier — distributed init without a timeout,
                                or an untimed coordinator-socket wait

The R18–R22 lockset family runs at PROJECT scope — per-file summaries
are linked into a whole-program view (import graph, call graph,
shared-mutable-state inventory) before the checks fire, because no
single file shows both sides of a data race:

* R18 unguarded-shared-write  — attribute guarded by a lock somewhere,
                                written bare somewhere else
* R19 lock-order-inversion    — two locks taken in both orders
                                (lexically or one call level deep)
* R20 callback-mutates-foreign-state — thread/callback/handler root
                                mutating another object's state lockless
* R21 await-under-lock        — indefinitely-blocking call while a
                                lock is held
* R22 daemon-thread-orphan    — non-daemon thread never joined, or
                                started and dropped

Nothing in this package imports torch, jax, ``estorch_tpu`` or the
analyzed modules — analysis is pure ``ast`` and safe to run where no
card exists.
"""

from .baseline import (ApplyResult, Baseline, BaselineEntry, load_baseline,
                       save_baseline)
from .config import EsguardConfig, load_config
from .engine import (Rule, all_rules, analyze_paths, analyze_source,
                     default_jobs, get_rule, iter_py_files,
                     render_rule_table, rule)
from .findings import Finding, findings_to_json, sort_findings
from .project import ModuleSummary, ProjectContext, build_summary
from .ratchet import (RatchetResult, check_ratchet, count_findings,
                      load_ratchet, save_ratchet)

__all__ = [
    "ApplyResult", "Baseline", "BaselineEntry", "EsguardConfig", "Finding",
    "ModuleSummary", "ProjectContext", "RatchetResult", "Rule",
    "all_rules", "analyze_paths", "analyze_source", "build_summary",
    "check_ratchet", "count_findings", "default_jobs", "findings_to_json",
    "get_rule", "iter_py_files", "load_baseline", "load_config",
    "load_ratchet", "render_rule_table", "rule", "save_baseline",
    "save_ratchet", "sort_findings",
]
