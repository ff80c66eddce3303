"""Environment doctor: diagnose the card and the runtime before training.

The counterpart of ``estorch_tpu/doctor.py`` for the port, with its checks,
its report rows, its status and reason taxonomy and its exit code (0 only
when the device is healthy).  A card's runtime can hang where no
exception reaches Python — a CUDA context that never comes up, an nvcc
build that goes silent, a launch that never returns — and a user whose
training script "does nothing" cannot tell a slow first build from a dead
card.  So the device is probed from a SUBPROCESS with a hard timeout (an
in-process call cannot be timed out once it enters the CUDA runtime), in
stages: torch's import, CUDA's init, the kernel library's build or cached
load (``ops/_build.py``), and one launch of each of the port's two
kernels against its plain version.  The first stage missing when the
timeout kills the child names the layer that hung.

Without ``device="cpu"`` the probe asks for the card: a host without one
is ``no-device``, never a quiet CPU run.  ``device="cpu"`` runs the same
stages on the CPU with the kernels' plain versions.  The other checks
(the envpool build, a sharded step over two gloo ranks, the elastic
coordinator with a ``--join`` host, scenarios, the obs/serving/fleet
planes over loopback) run on the CPU, each in its own timed-out child
where it touches torch.

This module imports the standard library only: torch and the port's
modules load inside the checks and their children.

Use:  python -m estorch_tpu_torch.doctor [--timeout S] [--run-dir DIR]
      [--resilience-probe] [--bundle DIR] [--device cpu]
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

# the checkout's root: children import the port from it even when the
# package is not installed
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# where ops/_build.py and envs/native_pool.py keep their built libraries
_BUILD_DIR = os.path.join(_ROOT, "build", "estorch_tpu_torch")


def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = (_ROOT + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else _ROOT)
    return env


def _markers(out: str) -> set[str]:
    return {ln.split()[0] for ln in out.splitlines() if ln.strip()}


def _run_staged_probe(script: str, timeout_s: float, env: dict) -> dict:
    """Run a marker-printing probe script in a killed-on-timeout child.

    The ONE subprocess harness every staged probe shares: file-captured
    stdout/stderr (a pipe's partials die with the kill; a file needs no
    reader thread that could itself block), hard timeout, SIGKILL and a
    bounded reap with the un-reapable (D-state) child reported as a
    finding of its own.  Returns {out, err, timed_out, returncode,
    unreapable, elapsed_s} for the caller's classifier to shape.
    """
    import tempfile
    import time

    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as fo, \
            tempfile.TemporaryFile("w+") as fe:
        proc = subprocess.Popen([sys.executable, "-c", script],
                                stdout=fo, stderr=fe, text=True, env=env)
        timed_out = False
        unreapable = False
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            timed_out = True
            proc.kill()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                unreapable = True  # D-state child: itself a finding
        fo.seek(0), fe.seek(0)
        out_text, err_text = fo.read(), fe.read()
    return {
        "out": out_text, "err": err_text, "timed_out": timed_out,
        "returncode": proc.returncode, "unreapable": unreapable,
        "elapsed_s": round(time.perf_counter() - t0, 2),
    }


def _staged_result(run: dict, status: str, stage: str | None, timeout_s: float) -> dict:
    """The row of a staged CPU probe (mesh, elastic, scenarios)."""
    result: dict = {
        "status": status,
        "elapsed_s": run["elapsed_s"],
        "timeout_s": timeout_s,
    }
    if status != "ok":
        result["failed_stage"] = stage
        result["timed_out"] = run["timed_out"]
        result["stderr_tail"] = run["err"][-500:]
    if run["unreapable"]:
        result["unreapable_child"] = True
    return result


# ---------------------------------------------------------------------
# the device: torch → CUDA init → kernel library → one launch of each
# kernel.  flush=True on every print — the parent reads the file after
# killing the child, and an unflushed marker would misclassify the hang
# one stage early.  __DEVICE__ is replaced by the repr of the device asked
# for ("cuda" or "cpu").
# ---------------------------------------------------------------------

_STAGED_PROBE = r"""
import json
import sys
print("PROBE_START", flush=True)
import torch
print("PROBE_TORCH_OK", torch.__version__, flush=True)
DEVICE = __DEVICE__
if DEVICE == "cuda":
    if not torch.cuda.is_available():
        print("torch %s sees no CUDA device (built for CUDA %s)"
              % (torch.__version__, torch.version.cuda), file=sys.stderr)
        sys.exit(3)
    n = torch.cuda.device_count()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    name = torch.cuda.get_device_name(0)
else:
    n, name = 1, "cpu"
print("PROBE_DEVICES_OK", DEVICE, n, name, flush=True)
from estorch_tpu_torch.ops import noise_kernels as nk
if DEVICE == "cuda":
    from estorch_tpu_torch.ops import _build
    _build.load_library()
    info = {"cached": bool(_build.build_info.get("cached")),
            "build_s": round(float(_build.build_info.get("seconds") or 0.0), 3),
            "path": str(_build.build_info.get("path"))}
else:
    info = {"plain_versions": True}
print("PROBE_COMPILE_OK", json.dumps(info), flush=True)
dev = torch.device(DEVICE)
g = torch.Generator(device=dev).manual_seed(0)
table = torch.randn(4096, generator=g, device=dev)
offs = torch.tensor([0, 17, 900, 3000], dtype=torch.int32, device=dev)
w = torch.tensor([0.5, -1.0, 0.25, 2.0], device=dev)
x = torch.randn(4, 3, generator=g, device=dev)
c = torch.tensor([1.0, -1.0, 0.5, -0.5], device=dev)
nk.reset_launch_counts()
got_sum = nk.weighted_noise_sum(table, offs, w, 64)
got_mv = nk.population_noise_matvec(table, offs, c, x, 0, 3, 8)
if DEVICE == "cuda":
    torch.cuda.synchronize()
launches = dict(nk.launch_counts)
err = {
    "weighted_noise_sum": float(
        (got_sum - nk.weighted_noise_sum_plain(table, offs, w, 64)).abs().max()),
    "population_noise_matvec": float(
        (got_mv - nk.population_noise_matvec_plain(table, offs, c, x, 0, 3, 8)).abs().max()),
}
if DEVICE == "cuda" and min(launches.values()) < 1:
    print("a kernel wrapper took its plain version on the card: %r" % launches,
          file=sys.stderr)
    sys.exit(1)
if max(err.values()) > 1e-5:
    print("a kernel disagrees with its plain version: %r" % err, file=sys.stderr)
    sys.exit(1)
print("PROBE_EXEC_OK", json.dumps({"launches": launches, "max_abs_err": err}), flush=True)
"""

# ordered (marker, hang-reason-when-absent) pairs: the first missing
# marker after a timeout names the stage that wedged
_PROBE_STAGES = (
    ("PROBE_TORCH_OK", "init-hang"),
    ("PROBE_DEVICES_OK", "init-hang"),
    ("PROBE_COMPILE_OK", "compile-hang"),
    ("PROBE_EXEC_OK", "exec-hang"),
)


def classify_device_probe(out: str, timed_out: bool, returncode
                          ) -> tuple[str, str | None]:
    """(status, reason) from a staged probe's output — pure so the
    reason-code taxonomy is unit-testable without wedging anything.

    Reasons (the JAX doctor's): ``no-device`` (the runtime answered fast:
    no card), ``init-hang`` / ``compile-hang`` / ``exec-hang`` (the layer
    that went silent: torch's import or CUDA's init, the kernel library's
    build or load, a launch), ``error`` (failed fast after the device came
    up — a failed build, a launch error, a kernel off its plain version:
    read the stderr)."""
    markers = _markers(out)
    if "PROBE_EXEC_OK" in markers and not timed_out and returncode == 0:
        return "ok", None
    if timed_out:
        for marker, reason in _PROBE_STAGES:
            if marker not in markers:
                return "failed", reason
        return "failed", "exec-hang"  # all markers but the child lived on
    if "PROBE_DEVICES_OK" not in markers:
        # failed fast before any device existed: no card, no CUDA build
        # of torch — not a wedge
        return "failed", "no-device"
    return "failed", "error"


def _marker_json(out: str, marker: str) -> dict:
    for ln in out.splitlines():
        if ln.startswith(marker + " "):
            try:
                return json.loads(ln.split(None, 1)[1])
            except ValueError:
                return {}
    return {}


def _device_probe_run(timeout_s: float, device: str | None) -> tuple[dict, str, str | None]:
    """The staged device child's run and its (status, reason)."""
    dev = "cuda" if device is None else str(device)
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    run = _run_staged_probe(_STAGED_PROBE.replace("__DEVICE__", repr(dev)), timeout_s,
                            _child_env())
    return (run,) + classify_device_probe(run["out"], run["timed_out"], run["returncode"])


def probe_device(timeout_s: float = 45.0, device: str | None = None) -> dict:
    """The JAX doctor's quick probe of the default device, over
    :func:`check_device`'s staged child with its hard timeout:
    ``{"status": "healthy"|"wedged"|"error", ...detail}``.  "healthy"
    (with ``platform`` and ``n_devices``) when the child launched the
    kernels; "wedged" (with ``timeout_s`` and ``stderr_tail``) when it
    neither finished nor failed within ``timeout_s``, the signature of a
    hung runtime; "error" (with ``returncode`` and ``stderr_tail``) when it
    failed fast, no card included."""
    run, status, reason = _device_probe_run(timeout_s, device)
    if status == "ok":
        platform, n = "", 0
        for ln in run["out"].splitlines():
            if ln.startswith("PROBE_DEVICES_OK"):
                parts = ln.split()
                platform, n = parts[1], int(parts[2])
        return {"status": "healthy", "platform": platform, "n_devices": n}
    if run["timed_out"]:
        out = {"status": "wedged", "timeout_s": timeout_s, "stderr_tail": run["err"][-500:]}
        if run["unreapable"]:
            out["unreapable_child"] = True
        return out
    return {"status": "error", "returncode": run["returncode"], "stderr_tail": run["err"][-500:]}


def check_device(timeout_s: float = 20.0, device: str | None = None) -> dict:
    """Prove the device path alive or wedged in SECONDS with a typed
    reason: a staged subprocess runs torch's import → CUDA init → the
    kernel library's build or cached load → one launch of each kernel
    checked against its plain version, each stage leaving a marker, and a
    hang is classified by the first marker missing when the timeout kills
    it.

    ``device`` is ``"cuda"`` by default (the card, or ``no-device``);
    ``"cpu"`` runs the stages on the CPU with the plain versions.  The row
    carries the kernels' launches in the probe and their largest
    difference from the plain versions."""
    run, status, reason = _device_probe_run(timeout_s, device)
    dev = "cuda" if device is None else str(device)
    result: dict = {
        "status": status,
        "elapsed_s": run["elapsed_s"],
        "timeout_s": timeout_s,
    }
    if device is not None:
        result["requested_device"] = dev
    for ln in run["out"].splitlines():
        if ln.startswith("PROBE_DEVICES_OK"):
            parts = ln.split(None, 3)
            result["platform"] = parts[1]
            result["n_devices"] = int(parts[2])
            result["device_name"] = parts[3] if len(parts) > 3 else ""
    library = _marker_json(run["out"], "PROBE_COMPILE_OK")
    if library:
        result["library"] = library
    result.update(_marker_json(run["out"], "PROBE_EXEC_OK"))
    if reason is not None:
        result["reason"] = reason
        result["stderr_tail"] = run["err"][-500:]
    if run["unreapable"]:
        result["unreapable_child"] = True
    return result


# ---------------------------------------------------------------------
# two gloo ranks on the CPU: the parent writes a worker script, starts two
# ranks of it over loopback, and prints its own marker once BOTH ranks
# wrote a stage's marker to their files; every wait is bounded.  %-style:
# worker is the worker's source, stages the (worker, parent) marker pairs.
# ---------------------------------------------------------------------

_TWO_RANKS = r"""
import os
import socket
import subprocess
import sys
import tempfile
import time

print(%(start)r, flush=True)
workdir = tempfile.mkdtemp(prefix="estorch_torch_probe_")
worker_py = os.path.join(workdir, "worker.py")
with open(worker_py, "w") as f:
    f.write(%(worker)r)
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
marks = [os.path.join(workdir, "w%%d.txt" %% i) for i in range(2)]
errs = [open(os.path.join(workdir, "w%%d.err" %% i), "w+") for i in range(2)]
procs = [subprocess.Popen([sys.executable, worker_py, str(i), str(port), marks[i]],
                          stdout=subprocess.DEVNULL, stderr=errs[i], text=True)
         for i in range(2)]


def both_have(marker, deadline):
    while time.monotonic() < deadline:
        got = 0
        for m in marks:
            try:
                with open(m) as f:
                    if any(ln.startswith(marker) for ln in f):
                        got += 1
            except OSError:
                pass  # not written yet: the next look decides
        if got == 2:
            return True
        if any(p.poll() not in (None, 0) for p in procs):
            return False
        time.sleep(0.05)
    return False


deadline = time.monotonic() + %(budget_s)r
try:
    for wmark, pmark in %(stages)r:
        if not both_have(wmark, deadline):
            raise SystemExit(3)
        print(pmark, flush=True)
finally:
    for p, e in zip(procs, errs):
        if p.poll() is None:
            p.kill()
        try:
            p.wait(timeout=5)
        except subprocess.TimeoutExpired:
            sys.stderr.write("a rank did not exit after its kill\n")
        if p.returncode not in (None, 0):
            e.seek(0)
            sys.stderr.write(e.read()[-800:])
        e.close()
"""


def _two_ranks(start: str, worker: str, stages: tuple, budget_s: float) -> str:
    return _TWO_RANKS % {"start": start, "worker": worker, "stages": stages,
                         "budget_s": budget_s}


# mesh probe: the param-sharded path (parallel/sharded.py) on two gloo
# ranks at (pop, model) = (1, 2): the 2-D mesh and its groups, the default
# partition rules over a dummy tree, the sharded ES built (the port
# compiles nothing ahead of time: building the engine and its sharded
# state is this stage), and one sharded generation.
_MESH_WORKER = r"""
import sys
rank, port, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
f = open(out_path, "w", buffering=1)
import torch
from estorch_tpu_torch.parallel import multihost
multihost.initialize("tcp://127.0.0.1:" + port, 2, rank, device="cpu",
                     cpu_collectives=True, timeout_s=45)
from estorch_tpu_torch.parallel.mesh import DEFAULT_PARTITION_RULES, match_partition_rules
mesh = multihost.global_hyperscale_mesh(1, 2)
print("WBUILD", mesh.devices.size, file=f)
tree = {"dense": {"kernel": torch.zeros((8, 16)), "bias": torch.zeros((16,))}}
match_partition_rules(DEFAULT_PARTITION_RULES, tree, mesh)
print("WRULES", file=f)
from estorch_tpu_torch import ES, CartPole, DeviceAgent, MLPPolicy, adam
es = ES(MLPPolicy, DeviceAgent(CartPole(), horizon=8), adam, population_size=8, sigma=0.1,
        seed=0, policy_kwargs={"action_dim": 2, "hidden": (16,), "discrete": True},
        optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 14, telemetry=False,
        shard_params=True, mesh=mesh)
print("WENGINE", file=f)
es.train(1, verbose=False)
assert bool(torch.isfinite(es.state.params_flat).all()), "non-finite sharded update"
print("WSTEP", file=f)
"""

_MESH_PROBE = _two_ranks(
    "MESH_START", _MESH_WORKER,
    (("WBUILD", "MESH_BUILD_OK"), ("WRULES", "MESH_RULES_OK"),
     ("WENGINE", "MESH_COMPILE_OK"), ("WSTEP", "MESH_EXEC_OK")), 80.0)

_MESH_STAGES = (
    ("MESH_BUILD_OK", "mesh-build"),
    ("MESH_RULES_OK", "partition-rules"),
    ("MESH_COMPILE_OK", "sharded-compile"),
    ("MESH_EXEC_OK", "sharded-exec"),
)


def classify_mesh_probe(out: str, timed_out: bool, returncode
                        ) -> tuple[str, str | None]:
    """(status, failed-stage) from the mesh probe's markers — pure, so
    the taxonomy is unit-testable without a mesh."""
    markers = _markers(out)
    if "MESH_EXEC_OK" in markers and not timed_out and returncode == 0:
        return "ok", None
    for marker, stage in _MESH_STAGES:
        if marker not in markers:
            return "failed", stage
    return "failed", "sharded-exec"


def check_mesh(timeout_s: float = 90.0) -> dict:
    """Can the param-sharded engine run here?  A staged subprocess starts
    two gloo ranks on the CPU, builds the (1, 2) mesh, resolves the
    default partition rules, builds the sharded ES and takes one
    generation — the first missing marker names the failing layer (gloo
    over loopback, the rules, the engine's sharded state, the step)."""
    run = _run_staged_probe(_MESH_PROBE, timeout_s, _child_env())
    status, stage = classify_mesh_probe(run["out"], run["timed_out"], run["returncode"])
    return _staged_result(run, status, stage, timeout_s)


# scenario probe: the scenario suite (estorch_tpu_torch/scenarios) on the
# CPU — (1) the distribution's table is deterministic in (seed, variant)
# and stacks, (2) one rollout of make_batched_rollout over a ScenarioEnv
# of 3 variants, the constants riding the state rows (finite fitness,
# variant ids in range).
_SCENARIO_PROBE = r"""
import sys
print("SCEN_START", flush=True)
import numpy as np
import torch
from estorch_tpu_torch.envs.pendulum import Pendulum
from estorch_tpu_torch.envs.rollout import make_batched_rollout
from estorch_tpu_torch.scenarios import ScenarioEnv, default_distribution
from estorch_tpu_torch.scenarios.env import variant_of_bc
dist = default_distribution(Pendulum(), n_variants=3, spread=0.2, seed=0)
a = dist.draw_concrete(1)
b = default_distribution(Pendulum(), n_variants=3, spread=0.2, seed=0).draw_concrete(1)
assert a == b, ("non-deterministic draw", a, b)
stacked = dist.draw_all()
for name in dist.names:
    assert tuple(stacked[name].shape) == (3,), name
print("SCEN_DRAW_OK", flush=True)
env = ScenarioEnv(Pendulum(), dist)
states, obs = env.reset(torch.Generator().manual_seed(0), 6)
w = torch.zeros((obs.shape[1], 1))
res = make_batched_rollout(env, 5)(lambda o: torch.tanh(o @ w), states, obs)
f = res.total_reward.numpy()
v = np.rint(variant_of_bc(res.bc)).astype(int)
assert np.isfinite(f).all(), f
assert set(v) <= {0, 1, 2}, v
print("SCEN_ROLLOUT_OK", flush=True)
"""

_SCENARIO_STAGES = (
    ("SCEN_DRAW_OK", "draw-determinism"),
    ("SCEN_ROLLOUT_OK", "traced-rollout"),
)


def classify_scenario_probe(out: str, timed_out: bool, returncode
                            ) -> tuple[str, str | None]:
    """(status, failed-stage) from the scenario probe's markers — pure,
    so the taxonomy is unit-testable without running the probe.  The
    rollout stage keeps the JAX doctor's name, ``traced-rollout``."""
    markers = _markers(out)
    if "SCEN_ROLLOUT_OK" in markers and not timed_out and returncode == 0:
        return "ok", None
    for marker, stage in _SCENARIO_STAGES:
        if marker not in markers:
            return "failed", stage
    return "failed", "traced-rollout"


def check_scenarios(timeout_s: float = 90.0) -> dict:
    """Can the scenario suite run here?  Findings, never tracebacks: a
    failure names the stage (draw-determinism vs traced-rollout) with a
    stderr tail, and a hung child is killed at the timeout."""
    run = _run_staged_probe(_SCENARIO_PROBE, timeout_s, _child_env())
    status, stage = classify_scenario_probe(run["out"], run["timed_out"], run["returncode"])
    return _staged_result(run, status, stage, timeout_s)


# elastic probe: the multi-process layers (parallel/multihost.py,
# parallel/elastic.py) — (1) torch.distributed bring-up of TWO processes
# over loopback (gloo, bounded timeout), (2) the global population mesh,
# (3) one cross-process all-reduce through it, (4) the elastic
# coordinator in the probe and one `--join` host process on the CPU: join
# and sync, the center pushed, one dispatch evaluated and its result
# folded back.
_ELASTIC_WORKER = r"""
import sys
rank, port, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
f = open(out_path, "w", buffering=1)
from estorch_tpu_torch.parallel import multihost
multihost.initialize("tcp://127.0.0.1:" + port, 2, rank, device="cpu",
                     cpu_collectives=True, timeout_s=45)
print("WINIT", file=f)
mesh = multihost.global_population_mesh()
print("WMESH", mesh.devices.size, file=f)
import torch
out = mesh.all_reduce_sum(torch.ones(4))
assert float(out[0]) == 2.0, out
print("WPSUM", float(out[0]), file=f)
"""

_ELASTIC_TAIL = r"""
import json
import numpy as np
from estorch_tpu_torch.parallel.elastic import ElasticCoordinator, es_from_spec

spec = {"env": "CartPole", "population_size": 8, "horizon": 8, "device": "cpu",
        "table_size": 1 << 12, "telemetry": False, "seed": 7}
coord = ElasticCoordinator(join_grace_s=30.0)
host_err = open(os.path.join(workdir, "host.err"), "w+")
host = subprocess.Popen(
    [sys.executable, "-m", "estorch_tpu_torch.parallel.elastic",
     "--join", "%s:%d" % tuple(coord.address[:2]), "--spec", json.dumps(spec), "--host", "0"],
    stdout=subprocess.DEVNULL, stderr=host_err, text=True)
try:
    es = es_from_spec(spec)
    deadline = time.monotonic() + 60
    while coord.n_live() < 1:
        if time.monotonic() > deadline or host.poll() is not None:
            raise SystemExit(4)
        time.sleep(0.05)
    coord.push_center(0, es.state.params_flat.numpy(), float(es.state.sigma))
    if coord.dispatch(0, 0) is None:
        raise SystemExit(4)
    got = []
    while not got and time.monotonic() < deadline:
        got = coord.poll(0.2)[0]
    assert got and got[0]["dispatch"] == 0, got
    fit = np.asarray(got[0]["fitness"])
    assert fit.shape == (8,) and np.isfinite(fit).all(), fit
finally:
    coord.close()
    try:
        host.wait(timeout=10)
    except subprocess.TimeoutExpired:
        host.kill()
        host.wait(timeout=5)
    if host.returncode not in (None, 0):
        host_err.seek(0)
        sys.stderr.write(host_err.read()[-800:])
    host_err.close()
print("ELASTIC_COORD_OK", flush=True)
"""

_ELASTIC_PROBE = _two_ranks(
    "ELASTIC_START", _ELASTIC_WORKER,
    (("WINIT", "ELASTIC_INIT_OK"), ("WMESH", "ELASTIC_MESH_OK"),
     ("WPSUM", "ELASTIC_PSUM_OK")), 70.0) + _ELASTIC_TAIL

_ELASTIC_STAGES = (
    ("ELASTIC_INIT_OK", "distributed-init"),
    ("ELASTIC_MESH_OK", "mesh-build"),
    ("ELASTIC_PSUM_OK", "cross-process-psum"),
    ("ELASTIC_COORD_OK", "coordinator-roundtrip"),
)


def classify_elastic_probe(out: str, timed_out: bool, returncode
                           ) -> tuple[str, str | None]:
    """(status, failed-stage) from the elastic probe's markers — pure,
    so the taxonomy is unit-testable without spawning a fleet.  The
    all-reduce stage keeps the JAX doctor's name, ``cross-process-psum``."""
    markers = _markers(out)
    if "ELASTIC_COORD_OK" in markers and not timed_out and returncode == 0:
        return "ok", None
    for marker, stage in _ELASTIC_STAGES:
        if marker not in markers:
            return "failed", stage
    return "failed", "coordinator-roundtrip"


def check_elastic(timeout_s: float = 120.0) -> dict:
    """Can the elastic multi-process path run here?  Findings, never
    tracebacks: a staged subprocess brings up a REAL 2-process gloo group
    over loopback, builds the population mesh, runs one cross-process
    all-reduce, then round-trips the elastic coordinator with a
    ``--join`` host process — the first missing marker names the failing
    layer (no gloo, broken loopback, protocol regression, ...)."""
    run = _run_staged_probe(_ELASTIC_PROBE, timeout_s, _child_env())
    status, stage = classify_elastic_probe(run["out"], run["timed_out"], run["returncode"])
    return _staged_result(run, status, stage, timeout_s)


def check_native_pool() -> dict:
    """Is the C++ env pool built and loadable?  The port builds it at
    first use (``envs/native_pool.py``, g++) and never falls back: a
    failed build is this row's error."""
    try:
        from .envs import native_pool

        lib = native_pool.load_library()
        return {"cpp_pool": lib is not None, "path": str(native_pool.library_path())}
    except Exception as e:  # diagnostic tool: never crash the report
        return {"cpp_pool": False, "error": repr(e)}


def _nvcc_path() -> str | None:
    """``ops/_build.py``'s search for nvcc: $CUDA_HOME/bin (default
    /usr/local/cuda), then PATH."""
    import shutil

    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return cand if os.path.isfile(cand) else shutil.which("nvcc")


def check_optional_deps() -> dict:
    """Presence of the optional packages and tools paths gate on."""
    out = {}
    for mod, why in (
        ("gymnasium", "host/pooled gym envs (envs/gym_vec_pool.py, envs/gym_adapter.py)"),
        ("mujoco", "host/pooled MuJoCo configs (device physics: envs/locomotion.py)"),
        ("ale_py", "real Atari (atari_frostbite); pong84 needs nothing"),
        ("triton", "none of the port's kernels (they are CUDA C++, ops/csrc)"),
    ):
        try:
            found = importlib.util.find_spec(mod) is not None
        except Exception:
            # find_spec("pkg.sub") IMPORTS pkg first: a missing parent
            # raises ModuleNotFoundError, a broken native install can
            # raise ImportError/OSError — never crash the report
            found = False
        out[mod] = {"available": found, "needed_for": why}
    nvcc = _nvcc_path()
    out["nvcc"] = {"available": nvcc is not None, "path": nvcc,
                   "needed_for": "the port's CUDA kernels, built at first use (ops/_build.py)"}
    cutlass = os.path.join(os.environ.get("CUTLASS_PATH", "/usr/local/cutlass"), "include")
    out["cutlass"] = {
        "available": os.path.isfile(os.path.join(cutlass, "cutlass", "cutlass.h")),
        "path": cutlass,
        "needed_for": "none of the port's kernels today (their sources include no CUTLASS)"}
    return out


def check_host() -> dict:
    """Host-side facts that decide what parallelism can actually help:
    worker threads/processes cannot speed up a 1-core box (they time-slice
    it), and the cache of built native libraries is what makes fresh
    processes cheap."""
    cache_dir = _BUILD_DIR
    cached = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    return {
        "cpu_count": os.cpu_count(),
        "note": (
            "1 CPU: host worker threads/processes and ranks time-slice one "
            "core — correctness yes, speedup no"
            if (os.cpu_count() or 1) == 1 else
            f"{os.cpu_count()} CPUs available for host workers / env pools"
        ),
        "compile_cache_dir": cache_dir,
        "compile_cache_entries": cached,
        "compile_cache_hint": (
            "the port builds its CUDA kernels (ops/_build.py, nvcc) and the "
            "envpool (envs/native_pool.py, g++) once into this directory, "
            "under a lock; every later process loads the cached libraries "
            "in milliseconds instead of a cold build of seconds"
        ),
    }


def check_obs(run_dir: str | None = None) -> dict:
    """Observability plumbing health (estorch_tpu_torch/obs/):

    - is the trace/telemetry directory writable (JSONL sinks, profiler
      traces, heartbeat files all land there)?
    - is TensorBoard importable (TensorBoardSink), or is JsonlSink the
      only option?
    - export probe: spin up the Prometheus metrics sidecar over a
      synthetic temp run-dir, scrape it over loopback, and validate the
      exposition PARSES — all stdlib, no torch, so "can this host be
      scraped" is answerable even from a machine whose card is wedged;
    - given a run dir: heartbeat freshness — the liveness verdict for a
      run that stopped printing ("wedged or dead" vs "slow but beating").
    """
    import tempfile

    from .obs.recorder import STALE_AFTER_S, read_heartbeat

    trace_dir = os.environ.get("ESTORCH_OBS_DIR") or tempfile.gettempdir()
    try:
        probe = os.path.join(trace_dir, f".obs_write_probe_{os.getpid()}")
        with open(probe, "w") as f:
            f.write("ok")
        os.remove(probe)
        writable = True
        err = None
    except OSError as e:  # diagnostic tool: never crash the report
        writable, err = False, repr(e)
    out: dict = {
        "trace_dir": {"path": trace_dir, "writable": writable,
                      **({"error": err} if err else {})},
    }
    try:
        tb = importlib.util.find_spec("torch.utils.tensorboard") is not None
    except Exception:
        tb = False
    out["tensorboard"] = {
        "available": tb,
        "needed_for": "obs.TensorBoardSink (obs.JsonlSink needs nothing)",
    }
    out["export"] = _export_probe()
    if run_dir is not None:
        hb_path = os.path.join(run_dir, "heartbeat.json")
        hb = read_heartbeat(hb_path)
        if hb is None:
            out["heartbeat"] = {
                "path": hb_path, "found": False,
                "hint": "no heartbeat — run never started telemetry, "
                        "finished long ago, or this is the wrong dir",
            }
        else:
            out["heartbeat"] = {
                "path": hb_path, "found": True,
                "age_s": round(hb["age_s"], 1),
                "stale": hb["age_s"] > STALE_AFTER_S,
                "phase": hb.get("phase"),
                "generation": hb.get("generation"),
            }
    return out


def _export_probe() -> dict:
    """Loopback-scrape the metrics sidecar against a synthetic temp
    run-dir and validate the exposition parses (obs/export/): the
    end-to-end proof that a supervised run on THIS host would be
    scrapeable.  Stdlib only — never touches torch or the card."""
    import tempfile
    import time as _time
    import urllib.request

    try:
        from .obs.export.prometheus import (parse_exposition, samples_by_name,
                                            validate_histogram_series)
        from .obs.export.sidecar import MetricsSidecar, publish_counters
        from .obs.hist import Histogram

        probe_hist = Histogram()
        probe_hist.observe(0.002)
        with tempfile.TemporaryDirectory() as d:
            hb_ts = _time.time()
            with open(os.path.join(d, "heartbeat.json"), "w") as f:
                json.dump({"ts": hb_ts, "pid": os.getpid(),
                           "phase": "doctor_probe", "generation": 1,
                           "counters": {"env_steps": 1},
                           "hists": {"probe_s": probe_hist.to_dict()}}, f)
            # published totals + a NEWER live beat: the scrape must
            # compose both (the cross-restart monotonicity contract) —
            # for the flat counters AND the histogram buckets
            publish_counters(d, {"env_steps": 2}, through_ts=hb_ts - 1.0,
                             extra={"restart_count": 1},
                             hists={"probe_s": probe_hist.to_dict()})
            sidecar = MetricsSidecar(d, port=0)
            sidecar.start_background()
            try:
                with urllib.request.urlopen(
                        f"http://{sidecar.host}:{sidecar.port}/metrics",
                        timeout=10) as resp:
                    body = resp.read().decode()
            finally:
                sidecar.close()
        samples = parse_exposition(body)  # ValueError on malformed lines
        vals = samples_by_name(samples)
        problems = []
        if vals.get("estorch_env_steps") != 3:
            problems.append(
                f"published+live composition broke: env_steps="
                f"{vals.get('estorch_env_steps')} (want 3)")
        if vals.get("estorch_up") != 1:
            problems.append("fresh heartbeat did not read as up")
        problems.extend(validate_histogram_series(samples))
        if vals.get("estorch_probe_s_count") != 2:
            problems.append(
                f"published+live HISTOGRAM composition broke: probe_s "
                f"count={vals.get('estorch_probe_s_count')} (want 2)")
        return {
            "ok": not problems,
            "samples": len(samples),
            **({"problems": problems} if problems else {}),
        }
    except Exception as e:  # diagnostic tool: never crash the report
        return {"ok": False, "error": repr(e)}


# the port's checkpoint round trip: a tiny host-backend ES (a torch policy,
# a rollout agent, torch.optim.Adam) on the CPU, saved, restored into a
# fresh ES, compared, in a SUBPROCESS with a hard timeout.  __ROOT__ is
# substituted (plain replace — str.format would trip on the dict braces)
# with the repr of the checkpoint root under test.
_RESILIENCE_PROBE = """
import os, shutil
import numpy as np
import torch
from estorch_tpu_torch import ES
from estorch_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

class P(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.l = torch.nn.Linear(2, 1)
    def forward(self, x):
        return self.l(x)

class A:
    def rollout(self, policy):
        with torch.no_grad():
            v = torch.nn.utils.parameters_to_vector(policy.parameters())
        return -float((v ** 2).sum())

def make():
    return ES(P, A, torch.optim.Adam, population_size=4, sigma=0.1, seed=0,
              optimizer_kwargs={"lr": 1e-2}, table_size=1 << 10,
              telemetry=False, device="cpu")

root = os.path.join(__ROOT__, "doctor_resilience_probe_%d" % os.getpid())
try:
    es = make()
    es.train(1, verbose=False)
    save_checkpoint(es, root)
    es2 = make()
    restore_checkpoint(es2, root)
    assert es2.generation == 1, es2.generation
    np.testing.assert_array_equal(np.asarray(es.state.params_flat),
                                  np.asarray(es2.state.params_flat))
finally:
    shutil.rmtree(root, ignore_errors=True)
print("RESILIENCE_PROBE_OK")
"""


def _roundtrip_probe(root: str, timeout_s: float = 180.0) -> dict:
    """Save/restore a tiny ES under ``root`` in a timed-out subprocess."""
    run = _run_staged_probe(_RESILIENCE_PROBE.replace("__ROOT__", repr(root)), timeout_s,
                            _child_env())
    if run["timed_out"]:
        out = {"status": "wedged", "timeout_s": timeout_s,
               "stderr_tail": run["err"][-500:]}
        if run["unreapable"]:
            out["unreapable_child"] = True
        return out
    if "RESILIENCE_PROBE_OK" in run["out"]:
        return {"status": "ok", "elapsed_s": run["elapsed_s"]}
    return {"status": "error", "returncode": run["returncode"],
            "stderr_tail": run["err"][-500:]}


def check_resilience(ckpt_root: str | None = None,
                     probe: bool = False,
                     probe_timeout_s: float = 180.0) -> dict:
    """Can a run here actually survive faults?

    - is the checkpoint root (``ESTORCH_CKPT_ROOT`` or tempdir) writable
      — without it the Supervisor has nothing to resume from;
    - ``probe=True``: a full save/restore round trip of the port's
      checkpoint (``utils/checkpoint.py``) on a tiny host ES in a
      timed-out subprocess — the end-to-end proof that resume works on
      THIS machine's torch install;
    - is fork available — worker respawn (host/procpool.py) needs it;
    - heartbeat-watchdog config sanity: a heartbeat path with telemetry
      disabled means a supervisor would see no beats and kill healthy
      runs.
    """
    import tempfile

    from .obs.recorder import HEARTBEAT_ENV, STALE_AFTER_S
    from .obs.spans import OBS_DISABLE_ENV

    root = (ckpt_root or os.environ.get("ESTORCH_CKPT_ROOT")
            or tempfile.gettempdir())
    try:
        probe_file = os.path.join(root, f".ckpt_write_probe_{os.getpid()}")
        with open(probe_file, "w") as f:
            f.write("ok")
        os.remove(probe_file)
        writable, err = True, None
    except OSError as e:  # diagnostic tool: never crash the report
        writable, err = False, repr(e)
    out: dict = {
        "ckpt_root": {"path": root, "writable": writable,
                      **({"error": err} if err else {})},
    }
    if probe and writable:
        out["roundtrip"] = _roundtrip_probe(root, probe_timeout_s)
    import multiprocessing as mp

    out["fork"] = {
        "available": os.name == "posix" and "fork" in mp.get_all_start_methods(),
        "needed_for": "host process workers + respawn (host/procpool.py)",
    }
    hb_path = os.environ.get(HEARTBEAT_ENV)
    obs_enabled = os.environ.get(OBS_DISABLE_ENV, "1") != "0"
    watchdog: dict = {
        "heartbeat_env_set": bool(hb_path),
        "telemetry_enabled": obs_enabled,
        "stale_after_s": STALE_AFTER_S,
    }
    if hb_path and not obs_enabled:
        watchdog["warning"] = (
            f"{HEARTBEAT_ENV} is set but {OBS_DISABLE_ENV}=0 disables "
            "telemetry — a staleness watchdog would see no beats and kill "
            "healthy runs"
        )
    if hb_path:
        hb_dir = os.path.dirname(os.path.abspath(hb_path)) or "."
        watchdog["heartbeat_dir_writable"] = os.access(hb_dir, os.W_OK)
    out["heartbeat_watchdog"] = watchdog
    return out


def check_serve(bundle: str | None = None) -> dict:
    """Serving readiness (estorch_tpu_torch/serve):

    - can this host bind a loopback listening socket (the server's one
      OS-level requirement beyond python)?
    - does the dynamic batcher round-trip requests (coalescing, bucket
      padding, recompile accounting) — exercised with a plain-numpy
      batch fn, so this check never touches torch or the card;
    - given ``bundle``: structural validation of the artifact (manifest
      schema, payload checksum, param count, warm block) via
      ``serve/validate.py``, without importing torch, so a corrupt bundle
      is diagnosable from a machine whose card is wedged.
    """
    import socket

    out: dict = {}
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        out["loopback"] = {"bindable": True, "probe_port": port}
    except OSError as e:  # diagnostic tool: never crash the report
        out["loopback"] = {"bindable": False, "error": repr(e)}

    try:
        import numpy as np

        from .obs.spans import Telemetry
        from .serve.batcher import DynamicBatcher

        tel = Telemetry(enabled=True)
        b = DynamicBatcher(lambda arr: arr * 2.0, (3,), max_batch=4,
                           max_wait_ms=1.0, telemetry=tel)
        got = b.predict([1.0, 2.0, 3.0], timeout=10.0)
        b.close()
        ok = np.allclose(got, [2.0, 4.0, 6.0])
        out["batcher"] = {
            "ok": bool(ok),
            "recompiles": int(tel.counters.get("recompiles")),
            "buckets": list(b.buckets),
        }
    except Exception as e:
        out["batcher"] = {"ok": False, "error": repr(e)}

    if bundle is not None:
        from .serve.validate import BundleError, validate_bundle

        try:
            man = validate_bundle(bundle)
            out["bundle"] = {
                "path": bundle, "valid": True,
                "version": man["version"],
                "param_dim": man["param_dim"],
                "module": man["module"]["import"],
                "obs_norm": bool(man.get("obs_norm")),
                "recurrent": bool(man.get("recurrent")),
                "warm": _probe_bundle_warmth(man),
            }
        except (BundleError, OSError) as e:
            out["bundle"] = {"path": bundle, "valid": False,
                             "error": str(e)}
    return out


def _probe_bundle_warmth(manifest: dict) -> dict:
    """The warm-bundle probe, torch-free like the rest of check_serve.
    The port's warm block (``serve/warm.py``, format ``torch_eager``)
    carries no compiled programs — torch keeps no persistent cache of
    them — only the bucket ladder the export verified and the platform it
    verified on.  ``validate_bundle`` already proved it structurally
    sound, so what is left is the COMPATIBILITY finding: a ladder
    verified under another torch version than this host's install is
    verified again at load (``warm.install_warmth`` reports the same
    mismatch there).  The installed torch version comes from package
    metadata, so a wedged card can still be probed."""
    warm = manifest.get("warm")
    if not isinstance(warm, dict):
        return {"present": False}
    out = {
        "present": True,
        "format": warm.get("format"),
        "entries": len(warm.get("entries") or {}),
        "buckets": warm.get("buckets"),
        "dtypes": warm.get("dtypes"),
        "torch_version": warm.get("torch_version"),
        "platform": warm.get("platform"),
    }
    try:
        from importlib.metadata import version

        installed = version("torch")
    except Exception:
        installed = None
    out["installed_torch"] = installed
    if installed is None:
        out["compatible"] = None
        out["finding"] = ("torch is not importable as package metadata on "
                          "this host — warmth compatibility unknown")
    elif installed != warm.get("torch_version"):
        out["compatible"] = False
        out["finding"] = (
            f"the ladder was verified under torch {warm.get('torch_version')} "
            f"but this host has torch {installed} — the server verifies it "
            "again at load; re-export the bundle with warm=True under the "
            "serving torch version to ship a ladder this host has checked")
    else:
        out["compatible"] = True
    return out


def check_router() -> dict:
    """Can this host run the fleet front router?  (serve/router.py)

    Loopback end-to-end probe, torch-free: spin a 2-replica TOY fleet
    (stdlib HTTP servers answering the /predict //healthz //stats
    shapes), route through a real :class:`Router`, then kill one
    replica and assert the next requests still answer (failover within
    the retry budget) and that the router's ``/metrics`` parses through
    the validating parser.  Never crashes the report: any failure comes
    back as ``{"ok": False, ...}``."""
    import threading
    import urllib.request
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    try:
        from .obs.export.prometheus import parse_exposition
        from .serve.router import Router

        def make_replica():
            class Toy(BaseHTTPRequestHandler):
                protocol_version = "HTTP/1.1"

                def log_message(self, *a):
                    pass

                def _j(self, obj):
                    body = json.dumps(obj).encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

                def do_GET(self):
                    if self.path == "/healthz":
                        self._j({"ok": True, "draining": False,
                                 "queue_depth": 0})
                    else:
                        self._j({"queue_depth": 0,
                                 "request_ms": {"p99": 1.0}})

                def do_POST(self):
                    n = int(self.headers.get("Content-Length", 0))
                    data = json.loads(self.rfile.read(n))
                    self._j({"action": [v * 2.0 for v in data["obs"]]})

            srv = ThreadingHTTPServer(("127.0.0.1", 0), Toy)
            threading.Thread(target=srv.serve_forever,
                             daemon=True).start()
            return srv

        problems = []
        a, b = make_replica(), make_replica()
        router = Router(
            [("ra", f"127.0.0.1:{a.server_address[1]}"),
             ("rb", f"127.0.0.1:{b.server_address[1]}")],
            port=0, poll_interval_s=30.0,  # stale health: exercise RETRY
            upstream_timeout_s=5.0)
        router.start_background()
        try:
            url = f"http://{router.host}:{router.port}"

            def predict(obs):
                req = urllib.request.Request(
                    url + "/predict",
                    json.dumps({"obs": obs}).encode(),
                    {"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=10) as r:
                    return json.loads(r.read())

            if predict([1.0])["action"] != [2.0]:
                problems.append("routed predict answered wrong")
            a.shutdown()
            a.server_close()
            for i in range(4):  # must fail over to rb, zero errors
                got = predict([float(i)])["action"]
                if got != [2.0 * i]:
                    problems.append(f"failover answer wrong: {got}")
            st = router.stats()
            retries = st["counters"].get("router_retries_total", 0)
            with urllib.request.urlopen(url + "/metrics",
                                        timeout=10) as r:
                body = r.read().decode()
            parse_exposition(body)
            if "estorch_router_breaker_state" not in body:
                problems.append("per-replica breaker gauge missing "
                                "from /metrics")
            return {"ok": not problems, "retries": int(retries),
                    "breakers": {x["name"]: x["breaker"]
                                 for x in st["replicas"]},
                    **({"problems": problems} if problems else {})}
        finally:
            router.shutdown(drain=False)
            b.shutdown()
            b.server_close()
    except Exception as e:  # diagnostic tool: never crash the report
        return {"ok": False, "error": repr(e)}


def check_tracing() -> dict:
    """Can this host assemble a CROSS-PROCESS distributed trace?
    (obs/tracing.py + obs/agg/traces.py)

    Loopback end-to-end probe, torch-free: a real :class:`Router` with a
    run dir routes one forced-sampled request (``X-Trace-Sampled: 1``)
    to a toy stdlib replica that keeps its OWN :class:`ProcessTracer`
    and records a ``request`` segment parented on the router's
    forwarded ``X-Parent-Span``.  Both tracers flush, then assembly
    (``obs trace --fleet``'s engine) must join the trace across both,
    with at least one cross-process parent→child hop, and the Perfetto
    export must validate.  Never crashes the report: any failure comes
    back as ``{"ok": False, ...}``."""
    import tempfile
    import threading
    import time as _time
    import urllib.request
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    try:
        from .obs.agg import traces as traces_agg
        from .obs.export.traceevent import validate_trace
        from .obs.tracing import (PARENT_SPAN_HEADER, SAMPLED_HEADER,
                                  TRACE_HEADER, TRACES_FILENAME,
                                  ProcessTracer, make_segment)
        from .serve.router import Router

        problems: list[str] = []
        trace_id = "doctor-trace-1"
        with tempfile.TemporaryDirectory() as td:
            replica_dir = os.path.join(td, "replica")
            os.makedirs(replica_dir)
            tracer = ProcessTracer(
                "replica", head_every=1,
                path=os.path.join(replica_dir, TRACES_FILENAME))

            class Toy(BaseHTTPRequestHandler):
                protocol_version = "HTTP/1.1"

                def log_message(self, *a):
                    pass

                def _j(self, obj):
                    body = json.dumps(obj).encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

                def do_GET(self):
                    if self.path == "/healthz":
                        self._j({"ok": True, "draining": False,
                                 "queue_depth": 0})
                    else:
                        self._j({"queue_depth": 0,
                                 "request_ms": {"p99": 1.0}})

                def do_POST(self):
                    t0 = _time.monotonic()
                    trace = self.headers.get(TRACE_HEADER) or ""
                    parent = self.headers.get(PARENT_SPAN_HEADER) or None
                    forced = self.headers.get(SAMPLED_HEADER) == "1"
                    n = int(self.headers.get("Content-Length", 0))
                    data = json.loads(self.rfile.read(n))
                    self._j({"action": [v * 2.0 for v in data["obs"]]})
                    if trace:
                        dt = _time.monotonic() - t0
                        tracer.add(make_segment(
                            trace, tracer.span_id(), parent, "replica",
                            "request", t0, dt, {"status": 200}))
                        tracer.finish(trace, dt, forced=forced)

            srv = ThreadingHTTPServer(("127.0.0.1", 0), Toy)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            router_dir = os.path.join(td, "router")
            router = Router(
                [("ra", f"127.0.0.1:{srv.server_address[1]}")],
                port=0, poll_interval_s=30.0, upstream_timeout_s=5.0,
                run_dir=router_dir)
            router.start_background()
            try:
                req = urllib.request.Request(
                    f"http://{router.host}:{router.port}/predict",
                    json.dumps({"obs": [1.0]}).encode(),
                    {"Content-Type": "application/json",
                     TRACE_HEADER: trace_id, SAMPLED_HEADER: "1"})
                with urllib.request.urlopen(req, timeout=10) as r:
                    got = json.loads(r.read())
                    echoed = r.headers.get(TRACE_HEADER)
                if got.get("action") != [2.0]:
                    problems.append(f"routed predict answered wrong: {got}")
                if echoed != trace_id:
                    problems.append(
                        f"router did not echo {TRACE_HEADER}: {echoed!r}")
            finally:
                router.shutdown(drain=False)
                srv.shutdown()
                srv.server_close()
            tracer.flush()

            segs = traces_agg.load_segments(traces_agg.trace_files([td]))
            asm = traces_agg.assemble(segs)
            trace = asm.get(trace_id)
            if trace is None:
                problems.append(
                    f"trace {trace_id!r} did not assemble "
                    f"(got {sorted(asm)})")
                return {"ok": False, "problems": problems}
            if len(trace["procs"]) < 2:
                problems.append(
                    f"trace did not cross processes: {trace['procs']}")
            hops = traces_agg.cross_process_edges(trace)
            if not hops:
                problems.append("no cross-process parent->child hop — "
                                "X-Parent-Span not propagated")
            export = traces_agg.export_fleet_trace([trace])
            errs = validate_trace(export)
            if errs:
                problems.append(f"perfetto export invalid: {errs[:3]}")
            return {"ok": not problems, "procs": trace["procs"],
                    "segments": len(trace["segments"]),
                    "cross_hops": len(hops),
                    "sampled": trace.get("sampled"),
                    **({"problems": problems} if problems else {})}
    except Exception as e:  # diagnostic tool: never crash the report
        return {"ok": False, "error": repr(e)}


def check_collector() -> dict:
    """Can this host run the fleet-aggregation plane?  (obs/agg/)

    Loopback end-to-end probe: spin a synthetic target (the metrics
    sidecar over a temp run dir with a fresh heartbeat), point a
    collector with an absence rule at it PLUS a dead port, run one
    collection tick, and assert the full chain — sample stored in the
    time-series store, rules evaluated (the dead target's absence rule
    fires, the live one's does not), and the collector's ``/alerts`` and
    ``/metrics`` parse over loopback.  Stdlib only, never touches torch,
    and never crashes the report: a refused port or any other failure
    comes back as ``{"ok": False, "error"/"problems": ...}``."""
    import socket
    import tempfile
    import time as _time
    import urllib.request

    try:
        from .obs.agg.collector import Collector, Target
        from .obs.agg.rules import RulesEngine
        from .obs.agg.store import SeriesStore
        from .obs.export.prometheus import parse_exposition
        from .obs.export.sidecar import MetricsSidecar

        problems = []
        with tempfile.TemporaryDirectory() as d:
            run_dir = os.path.join(d, "run")
            os.makedirs(run_dir)
            with open(os.path.join(run_dir, "heartbeat.json"), "w") as f:
                json.dump({"ts": _time.time(), "pid": os.getpid(),
                           "phase": "doctor_probe", "generation": 1,
                           "counters": {"env_steps": 3}}, f)
            sidecar = MetricsSidecar(run_dir, port=0)
            sidecar.start_background()
            # bound-but-not-listening: connects get RST for the whole
            # probe (closing it would race the port back to the
            # allocator, which could hand it to the collector itself)
            dead_sock = socket.socket()
            dead_sock.bind(("127.0.0.1", 0))
            dead_port = dead_sock.getsockname()[1]
            col = None
            try:
                store = SeriesStore(os.path.join(d, "store"))
                rules = RulesEngine([
                    {"name": "replica-down", "kind": "absence",
                     "metric": "estorch_up", "for_s": 0, "window_s": 30},
                ])
                col = Collector(
                    [Target("probe-run",
                            url=f"http://{sidecar.host}:{sidecar.port}"
                                "/metrics", timeout_s=5.0),
                     Target("probe-dead",
                            url=f"http://127.0.0.1:{dead_port}/metrics",
                            timeout_s=0.5)],
                    store, rules, port=0)
                col.start_background()
                now = _time.time()
                tick = col.tick(now)
                if not tick["targets"]["probe-run"]["ok"]:
                    problems.append(
                        f"live target scrape failed: {tick}")
                stored = store.latest("estorch_env_steps",
                                      {"target": "probe-run"},
                                      window_s=60, now=now)
                if not stored:
                    problems.append("scraped sample not found in store")
                fired = {(t["rule"], t["target"])
                         for t in tick["transitions"]
                         if t["event"] == "firing"}
                if ("replica-down", "probe-dead") not in fired:
                    problems.append(
                        f"absence rule did not fire for the dead "
                        f"target: {fired}")
                if ("replica-down", "probe-run") in fired:
                    problems.append("absence rule fired for the live "
                                    "target")
                base = f"http://{col.host}:{col.port}"
                with urllib.request.urlopen(base + "/alerts",
                                            timeout=10) as resp:
                    alerts = json.loads(resp.read().decode())
                if not any(a["rule"] == "replica-down"
                           and a["target"] == "probe-dead"
                           for a in alerts["active"]):
                    problems.append(f"/alerts missing the active "
                                    f"absence alert: {alerts}")
                with urllib.request.urlopen(base + "/metrics",
                                            timeout=10) as resp:
                    parse_exposition(resp.read().decode())
            finally:
                if col is not None:
                    col.close()
                dead_sock.close()
                sidecar.close()
        return {"ok": not problems,
                **({"problems": problems} if problems else {})}
    except Exception as e:  # diagnostic tool: never crash the report
        return {"ok": False, "error": repr(e)}


def check_autoscaler() -> dict:
    """Can this host close the serving control loop?  (obs/agg/
    autoscale.py)

    Loopback decision dry-run: seed a synthetic store with a demand
    ramp, write a matching capacity artifact, and run one control cycle
    with ``dry_run`` — the decision must be a scale-up, logged to the
    append-only decision log, and the log must replay bit-exactly.  A
    mismatched capacity model (wrong bundle sha) must be REFUSED.
    Stdlib only, never touches torch, never crashes the report."""
    import tempfile

    try:
        from .obs.agg import autoscale as _az
        from .obs.agg.store import SeriesStore

        problems = []
        with tempfile.TemporaryDirectory() as d:
            store = SeriesStore(os.path.join(d, "store"))
            t0 = 1_000_000.0
            for ts, total in ((t0, 0.0), (t0 + 10, 100.0)):
                store.append([
                    {"name": "estorch_router_requests_total",
                     "labels": {"target": "probe"}, "value": total},
                    {"name": "estorch_router_replica_up",
                     "labels": {"target": "probe", "replica": "r0"},
                     "value": 1.0},
                ], ts=ts)
            cap_path = os.path.join(d, "capacity.json")
            capacity = {"schema": _az.CAPACITY_SCHEMA, "kind": "capacity",
                        "created_ts": t0, "slo_ms": 50.0,
                        "quantile": "p99", "max_rps_at_slo": 5.0,
                        "saturated": False,
                        "rungs": [{"offered_rps": 5.0, "ok": True}],
                        "bundle_sha": "ab" * 32, "bundle_version": 1,
                        "platform": "cpu"}
            with open(cap_path, "w") as f:
                json.dump(capacity, f)
            bad = _az.validate_capacity(capacity)
            if bad:
                problems.append(f"capacity artifact rejected: {bad}")
            az = _az.Autoscaler(
                os.path.join(d, "store"), capacity=cap_path,
                fleet_identity={"bundle_sha": "ab" * 32,
                                "platform": "cpu"},
                policy={"min_replicas": 1, "max_replicas": 8,
                        "window_s": 10.0}, dry_run=True)
            # 10 rps against 5 rps/replica: the only sane verdict is up
            ev = az.tick(now=t0 + 10)
            if ev is None or ev["verdict"]["action"] != "up":
                problems.append(f"dry-run decision not a scale-up: "
                                f"{ev and ev['verdict']}")
            elif ev["actuation"] != {"attempted": False,
                                     "dry_run": True}:
                problems.append(f"dry-run actuated: {ev['actuation']}")
            rep = _az.replay(az.log_path)
            if not rep["ok"]:
                problems.append(f"decision log replay mismatch: "
                                f"{rep['mismatches'][:2]}")
            try:
                _az.Autoscaler(
                    os.path.join(d, "store"), capacity=cap_path,
                    fleet_identity={"bundle_sha": "cd" * 32,
                                    "platform": "cpu"},
                    dry_run=True)
                problems.append("mismatched capacity model accepted")
            except _az.AutoscaleError as e:
                # the refusal IS the pass; gate that it names both shas
                if "cd" * 6 not in str(e):
                    problems.append(
                        f"mismatch refusal names neither sha: {e}")
        return {"ok": not problems,
                **({"problems": problems} if problems else {})}
    except Exception as e:  # diagnostic tool: never crash the report
        return {"ok": False, "error": repr(e)}


def report(timeout_s: float = 45.0, run_dir: str | None = None,
           resilience_probe: bool = False,
           serve_bundle: str | None = None,
           device: str | None = None) -> dict:
    # ONE staged probe serves both rows: the typed verdict (no-device /
    # init-hang / compile-hang / exec-hang / error) and the
    # healthy/wedged/error summary derived from it, so a wedged host costs
    # one timeout, not two serial ones.  The caller's timeout_s (--timeout)
    # rules: capping it here would classify a slow-but-healthy host (a
    # cold nvcc build) as wedged, the false alarm a larger --timeout is
    # passed to avoid.
    probe = check_device(timeout_s=timeout_s, device=device)
    if probe["status"] == "ok":
        dev = {"status": "healthy", "platform": probe["platform"],
               "n_devices": probe["n_devices"]}
    elif str(probe.get("reason", "")).endswith("-hang"):
        dev = {"status": "wedged", "timeout_s": probe["timeout_s"],
               "stderr_tail": probe.get("stderr_tail", "")}
        if probe.get("unreapable_child"):
            dev["unreapable_child"] = True
    else:
        dev = {"status": "error",
               "stderr_tail": probe.get("stderr_tail", "")}
    rep = {
        "device": dev,
        "device_probe": probe,
        "native": check_native_pool(),
        "mesh": check_mesh(),
        "elastic": check_elastic(),
        "scenarios": check_scenarios(),
        "optional": check_optional_deps(),
        "host": check_host(),
        "obs": check_obs(run_dir),
        "collector": check_collector(),
        "resilience": check_resilience(probe=resilience_probe),
        "serve": check_serve(bundle=serve_bundle),
        "router": check_router(),
        "tracing": check_tracing(),
        "autoscaler": check_autoscaler(),
    }
    cpu_recipe = (
        "run on the CPU instead — pass device=\"cpu\" to ES(...) and the "
        "other entry points (they run on cuda unless asked), and check "
        "that path with `python -m estorch_tpu_torch.doctor --device cpu`"
    )
    if dev["status"] == "wedged":
        rep["hint"] = (
            "the card's runtime is hung (not merely building): " + cpu_recipe +
            " — or retry later; a wedged CUDA runtime can outlive the process "
            "that hit it"
        )
    elif dev["status"] == "error":
        rep["hint"] = (
            "the device path failed fast (see stderr_tail: no card, a "
            "failed kernel build or a kernel off its plain version) — "
            "not a wedge; " + cpu_recipe
        )
    return rep


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--timeout", type=float, default=45.0,
                   help="device probe timeout in seconds")
    p.add_argument("--run-dir", default=None, metavar="DIR",
                   help="training run directory: report heartbeat "
                        "freshness for a run that stopped answering")
    p.add_argument("--resilience-probe", action="store_true",
                   help="also run the checkpoint save/restore round-trip "
                        "probe (a tiny ES in a timed-out subprocess)")
    p.add_argument("--bundle", default=None, metavar="DIR",
                   help="policy bundle to validate (manifest schema + "
                        "payload checksum, no torch import)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="the device the probe asks for (default cuda; cpu "
                        "runs its stages with the kernels' plain versions)")
    args = p.parse_args(argv)
    rep = report(args.timeout, run_dir=args.run_dir,
                 resilience_probe=args.resilience_probe,
                 serve_bundle=args.bundle, device=args.device)
    print(json.dumps(rep, indent=2))
    return 0 if rep["device"]["status"] == "healthy" else 1


if __name__ == "__main__":
    sys.exit(main())
