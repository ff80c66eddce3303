"""The port's environment doctor (``estorch_tpu_torch/doctor.py``), on the
CPU: the counterpart of ``tests/test_doctor.py``.

The device probe runs a REAL subprocess: here, where torch has no CUDA,
the card's probe must answer ``no-device`` within its timeout, and with
``device="cpu"`` every probe of the report is healthy (one full report,
shared by the row tests).  The classifiers' taxonomies are pinned on
controlled children and pure inputs, every failure comes back as a named
stage or a row, never a raise, and the report's rows are the JAX
doctor's, with every check of both modules stubbed so no JAX probe runs.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from estorch_tpu_torch import doctor

REPO = Path(__file__).resolve().parent.parent
CHECKS = ("check_device", "check_native_pool", "check_mesh", "check_elastic",
          "check_scenarios", "check_optional_deps", "check_host", "check_obs",
          "check_collector", "check_resilience", "check_serve", "check_router",
          "check_tracing", "check_autoscaler")


# ------------------------------------------------------------ classifiers

DEVICE_OK = ("PROBE_START\nPROBE_TORCH_OK 2.13\nPROBE_DEVICES_OK cuda 1 NVIDIA H100\n"
             "PROBE_COMPILE_OK {}\nPROBE_EXEC_OK {}\n")


@pytest.mark.parametrize("out,timed_out,rc,want", [
    (DEVICE_OK, False, 0, ("ok", None)),
    ("", True, None, ("failed", "init-hang")),
    ("PROBE_START\nPROBE_TORCH_OK 2\n", True, None, ("failed", "init-hang")),
    ("PROBE_START\nPROBE_TORCH_OK 2\nPROBE_DEVICES_OK cuda 1 H100\n", True, None,
     ("failed", "compile-hang")),
    ("PROBE_START\nPROBE_TORCH_OK 2\nPROBE_DEVICES_OK cuda 1 H100\nPROBE_COMPILE_OK {}\n",
     True, None, ("failed", "exec-hang")),
    (DEVICE_OK, True, None, ("failed", "exec-hang")),
    # failed FAST before a device existed: no card — not a wedge
    ("PROBE_START\nPROBE_TORCH_OK 2\n", False, 3, ("failed", "no-device")),
    # failed fast AFTER the device came up: a failed build or launch
    ("PROBE_START\nPROBE_TORCH_OK 2\nPROBE_DEVICES_OK cuda 1 H100\n", False, 1,
     ("failed", "error")),
    ("PROBE_START\nPROBE_TORCH_OK 2\nPROBE_DEVICES_OK cuda 1 H100\nPROBE_COMPILE_OK {}\n",
     False, 1, ("failed", "error")),
])
def test_device_classifier_taxonomy(out, timed_out, rc, want):
    assert doctor.classify_device_probe(out, timed_out, rc) == want


@pytest.mark.parametrize("classify,stages", [
    (doctor.classify_mesh_probe, doctor._MESH_STAGES),
    (doctor.classify_scenario_probe, doctor._SCENARIO_STAGES),
    (doctor.classify_elastic_probe, doctor._ELASTIC_STAGES),
])
def test_staged_classifier_taxonomy(classify, stages):
    """Each staged CPU probe names the first stage whose marker is
    missing, timed out or not, and is ok only with every marker, rc 0 and
    no timeout; the stage names are the JAX doctor's."""
    markers = [m for m, _ in stages]
    full = "START\n" + "\n".join(markers) + "\n"
    assert classify(full, False, 0) == ("ok", None)
    assert classify(full, True, None) == ("failed", stages[-1][1])
    for i, (_, stage) in enumerate(stages):
        partial = "START\n" + "\n".join(markers[:i]) + "\n"
        assert classify(partial, False, 1) == ("failed", stage)
        assert classify(partial, True, None) == ("failed", stage)


def test_stage_names_are_the_jax_doctors():
    from estorch_tpu import doctor as jdoctor

    assert [r for _, r in doctor._PROBE_STAGES] == [r for _, r in jdoctor._PROBE_STAGES]
    for name in ("_MESH_STAGES", "_SCENARIO_STAGES", "_ELASTIC_STAGES"):
        assert getattr(doctor, name) == getattr(jdoctor, name), name


# ------------------------------------------------------------ the device


def test_card_probe_here_is_no_device_within_its_timeout():
    """This host's torch has no CUDA: the card's probe fails fast as
    ``no-device`` (never a quiet CPU run) and the report's device row is
    an error with the CPU hint."""
    out = doctor.check_device(timeout_s=60.0)
    assert out["status"] == "failed" and out["reason"] == "no-device", out
    assert out["elapsed_s"] < 60.0
    assert "no CUDA device" in out["stderr_tail"]
    assert "launches" not in out


@pytest.mark.parametrize("script,reason,platform", [
    ('print("PROBE_START", flush=True)\nprint("PROBE_TORCH_OK 2", flush=True)\n'
     'print("PROBE_DEVICES_OK cuda 1 NVIDIA H100 80GB HBM3", flush=True)\n'
     "import time; time.sleep(60)\n", "compile-hang", "cuda"),
    ('print("PROBE_START", flush=True)\nimport time; time.sleep(60)\n', "init-hang", None),
])
def test_hang_classified_by_its_stage(monkeypatch, script, reason, platform):
    monkeypatch.setattr(doctor, "_STAGED_PROBE", script)
    out = doctor.check_device(timeout_s=3.0)
    assert out["status"] == "failed" and out["reason"] == reason
    assert out.get("platform") == platform  # the layer that DID answer
    if platform:
        assert out["device_name"] == "NVIDIA H100 80GB HBM3"


def test_device_pin_reaches_child(monkeypatch):
    monkeypatch.setattr(doctor, "_STAGED_PROBE", (
        'DEVICE = __DEVICE__\nprint("PROBE_DEVICES_OK", DEVICE, 1, "x", flush=True)\n'
        "raise SystemExit(1)\n"))
    out = doctor.check_device(timeout_s=30.0, device="cpu")
    assert out["requested_device"] == "cpu" and out["platform"] == "cpu"
    assert out["reason"] == "error"
    with pytest.raises(ValueError, match="cuda' or 'cpu"):
        doctor.check_device(device="tpu")


def test_failed_kernel_check_is_a_failed_row(monkeypatch):
    """A kernel off its plain version (or a failed build or launch) is
    an ``error`` row with the stderr, never a pass."""
    script = doctor._STAGED_PROBE.replace("if max(err.values()) > 1e-5:",
                                          "if max(err.values()) > -1.0:")
    monkeypatch.setattr(doctor, "_STAGED_PROBE", script)
    out = doctor.check_device(timeout_s=60.0, device="cpu")
    assert out["status"] == "failed" and out["reason"] == "error"
    assert "disagrees with its plain version" in out["stderr_tail"]


# ------------------------------------- probe_device (tests/test_doctor.py)


def test_probe_device_healthy_parse(monkeypatch):
    """A child that reaches its launch is classified healthy with fields
    (``TestProbeClassifier.test_healthy_parse``)."""
    monkeypatch.setattr(doctor, "_STAGED_PROBE", "print(%r)" % DEVICE_OK.replace(
        "cuda 1 NVIDIA H100", "cpu 8 cpu"))
    out = doctor.probe_device(timeout_s=60)
    assert out == {"status": "healthy", "platform": "cpu", "n_devices": 8}


def test_probe_device_wedge_detected_by_timeout_with_stderr_clue(monkeypatch):
    """A child that hangs past the timeout is classified wedged, and what
    it wrote to stderr before hanging survives in the report."""
    monkeypatch.setattr(doctor, "_STAGED_PROBE", (
        "import sys, time\n"
        "sys.stderr.write('initializing the CUDA context...')\n"
        "sys.stderr.flush()\n"
        "time.sleep(60)\n"))
    out = doctor.probe_device(timeout_s=3)
    assert out["status"] == "wedged"
    assert out["timeout_s"] == 3
    assert "initializing the CUDA context" in out["stderr_tail"]


def test_probe_device_fast_failure_is_error_not_wedge(monkeypatch):
    """A child that raises quickly is an init error with its stderr tail;
    here, with no card, the real probe is too."""
    monkeypatch.setattr(doctor, "_STAGED_PROBE", "raise RuntimeError('backend exploded')")
    out = doctor.probe_device(timeout_s=60)
    assert out["status"] == "error" and out["returncode"] == 1
    assert "backend exploded" in out["stderr_tail"]


def test_probe_device_real_child_on_this_host():
    """The real staged child: the card's probe is an error here (no card),
    the CPU's healthy."""
    assert doctor.probe_device(timeout_s=60)["status"] == "error"
    assert doctor.probe_device(timeout_s=60, device="cpu") == {
        "status": "healthy", "platform": "cpu", "n_devices": 1}


# ------------------------------------------- one full report on the CPU


@pytest.fixture(scope="module")
def cpu_report(tmp_path_factory):
    from estorch_tpu_torch.obs import Heartbeat

    run_dir = tmp_path_factory.mktemp("run")
    Heartbeat(str(run_dir / "heartbeat.json")).beat("update", 11)
    return doctor.report(timeout_s=60.0, run_dir=str(run_dir), resilience_probe=True,
                         device="cpu")


def test_cpu_device_rows(cpu_report):
    assert cpu_report["device"] == {"status": "healthy", "platform": "cpu", "n_devices": 1}
    probe = cpu_report["device_probe"]
    assert probe["status"] == "ok" and probe["requested_device"] == "cpu"
    assert probe["library"] == {"plain_versions": True}
    # the plain versions on the CPU: no kernel launched, both compared
    assert probe["launches"] == {"weighted_noise_sum": 0, "population_noise_matvec": 0}
    assert max(probe["max_abs_err"].values()) <= 1e-5
    assert "hint" not in cpu_report


@pytest.mark.parametrize("row", ["mesh", "elastic", "scenarios"])
def test_cpu_staged_rows_healthy(cpu_report, row):
    out = cpu_report[row]
    assert out["status"] == "ok", out
    assert "failed_stage" not in out and out["elapsed_s"] < out["timeout_s"]


@pytest.mark.parametrize("row,path", [
    ("native", ("cpp_pool",)),
    ("obs", ("export", "ok")),
    ("obs", ("trace_dir", "writable")),
    ("collector", ("ok",)),
    ("resilience", ("ckpt_root", "writable")),
    ("resilience", ("fork", "available")),
    ("serve", ("loopback", "bindable")),
    ("serve", ("batcher", "ok")),
    ("router", ("ok",)),
    ("tracing", ("ok",)),
    ("autoscaler", ("ok",)),
])
def test_cpu_rows_healthy(cpu_report, row, path):
    got = cpu_report[row]
    for k in path:
        got = got[k]
    assert got is True, cpu_report[row]


def test_cpu_report_details(cpu_report):
    assert cpu_report["resilience"]["roundtrip"]["status"] == "ok"
    assert cpu_report["obs"]["heartbeat"]["generation"] == 11
    assert cpu_report["obs"]["heartbeat"]["stale"] is False
    assert cpu_report["tracing"]["cross_hops"] >= 1
    assert cpu_report["router"]["retries"] >= 1
    host = cpu_report["host"]
    assert host["compile_cache_dir"].endswith("build/estorch_tpu_torch")
    assert host["cpu_count"] >= 1
    opt = cpu_report["optional"]
    assert set(opt) == {"gymnasium", "mujoco", "ale_py", "triton", "nvcc", "cutlass"}
    assert opt["nvcc"]["available"] is (opt["nvcc"]["path"] is not None)


# ------------------------------------------- failures are rows, not raises


@pytest.mark.parametrize("attr,name", [
    ("_MESH_PROBE", "check_mesh"),
    ("_SCENARIO_PROBE", "check_scenarios"),
    ("_ELASTIC_PROBE", "check_elastic"),
])
def test_failing_stage_named_not_raised(monkeypatch, attr, name):
    stages = {"check_mesh": doctor._MESH_STAGES, "check_scenarios": doctor._SCENARIO_STAGES,
              "check_elastic": doctor._ELASTIC_STAGES}[name]
    monkeypatch.setattr(doctor, attr, (
        f'print("START", flush=True)\nprint("{stages[0][0]}", flush=True)\n'
        "raise RuntimeError('layer two exploded')\n"))
    out = getattr(doctor, name)(timeout_s=30.0)
    assert out["status"] == "failed" and out["failed_stage"] == stages[1][1]
    assert "layer two exploded" in out["stderr_tail"] and out["timed_out"] is False


@pytest.mark.parametrize("module,cls,check", [
    ("estorch_tpu_torch.obs.export.sidecar", "MetricsSidecar", "_export_probe"),
    ("estorch_tpu_torch.obs.agg.collector", "Collector", "check_collector"),
    ("estorch_tpu_torch.serve.router", "Router", "check_router"),
    ("estorch_tpu_torch.serve.router", "Router", "check_tracing"),
    ("estorch_tpu_torch.obs.agg.autoscale", "Autoscaler", "check_autoscaler"),
])
def test_loopback_probe_failure_is_a_row(monkeypatch, module, cls, check):
    import importlib

    def boom(*a, **kw):
        raise OSError("port refused")

    monkeypatch.setattr(getattr(importlib.import_module(module), cls), "__init__", boom)
    out = getattr(doctor, check)()
    assert out["ok"] is False and "port refused" in out["error"]


def test_missing_parent_package_never_crashes(monkeypatch):
    import importlib.util as ilu

    def raising(name, *a, **kw):
        raise ModuleNotFoundError(name)

    monkeypatch.setattr(ilu, "find_spec", raising)
    out = doctor.check_optional_deps()
    assert all(not out[m]["available"] for m in ("gymnasium", "mujoco", "ale_py", "triton"))


def test_unwritable_roots_never_crash(tmp_path, monkeypatch):
    monkeypatch.setenv("ESTORCH_OBS_DIR", str(tmp_path / "missing" / "deep"))
    out = doctor.check_obs()
    assert out["trace_dir"]["writable"] is False and "error" in out["trace_dir"]
    out = doctor.check_resilience(ckpt_root=str(tmp_path / "missing" / "deep"))
    assert out["ckpt_root"]["writable"] is False and "roundtrip" not in out


def test_watchdog_warns_on_heartbeat_with_telemetry_off(tmp_path, monkeypatch):
    monkeypatch.setenv("ESTORCH_OBS_HEARTBEAT", str(tmp_path / "hb.json"))
    monkeypatch.setenv("ESTORCH_OBS", "0")
    wd = doctor.check_resilience(ckpt_root=str(tmp_path))["heartbeat_watchdog"]
    assert wd["heartbeat_env_set"] is True and wd["telemetry_enabled"] is False
    assert "warning" in wd and wd["heartbeat_dir_writable"] is True


@pytest.mark.parametrize("script,status,clue", [
    ("print('RESILIENCE_PROBE_OK')", "ok", None),
    ("raise RuntimeError('torch.save exploded')", "error", "torch.save exploded"),
    ("import time; time.sleep(60)", "wedged", None),
])
def test_roundtrip_probe_classifier(tmp_path, monkeypatch, script, status, clue):
    monkeypatch.setattr(doctor, "_RESILIENCE_PROBE", script)
    out = doctor.check_resilience(ckpt_root=str(tmp_path), probe=True, probe_timeout_s=3.0)
    assert out["roundtrip"]["status"] == status
    if clue:
        assert clue in out["roundtrip"]["stderr_tail"]


def test_heartbeat_missing_is_reported(tmp_path):
    out = doctor.check_obs(str(tmp_path))
    assert out["heartbeat"]["found"] is False and "hint" in out["heartbeat"]


# ------------------------------------------------------------- bundles


def _bundle(tmp_path, torch_version=None, **warm_over):
    """A hand-made bundle (raw files and checksums: the probe must stay
    torch-free, so no export machinery)."""
    bdir = tmp_path / "b"
    bdir.mkdir()
    arrays = bdir / "arrays.npz"
    with open(arrays, "wb") as f:
        np.savez(f, params_flat=np.zeros(7, np.float32))
    man = {"schema": 1, "version": "v9",
           "module": {"import": "whatever:NotImported", "kwargs": {}},
           "obs_shape": [3], "param_dim": 7, "obs_norm": False,
           "sha256": {"arrays.npz": hashlib.sha256(arrays.read_bytes()).hexdigest()}}
    if torch_version is not None:
        man["warm"] = {"format": "torch_eager", "max_batch": 4, "buckets": [2, 4],
                       "buckets_excluded": [], "dtypes": ["f32"],
                       "torch_version": torch_version, "platform": "gpu",
                       "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 1,
                       **warm_over}
    (bdir / "MANIFEST.json").write_text(json.dumps(man))
    return bdir


def test_broken_bundles_diagnosed(tmp_path):
    out = doctor.check_serve(bundle=str(tmp_path / "missing"))
    assert out["bundle"]["valid"] is False and "error" in out["bundle"]
    bdir = _bundle(tmp_path)
    (bdir / "arrays.npz").write_bytes(b"junk")
    out = doctor.check_serve(bundle=str(bdir))
    assert out["bundle"]["valid"] is False and "checksum" in out["bundle"]["error"]


def test_valid_bundle_reported(tmp_path):
    out = doctor.check_serve(bundle=str(_bundle(tmp_path)))
    assert out["bundle"]["valid"] is True
    assert out["bundle"]["version"] == "v9" and out["bundle"]["param_dim"] == 7
    assert out["bundle"]["warm"] == {"present": False}


@pytest.mark.parametrize("which", ["compatible", "mismatch", "ladder"])
def test_warm_probe(tmp_path, which):
    from importlib.metadata import version

    if which == "compatible":
        warm = doctor.check_serve(bundle=str(_bundle(tmp_path, version("torch"))))
        warm = warm["bundle"]["warm"]
        assert warm["present"] and warm["compatible"] is True and "finding" not in warm
        assert warm["format"] == "torch_eager" and warm["buckets"] == [2, 4]
    elif which == "mismatch":
        out = doctor.check_serve(bundle=str(_bundle(tmp_path, "0.0.0")))
        assert out["bundle"]["valid"] is True
        warm = out["bundle"]["warm"]
        assert warm["compatible"] is False
        assert "0.0.0" in warm["finding"] and "re-export" in warm["finding"]
    else:
        out = doctor.check_serve(bundle=str(_bundle(tmp_path, "0.0.0", buckets=[2])))
        assert out["bundle"]["valid"] is False
        assert "ladder incomplete" in out["bundle"]["error"]


def test_bundle_check_imports_no_torch(tmp_path):
    """``--bundle`` validates the manifest and checksums without importing
    torch (``serve/validate.py``), so a wedged card cannot hang it."""
    bdir = _bundle(tmp_path, "0.0.0")
    code = ("import json, sys\nfrom estorch_tpu_torch import doctor\n"
            f"out = doctor.check_serve(bundle={str(bdir)!r})\n"
            "print(json.dumps([out['bundle']['valid'], 'torch' in sys.modules]))\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=REPO)
    assert got.returncode == 0, got.stderr
    assert json.loads(got.stdout.strip().splitlines()[-1]) == [True, False]


def test_doctor_and_analysis_import_nothing_of_jax_or_torch():
    """The doctor imports the standard library only at load, and neither
    it nor the port's analyzer imports JAX or the JAX package."""
    code = ("import sys\nimport estorch_tpu_torch.doctor\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'numpy', 'estorch_tpu'))\n"
            "import estorch_tpu_torch.analysis\nimport estorch_tpu_torch.analysis.__main__\n"
            "bad += sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'estorch_tpu'))\n"
            "print(bad)\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=REPO)
    assert got.returncode == 0, got.stderr
    assert got.stdout.strip() == "[]"


# ------------------------------------------------------------ the report


def _stub_all(monkeypatch, mod, device_row):
    for name in CHECKS:
        monkeypatch.setattr(mod, name, lambda *a, **kw: {"status": "ok", "ok": True})
    monkeypatch.setattr(mod, "check_device", lambda *a, **kw: dict(device_row))


@pytest.mark.parametrize("verdict", ["ok", "hang", "no-device"])
def test_report_rows_equal_the_jax_doctors(monkeypatch, verdict):
    from estorch_tpu import doctor as jdoctor

    row = {"ok": {"status": "ok", "platform": "cpu", "n_devices": 1},
           "hang": {"status": "failed", "reason": "compile-hang", "timeout_s": 5.0},
           "no-device": {"status": "failed", "reason": "no-device"}}[verdict]
    _stub_all(monkeypatch, jdoctor, row)
    _stub_all(monkeypatch, doctor, row)
    want, got = jdoctor.report(timeout_s=5.0), doctor.report(timeout_s=5.0)
    assert list(got) == list(want)
    assert got["device"] == want["device"]
    assert ("hint" in got) == (verdict != "ok")


def test_hints_name_the_cpu_device(monkeypatch):
    _stub_all(monkeypatch, doctor, {"status": "failed", "reason": "exec-hang",
                                    "timeout_s": 5.0, "stderr_tail": ""})
    rep = doctor.report(timeout_s=5.0)
    assert rep["device"]["status"] == "wedged"
    assert 'device="cpu"' in rep["hint"] and "jax" not in rep["hint"].lower()
    _stub_all(monkeypatch, doctor, {"status": "failed", "reason": "error"})
    rep = doctor.report(timeout_s=5.0)
    assert rep["device"]["status"] == "error" and "failed kernel build" in rep["hint"]


@pytest.mark.parametrize("status,rc", [("ok", 0), ("failed", 1)])
def test_cli_json_and_exit_code(monkeypatch, capsys, status, rc):
    _stub_all(monkeypatch, doctor, {"status": status, "platform": "cuda", "n_devices": 1,
                                    "reason": None if status == "ok" else "no-device"})
    assert doctor.main(["--timeout", "5"]) == rc
    rep = json.loads(capsys.readouterr().out)
    assert ("hint" in rep) == (rc != 0)
    if rc == 0:
        assert rep["device"] == {"status": "healthy", "platform": "cuda", "n_devices": 1}

