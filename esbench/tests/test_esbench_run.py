"""A run's guards: no card, no JAX, nothing but the benchmark's files."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from esbench import run

ROOT = Path(__file__).resolve().parents[2]
CMD = [sys.executable, "-m", "esbench.run", "--workload", "humanoid_mlp256_pop10k.streamed",
       "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"]


def _run(cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(CMD, cwd=cwd, capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_a_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "esbench", tmp_path / "esbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("estorch_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "estorch_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == ["estorch_tpu.ops", "jax"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import json, sys; from esbench import run, control, loader\n"
            "[loader.load_metric(m['name']) for m in loader.load_benchmark()['per_layer']]\n"
            "run.run_cell('naturecnn_vbn_pop5k.standard', 3, 0.0, True, device='cpu',\n"
            "             config_override={'population_size': 4, 'horizon': 2,\n"
            "                              'table_size': 1 << 21})\n"
            "print(json.dumps(run.forbidden_modules()))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.cuda
def test_a_short_run_of_the_streamed_cell_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    proc = _run(ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"setup_s", "env_steps_per_s", "peak_mem_gib"}
    assert list(result)[-1] == "checks"
