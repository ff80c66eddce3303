"""The loader finds configurations, cells and metrics by name, and every
name that BENCHMARK.json gives has its file."""

import json

import pytest

from esbench import loader


def test_every_name_in_benchmark_json_has_its_file():
    bench = loader.load_benchmark()
    for c in bench["configs"]:
        cfg = loader.load_config(c["name"])
        assert c["file"] == f"esbench/configs/{c['name']}.json"
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
    for w in bench["workloads"]:
        cell = loader.load_workload(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert {"loss0_gap", "grad_gap", "steps_gap"} <= set(cell["limits"]) <= {
            "loss_gap", "loss0_gap", "grad_gap", "change_gap", "steps_gap", "action_gap",
            "flip_share"}
        assert cell["steps"] >= 1
    for m in bench["per_layer"]:
        assert callable(loader.load_metric(m["name"]).read)


@pytest.mark.parametrize("name", ["a/b", "../x", ".hidden", "-x", "a b", "x" * 65, "é", ""])
def test_a_name_outside_the_alphabet_is_refused(name):
    with pytest.raises(ValueError):
        loader.check_name(name)
    with pytest.raises(ValueError):
        loader.load_workload(name)


def test_an_unknown_name_is_not_found():
    with pytest.raises(FileNotFoundError):
        loader.load_config("no_such_config")
    with pytest.raises(FileNotFoundError):
        loader.load_metric("no_such_metric")


def test_cell_metrics_follow_the_workloads_key():
    bench = loader.load_benchmark()
    e2e, per_layer = loader.cell_metrics(bench, "humanoid_mlp256_pop10k.streamed")
    assert {m["name"] for m in e2e} == {"setup_s", "env_steps_per_s", "peak_mem_gib"}
    names = {m["name"] for m in per_layer}
    assert {"matvec_roofline_pct", "reduction_roofline_pct", "mfu_pct"} <= names
    assert "forward_ms_per_step" not in names
    _, per_layer = loader.cell_metrics(bench, "naturecnn_vbn_pop5k.standard")
    names = {m["name"] for m in per_layer}
    assert "forward_ms_per_step" in names and "matvec_roofline_pct" not in names


def test_benchmark_json_keeps_to_the_contract_shape():
    bench = json.loads(loader.BENCHMARK.read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
