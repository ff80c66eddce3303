"""The port's export surfaces and histograms against the JAX package's.

``estorch_tpu_torch/obs/export`` and ``obs/hist.py`` against their
counterparts in ``estorch_tpu/obs`` on the same inputs, made from seeds,
exact: the Prometheus exposition byte for byte (and its parser's round
trip), the Perfetto export as JSON apart from the manifest keys each
package copies (``jax`` there, ``torch`` and ``cuda`` here) and the
exporter's name, the regress verdicts (median, per phase, tail), the
histogram selfcheck, merges, exports and exemplars.  A card measurement
against a committed BENCH file raises instead of giving a verdict; the
sidecar is started and scraped in process on port 0; the CLI's exit codes;
``NOT_PORTED`` names only item 9.
"""

import json
import random
import shutil
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from estorch_tpu.obs import hist as jhist
from estorch_tpu.obs.export import prometheus as jprom
from estorch_tpu.obs.export import regress as jregress
from estorch_tpu.obs.export import sidecar as jsidecar
from estorch_tpu.obs.export import traceevent as jtrace
from estorch_tpu_torch.obs import __main__ as tcli
from estorch_tpu_torch.obs import hist as thist
from estorch_tpu_torch.obs.export import prometheus as tprom
from estorch_tpu_torch.obs.export import regress as tregress
from estorch_tpu_torch.obs.export import sidecar as tsidecar
from estorch_tpu_torch.obs.export import traceevent as ttrace
from estorch_tpu_torch.obs.recorder import Heartbeat

REPO = Path(__file__).resolve().parents[1]


def seeded_hists(seed: int, mod=thist) -> "thist.Histograms":
    rng = random.Random(seed)
    reg = mod.Histograms()
    for i in range(900):
        reg.observe("phase/dispatch", rng.expovariate(5.0),
                    exemplar=f"g{i}" if i % 11 == 0 else None)
        reg.observe("async/staleness", rng.randint(0, 20), lo=0.5, decades=4, per_decade=3)
    for i in range(40):
        reg.observe("phase/device", rng.uniform(1e-3, 1e-1), n=1 + i % 3)
    return reg


def seeded_counters(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"env_steps": int(rng.integers(1, 10**9)), "generations": 12,
            "peak_rss_mb": float(rng.uniform(100, 9000)), "compile_time_s": 1.25,
            "compile_s_noise_kernels": 0.034512, "recompiles": 2, "queue_depth": 3,
            "rollout_failures": 0, "weird.name-x": 1.5, "flag": True,
            "overlap_efficiency": float(rng.uniform()), "bad": "text"}


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_exposition_byte_identical_and_parses(seed):
    counters = seeded_counters(seed)
    hb = {"age_s": 3.25 + seed * 200, "generation": 7, "phase": 'dev"ice\\x\n', "pid": 42,
          "ts": 1.0}
    hists = seeded_hists(seed).export()
    assert hists == seeded_hists(seed, jhist).export()
    for kw in ({}, {"heartbeat": hb}, {"heartbeat": hb, "stale_after_s": 5.0},
               {"extra_gauges": {"queue_depth": 9, "uptime_s": 12.5, "no": None}},
               {"up": True, "histograms": hists}, {"heartbeat": None, "up": False}):
        t = tprom.render_exposition(counters, **kw)
        assert t == jprom.render_exposition(counters, **kw)
        samples = tprom.parse_exposition(t)
        assert samples == jprom.parse_exposition(t)
        assert tprom.validate_histogram_series(samples) == []
        assert tprom.histogram_series(samples) == jprom.histogram_series(samples)
        assert tprom.samples_by_name(samples)["estorch_env_steps"] == counters["env_steps"]
    for name in list(counters) + ["a_last", "peak_x", "compile_s_y", "elastic_fold_p99_s"]:
        assert tprom.is_gauge(name) == jprom.is_gauge(name)
        assert tprom.metric_name(name) == jprom.metric_name(name)
    assert tprom.GAUGE_NAMES == jprom.GAUGE_NAMES
    for bad in ("x{a=b} 1", "# TYPE x nope", "x 1\n# TYPE x gauge\n# TYPE x gauge", "x one"):
        with pytest.raises(ValueError):
            tprom.parse_exposition(bad)


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------


def test_hist_selfcheck_and_snapshots_equal_jax():
    assert thist.selfcheck(tprom.render_exposition, tprom.parse_exposition) == []
    assert jhist.selfcheck(jprom.render_exposition, jprom.parse_exposition) == []
    t, j = seeded_hists(3), seeded_hists(3, jhist)
    assert t.snapshot() == j.snapshot() and t.export() == j.export()
    assert t.names() == j.names()
    for name in t.names():
        th, jh = t.get(name), j.get(name)
        assert th.exemplars() == jh.exemplars()
        assert th.quantile_error_bound() == jh.quantile_error_bound()
        for q in (0.5, 0.9, 0.99):
            assert th.slow_exemplars(q) == jh.slow_exemplars(q)
        back = thist.Histogram.from_dict(json.loads(json.dumps(th.to_dict())))
        assert back.to_dict() == jh.to_dict()
    a, b = seeded_hists(4).snapshot(), seeded_hists(5).snapshot(compact=True)
    b["odd"] = thist.Histogram(lo=1e-3).to_dict()
    a["odd"] = seeded_hists(6).snapshot()["phase/device"]
    assert thist.merge_snapshots(a, b) == jhist.merge_snapshots(a, b)
    assert thist.export_snapshots(a) == jhist.export_snapshots(a)
    assert thist.export_snapshots({"x": {"schema": 9}}) == {}
    for name, series in t.export().items():
        snap = thist.snapshot_from_export(series)
        assert snap == jhist.snapshot_from_export(series)
    assert thist.snapshot_from_export({"buckets": [(0.123, 1)]}) is None


# ---------------------------------------------------------------------------
# Perfetto export
# ---------------------------------------------------------------------------


def seeded_run(seed: int) -> tuple[list[dict], dict, list[dict], dict]:
    rng = np.random.default_rng(seed)
    recs = []
    for g in list(range(5)) + [3, 4, 5]:  # a replay after a restart
        rec = {"generation": g, "wall_time_s": float(rng.uniform(0.1, 0.5)),
               "env_steps": 819200, "env_steps_per_sec": float(rng.uniform(1e6, 4e6)),
               "reward_mean": float(rng.normal()), "reward_max": 1.0, "n_failed": 0,
               "phases": {"dispatch": float(rng.uniform(0.05, 0.2)),
                          "device": float(rng.uniform(0, 0.1)),
                          "record": 0.001, "record/best": 0.0005}}
        if g == 0:
            rec["compile_events"] = [{"program": "noise_kernels", "compile_s": 2.1,
                                      "generation": 0, "cached": False, "library": "lib.so"}]
        if g == 2:
            rec["async"] = {"dispatches": [4, 5], "consumed_dispatches": [[3, 16], [4, 8]],
                            "discarded_dispatches": [[1, 2]]}
        if g == 3:
            rec["async"] = {"consumed_dispatches": [[4, 8], [5, 16]]}
        recs.append(rec)
    manifest = {"hostname": "h", "pid": 7, "git_sha": "abc", "jax": "0.9", "torch": "2.11",
                "cuda": "12.8",
                "resilience": {"restarts": [{"reason": "exit -9",
                                             "heartbeat": {"pid": 99, "generation": 4}}]}}
    events = [{"ts": 100.0 + i, "kind": "event", "name": f"e{i}", "x": i} for i in range(3)]
    return recs, manifest, events, {"ts": 104.5, "pid": 11, "phase": "device",
                                    "generation": 5, "age_s": 0.5}


@pytest.mark.parametrize("seed", [0, 1])
def test_export_trace_equals_jax_apart_from_manifest_keys(seed):
    recs, manifest, events, hb = seeded_run(seed)
    for kw in ({}, {"manifest": manifest}, {"manifest": manifest, "events": events,
                                            "heartbeat": hb}, {"heartbeat": {"ts": "x"}}):
        t = json.loads(json.dumps(ttrace.export_trace(recs, **kw)))
        j = json.loads(json.dumps(jtrace.export_trace(recs, **kw)))
        assert ttrace.validate_trace(t) == [] == jtrace.validate_trace(j)
        t_meta, j_meta = t.pop("otherData"), j.pop("otherData")
        assert t == j
        assert t_meta.pop("exporter") == "estorch_tpu_torch.obs trace"
        assert j_meta.pop("exporter") == "estorch_tpu.obs trace"
        if "manifest" in kw:
            assert (t_meta.pop("torch"), t_meta.pop("cuda")) == ("2.11", "12.8")
            assert j_meta.pop("jax") == "0.9"
        assert t_meta == j_meta
    bad = {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": -1, "dur": 1},
                           {"ph": "?"}, 3]}
    assert ttrace.validate_trace(bad) == jtrace.validate_trace(bad) != []


# ---------------------------------------------------------------------------
# regress
# ---------------------------------------------------------------------------


def gen_rows(seed: int, slow: float = 1.0, n: int = 30, tail_every: int = 0) -> list[dict]:
    rng = random.Random(seed)
    rows = []
    for g in range(n):
        ev = 0.1 * slow * (1 + rng.uniform(-0.03, 0.03))
        if tail_every and g % tail_every == 0:
            ev *= 5
        up = 0.02 * (1 + rng.uniform(-0.03, 0.03))
        rows.append({"generation": g, "wall_time_s": ev + up, "env_steps": 1000,
                     "env_steps_per_sec": 1000 / (ev + up), "phases": {"eval": ev, "update": up}})
    return rows


def test_regress_verdicts_equal_jax():
    for cur, base in ((gen_rows(1), gen_rows(0)), (gen_rows(2, slow=1.3), gen_rows(0)),
                      (gen_rows(3, slow=0.7), gen_rows(0)),
                      (gen_rows(4, tail_every=10, n=100), gen_rows(5, n=100))):
        for band in (5.0, 0.5):
            for fn in ("compare_phases", "compare_tail"):
                t = getattr(tregress, fn)(cur, base, min_band_pct=band)
                assert t == getattr(jregress, fn)(cur, base, min_band_pct=band)
            cs, _ = tregress.extract_samples(cur)
            bs, _ = tregress.extract_samples(base)
            assert tregress.compare(cs, bs, min_band_pct=band) == jregress.compare(
                cs, bs, min_band_pct=band)
    assert tregress.compare_phases(gen_rows(2, slow=1.3), gen_rows(0))["regressed_phases"] == [
        "eval"]
    assert tregress.selfcheck() == [] and tregress.tail_selfcheck() == []


def test_gpu_measurement_refused_against_a_bench_file(tmp_path):
    """A card run's rows name ``gpu``; against the committed BENCH_r07.json
    (read only) the gate raises a platform mismatch and gives no verdict."""
    bench = REPO / "BENCH_r07.json"
    cur = tmp_path / "card.jsonl"
    cur.write_text(json.dumps({"platform": "gpu"}) + "\n"
                   + "".join(json.dumps(r) + "\n" for r in gen_rows(0)))
    assert tregress.measurement_platform(tregress.load_rows(str(cur))) == "gpu"
    assert tregress.measurement_platform([{"parsed": {"unit": "env-steps/s (x, gpu)"}}]) == "gpu"
    assert jregress.measurement_platform([{"parsed": {"unit": "env-steps/s (x, gpu)"}}]) is None
    base_platform = tregress.measurement_platform(tregress.load_rows(str(bench)))
    assert base_platform == jregress.measurement_platform(jregress.load_rows(str(bench)))
    for fn in (tregress.compare_files, tregress.compare_tail_files):
        with pytest.raises(ValueError, match="platform mismatch"):
            fn(str(cur), str(bench))
    assert tcli.main(["regress", str(cur), "--baseline", str(bench)]) == 1
    with pytest.raises(ValueError, match="platform mismatch"):
        tregress.ensure_same_platform("gpu", "tpu")


def test_regress_cli_exit_codes(tmp_path, capsys):
    def write(name, rows):
        p = tmp_path / name
        p.write_text("".join(json.dumps(r) + "\n" for r in rows))
        return str(p)

    base, same, slow = (write("b.jsonl", gen_rows(0)), write("s.jsonl", gen_rows(1)),
                        write("x.jsonl", gen_rows(2, slow=1.4)))
    assert tcli.main(["regress", same, "--baseline", base]) == 0
    assert tcli.main(["regress", same, "--baseline", base, "--phases", "--json"]) == 0
    v = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert v["verdict"] == "pass" and set(v["phases"]) == {"eval", "update"}
    assert tcli.main(["regress", slow, "--baseline", base, "--phases"]) == 1
    assert "REGRESSION in phase 'eval'" in capsys.readouterr().out
    assert tcli.main(["regress", slow, "--baseline", base, "--tail"]) == 1
    assert tcli.main(["regress", slow, "--baseline", base]) == 1
    assert tcli.main(["regress", same, "--baseline", str(tmp_path / "none.jsonl")]) == 1
    assert tcli.main(["regress", same]) == 3
    assert tcli.main(["regress", same, "--baseline", base, "--quantile", "0.9"]) == 3
    assert tcli.main(["regress", same, "--baseline", base, "--tail", "--phases"]) == 3
    assert tcli.main(["regress", same, "--baseline", base, "--phases", "--label", "a"]) == 3
    assert tcli.main(["regress", "--selfcheck"]) == 0
    assert tcli.main(["regress", "--tail", "--selfcheck"]) == 0


# ---------------------------------------------------------------------------
# the sidecar, the other subcommands, NOT_PORTED
# ---------------------------------------------------------------------------


def test_sidecar_scraped_in_process(tmp_path):
    """The live heartbeat composed with the supervisor's published totals:
    the scrape parses, its histograms validate, and it equals the JAX
    sidecar's on the same directory."""
    run = tmp_path / "run"
    run.mkdir()
    hists = seeded_hists(7).snapshot(compact=True)
    Heartbeat(str(run / "heartbeat.json")).beat("device", 5, {"env_steps": 100, "recompiles": 1},
                                                hists=hists)
    tsidecar.publish_counters(str(run), {"env_steps": 900, "recompiles": 1}, through_ts=0.0,
                              extra={"restart_count": 2, "completed": False},
                              hists=seeded_hists(8).snapshot())
    assert tsidecar.COUNTERS_FILENAME == jsidecar.COUNTERS_FILENAME == "counters.json"
    pub = tsidecar.read_published_counters(str(run))
    assert pub == jsidecar.read_published_counters(str(run))
    car = tsidecar.MetricsSidecar(str(run), port=0)
    car.start_background()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{car.port}/metrics", timeout=10) as r:
            body = r.read().decode()
        with urllib.request.urlopen(f"http://127.0.0.1:{car.port}/healthz", timeout=10) as r:
            health = json.loads(r.read())
    finally:
        car.close()
    samples = tprom.parse_exposition(body)
    assert tprom.validate_histogram_series(samples) == []
    vals = tprom.samples_by_name(samples)
    assert vals["estorch_env_steps"] == 1000 and vals["estorch_up"] == 1
    assert vals["estorch_supervisor_restarts"] == 2 and vals["estorch_run_completed"] == 0
    assert health["ok"] and health["phase"] == "device"
    jcar = jsidecar.MetricsSidecar(str(run), port=0)
    try:
        want = jcar.scrape()
    finally:
        jcar.close()
    strip = [ln for ln in body.splitlines() if not ln.startswith("estorch_heartbeat_age")]
    assert strip == [ln for ln in want.splitlines()
                     if not ln.startswith("estorch_heartbeat_age")]
    hb = json.loads((run / "heartbeat.json").read_text())
    assert tsidecar.compose_totals(pub, hb) == jsidecar.compose_totals(pub, hb)
    assert tsidecar.compose_hists(pub, hb) == jsidecar.compose_hists(pub, hb)


def test_sidecar_runs_as_a_file_without_the_package(tmp_path):
    """The file form loads the port's own siblings by path: a copy of the
    four files outside the repository serves /metrics."""
    import subprocess
    import sys
    import time

    obs = REPO / "estorch_tpu_torch" / "obs"
    (tmp_path / "obs" / "export").mkdir(parents=True)
    for rel in ("recorder.py", "hist.py", "export/prometheus.py", "export/sidecar.py"):
        shutil.copy(obs / rel, tmp_path / "obs" / rel)
    run = tmp_path / "run"
    run.mkdir()
    Heartbeat(str(run / "heartbeat.json")).beat("eval", 1, {"env_steps": 5})
    pf = tmp_path / "pf.json"
    proc = subprocess.Popen([sys.executable, str(tmp_path / "obs/export/sidecar.py"),
                             "--run-dir", str(run), "--port", "0", "--port-file", str(pf)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 30
        while not pf.exists() and time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.05)
        port = json.loads(pf.read_text())["port"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            vals = tprom.samples_by_name(tprom.parse_exposition(r.read().decode()))
        assert vals["estorch_env_steps"] == 5 and vals["estorch_up"] == 1
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode == 0


def test_trace_hist_serve_metrics_cli_exit_codes(tmp_path, capsys):
    recs, manifest, events, hb = seeded_run(0)
    jsonl = tmp_path / "run.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in recs))
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    ev = tmp_path / "ring.jsonl"
    ev.write_text("".join(json.dumps(e) + "\n" for e in events))
    assert tcli.main(["trace", str(jsonl), "--events", str(ev)]) == 0
    t = json.loads((tmp_path / "trace.json").read_text())
    assert ttrace.validate_trace(t) == [] and t["otherData"]["torch"] == "2.11"
    assert tcli.main(["trace", str(jsonl), "-o", str(tmp_path / "o.json")]) == 0
    assert tcli.main(["trace", str(tmp_path / "missing.jsonl")]) == 1
    assert tcli.main(["trace", str(jsonl), "--events", str(tmp_path / "no.jsonl")]) == 1
    assert tcli.main(["hist", "--selfcheck"]) == 0
    assert tcli.main(["hist"]) == 3
    assert tcli.main(["serve-metrics", "--run-dir", str(tmp_path / "nowhere")]) == 2
    assert tcli.main([]) == 3


def test_not_ported_names_only_item_9(capsys):
    assert tcli.NOT_PORTED == {"collect": "9", "dash": "9", "slow": "9", "autoscale": "9"}
    for cmd in tcli.NOT_PORTED:
        assert tcli.main([cmd]) == 3
        assert "item 9" in capsys.readouterr().err
    assert tcli.main(["trace", "--fleet", "d"]) == 3
    assert "item 9" in capsys.readouterr().err
    for cmd in ("trace", "profile", "regress", "hist", "serve-metrics", "summarize"):
        assert cmd not in tcli.NOT_PORTED
