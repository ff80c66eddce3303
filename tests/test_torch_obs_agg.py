"""The port's fleet observability (``estorch_tpu_torch/obs/agg``) and the
serving section of ``obs summarize`` against the JAX package's, on the
same inputs, on the CPU.

Both packages' modules are stdlib-only copies, so "the same inputs" means
the same files and dicts: a store the JAX collector's ``SeriesStore``
wrote is read by the port's (and the reverse), the same rules evaluate
the same store, ``decide`` runs over a seeded grid of inputs, the port's
``replay`` re-derives a JAX-written decision log bit for bit, trace
assembly and export run on the same synthetic segments, ``dash.render``
renders the same store, and ``_serving_block`` and ``summarize`` read the
same server heartbeat.  Each module's ``selfcheck`` passes, in process and
through ``python -m estorch_tpu_torch.obs``, and the file-run forms load
neither torch nor any package.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from estorch_tpu.obs.agg import autoscale as jaz
from estorch_tpu.obs.agg import collector as jcol
from estorch_tpu.obs.agg import dash as jdash
from estorch_tpu.obs.agg import rules as jrules
from estorch_tpu.obs.agg import traces as jtraces
from estorch_tpu.obs.agg.store import SeriesStore as JStore
from estorch_tpu.obs.hist import Histogram as JHist
from estorch_tpu_torch.obs import summarize as tsum
from estorch_tpu_torch.obs.agg import autoscale as taz
from estorch_tpu_torch.obs.agg import collector as tcol
from estorch_tpu_torch.obs.agg import dash as tdash
from estorch_tpu_torch.obs.agg import rules as trules
from estorch_tpu_torch.obs.agg import traces as ttraces
from estorch_tpu_torch.obs.agg.store import SeriesStore as TStore
from estorch_tpu_torch.obs.hist import Histogram as THist

jsum = importlib.import_module("estorch_tpu.obs.summarize")  # the package exports a function

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0


def _fill(store_cls, hist_cls, root, seed=0, ticks=12):
    """A seeded fleet history: two serve targets and a router, counters
    with a restart, gauges, request histograms with trace-id exemplars."""
    rng = np.random.default_rng(seed)
    store = store_cls(root, segment_max_samples=40, max_segments=50)
    hists = {t: hist_cls() for t in ("serve-a", "serve-b")}
    route = hist_cls()
    total = {"serve-a": 0.0, "serve-b": 0.0}
    for k in range(ticks):
        ts = T0 + 2.0 * k
        rows = []
        for t in ("serve-a", "serve-b"):
            if t == "serve-b" and k == 6:
                total[t] = 0.0  # the replica restarted: its counter resets
            total[t] += float(rng.integers(20, 80))
            for j in range(int(rng.integers(3, 9))):
                hists[t].observe(float(rng.lognormal(-5.0, 0.8)),
                                 exemplar=f"{t}-{k}-{j}")
            up = 0.0 if (t == "serve-b" and k in (6, 7)) else 1.0
            rows += [{"name": "estorch_up", "labels": {"target": t}, "value": up},
                     {"name": "estorch_serve_requests_total", "labels": {"target": t},
                      "value": total[t]},
                     {"name": "estorch_queue_depth", "labels": {"target": t},
                      "value": float(rng.integers(0, 5))},
                     {"name": "estorch_recompiles", "labels": {"target": t},
                      "value": 0.0},
                     {"name": "estorch_serve_request_s", "labels": {"target": t},
                      "hist": hists[t].to_dict()}]
        for j in range(int(rng.integers(4, 12))):
            route.observe(float(rng.lognormal(-4.5, 0.6)), exemplar=f"r-{k}-{j}")
        rows += [{"name": "estorch_up", "labels": {"target": "router"}, "value": 1.0},
                 {"name": "estorch_router_requests_total", "labels": {"target": "router"},
                  "value": float(100 * k + rng.integers(0, 50))},
                 {"name": "estorch_router_route_s", "labels": {"target": "router"},
                  "hist": route.to_dict()}]
        for r in range(2 + (k > 8)):
            rows.append({"name": "estorch_router_replica_up",
                         "labels": {"target": "router", "replica": f"r{r}"},
                         "value": 0.0 if (r == 1 and k in (6, 7)) else 1.0})
        store.append(rows, ts=ts)
    return store, T0 + 2.0 * (ticks - 1)


def _reads(store, now):
    """Every query a reader makes, as plain JSON-able values."""
    out = {}
    for t in ("serve-a", "serve-b", "router"):
        lab = {"target": t}
        out[t] = {
            "range": [(ts, sorted(la.items()), v)
                      for ts, la, v in store.range("estorch_up", lab, 30.0, now)],
            "latest": sorted((str(k), v[2]) for k, v in
                             store.latest("estorch_router_replica_up", lab, 30.0, now).items()),
            "increase": store.increase("estorch_serve_requests_total", lab, 30.0, now),
            "rate": store.rate("estorch_router_requests_total", lab, 10.0, now),
        }
        for name in ("estorch_serve_request_s", "estorch_router_route_s"):
            for w in (5.0, 30.0):
                h = store.hist_window(name, lab, w, now)
                out[t][f"{name}/{w}"] = None if h is None else h.to_dict()
                out[t][f"{name}/{w}/p99"] = store.quantile(name, 0.99, lab, w, now)
    out["labels"] = store.label_values("estorch_up", "target", 60.0, now)
    return out


# =====================================================================
# store: written by one package, read by the other
# =====================================================================

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_crosses_packages(tmp_path, writer):
    root = str(tmp_path / "store")
    if writer == "jax":
        _, now = _fill(JStore, JHist, root)
    else:
        _, now = _fill(TStore, THist, root)
    assert sorted(os.listdir(root)) == [os.path.basename(p) for p in TStore(root).segments()]
    assert _reads(TStore(root), now) == _reads(JStore(root), now)


def test_store_files_are_byte_equal(tmp_path):
    _fill(JStore, JHist, str(tmp_path / "j"))
    _fill(TStore, THist, str(tmp_path / "t"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    for n in names:
        assert (tmp_path / "j" / n).read_bytes() == (tmp_path / "t" / n).read_bytes(), n


def _exposition_server(text: str):
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Prom(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = text.encode() if self.path == "/metrics" else b"{}"
            self.send_response(200 if self.path == "/metrics" else 404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Prom)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_collector_stores_cross_packages(tmp_path):
    """The JAX collector and the port's scrape the same endpoint at the same
    ticks: each store reads the same through either package's
    ``SeriesStore``, and the two stores hold the same series."""
    from estorch_tpu.obs.export.prometheus import render_exposition

    h = JHist()
    for v in np.random.default_rng(4).lognormal(-5, 1, 200):
        h.observe(float(v), exemplar=f"t{v:.6f}")
    srv = _exposition_server(render_exposition(
        {"requests_total": 420.0, "shed_total": 3.0}, up=True,
        extra_gauges={"queue_depth": 2.0}, histograms={"serve/request_s": h.to_export()}))
    url = f"http://127.0.0.1:{srv.server_address[1]}/metrics"
    try:
        roots = {}
        for tag, col, store_cls in (("j", jcol, JStore), ("t", tcol, TStore)):
            roots[tag] = str(tmp_path / tag)
            c = col.Collector([col.Target("serve-a", url=url, timeout_s=5.0),
                               col.Target("dead", url="http://127.0.0.1:1/metrics",
                                          timeout_s=0.5)],
                              store_cls(roots[tag]), serve_http=False, scrape_traces=False)
            for k in range(4):
                c.tick(now=T0 + 2.0 * k)
    finally:
        srv.shutdown(), srv.server_close()
    now = T0 + 6.0

    def series(root, store_cls):
        st = store_cls(root)
        names = sorted({r["name"] for r in st._iter_rows(0.0)})
        out = {}
        for name in names:
            if "scrape" in name:
                continue  # the scrape's own duration: a clock reading
            out[name] = sorted((str(k), v[2]) for k, v in st.latest(name, None, 60.0, now).items())
            hw = st.hist_window(name, {"target": "serve-a"}, 60.0, now)
            if hw is not None:
                out[name + "/hist"] = hw.to_dict()
        return out

    for tag in ("j", "t"):
        assert series(roots[tag], TStore) == series(roots[tag], JStore)
    assert series(roots["t"], TStore) == series(roots["j"], JStore)
    ups = dict(series(roots["t"], TStore)["estorch_up"])
    assert len(ups) == 2 and sorted(ups.values()) == [0.0, 1.0]


# =====================================================================
# rules
# =====================================================================

RULES = [
    {"name": "down", "kind": "absence", "metric": "estorch_up", "for_s": 0, "window_s": 5},
    {"name": "deep", "kind": "threshold", "metric": "estorch_queue_depth", "op": ">=",
     "value": 3, "for_s": 2, "window_s": 10},
    {"name": "p99-slo", "kind": "burn_rate", "metric": "estorch_serve_request_s",
     "quantile": 0.99, "slo_s": 0.01, "windows": [{"window_s": 20}, {"window_s": 4}]},
]


def test_rules_engine_verdicts_equal(tmp_path):
    _, last = _fill(JStore, JHist, str(tmp_path / "store"))
    store = TStore(str(tmp_path / "store"))
    je = jrules.RulesEngine(RULES, ledger_path=str(tmp_path / "j_alerts.jsonl"))
    te = trules.RulesEngine(RULES, ledger_path=str(tmp_path / "t_alerts.jsonl"))
    targets = ["serve-a", "serve-b", "router", "gone"]
    seen = 0
    for now in np.arange(T0, last + 40.0, 1.5):
        got = te.evaluate(store, targets, float(now))
        assert got == je.evaluate(JStore(str(tmp_path / "store")), targets, float(now))
        seen += len(got)
        assert te.active() == je.active()
    assert seen > 3
    assert trules.read_ledger(str(tmp_path / "t_alerts.jsonl"), tail=500) == \
        jrules.read_ledger(str(tmp_path / "j_alerts.jsonl"), tail=500)


@pytest.mark.parametrize("doc", [
    {"schema": 1, "rules": [{"kind": "nope"}]},
    {"schema": 2, "rules": []},
    {"schema": 1, "rules": [{"name": "x", "kind": "burn_rate", "metric": "m", "slo_s": 0,
                             "windows": []}]},
    {"schema": 1, "rules": [{"name": "ok", "kind": "threshold", "metric": "m", "op": ">",
                             "value": 1}]},
    {"schema": 1, "rules": "all"},
    [],
])
def test_validation_messages_equal(doc):
    assert trules.validate_rules(doc) == jrules.validate_rules(doc)
    assert tcol.validate_targets(doc) == jcol.validate_targets(doc)
    assert taz.validate_capacity(doc) == jaz.validate_capacity(doc)


def test_samples_from_exposition_equal():
    h = JHist()
    for v in (0.001, 0.002, 0.02, 0.4):
        h.observe(v, exemplar=f"t{v}")
    from estorch_tpu.obs.export.prometheus import render_exposition

    text = render_exposition({"requests_total": 12.0}, up=True,
                             extra_gauges={"queue_depth": 3.0},
                             histograms={"serve/request_s": h.to_export()})
    assert tcol.samples_from_exposition(text, "a") == jcol.samples_from_exposition(text, "a")
    with pytest.raises(ValueError):
        tcol.samples_from_exposition("garbage {{{", "a")


# =====================================================================
# autoscale: decide over a seeded grid, replay of the other's log
# =====================================================================

def _grid(seed, n):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        pol = {**jaz.POLICY_DEFAULTS, "max_rps_at_slo": float(rng.choice([5.0, 10.0, 40.0])),
               "min_replicas": int(rng.integers(1, 3)), "max_replicas": int(rng.integers(3, 9)),
               "headroom": float(rng.choice([1.0, 1.3, 2.0])), "window_s": 10.0,
               "up_cooldown_s": float(rng.choice([0.0, 5.0])),
               "down_cooldown_s": float(rng.choice([0.0, 5.0, 30.0])),
               "low_watermark": float(rng.choice([0.3, 0.5, 0.7])),
               "low_hold_s": float(rng.choice([0.0, 4.0]))}
        ts = 1000.0 + float(rng.integers(0, 40))
        actual = int(rng.integers(1, 9))
        burn = ["p99-burn"] if rng.random() < 0.3 else []
        inp = {"ts": ts, "target": "t", "window_s": 10.0,
               "offered_rps": None if rng.random() < 0.1 else float(rng.uniform(0, 120)),
               "p99_ms": float(rng.uniform(1, 80)), "queue_depth": float(rng.integers(0, 6)),
               "actual_replicas": actual, "replicas_known": actual, "reported_desired": None,
               "alerts_active": list(burn), "burn_firing": list(burn)}
        st = {"desired": None if rng.random() < 0.3 else int(rng.integers(1, 9)),
              "last_up_ts": None if rng.random() < 0.5 else ts - float(rng.integers(0, 10)),
              "last_down_ts": None if rng.random() < 0.5 else ts - float(rng.integers(0, 40)),
              "low_since": None if rng.random() < 0.5 else ts - float(rng.integers(0, 10))}
        yield inp, pol, st


def test_decide_equal_over_a_seeded_grid():
    actions = set()
    for inp, pol, st in _grid(0, 400):
        tv = taz.decide(dict(inp), dict(pol), dict(st))
        jv = jaz.decide(dict(inp), dict(pol), dict(st))
        assert json.dumps(tv, sort_keys=True) == json.dumps(jv, sort_keys=True), (inp, pol, st)
        actions.add(tv[0]["action"])
    assert actions == {"up", "down", "hold"}


def _cap(tmp_path, max_rps=10.0):
    path = tmp_path / "capacity.json"
    path.write_text(json.dumps({"schema": 1, "kind": "capacity", "created_ts": 0.0,
                                "slo_ms": 50.0, "quantile": "p99",
                                "max_rps_at_slo": float(max_rps), "saturated": False,
                                "rungs": [{}]}))
    return str(path)


def _decision_log(mod, store_cls, tmp_path, name):
    root = str(tmp_path / name)
    store = store_cls(root)
    az = mod.Autoscaler(root, capacity=_cap(tmp_path), actuate=lambda n, r: {"ok": True},
                        policy={"window_s": 10.0, "min_replicas": 1, "up_cooldown_s": 4.0,
                                "down_cooldown_s": 6.0, "low_hold_s": 4.0})
    rng = np.random.default_rng(3)
    total, reps = 0.0, 2
    for k in range(30):
        ts = 1000.0 + 2.0 * k
        total += float(rng.integers(0, 400) if k < 15 else rng.integers(0, 10))
        rows = [{"name": "estorch_router_requests_total", "labels": {"target": "t"},
                 "value": total}]
        rows += [{"name": "estorch_router_replica_up",
                  "labels": {"target": "t", "replica": f"r{i}"}, "value": 1.0}
                 for i in range(reps)]
        store.append(rows, ts=ts)
        ev = az.tick(now=ts)
        if ev and ev["verdict"]["action"] != "hold":
            reps = ev["verdict"]["desired"]
    return az.log_path


def test_replay_of_the_other_packages_log_is_bit_exact(tmp_path):
    jlog = _decision_log(jaz, JStore, tmp_path, "j")
    tlog = _decision_log(taz, TStore, tmp_path, "t")
    jrows = jaz.read_decisions(jlog)
    assert len(jrows) == 30 and {r["verdict"]["action"] for r in jrows} >= {"up", "down"}
    rep = taz.replay(jlog)
    assert rep["ok"] and rep["decisions"] == 30, rep
    assert rep == jaz.replay(jlog)
    assert jaz.replay(tlog) == taz.replay(tlog)
    # the two controllers made the same decisions from the same store
    strip = lambda rows: [{k: v for k, v in r.items() if k != "actuation"} for r in rows]  # noqa: E731
    assert strip(taz.read_decisions(tlog)) == strip(jrows)
    # a tampered verdict is named by both
    rows = [json.loads(ln) for ln in open(jlog)]
    rows[4]["verdict"]["desired"] = 99
    bad = tmp_path / "tampered.jsonl"
    bad.write_text("".join(json.dumps(r) + "\n" for r in rows))
    assert taz.replay(str(bad)) == jaz.replay(str(bad))
    assert not taz.replay(str(bad))["ok"]


@pytest.mark.parametrize("fleet", [
    {"bundle_sha": "cafe" * 16, "platform": "gpu"},
    {"bundle_sha": "beef" * 16, "platform": "gpu"},
    {"bundle_sha": "cafe" * 16, "platform": "cpu"},
    {},
])
def test_capacity_mismatch_equal(fleet):
    cap = taz._mk_capacity(bundle_sha="cafe" * 16, platform="gpu")
    assert taz.capacity_mismatch(cap, fleet) == jaz.capacity_mismatch(cap, fleet)


# =====================================================================
# distributed traces
# =====================================================================

def _segments(seed):
    """A seeded set of router → replica traces (retries, hedges, orphans)."""
    rng = np.random.default_rng(seed)
    segs = []
    for i in range(30):
        tid, t = f"t{i:03d}", T0 + float(rng.uniform(0, 60))
        route = float(rng.uniform(0.002, 0.09))
        segs.append(ttraces._synth_segment(tid, f"router.{i}", None, "router", "route", t,
                                           route, status=200, replica="r0", attempts=1,
                                           sampled=str(rng.choice(["head", "tail", "hedge"]))))
        for leg in range(1 + int(rng.integers(0, 2))):
            rep = f"server-{leg}"
            span = f"router.{i}.{leg}"
            segs.append(ttraces._synth_segment(tid, span, f"router.{i}", "router", "upstream",
                                               t + 0.001 * (leg + 1), route * 0.8,
                                               replica=f"r{leg}", attempt=leg, hedge=leg > 0,
                                               cancelled=leg > 0, status=200))
            segs.append(ttraces._synth_segment(tid, f"{rep}.{i}", span, rep, "request",
                                               t + 0.002 * (leg + 1), route * 0.6, status=200))
            segs.append(ttraces._synth_segment(tid, f"{rep}.{i}.c", f"{rep}.{i}", rep,
                                               "compute", t + 0.003, route * 0.3, bucket=64,
                                               n=int(rng.integers(1, 64))))
        if rng.random() < 0.2:
            segs.append(ttraces._synth_segment(f"orphan{i}", f"server-0.o{i}", None,
                                               "server-0", "request", t, 0.001, status=200))
    return segs


def _normalize_export(trace):
    trace = json.loads(json.dumps(trace))
    trace["otherData"].pop("exporter")
    return trace


def test_assemble_and_export_equal_on_the_same_segments():
    segs = _segments(0)
    ta, ja = ttraces.assemble(json.loads(json.dumps(segs))), jtraces.assemble(segs)
    assert ta == ja and len(ta) >= 30
    ordered = sorted(ta.values(), key=lambda t: t["t0"])
    te = ttraces.export_fleet_trace(ordered, files=3)
    je = jtraces.export_fleet_trace(sorted(ja.values(), key=lambda t: t["t0"]), files=3)
    assert te["otherData"]["exporter"] == "estorch_tpu_torch.obs trace --fleet"
    assert _normalize_export(te) == _normalize_export(je)
    assert any(e["ph"] == "s" for e in te["traceEvents"])
    for t in ordered[:5]:
        assert ttraces.format_trace(t) == jtraces.format_trace(t)
        assert ttraces.cross_process_edges(t) == jtraces.cross_process_edges(t)


def test_slowest_traces_equal_from_one_store(tmp_path):
    root = str(tmp_path / "store")
    _fill(JStore, JHist, root)
    segs = _segments(1)
    # segments for the slow exemplar ids the store's histograms name
    ids = ttraces.slowest_traces(root, quantile=0.5, window_s=1e6, limit=50)["missing"]
    assert ids
    for i, tid in enumerate(ids[:10]):
        segs.append(ttraces._synth_segment(tid, f"router.x{i}", None, "router", "route",
                                           T0 + i, 0.5, status=200, replica="r1", attempts=1,
                                           sampled="tail"))
    jcol.append_segments(jcol.trace_file_path(root, "router"), segs)
    for q in (0.5, 0.9, 0.99):
        got = ttraces.slowest_traces(root, quantile=q, window_s=1e6, limit=5)
        assert got == jtraces.slowest_traces(root, quantile=q, window_s=1e6, limit=5)
    assert got["traces"] and got["metric"]


# =====================================================================
# dash
# =====================================================================

def test_dash_snapshot_and_render_equal(tmp_path):
    root = str(tmp_path / "store")
    _, now = _fill(JStore, JHist, root)
    jrules.append_ledger(os.path.join(root, "alerts.jsonl"), [
        {"ts": now - 4, "event": "firing", "rule": "replica-down", "target": "serve-b",
         "detail": "estorch_up=0 on target 'serve-b'"}])
    for window in (10.0, 60.0):
        ts = tdash.fleet_snapshot(root, window_s=window, now=now)
        assert ts == jdash.fleet_snapshot(root, window_s=window, now=now)
        text = tdash.render(root, window_s=window, now=now)
        assert text == jdash.render(root, window_s=window, now=now)
    assert "serve-a" in text and "replica-down" in text


# =====================================================================
# obs summarize: the serving section
# =====================================================================

@pytest.mark.parametrize("counters", [
    {"requests_total": 640, "batches_total": 40, "batched_requests_total": 640,
     "shed_total": 3, "recompiles": 5},
    {"requests_total": 9, "batches_total": 0, "batched_requests_total": 0, "shed_total": 0,
     "recompiles": 0, "batch_errors_total": 2, "reloads_total": 1},
    {"requests_total": 0, "generations_rejected": 2},
    {},
    None,
])
def test_serving_block_equal(counters, tmp_path):
    assert tsum._serving_block(counters) == jsum._serving_block(counters)
    if counters is None:
        return
    import time

    hb = tmp_path / "heartbeat.json"
    for phase in ("serving", "drained"):
        hb.write_text(json.dumps({"ts": time.time(), "pid": 2, "phase": phase,
                                  "generation": 0, "counters": counters}))
        t, j = tsum.summarize([], heartbeat_path=str(hb)), jsum.summarize([], heartbeat_path=str(hb))
        t["heartbeat"].pop("age_s"), j["heartbeat"].pop("age_s")
        assert t == j
        assert tsum.format_summary(t) == jsum.format_summary(j)


def test_serving_section_from_a_manifest_equal(tmp_path):
    mf = tmp_path / "manifest.json"
    mf.write_text(json.dumps({"resilience": {"restart_count": 0, "completed": True,
                                             "counters": {"requests_total": 100,
                                                          "batches_total": 10,
                                                          "batched_requests_total": 100,
                                                          "shed_total": 0, "recompiles": 0}}}))
    rec = dict(tsum.GOLDEN_RECORD)
    recs = [dict(rec, generation=g) for g in range(3)]
    t = tsum.summarize(recs, manifest_path=str(mf))
    j = jsum.summarize(recs, manifest_path=str(mf))
    assert t["serving"] == j["serving"] and "serving: 100 requests" in t["diagnosis"]
    assert "serving" in tsum.format_summary(t)


# =====================================================================
# selfchecks and file-run forms
# =====================================================================

def test_every_selfcheck_passes():
    assert tcol.selfcheck() == []
    assert ttraces.selfcheck() == []
    assert taz.selfcheck() == 0
    assert tsum.selfcheck() == []


@pytest.mark.parametrize("argv", [["collect", "--selfcheck"], ["autoscale", "--selfcheck"],
                                  ["trace", "--selfcheck"], ["summarize", "--selfcheck"]])
def test_cli_selfchecks(argv):
    r = subprocess.run([sys.executable, "-m", "estorch_tpu_torch.obs", *argv], cwd=REPO,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-1000:] + r.stderr[-2000:]


@pytest.mark.parametrize("name", ["collector", "autoscale", "dash", "traces", "store", "rules"])
def test_file_run_loads_no_torch_and_no_package(name):
    path = os.path.join(REPO, "estorch_tpu_torch", "obs", "agg", f"{name}.py")
    probe = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('m', {path!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'estorch_tpu', 'estorch_tpu_torch'))\n"
        "assert not bad, bad\n"
        "print('FILE_RUN_OK')\n")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "FILE_RUN_OK" in r.stdout, r.stderr[-2000:]


def test_collector_file_run_scrapes_a_run_dir(tmp_path):
    """``python estorch_tpu_torch/obs/agg/collector.py`` (no package, no
    torch) over a heartbeat run dir and a dead url: the live target up,
    the dead one down, an absence alert on the dead one only."""
    import time

    run = tmp_path / "run"
    run.mkdir()
    (run / "heartbeat.json").write_text(json.dumps(
        {"ts": time.time(), "pid": 1, "phase": "eval", "generation": 3,
         "counters": {"env_steps": 100}}))
    targets = tmp_path / "targets.json"
    targets.write_text(json.dumps({"schema": 1, "targets": [
        {"name": "run", "run_dir": str(run)},
        {"name": "dead", "url": "http://127.0.0.1:1/metrics", "timeout_s": 0.5}]}))
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps({"schema": 1, "rules": [
        {"name": "down", "kind": "absence", "metric": "estorch_up", "for_s": 0,
         "window_s": 30}]}))
    store = tmp_path / "store"
    r = subprocess.run([sys.executable, os.path.join(REPO, "estorch_tpu_torch", "obs", "agg",
                                                     "collector.py"),
                        "--targets", str(targets), "--store", str(store), "--rules", str(rules),
                        "--ticks", "3", "--interval", "0.2", "--port", "0"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    snap = tdash.fleet_snapshot(str(store), window_s=60.0)
    rows = {row["target"]: row for row in snap["targets"]}
    assert rows["run"]["up"] and not rows["dead"]["up"]
    fired = [t for t in trules.read_ledger(str(store / "alerts.jsonl")) if t["event"] == "firing"]
    assert {t["target"] for t in fired} == {"dead"}
