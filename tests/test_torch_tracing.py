"""The port's ``obs/tracing.py`` against the JAX package's.

``estorch_tpu_torch/obs/tracing.py`` is a copy of ``estorch_tpu/obs/
tracing.py`` (stdlib only), which the port's server and batcher import.
Both are driven here by the same seeded scripts — segments with explicit
wall times, trace ends with random outcome flags and durations, late
segments after a verdict, flushes to a capped ``traces.jsonl``, scrape
cursors, payloads with histogram exemplars (each package's own
``Histograms`` and ``Counters``) — and must give the same transcript,
exactly.  The sampler's rules and the file IO are also held on the port's
module alone, as the JAX package's tests hold them.
"""

import json
import os
import random

import pytest

from estorch_tpu.obs import counters as jcounters
from estorch_tpu.obs import hist as jhist
from estorch_tpu.obs import tracing as jtracing
from estorch_tpu_torch.obs import counters as tcounters
from estorch_tpu_torch.obs import hist as thist
from estorch_tpu_torch.obs import tracing as ttracing

PACKAGES = {"jax": (jtracing, jhist, jcounters), "port": (ttracing, thist, tcounters)}
FLAGS = ("error", "shed", "retried", "hedged", "breaker", "forced")


def transcript(pkg: str, seed: int, tmp_path) -> list:
    """One seeded script on one package's tracer: everything observable,
    in order."""
    tracing, hist, counters = PACKAGES[pkg]
    rng = random.Random(seed)
    hists = hist.Histograms()
    ctr = counters.Counters()
    path = str(tmp_path / pkg / f"s{seed}" / tracing.TRACES_FILENAME)
    tr = tracing.ProcessTracer(
        "server-1", counters=ctr, hists=hists, hist_name="serve/request_s",
        head_every=rng.choice([1, 4, 16]), p99_min_count=rng.choice([8, 64]),
        path=path, max_pending=rng.choice([4, 512]), max_file_lines=rng.choice([7, 20000]),
        flush_every=rng.choice([3, 64]))
    out = []
    open_traces: list[str] = []
    for step in range(120):
        op = rng.random()
        if op < 0.45 or not open_traces:
            tid = f"r{rng.randrange(10 ** 6)}"
            root = tr.span_id()
            open_traces.append(tid)
            tr.add(tracing.make_segment(tid, root, None, tr.proc, "request",
                                        rng.random(), rng.expovariate(50.0),
                                        attrs={"status": 200}, ts=1.7e9 + step))
            for name in rng.sample(["queue_wait", "coalesce", "compute", "write"], 2):
                tr.add(tracing.make_segment(tid, tr.span_id(), root, tr.proc, name,
                                            rng.random(), rng.expovariate(200.0),
                                            ts=1.7e9 + step + 0.5))
        elif op < 0.8:
            tid = open_traces.pop(rng.randrange(len(open_traces)))
            dur = rng.expovariate(50.0)
            hists.observe("serve/request_s", dur, exemplar=tid)
            flags = {f: rng.random() < 0.08 for f in FLAGS}
            out.append(("finish", tid, tr.finish(tid, dur, **flags)))
            if rng.random() < 0.2:  # a late segment follows the verdict
                tr.add(tracing.make_segment(tid, tr.span_id(), None, tr.proc, "late",
                                            0.0, 0.001, ts=1.7e9 + step))
        elif op < 0.88:
            tr.record(tracing.make_segment(f"b{step}", tr.span_id(), None, tr.proc, "batch",
                                           0.0, 0.002, attrs={"n": 3}, ts=1.7e9 + step))
        elif op < 0.94:
            out.append(("flush", tr.flush()))
        else:
            cursor = rng.randrange(0, 40)
            out.append(("since", cursor, tr.since(cursor)))
    out.append(("flush", tr.flush()))
    out.append(("file", tracing.read_segments(path)))
    out.append(("payload", tracing.traces_payload(tr, 5, hists=hists)))
    out.append(("counters", {k: ctr.get(k) for k in ("traces_sampled", "traces_dropped")}))
    out.append(("verdicts", [tr.sampler.verdict(f"v{i}", d)
                             for i, d in enumerate((0.0001, 0.01, 0.05, 1.0))]))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_tracer_transcript_equals_jax(seed, tmp_path):
    assert transcript("port", seed, tmp_path) == transcript("jax", seed, tmp_path)


def test_pure_functions_equal_jax():
    rng = random.Random(7)
    ids = [f"t{rng.randrange(10 ** 9)}" for _ in range(200)]
    for n in (1, 2, 7, 16):
        assert ([ttracing.head_sampled(t, n) for t in ids]
                == [jtracing.head_sampled(t, n) for t in ids])
    good = ttracing.make_segment("t", "s", "p0", "proc", "n", 0.5, 0.1, {"a": 1}, ts=3.0)
    assert good == jtracing.make_segment("t", "s", "p0", "proc", "n", 0.5, 0.1, {"a": 1}, ts=3.0)
    rows = [good, "nope", {**good, "trace_id": ""}, {**good, "dur_s": "fast"},
            {**good, "ts": True}, {**good, "name": None}]
    assert ([ttracing.valid_segment(r) for r in rows]
            == [jtracing.valid_segment(r) for r in rows] == [True] + [False] * 5)
    assert ttracing.traces_payload(None, 7) == jtracing.traces_payload(None, 7)
    for name in ("TRACING_SCHEMA", "TRACE_HEADER", "PARENT_SPAN_HEADER", "SAMPLED_HEADER",
                 "TRACES_FILENAME", "DEFAULT_HEAD_EVERY", "DEFAULT_P99_MIN_COUNT"):
        assert getattr(ttracing, name) == getattr(jtracing, name), name


def test_sampler_precedence_and_p99_rule():
    s = ttracing.TraceSampler(head_every=10 ** 9)
    for flag, reason in (("error", "error"), ("shed", "shed"), ("retried", "retry"),
                         ("hedged", "hedge"), ("breaker", "breaker"), ("forced", "forced")):
        assert s.verdict("t", 0.01, **{flag: True}) == reason
    assert s.verdict("t", 0.01, forced=True, error=True) == "forced"
    hists = thist.Histograms()
    s = ttracing.TraceSampler(hists=hists, hist_name="serve/request_s", head_every=10 ** 9,
                              p99_min_count=100)
    for _ in range(50):
        hists.observe("serve/request_s", 0.010)
    assert s.verdict("zz-no-head", 0.500) is None  # disarmed below min_count
    for _ in range(100):
        hists.observe("serve/request_s", 0.010)
    assert s.verdict("zz-no-head", 0.500) == "p99"
    assert s.verdict("zz-no-head", 0.001) is None


def test_flush_caps_the_file_and_reads_tolerate_a_torn_tail(tmp_path):
    path = str(tmp_path / "run" / ttracing.TRACES_FILENAME)
    tr = ttracing.ProcessTracer("server", head_every=1, path=path, max_file_lines=5)
    for i in range(8):
        tr.add(ttracing.make_segment(f"t{i}", tr.span_id(), None, "server", "request",
                                     0.0, 0.01))
        tr.finish(f"t{i}", 0.01)
        assert tr.flush() == 1
    assert tr.flush() == 0
    assert not os.path.exists(path + ".tmp")
    rows = ttracing.read_segments(path)
    assert len(rows) == 5 and rows[-1]["trace_id"] == "t7"
    with open(path, "a") as f:
        f.write('not json\n{"trace_id": "torn", "sp')
    assert [r["trace_id"] for r in ttracing.read_segments(path)] == [
        r["trace_id"] for r in rows]
    assert ttracing.read_segments(str(tmp_path / "absent.jsonl")) == []
    json.dumps(rows)  # the rows are plain JSON
