"""Elastic multi-host ES in the port (``parallel/elastic.py``, the
``ElasticScheduler`` of ``algo/scheduler.py``) against ``tests/
test_elastic.py``'s claims and against the JAX package.

The hosts are threads of this process (``run_host_thread``): their own ES
instances joined through a real loopback socket.  The six cases of the JAX
package's file, on the port (the spec adds ``"device": "cpu"``), then the
two packages against each other: each reads the other's frames, and each
replays the other's elastic event log to its parameters within
``CROSS_RTOL``, the fold's tolerance (``tests/test_torch_scheduler.py``),
with the other run's table, initial center and per-dispatch offsets handed
over (the two packages draw different noise streams).
"""

from __future__ import annotations

import json
import os
import socket
import time

import numpy as np
import pytest
import torch

from estorch_tpu_torch import interop
from estorch_tpu_torch.algo import scheduler as tsched
from estorch_tpu_torch.algo.scheduler import AsyncEventLog
from estorch_tpu_torch.parallel.elastic import (ElasticCoordinator, es_from_spec, recv_msg,
                                                run_host_thread, send_msg)
from estorch_tpu_torch.resilience import chaos as tchaos

SPEC = {"population_size": 16, "horizon": 64, "seed": 7, "device": "cpu"}
# the JAX package's documented IW tolerance (tests/test_elastic.py): an
# elastic run is the synchronous estimator with reweighted stale samples
IW_REL_L2_TOL = 0.10
# a replay of the other package's log: the largest difference over the
# largest parameter after the run's Adam steps (the JAX package folds with
# float32 statistics through its engine's programs, the port with float64
# statistics and one reduction; tests/test_torch_scheduler.py's bound)
CROSS_RTOL = 1e-6


@pytest.fixture
def chaos_env():
    from estorch_tpu.resilience import chaos as jchaos

    def set_plan(events):
        os.environ[tchaos.CHAOS_ENV] = tchaos.ChaosPlan(events).to_json()
        tchaos.reset_cache()
        jchaos.reset_cache()

    yield set_plan
    os.environ.pop(tchaos.CHAOS_ENV, None)
    tchaos.reset_cache()
    jchaos.reset_cache()


def run_fleet(es, n, hosts=2, log_fn=None, spec=SPEC, mod=None):
    """One elastic run over ``hosts`` host threads of ``mod`` (the port's
    ``parallel/elastic.py`` by default); returns the workers, the
    coordinator closed."""
    import estorch_tpu_torch.parallel.elastic as port_elastic

    mod = port_elastic if mod is None else mod
    coord = mod.ElasticCoordinator(join_grace_s=60.0)
    workers = [mod.run_host_thread(coord.address, mod.es_from_spec(spec), i)[0]
               for i in range(hosts)]
    try:
        es.train_elastic(n, fleet=coord, verbose=False, log_fn=log_fn)
    finally:
        coord.close()
        for w in workers:
            w.stop()
    return workers


def params_bytes(es) -> bytes:
    return es.state.params_flat.cpu().numpy().tobytes()


def closed_accounting(es) -> None:
    log = es.async_event_log
    n = es.population_size
    assert len(log.dispatches) * n == (sum(len(u["consumed"]) for u in log.updates)
                                       + len(log.discarded) + len(log.lost))


# ------------------------------------------------ tests/test_elastic.py


def test_two_host_elastic_within_documented_iw_tolerance():
    ref = es_from_spec(SPEC)
    ref.train(8, verbose=False)
    want = ref.state.params_flat.numpy().astype(np.float64)
    es = es_from_spec(SPEC)
    run_fleet(es, 8)
    got = es.state.params_flat.numpy().astype(np.float64)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel < IW_REL_L2_TOL, rel
    assert len(es.history) == 8
    assert all(np.isfinite(r["reward_mean"]) for r in es.history)
    counters = es.obs.counters.snapshot()
    assert counters.get("results_folded", 0) > 0
    assert counters.get("hosts_joined") == 2
    closed_accounting(es)


def test_live_replay_bit_identical(chaos_env):
    chaos_env(tchaos.ChaosPlan.generate(
        seed=0, n_generations=40, straggle_host_every=1, straggle_host=1,
        straggle_host_sleep_s=0.15, straggle_host_jitter_s=0.05).events)
    es = es_from_spec(SPEC)
    run_fleet(es, 6)
    log = es.async_event_log
    assert es.obs.counters.snapshot().get("results_folded", 0) > 0
    os.environ.pop(tchaos.CHAOS_ENV, None)
    tchaos.reset_cache()
    es2 = es_from_spec(SPEC)
    es2.train_elastic(6, replay=log, verbose=False)
    assert params_bytes(es2) == params_bytes(es)
    es3 = es_from_spec(SPEC)
    es3.train_elastic(6, replay=es2.async_event_log, verbose=False)
    assert params_bytes(es3) == params_bytes(es)
    with pytest.raises(ValueError, match="RECORDED schedule"):
        es_from_spec(SPEC).train_elastic(7, replay=log, verbose=False)


def test_host_join_mid_run_continues_dispatch_stream(chaos_env):
    chaos_env([{"kind": "straggle_host", "gen": g, "host": "all", "sleep_s": 0.05}
               for g in range(64)])
    late_es = es_from_spec(SPEC)
    es = es_from_spec(SPEC)
    coord = ElasticCoordinator(join_grace_s=60.0)
    w0 = run_host_thread(coord.address, es_from_spec(SPEC), 0)[0]
    late: list = []

    def join_late(rec):
        if rec["generation"] >= 3 and not late:
            late.append(run_host_thread(coord.address, late_es, 1)[0])

    try:
        es.train_elastic(14, fleet=coord, verbose=False, log_fn=join_late)
    finally:
        coord.close()
        w0.stop()
        for w in late:
            w.stop()
    log = es.async_event_log
    ids = [d[0] for d in log.dispatches]
    assert len(ids) == len(set(ids)), "dispatch id reused"
    assert ids == sorted(ids)
    joins = [m for m in log.membership if m["event"] == "join"]
    assert [m["host"] for m in joins] == [0, 1]
    assert joins[1]["at_dispatch"] > joins[0]["at_dispatch"], "the second join was not mid-run"
    assert late and late[0].dispatches_done > 0, "the late host never contributed"


def test_host_kill_loses_throughput_not_the_run(chaos_env):
    # every host pays a declared stall a dispatch, so throughput is host-bound:
    # 0.15 s (the JAX package's test: 0.06 s), since the port's host threads
    # run their rollouts' small torch ops under one GIL, which two JAX hosts'
    # single compiled calls do not share
    events = [{"kind": "straggle_host", "gen": g, "host": "all", "sleep_s": 0.15}
              for g in range(64)]
    # host 1 dies at whichever of dispatches 8..13 it takes first
    events += [{"kind": "kill_host", "gen": g, "host": 1} for g in range(8, 14)]
    chaos_env(events)
    es = es_from_spec(SPEC)
    walls: list[float] = []
    last = [None]

    def clock(rec):
        now = time.perf_counter()
        if last[0] is not None:
            walls.append(now - last[0])
        last[0] = now

    run_fleet(es, 16, log_fn=clock)
    log = es.async_event_log
    counters = es.obs.counters.snapshot()
    assert len(log.updates) == 16
    leaves = [m for m in log.membership if m["event"] == "leave"]
    assert len(leaves) == 1 and leaves[0]["host"] == 1
    assert counters.get("hosts_lost") == 1
    assert len(log.lost) > 0
    assert counters.get("results_lost", 0) == len(log.lost)
    closed_accounting(es)
    head = sum(walls[2:6]) / 4
    tail = sum(walls[-4:]) / 4
    assert tail > 1.35 * head, (head, tail, walls)
    os.environ.pop(tchaos.CHAOS_ENV, None)
    tchaos.reset_cache()
    es2 = es_from_spec(SPEC)
    es2.train_elastic(16, replay=log, verbose=False)
    assert params_bytes(es2) == params_bytes(es)


def test_membership_event_log_round_trip():
    log = AsyncEventLog()
    log.dispatches.append((0, 0))
    log.membership.append({"event": "join", "host": 0, "at_dispatch": 0})
    log.membership.append({"event": "leave", "host": 0, "at_dispatch": 3})
    d = log.to_dict()
    back = AsyncEventLog.from_dict(d)
    assert back.membership == log.membership
    assert back.to_dict() == d
    assert "membership" not in AsyncEventLog().to_dict()
    assert AsyncEventLog.from_dict({"schema": 1, "dispatches": [], "updates": [],
                                    "discarded": [], "lost": []}).membership == []


def _socketpair():
    a, b = socket.socketpair()
    a.settimeout(0.05)
    b.settimeout(0.05)
    return a, b


def test_wire_protocol_round_trip():
    a, b = _socketpair()
    try:
        arr = np.arange(5, dtype=np.float32)
        send_msg(a, {"t": "result", "dispatch": 3}, {"fitness": arr})
        header, arrays = recv_msg(b, 1.0)
        assert header["t"] == "result" and header["dispatch"] == 3
        np.testing.assert_array_equal(arrays["fitness"], arr)
        assert arrays["fitness"].dtype == np.float32
        assert recv_msg(b, 0.05) is None
    finally:
        a.close()
        b.close()


# ------------------------------------------------- the two packages


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_frames_cross_packages(direction):
    """A frame written by one package's ``send_msg`` is read by the
    other's ``recv_msg``, and the bytes on the wire are the same."""
    from estorch_tpu.parallel import elastic as jelastic

    send = send_msg if direction == "port_to_jax" else jelastic.send_msg
    recv = jelastic.recv_msg if direction == "port_to_jax" else recv_msg
    header = {"t": "center", "version": 4, "sigma": 0.05}
    arrays = {"center": np.linspace(-1, 1, 7, dtype=np.float32),
              "stats": np.arange(6, dtype=np.float64).reshape(2, 3)}
    a, b = _socketpair()
    try:
        send(a, header, arrays)
        got_h, got_a = recv(b, 1.0)
        assert got_h == header
        for k, v in arrays.items():
            assert got_a[k].dtype == v.dtype and got_a[k].tobytes() == v.tobytes()
        send_msg(a, header, arrays)
        port_bytes = b.recv(1 << 16)
        jelastic.send_msg(a, header, arrays)
        assert b.recv(1 << 16) == port_bytes
    finally:
        a.close()
        b.close()


def _jax_spec():
    return {k: v for k, v in SPEC.items() if k != "device"}


def _port_es_on_jax_draws(jes, monkeypatch):
    """A port ES (the coordinator's) holding the JAX ES's table and
    initial center, its scheduler drawing JAX's offsets for each dispatch:
    the other package's fold math on the same numbers."""
    import jax.numpy as jnp

    key = jes.state.key

    def jax_offsets(self, st, dispatch):
        jst = jes.state._replace(key=key, generation=jnp.asarray(int(dispatch), jnp.int32))
        return np.asarray(jes.engine.all_pair_offsets(jst))

    monkeypatch.setattr(tsched.ElasticScheduler, "_offsets_for", jax_offsets)
    tes = es_from_spec(SPEC)
    tes.engine.table = tes.table = interop.table_from_numpy(np.asarray(jes.table.data))
    tes.state = tes.engine.init_state(torch.from_numpy(np.array(jes.state.params_flat)),
                                      seed=7)
    return tes


def _assert_cross(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= CROSS_RTOL, rel


STRAGGLE_1 = [{"kind": "straggle_host", "gen": g, "host": 1, "sleep_s": 0.1} for g in range(40)]


def test_port_replays_jax_elastic_log(chaos_env, monkeypatch):
    """A JAX elastic run (its coordinator, 2 host threads, host 1
    straggling) replayed by the port on JAX's draws: JAX's params within
    CROSS_RTOL, the same logged fitness."""
    from estorch_tpu.parallel import elastic as jelastic

    chaos_env(STRAGGLE_1)
    jes = jelastic.es_from_spec(_jax_spec())
    tes = _port_es_on_jax_draws(jelastic.es_from_spec(_jax_spec()), monkeypatch)
    run_fleet(jes, 6, spec=_jax_spec(), mod=jelastic)
    log = json.loads(json.dumps(jes.async_event_log.to_dict()))
    assert sum(r["async"]["folded"] for r in jes.history) > 0
    tes.train_elastic(6, replay=log, verbose=False)
    _assert_cross(tes.state.params_flat.numpy(), jes.state.params_flat)
    assert [r["reward_mean"] for r in tes.history] == [r["reward_mean"] for r in jes.history]


def test_jax_replays_port_elastic_log(chaos_env, monkeypatch):
    """The reverse: a port elastic run whose coordinator holds JAX's draws
    (its hosts evaluate on the port's own: the fold's math is what
    crosses), replayed natively by the JAX package."""
    from estorch_tpu.parallel import elastic as jelastic

    chaos_env(STRAGGLE_1)
    tes = _port_es_on_jax_draws(jelastic.es_from_spec(_jax_spec()), monkeypatch)
    run_fleet(tes, 6)
    log = json.loads(json.dumps(tes.async_event_log.to_dict()))
    assert sum(r["async"]["folded"] for r in tes.history) > 0
    jes = jelastic.es_from_spec(_jax_spec())
    jes.train_elastic(6, replay=log, verbose=False)
    _assert_cross(jes.state.params_flat, tes.state.params_flat.numpy())
    assert [r["reward_mean"] for r in jes.history] == [r["reward_mean"] for r in tes.history]


def test_coordinator_refuses_what_it_cannot_fold():
    with pytest.raises(ValueError, match="obs_norm"):
        from estorch_tpu_torch.algo.scheduler import ElasticScheduler

        es = es_from_spec(SPEC)
        es.config = es.config.__class__(**{**es.config.__dict__, "obs_norm": True})
        ElasticScheduler(es, fleet=None)
    with pytest.raises(ValueError, match="needs a fleet"):
        es_from_spec(SPEC).train_elastic(2)
