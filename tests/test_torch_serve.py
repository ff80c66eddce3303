"""The port's serving path (``estorch_tpu_torch/serve``) against the JAX
package's, and its own contracts, on the CPU.

Parity with JAX: the same numpy params (``interop.params_from_jax``), obs
stats (``interop.obs_stats_from_jax``) and observations go through JAX's
``ES.predict`` and the port's: float32 within 1e-6 relative (obs-norm off
and on, the GRU with its carry over 5 steps), bf16 within a stated bound
(and, with XLA's three-rounding bf16 sigmoid pinned in torch, within the
MLP's bound of three bf16 roundings), the bundle's ``arrays.npz`` equal key for key and value for
value to JAX's, and both manifests equal in every field but the runtime
facts, the time, the checksum and the package in the import path.

The port's own contracts, ported from ``tests/test_serve.py`` and run on
``device="cpu"``: bit-exactness from ``ES.predict`` through a bundle, a
fresh process, the batcher and HTTP; the six rejections; the bucket
ladder, the batcher, bucket verification and the quantized batcher; the
server's endpoints, reload and trace ids; the CLI's SIGTERM drain.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from estorch_tpu import ES as JES
from estorch_tpu import JaxAgent
from estorch_tpu import MLPPolicy as JMLPPolicy
from estorch_tpu import RecurrentPolicy as JRecurrentPolicy
from estorch_tpu.envs.pendulum import Pendulum as JPendulum
from estorch_tpu.parallel import population_mesh
from estorch_tpu.serve import load_bundle as jload_bundle
from estorch_tpu_torch import (ES, DeviceAgent, MLPPolicy, Pendulum, RecurrentPolicy, adam,
                               interop)
from estorch_tpu_torch.obs.spans import Telemetry
from estorch_tpu_torch.serve import (BatcherClosed, BatcherSaturated, BundleError,
                                     DynamicBatcher, ServeClient, ServeError, bucket_sizes,
                                     load_bundle, validate_bundle)
from estorch_tpu_torch.serve.batcher import measure_quant_divergence, verify_stable_buckets
from estorch_tpu_torch.serve.bundle import ARRAYS_NAME, MANIFEST_NAME

REPO = Path(__file__).resolve().parents[1]
SMALL_PK = {"action_dim": 1, "hidden": (24, 24), "discrete": False, "action_scale": 2.0}
GRU_PK = {"action_dim": 1, "hidden": (8,), "gru_size": 8, "discrete": False}
# the discrete GRU of the bf16 sigmoid case: logits, no output tanh
GRU_DISCRETE_PK = {"action_dim": 3, "hidden": (8,), "gru_size": 8, "discrete": True}


def _obs(seed: int, *shape: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape or (3,)).astype(np.float32)


def _port_es(policy=MLPPolicy, policy_kwargs=SMALL_PK, **over):
    kw = dict(population_size=8, sigma=0.05, policy_kwargs=dict(policy_kwargs),
              optimizer_kwargs={"learning_rate": 1e-2}, seed=0, table_size=1 << 14,
              device="cpu", telemetry=False)
    kw.update(over)
    return ES(policy, DeviceAgent(Pendulum(), horizon=20), adam, **kw)


@pytest.fixture(scope="module")
def small_es():
    es = _port_es(obs_norm=True)
    es.train(1, verbose=False)
    return es


@pytest.fixture(scope="module")
def small_bundle(small_es, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bundles") / "pendulum")
    small_es.export_bundle(path, version="test-v1")
    return path


# =====================================================================
# parity with the JAX package
# =====================================================================

def _jax_es(policy=JMLPPolicy, policy_kwargs=SMALL_PK, **over):
    kw = dict(population_size=8, sigma=0.05, policy_kwargs=dict(policy_kwargs),
              optimizer_kwargs={"learning_rate": 1e-2}, seed=0, table_size=1 << 14,
              telemetry=False, mesh=population_mesh(jax.devices()[:1]))
    kw.update(over)
    return JES(policy, JaxAgent(JPendulum(), horizon=20), optax.adam, **kw)


def _random_obs_stats(seed: int, dim: int = 3):
    """A Welford triple of a realistic spread: count, mean, m2."""
    rng = np.random.default_rng(seed)
    count = np.float32(250.0)
    mean = rng.standard_normal(dim).astype(np.float32)
    m2 = (count * rng.uniform(0.2, 3.0, dim)).astype(np.float32)
    return count, mean, m2


def _pair(jpolicy, tpolicy, policy_kwargs, obs_norm=False, seed=0, **over):
    """A JAX ES and a port ES holding the JAX side's params (and, with
    obs-norm, the same random obs stats on both sides)."""
    jes = _jax_es(jpolicy, policy_kwargs, obs_norm=obs_norm, **over)
    tes = _port_es(tpolicy, policy_kwargs, obs_norm=obs_norm, **over)
    flat, _ = interop.params_from_jax(np.asarray(jes.state.params_flat), tes.spec)
    stats = None
    if obs_norm:
        triple = _random_obs_stats(seed)
        jes.state = jes.state._replace(obs_stats=tuple(jnp.asarray(x) for x in triple))
        stats = interop.obs_stats_from_jax(triple)
    tes.state = tes.state._replace(params_flat=flat, obs_stats=stats)
    return jes, tes


def _rel_err(got, want, scale=None) -> float:
    """max |got - want| over ``scale`` (default: max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.max(np.abs(want)) if scale is None else scale
    return float(np.max(np.abs(got - want)) / max(scale, 1e-30))


@pytest.mark.parametrize("obs_norm", [False, True], ids=["plain", "obs_norm"])
def test_predict_matches_jax(obs_norm):
    """float32 ``ES.predict`` against JAX's on the same params and obs
    stats: one observation and a batch of 16, within 1e-6 relative (the
    same float32 products summed in another order)."""
    jes, tes = _pair(JMLPPolicy, MLPPolicy, SMALL_PK, obs_norm=obs_norm)
    for obs in (_obs(1), _obs(2, 16, 3)):
        want = np.asarray(jes.predict(obs))
        got = tes.predict(obs).numpy()
        assert got.shape == want.shape
        assert _rel_err(got, want) <= 1e-6


def test_recurrent_predict_matches_jax_over_five_steps():
    """The GRU's ``ES.predict`` threads its carry: 5 steps from the
    episode-start carry on both sides (each side threads its own), output
    and carry within 1e-6 of the step's scale (the largest |value| of its
    output and carry: the one-unit action can sit near 0, where its own
    magnitude is no scale for float32 rounding)."""
    jes, tes = _pair(JRecurrentPolicy, RecurrentPolicy, GRU_PK)
    jc = tc = None
    for t in range(5):
        obs = _obs(10 + t)
        jo, jc = jes.predict(obs, carry=jc)
        to, tc = tes.predict(obs, carry=tc)
        jo, jc_np = np.asarray(jo), np.asarray(jc)
        scale = max(np.abs(jo).max(), np.abs(jc_np).max())
        assert _rel_err(to.numpy(), jo, scale) <= 1e-6, t
        assert _rel_err(tc.numpy(), jc_np, scale) <= 1e-6, t


def _xla_bf16_sigmoid(torch_sigmoid):
    """XLA's CPU bf16 logistic: 1 / (1 + exp(-x)) with the exp, the add and
    the divide each rounded to bf16 (torch rounds σ once)."""
    def sigmoid(x):
        if x.dtype != torch.bfloat16:
            return torch_sigmoid(x)
        return 1.0 / (1.0 + torch.exp(-x))

    return sigmoid


# bf16 bounds, relative to the output's scale: the bf16 MLP rounds each
# product and activation once on both sides (one bf16 ulp, 2^-8 relative,
# per rounding, over 3 layers); the GRU's gates differ by a bf16 ulp where
# XLA rounds σ three times and torch once, and those differences pass
# through the cell and the head (0.016 on an AVX-512-BF16 x86 CPU).  With
# XLA's sigmoid pinned the GRU is held to the MLP's bound (the MLP and the
# pinned GRU both read 0 on that CPU).
BF16_MLP_BOUND = 3 * 2.0 ** -8
BF16_GRU_BOUND = 0.05


@pytest.mark.parametrize("case", ["mlp_continuous", "gru_discrete", "gru_discrete_xla_sigmoid"])
def test_bf16_predict_matches_jax(case, monkeypatch):
    """The bf16 serving programs (``make_single_predict(dtype="bf16")``,
    params cast once) on the same params and observations, against JAX's:
    a batch of 16 (the MLP with obs-norm), or 5 carry-threaded steps of a
    discrete GRU with its carry in bf16 (logits, so the gates' sigmoid is
    the only difference left).  Within the bounds stated above."""
    from estorch_tpu.parallel.engine import _cast_leaves
    from estorch_tpu.serve.predictor import make_single_predict as jmake
    from estorch_tpu_torch.ops.params import map_tree
    from estorch_tpu_torch.envs.rollout import episode_carry
    from estorch_tpu_torch.serve.predictor import make_single_predict as tmake

    recurrent = case != "mlp_continuous"
    if case == "gru_discrete_xla_sigmoid":
        monkeypatch.setattr(torch, "sigmoid", _xla_bf16_sigmoid(torch.sigmoid))
    if recurrent:
        jes, tes = _pair(JRecurrentPolicy, RecurrentPolicy, GRU_DISCRETE_PK)
    else:
        jes, tes = _pair(JMLPPolicy, MLPPolicy, SMALL_PK, obs_norm=True)
    bound = BF16_GRU_BOUND if case == "gru_discrete" else BF16_MLP_BOUND
    jfn = jmake(jes._policy_apply, recurrent=recurrent, obs_norm=not recurrent, dtype="bf16")
    tfn = tmake(tes.module.apply_params, recurrent=recurrent, obs_norm=not recurrent,
                dtype="bf16")
    jparams = _cast_leaves(jes.policy, jnp.bfloat16)
    tparams = map_tree(lambda t: t.to(torch.bfloat16), tes.spec.unravel(tes.state.params_flat))
    jstats = jes.state.obs_stats if not recurrent else None
    tstats = tes.state.obs_stats if not recurrent else None
    errs = []
    if not recurrent:
        obs = _obs(20, 16, 3)
        want, got = np.asarray(jfn(jparams, jstats, jnp.asarray(obs))), tfn(
            tparams, tstats, torch.from_numpy(obs)).numpy()
        errs.append(_rel_err(got, want))
    else:
        jc = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                    jes.module.carry_init())
        tc = episode_carry(tes.module, tparams, "cpu")
        tc = tc.to(torch.bfloat16)
        for t in range(5):
            obs = _obs(30 + t)
            jo, jc = jfn(jparams, None, jnp.asarray(obs), jc)
            to, tc = tfn(tparams, None, torch.from_numpy(obs), tc)
            assert to.dtype == torch.float32 and tc.dtype == torch.bfloat16
            errs.append(_rel_err(to.numpy(), np.asarray(jo)))
    print(f"bf16 {case}: max rel err {max(errs):.3g} (bound {bound:.3g})")
    assert max(errs) <= bound


@pytest.mark.parametrize("case", ["obs_norm", "vbn"])
def test_bundle_arrays_and_manifest_match_jax(case, tmp_path):
    """Both packages' bundles of the same params (and obs stats, or VBN
    statistics): ``arrays.npz`` holds the same keys with equal values, and
    the manifests agree on every field but ``runtime`` (each package's
    versions and devices), ``created_unix``, the checksum (npz members carry
    their write time) and the package in the module's import path."""
    if case == "obs_norm":
        jes, tes = _pair(JMLPPolicy, MLPPolicy, SMALL_PK, obs_norm=True)
    else:
        pk = dict(SMALL_PK, use_vbn=True)
        jes, tes = _pair(JMLPPolicy, MLPPolicy, pk)
        tes.module.vbn_stats = interop.vbn_stats_from_jax(
            jax.tree_util.tree_map(np.asarray, jes._frozen["vbn_stats"]))
    jpath = jes.export_bundle(str(tmp_path / "jax"), version="v")
    tpath = tes.export_bundle(str(tmp_path / "port"), version="v")
    with np.load(os.path.join(jpath, ARRAYS_NAME)) as jz, \
            np.load(os.path.join(tpath, ARRAYS_NAME)) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for k in jz.files:
            assert jz[k].dtype == tz[k].dtype and jz[k].shape == tz[k].shape, k
            np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
    jman, tman = validate_bundle(jpath), validate_bundle(tpath)
    assert tman["module"]["import"] == jman["module"]["import"].replace(
        "estorch_tpu.", "estorch_tpu_torch.", 1)
    for man in (jman, tman):
        for key in ("runtime", "created_unix", "sha256"):
            man.pop(key)
        man["module"].pop("import")
    assert tman == jman
    # and the port's bundle predicts as the JAX bundle does
    obs = _obs(40, 8, 3)
    got = load_bundle(tpath, device="cpu").predict(obs).numpy()
    assert _rel_err(got, np.asarray(jload_bundle(jpath).predict(obs))) <= 1e-6


# =====================================================================
# ES.predict and bundles: the bit-exactness chain
# =====================================================================

def test_predict_is_the_eager_composition(small_es):
    """ES.predict is normalize-then-apply on the center's params, bit for
    bit, and takes a batch."""
    from estorch_tpu_torch.parallel.engine import normalize_obs

    obs = torch.from_numpy(_obs(0))
    with torch.no_grad():
        want = small_es.module.apply_params(
            small_es.spec.unravel(small_es.state.params_flat),
            normalize_obs(obs, small_es.state.obs_stats, small_es.config.obs_clip))
    assert small_es.predict(obs.numpy()).numpy().tobytes() == want.numpy().tobytes()
    assert tuple(small_es.predict(_obs(1, 5, 3)).shape) == (5, 1)


def test_manifest_is_self_describing(small_bundle):
    man = validate_bundle(small_bundle)
    assert man["version"] == "test-v1"
    assert man["module"]["import"] == "estorch_tpu_torch.models.policies:MLPPolicy"
    assert man["module"]["kwargs"] == {"action_dim": 1, "hidden": [24, 24],
                                       "discrete": False, "action_scale": 2.0}
    assert man["obs_shape"] == [3] and man["obs_norm"] is True
    assert man["source"]["algorithm"] == "ES" and man["source"]["generation"] == 1
    # the regression-hunt facts: torch, CUDA, the device, the git sha
    for key in ("torch", "cuda", "git_sha", "devices"):
        assert key in man["runtime"]
    assert man["runtime"]["devices"][0]["platform"] == "cpu"


def test_bundle_predict_bit_equal_single_batch_and_batched_fn(small_es, small_bundle):
    """Bundle.predict equals ES.predict for one observation and a batch, and
    the batcher's program equals ES.predict at the same batch shape — the
    link that chains every served response back to ES.predict."""
    b = load_bundle(small_bundle, device="cpu")
    assert b.device.type == "cpu" and b.params["head"]["kernel"].device.type == "cpu"
    for obs in (_obs(2), _obs(3, 6, 3)):
        assert b.predict(obs).numpy().tobytes() == small_es.predict(obs).numpy().tobytes()
    batch = _obs(9, 8, 3)
    assert (b.batched_predict_fn()(batch).tobytes()
            == small_es.predict(batch).numpy().tobytes())


def test_use_best_snapshot_roundtrip(small_es, tmp_path):
    path = small_es.export_bundle(str(tmp_path / "best"), use_best=True)
    obs = _obs(3)
    assert (load_bundle(path, device="cpu").predict(obs).numpy().tobytes()
            == small_es.predict(obs, use_best=True).numpy().tobytes())
    assert validate_bundle(path)["source"]["use_best"] is True


def test_fresh_process_bit_equal(small_es, small_bundle, tmp_path):
    """THE bundle contract: a process that never saw the ES — only the
    artifact — reproduces es.predict bit for bit on the same device."""
    obs = _obs(4, 8, 3)
    np.save(tmp_path / "obs.npy", obs)
    script = ("import sys, numpy as np\n"
              "from estorch_tpu_torch.serve import load_bundle\n"
              "b = load_bundle(sys.argv[1], device='cpu')\n"
              "obs = np.load(sys.argv[2])\n"
              "print(b.predict(obs).numpy().tobytes().hex())\n"
              "print(b.predict(obs[0]).numpy().tobytes().hex())\n")
    r = subprocess.run([sys.executable, "-c", script, small_bundle, str(tmp_path / "obs.npy")],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    batch_hex, single_hex = r.stdout.strip().splitlines()[-2:]
    assert batch_hex == small_es.predict(obs).numpy().tobytes().hex()
    assert single_hex == small_es.predict(obs[0]).numpy().tobytes().hex()


def test_recurrent_bundle_roundtrip(tmp_path):
    es = _port_es(RecurrentPolicy, GRU_PK, sigma=0.1)
    b = load_bundle(es.export_bundle(str(tmp_path / "rec")), device="cpu")
    assert b.recurrent
    obs = _obs(5)
    o_es, h_es = es.predict(obs)
    o_b, h_b = b.predict(obs)
    assert o_es.numpy().tobytes() == o_b.numpy().tobytes()
    # the threaded carry continues bit-equal
    o_es2, _ = es.predict(obs, carry=h_es)
    o_b2, _ = b.predict(obs, carry=h_b)
    assert o_es2.numpy().tobytes() == o_b2.numpy().tobytes()
    # sessionless coalescing of carries is refused, not fudged
    with pytest.raises(BundleError, match="recurrent"):
        b.batched_predict_fn()


def test_host_backend_is_not_bundleable(tmp_path):
    class P(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(2, 1)

        def forward(self, x):
            return self.lin(x)

    class A:
        def rollout(self, policy):
            self.last_episode_steps = 1
            return 0.0

    es = ES(P, A, torch.optim.Adam, population_size=4, sigma=0.1, seed=0, table_size=1 << 12,
            device="cpu")
    assert tuple(es.predict([0.5, -0.5]).shape) == (1,)  # the torch policy's forward
    with pytest.raises(NotImplementedError, match="torch"):
        es.export_bundle(str(tmp_path / "nope"))


def _tamper_manifest(edit):
    """A tamper that rewrites the committed manifest with ``edit(man)``."""
    def tamper(path):
        mp = os.path.join(path, MANIFEST_NAME)
        with open(mp) as f:
            man = json.load(f)
        edit(man)
        with open(mp, "w") as f:
            json.dump(man, f)
    return tamper


def _flip_payload_byte(path):
    arrays = os.path.join(path, ARRAYS_NAME)
    data = bytearray(open(arrays, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(arrays, "wb") as f:
        f.write(bytes(data))


REJECTIONS = {
    "missing_manifest": (lambda p: os.remove(os.path.join(p, MANIFEST_NAME)),
                         "never\\s+committed"),
    "corrupt_payload": (_flip_payload_byte, "checksum"),
    "schema": (_tamper_manifest(lambda m: m.update(schema=99)), "schema"),
    "param_count_drift": (_tamper_manifest(lambda m: m.update(param_dim=m["param_dim"] + 1)),
                          "param"),
    "unimportable_module": (_tamper_manifest(lambda m: m["module"].update(
        {"import": "estorch_tpu_torch.nonexistent:Ghost"})), "importable|import"),
}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_bundle_rejected(small_bundle, tmp_path, case):
    """Corrupt or partial artifacts are rejected loudly."""
    tamper, match = REJECTIONS[case]
    p = str(shutil.copytree(small_bundle, tmp_path / "b"))
    tamper(p)
    with pytest.raises(BundleError, match=match):
        load_bundle(p, device="cpu")


def test_reexport_over_existing_bundle(small_es, tmp_path):
    path = str(tmp_path / "b")
    small_es.export_bundle(path, version="a")
    small_es.export_bundle(path, version="b")
    assert load_bundle(path, device="cpu").version == "b"


def test_load_bundle_defaults_to_cuda(small_bundle):
    """No silent fallback: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers the default")
    with pytest.raises(RuntimeError, match="cuda"):
        load_bundle(small_bundle)


# =====================================================================
# the dynamic batcher (numpy batch functions)
# =====================================================================

def test_ladder_shapes():
    assert bucket_sizes(1) == (1,)
    assert bucket_sizes(2) == (2,)
    assert bucket_sizes(32) == (2, 4, 8, 16, 32)
    with pytest.raises(ValueError, match="power of two"):
        bucket_sizes(12)


def _batcher(fn=None, **kw):
    tel = Telemetry(enabled=True)
    shapes = []

    def batch_fn(arr):
        shapes.append(arr.shape)
        return (fn or (lambda a: a.sum(axis=1, keepdims=True)))(arr)

    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 5.0)
    b = DynamicBatcher(batch_fn, (3,), telemetry=tel, **kw)
    shapes.clear()  # drop the construction-time verification shapes
    return b, shapes, tel


def test_batches_pad_to_ladder_buckets():
    b, shapes, _ = _batcher()
    outs = [b.submit(np.full(3, i, np.float32)) for i in range(5)]
    for o in outs:
        assert o.event.wait(10)
    b.close()
    assert shapes, "no batches dispatched"
    for s in shapes:
        assert s[0] in b.buckets, f"dispatched shape {s} off-ladder"
    for i, o in enumerate(outs):
        assert o.result[0] == pytest.approx(3.0 * i)


def test_recompiles_bounded_under_mixed_load():
    b, _, tel = _batcher(max_batch=16, max_wait_ms=2.0)
    n_ladder = len(b.buckets) + len(b.buckets_excluded)

    def client(seed):
        rng = np.random.default_rng(seed)
        for _ in range(40):
            item = b.submit(rng.standard_normal(3).astype(np.float32))
            assert item.event.wait(10)
            if rng.random() < 0.3:
                time.sleep(0.001)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    b.close()
    assert tel.counters.get("recompiles") <= n_ladder
    assert tel.counters.get("requests_total") == 240
    assert tel.counters.get("batched_requests_total") == 240


def test_full_queue_sheds_with_backpressure():
    gate = threading.Event()

    def slow(arr):
        gate.wait(10)
        return arr

    tel = Telemetry(enabled=True)
    b = DynamicBatcher(slow, (3,), max_batch=2, max_wait_ms=1.0, max_queue=4, telemetry=tel,
                       verify=False)
    first = b.submit(np.zeros(3, np.float32))
    time.sleep(0.1)  # the worker takes `first` and blocks in slow()
    for _ in range(4):
        b.submit(np.zeros(3, np.float32))
    with pytest.raises(BatcherSaturated):
        b.submit(np.zeros(3, np.float32))
    assert tel.counters.get("shed_total") == 1
    gate.set()
    assert first.event.wait(10)
    b.close()


def test_close_drains_queued_requests():
    def slowish(arr):
        time.sleep(0.02)
        return arr

    b = DynamicBatcher(slowish, (3,), max_batch=2, max_wait_ms=1.0, verify=False)
    items = [b.submit(np.full(3, i, np.float32)) for i in range(10)]
    b.close(drain=True)
    for i, item in enumerate(items):
        assert item.event.is_set() and item.error is None
        assert item.result[0] == pytest.approx(float(i))
    with pytest.raises(BatcherClosed):
        b.submit(np.zeros(3, np.float32))


def test_batch_fn_error_propagates_to_waiters():
    def boom(arr):
        raise RuntimeError("model exploded")

    tel = Telemetry(enabled=True)
    b = DynamicBatcher(boom, (3,), max_batch=2, telemetry=tel, verify=False)
    item = b.submit(np.zeros(3, np.float32))
    assert item.event.wait(10)
    assert isinstance(item.error, RuntimeError)
    assert tel.counters.get("batch_errors_total") == 1
    b.close()


def test_obs_shape_mismatch_rejected():
    b, _, _ = _batcher()
    with pytest.raises(ValueError, match="obs_shape"):
        b.submit(np.zeros(4, np.float32))
    b.close()


def _shape_dependent(bad: int, shapes=None):
    """A batch fn whose rows move by 1e-6 at batch ``bad`` (a
    shape-dependent kernel choice); records the shapes it was called at."""
    def fn(arr):
        if shapes is not None:
            shapes.append(arr.shape[0])
        out = arr.sum(axis=1, keepdims=True)
        if arr.shape[0] == bad:
            out = out + np.float32(1e-6)
        return out
    return fn


@pytest.mark.parametrize("bad,stable,excluded", [(2, (4, 8), (2,)), (4, (2, 8), (4,)),
                                                 (None, (2, 4, 8), ())])
def test_verify_stable_buckets(bad, stable, excluded):
    """Buckets whose rows differ from the anchor's are excluded (edge and
    interior); a stable fn keeps the whole ladder."""
    assert verify_stable_buckets(_shape_dependent(bad), (3,), (2, 4, 8)) == (stable, excluded)


def test_slot_dependent_anchor_is_fatal():
    def fn(arr):
        out = arr.sum(axis=1, keepdims=True)
        out[0] += np.float32(1e-6)  # slot 0 special-cased
        return out

    with pytest.raises(ValueError, match="slot-dependent"):
        verify_stable_buckets(fn, (3,), (2, 4))


@pytest.mark.parametrize("bad", [2, 4])
def test_batcher_routes_around_excluded_bucket(bad):
    """A lone request, and three coalesced ones, pad PAST an excluded shape
    (at the ladder's edge or inside it): it is never dispatched."""
    shapes = []
    b = DynamicBatcher(_shape_dependent(bad, shapes), (3,), max_batch=8, max_wait_ms=20.0)
    assert b.buckets_excluded == (bad,)
    shapes.clear()
    items = [b.submit(np.ones(3, np.float32)) for _ in range(3 if bad == 4 else 1)]
    for it in items:
        assert it.event.wait(10)
    b.close()
    assert bad not in shapes
    if bad == 4:
        assert [b._bucket(n) for n in (1, 2, 3, 4, 5, 8)] == [2, 2, 8, 8, 8, 8]


def _f32(arr):
    return arr.sum(axis=1, keepdims=True).astype(np.float32)


def test_drifting_quant_bucket_excluded_f32_fallback_answers():
    """A quantized path that drifts at ONE bucket keeps serving: that bucket
    is excluded (measured, counted) and dispatches the exact f32 program at
    the same shape, while within-bound buckets ride the quantized path."""
    def quant(arr):
        out = _f32(arr) + 0.01  # inside the bound
        if arr.shape[0] == 4:
            out = out + 1e3  # engineered drift at bucket 4
        return out

    tel = Telemetry(enabled=True)
    b = DynamicBatcher(_f32, (3,), max_batch=8, max_wait_ms=40.0, telemetry=tel,
                       quant_fn=quant, quant_bound=0.05)
    try:
        assert b.quant_buckets_excluded == (4,) and set(b.quant_buckets) == {2, 8}
        assert b.quant_divergence[4] > 0.05
        assert int(tel.counters.get("quant_buckets_excluded")) == 1
        got = b.predict([1.0, 2.0, 3.0], timeout=10.0)
        assert got[0] == np.float32(6.0) + np.float32(0.01)
        items = [b.submit([float(i), 1.0, 1.0]) for i in range(3)]
        for i, it in enumerate(items):
            assert it.event.wait(10.0)
            assert it.result[0] == np.float32(i + 2.0)
        stats = b.stats()
        assert stats["quant"]["excluded"] == [4] and stats["quant"]["batches_total"] >= 1
    finally:
        b.close()


def test_quant_refusals_and_batch1_ladder():
    """Anchor drift is refused (also on the batch-1 ladder, which measures
    its one bucket); a quant fn needs a bound and bucket verification;
    non-finite output is infinite divergence."""
    for max_batch in (4, 1):
        with pytest.raises(ValueError, match="anchor"):
            DynamicBatcher(_f32, (3,), max_batch=max_batch, max_wait_ms=1.0,
                           quant_fn=lambda a: _f32(a) + 1e3, quant_bound=0.05)
    b = DynamicBatcher(_f32, (3,), max_batch=1, max_wait_ms=1.0,
                       quant_fn=lambda a: _f32(a) + 0.001, quant_bound=0.05)
    try:
        assert b.quant_buckets == (1,) and 1 in b.quant_divergence
    finally:
        b.close()
    with pytest.raises(ValueError, match="quant_bound"):
        DynamicBatcher(_f32, (3,), max_batch=4, quant_fn=_f32)
    with pytest.raises(ValueError, match="verification"):
        DynamicBatcher(_f32, (3,), max_batch=4, verify=False, quant_fn=_f32, quant_bound=0.05)

    def nan_quant(arr):
        out = _f32(arr)
        out[0] = np.nan
        return out

    div = measure_quant_divergence(nan_quant, _f32, (3,), [2, 4])
    assert div[2] == float("inf") and div[4] == float("inf")


# =====================================================================
# the server, in process
# =====================================================================

@pytest.fixture(scope="module")
def live_server(small_bundle):
    from estorch_tpu_torch.serve import PolicyServer

    srv = PolicyServer(small_bundle, port=0, max_batch=8, max_wait_ms=2.0,
                       telemetry=Telemetry(enabled=True), device="cpu")
    srv.start_background()
    yield srv
    srv.shutdown(drain=True)


def _anchor_ref(es, obs, anchor):
    """The bit-sound reference for a lone served request: the batcher pads
    into a VERIFIED bucket whose rows equal the anchor bucket's, and at the
    anchor shape the serving program is ES.predict's — so the reference is
    es.predict on an anchor-sized zero-padded batch."""
    pad = np.zeros((anchor,) + np.shape(obs), np.float32)
    pad[0] = obs
    return es.predict(pad).numpy()[0]


def test_predict_health_stats(small_es, live_server):
    with ServeClient(f"{live_server.host}:{live_server.port}") as c:
        h = c.health()
        assert h["ok"] and h["version"] == "test-v1"
        obs = _obs(6)
        action = np.asarray(c.predict(obs), np.float32)
        s = c.stats()
    assert action.tobytes() == _anchor_ref(small_es, obs, max(s["buckets"])).tobytes()
    assert s["requests_total"] >= 1 and s["device"]["platform"] == "cpu"
    assert s["recompiles"] <= len(s["buckets"]) + len(s["buckets_excluded"])
    assert s["cold_start"]["compiles_at_load"] == 0 and s["cold_start"]["warm_cache_hits"] == 0


def test_metrics_exposition_scrapeable(live_server):
    from estorch_tpu_torch.obs.export.prometheus import parse_exposition, samples_by_name

    with ServeClient(f"{live_server.host}:{live_server.port}") as c:
        c.predict(np.zeros(3, np.float32))
    url = f"http://{live_server.host}:{live_server.port}/metrics"
    with urllib.request.urlopen(url, timeout=30) as r:
        assert r.status == 200 and "text/plain" in r.headers["Content-Type"]
        body = r.read().decode()
    vals = samples_by_name(parse_exposition(body))
    assert vals["estorch_requests_total"] >= 1
    assert vals["estorch_up"] == 1 and vals["estorch_uptime_seconds"] >= 0
    assert "estorch_queue_depth" in vals
    assert "# TYPE estorch_requests_total counter" in body
    assert "# TYPE estorch_queue_depth gauge" in body


def test_bad_requests_are_4xx(live_server):
    with ServeClient(f"{live_server.host}:{live_server.port}") as c:
        for method, path, body, status in (("POST", "/predict", {"obs": [1.0, 2.0]}, 400),
                                           ("POST", "/predict", {"not_obs": 1}, 400),
                                           ("GET", "/nope", None, 404)):
            with pytest.raises(ServeError) as ei:
                c._request(method, path, body)
            assert ei.value.status == status


def test_predict_response_carries_trace_id(live_server):
    body = json.dumps({"obs": [0.0, 0.0, 0.0]}).encode()
    req = urllib.request.Request(f"http://{live_server.host}:{live_server.port}/predict",
                                 data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200
        trace = r.headers.get("X-Trace-Id")
    assert trace and trace.startswith("r")
    evs = [e for e in live_server.obs.recorder.events() if e["name"] == "batch_dispatch"]
    assert any(trace in e.get("traces", []) for e in evs)
    # an incoming id is honored, and /traces answers
    req = urllib.request.Request(f"http://{live_server.host}:{live_server.port}/predict",
                                 data=body, headers={"Content-Type": "application/json",
                                                     "X-Trace-Id": "router-7"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.headers.get("X-Trace-Id") == "router-7"
    with urllib.request.urlopen(f"http://{live_server.host}:{live_server.port}/traces?since=0",
                                timeout=30) as r:
        payload = json.loads(r.read())
    assert payload["proc"] == f"server-{live_server.port}" and "segments" in payload


def test_one_connection_does_not_wait_for_delayed_acks(live_server):
    """20 requests in turn on one keep-alive connection: a reply's body
    must not wait for the client's delayed ACK of its headers (with Nagle's
    algorithm on the server's socket each request waits out the ~40 ms
    delayed-ACK timer); the median is held under 20 ms."""
    with ServeClient(f"{live_server.host}:{live_server.port}") as c:
        c.predict([0.0, 0.0, 0.0])
        lat = []
        for i in range(20):
            t0 = time.perf_counter()
            c.predict([0.01 * i, 0.0, 0.0])
            lat.append(time.perf_counter() - t0)
    assert sorted(lat)[10] < 0.020, sorted(lat)


def test_hot_reload_swaps_atomically(small_es, live_server, tmp_path):
    v2 = small_es.export_bundle(str(tmp_path / "v2"), version="test-v2")
    with ServeClient(f"{live_server.host}:{live_server.port}") as c:
        assert c.reload(v2)["version"] == "test-v2"
        assert c.health()["version"] == "test-v2"
        # a bad reload is a 409 and the old bundle keeps serving
        with pytest.raises(ServeError) as ei:
            c.reload(str(tmp_path / "missing"))
        assert ei.value.status == 409
        assert c.health()["version"] == "test-v2"
        obs = _obs(7)
        got = np.asarray(c.predict(obs), np.float32)
        anchor = max(c.stats()["buckets"])
    assert got.tobytes() == _anchor_ref(small_es, obs, anchor).tobytes()


# =====================================================================
# warm blocks and bf16 serving
# =====================================================================

@pytest.fixture(scope="module")
def warm_bundle_path(small_es, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("warm") / "pendulum_warm")
    small_es.export_bundle(path, version="warm-v1", warm=True, warm_max_batch=4,
                           serve_bf16=True)
    return path


def test_warm_block_records_the_verified_ladder(warm_bundle_path, small_bundle, tmp_path):
    """The port's warm block: format ``torch_eager``, no entries, the
    ladder verified at export complete, the platform facts; installed in a
    process on the same platform; a cold bundle reports no warmth; another
    torch version is a finding, not an error; an unknown format is
    rejected."""
    warm = validate_bundle(warm_bundle_path)["warm"]
    assert warm["format"] == "torch_eager" and "entries" not in warm
    assert set(warm["buckets"]) | set(warm["buckets_excluded"]) == set(bucket_sizes(4))
    assert warm["dtypes"] == ["f32", "bf16"] and warm["platform"] == "cpu"
    assert warm["torch_version"] == torch.__version__
    b = load_bundle(warm_bundle_path, device="cpu")
    assert b.warm_status["installed"] is True and b.warm_status["entries"] == 0
    cold = load_bundle(small_bundle, device="cpu")
    assert cold.warm_status == {"installed": False, "reason": "no warmth packed",
                                "entries": 0, "cache_dir": None}
    for edit, outcome in ((("torch_version", "0.0.0"), "0.0.0"), (("format", "xla_cache"), None)):
        dst = str(shutil.copytree(warm_bundle_path, tmp_path / edit[0]))
        mp = os.path.join(dst, MANIFEST_NAME)
        with open(mp) as f:
            man = json.load(f)
        man["warm"][edit[0]] = edit[1]
        with open(mp, "w") as f:
            json.dump(man, f)
        if outcome is None:
            with pytest.raises(BundleError, match="format"):
                validate_bundle(dst)
            continue
        stale = load_bundle(dst, device="cpu")
        assert stale.warm_status["installed"] is False and outcome in stale.warm_status["reason"]
        assert stale.batched_predict_fn()(np.zeros((2, 3), np.float32)).shape == (2, 1)


def test_reexport_without_warm_drops_the_block(small_es, tmp_path):
    path = str(tmp_path / "re")
    small_es.export_bundle(path, warm=True, warm_max_batch=4)
    assert "warm" in validate_bundle(path)
    small_es.export_bundle(path)
    assert "warm" not in validate_bundle(path)


class DriftPolicy(MLPPolicy):
    """bf16-hostile by construction: the +4096/−4096 round trip keeps the
    (tiny) signal in float32 and destroys it at bf16's 8 mantissa bits —
    the policy-exceeds-the-bound refusal case."""

    def apply_params(self, params, obs, captured=None):
        from estorch_tpu_torch.models.policies import _dense

        h = _dense(obs, params["head"]) * 0.01
        return (h + 4096.0) - 4096.0


def test_bf16_refused_without_opt_in(small_bundle):
    with pytest.raises(BundleError, match="did not opt into"):
        load_bundle(small_bundle, device="cpu").batched_predict_fn(dtype="bf16")


def test_bf16_server_serves_within_measured_bound(small_es, warm_bundle_path):
    """An opted-in policy serves bf16 with per-bucket divergence MEASURED at
    load and every answer inside the documented bound of the f32
    reference."""
    from estorch_tpu_torch.serve import BF16_DIVERGENCE_BOUND, PolicyServer

    srv = PolicyServer(warm_bundle_path, port=0, max_batch=4, max_wait_ms=2.0, dtype="bf16",
                       telemetry=Telemetry(enabled=True), device="cpu")
    srv.start_background()
    try:
        obs = _obs(12)
        with ServeClient(f"{srv.host}:{srv.port}") as c:
            got = np.asarray(c.predict(obs), np.float32)
            stats = c.stats()
    finally:
        srv.shutdown(drain=True)
    quant = stats["quant"]
    assert quant["dtype"] == "bf16" and quant["bound"] == BF16_DIVERGENCE_BOUND
    for b_, d in quant["divergence"].items():
        if int(b_) in quant["buckets"]:
            assert d <= BF16_DIVERGENCE_BOUND
    ref = _anchor_ref(small_es, obs, max(stats["buckets"]))
    assert abs(float(got[0]) - float(ref[0])) <= BF16_DIVERGENCE_BOUND * max(abs(float(ref[0])),
                                                                             2.0)


def test_drift_policy_refused_at_load_and_at_warm_export(tmp_path):
    """A policy whose bf16 divergence exceeds the bound at the anchor is
    REFUSED (the server's 409 / CLI exit 2), never served quantized-but-
    wrong; the same bundle serves f32; a warm export fails loudly."""
    from estorch_tpu_torch.serve import PolicyServer
    from estorch_tpu_torch.serve.warm import build_serving_batcher

    es = _port_es(DriftPolicy, {"action_dim": 1, "hidden": ()})
    path = es.export_bundle(str(tmp_path / "drift"), serve_bf16=True)
    assert validate_bundle(path)["module"]["import"].endswith(":DriftPolicy")
    with pytest.raises(BundleError, match="divergence bound"):
        build_serving_batcher(load_bundle(path, device="cpu"), max_batch=4, dtype="bf16")
    srv = PolicyServer(path, port=0, max_batch=4, dtype="f32", device="cpu")
    srv.start_background()
    try:
        with ServeClient(f"{srv.host}:{srv.port}") as c:
            assert np.isfinite(np.asarray(c.predict([0.1, 0.2, 0.3]), np.float32)).all()
    finally:
        srv.shutdown(drain=True)
    with pytest.raises(BundleError, match="divergence bound"):
        es.export_bundle(str(tmp_path / "drift_warm"), warm=True, warm_max_batch=4,
                         serve_bf16=True)


# =====================================================================
# the CLI: a server process, bit-exact under load, SIGTERM drain
# =====================================================================

def _spawn_server(bundle, max_batch, *extra):
    proc = subprocess.Popen(
        [sys.executable, "-m", "estorch_tpu_torch.serve", "--bundle", bundle, "--port", "0",
         "--device", "cpu", "--max-batch", str(max_batch), "--beat-interval", "0.5", *extra],
        stdout=subprocess.PIPE, text=True, cwd=REPO)
    return proc, json.loads(proc.stdout.readline())


def test_cli_serves_bit_exact_and_drains_on_sigterm(small_es, small_bundle):
    """A server process on the CPU: the ready line names the device; 16
    distinct observations through the loadgen are bit-equal to ES.predict
    on the anchor batch; SIGTERM with 8 requests in flight drains them all
    with real answers, nothing shed, exit 0."""
    from estorch_tpu_torch.serve.loadgen import run_load

    proc, ready = _spawn_server(small_bundle, 16)
    try:
        assert ready["ready"] and ready["device"]["platform"] == "cpu"
        assert ready["cold_start"]["compiles_at_load"] == 0
        assert set(ready["buckets"]) | set(ready["buckets_excluded"]) == set(bucket_sizes(16))
        check = _obs(8, 16, 3)
        ref = small_es.predict(check).numpy()
        res = run_load(ready["url"], conns=4, total=len(check), duration_s=60.0,
                       obs_list=[o.tolist() for o in check], collect_responses=True)
        assert res["errors"] == 0 and res["shed"] == 0
        got = np.asarray([r["action"] for r in res["responses"]], np.float32)
        assert got.tobytes() == ref.tobytes()

        host_port = ready["url"].split("://", 1)[1]
        clients = [ServeClient(host_port, timeout_s=60) for _ in range(8)]
        for c in clients:
            c.health()  # connections established before the signal
        results, errors = [None] * 8, []

        def client(i):
            try:
                results[i] = clients[i].predict([0.1 * i, 0.2, 0.3])
            except Exception as e:  # asserted empty below
                errors.append((i, repr(e)))
            finally:
                clients[i].close()

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(timeout=60)
        out, _ = proc.communicate(timeout=60)
        final = json.loads(out.strip().splitlines()[-1])
        assert not errors, errors
        assert proc.returncode == 0 and final["clean"]
        assert final["counters"].get("shed_total", 0) == 0
        pad = np.zeros((16, 3), np.float32)
        pad[:8] = [[0.1 * i, 0.2, 0.3] for i in range(8)]
        assert (np.asarray(results, np.float32).tobytes()
                == small_es.predict(pad).numpy()[:8].tobytes())
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_supervised_cli_drains_on_sigterm(small_bundle, tmp_path):
    """``serve --supervised``: the server answers as a spawned child of
    the ``Supervisor``, and SIGTERM to the supervisor reaches the child,
    which drains — the supervisor reports a clean completion, exit 0."""
    from estorch_tpu_torch.serve.server import find_free_port

    port = find_free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "estorch_tpu_torch.serve", "--bundle", small_bundle,
         "--supervised", "--supervise-root", str(tmp_path / "root"), "--port", str(port),
         "--device", "cpu", "--max-batch", "8", "--beat-interval", "0.5",
         "--stale-after-s", "30"],
        stdout=subprocess.PIPE, text=True, cwd=REPO)
    try:
        health, deadline = None, time.time() + 120
        while health is None and time.time() < deadline:
            try:
                with ServeClient(f"127.0.0.1:{port}", timeout_s=2) as c:
                    health = c.health()
            except OSError:
                time.sleep(0.3)
        assert health is not None and health["ok"], health
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0, out[-1000:]
    assert json.loads(out.strip().splitlines()[-1]) == {
        "supervised": True, "ok": True, "restarts": 0, "reason": None}


@pytest.mark.parametrize("argv,match", [
    (["--max-batch", "12"], "power of two"),
    (["--device", "cuda"], "cuda"),
    (["route"], "9c"),
])
def test_cli_refuses_with_exit_2(small_bundle, argv, match):
    """Config errors are exit 2 with one line: a bad ladder, a card that is
    not there (never a fallback to the CPU), the router of item 9c."""
    if argv == ["--device", "cuda"] and torch.cuda.is_available():
        pytest.skip("a card is present")
    args = argv if argv == ["route"] else ["--bundle", small_bundle, *argv]
    r = subprocess.run([sys.executable, "-m", "estorch_tpu_torch.serve", *args],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 2, r.stderr[-2000:]
    assert match in r.stderr
