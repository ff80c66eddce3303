"""The sharded forward of every feedforward policy (``parallel/sharded.py``):
NatureCNN's conv trunk with and without VBN, and ``MLPPolicy`` with VBN,
across gloo ranks on the CPU, against the JAX package's ``ShardedESEngine``.

Ranks are real processes, as in ``tests/test_torch_sharded.py``: this file
run as a script is one rank (``python tests/test_torch_sharded_conv.py
MODE RANK POP MODEL RDV WORK [DEVICE]``), joined by gloo through a file
store under the test's temporary directory.  The module imports no JAX at
load (the ranks import it); the JAX references are built in a fixture on
the virtual CPU devices with a ``(pop, model)`` mesh of ``Auto`` axes
(ROADMAP F4), their draws handed to the ranks as npz.

The pixel env is :class:`PixelShift`, a leaky shift register of (36, 36, 4)
float pixels driven by the action, written alike for both packages
(:func:`jax_pixel_env`): 36 → 8 → 3 → 1 is the Nature-DQN trunk's smallest
valid input.  Its rewards are elementwise functions of the pixels, so equal
actions give bit-equal returns in both packages.  Tolerances: fitness and
params within JAX's sharded A/B gate (``bench.py``: rtol 2e-4, atol 1e-5).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from estorch_tpu_torch import ES, DeviceAgent, MLPPolicy, NatureCNN, adam, interop  # noqa: E402
from estorch_tpu_torch.parallel import Sample  # noqa: E402
from test_torch_sharded import _join, noise_rows  # noqa: E402

HORIZON = 4
GENS = 2
POP = 8
RANK_TIMEOUT_S = 60.0
ATOL, RTOL = 1e-5, 2e-4  # JAX's sharded A/B gate
SHAPES = [(1, 2), (2, 1), (2, 2)]


@dataclasses.dataclass(frozen=True)
class PixelShift:
    """(H, W, C) float pixels, a leaky shift register driven by the action:
    each step moves the image one column right, scaled by 0.9, and writes
    the action's value a / (A − 1) into column 0; the reward is −(value −
    pixel (0, 5, 0))², read before the step.  Never ends.  The state is the
    flat image."""

    height: int = 36
    width: int = 36
    channels: int = 4
    action_dim: int = 2
    discrete: bool = True
    default_horizon: int = HORIZON
    bc_dim: int = 4

    @property
    def obs_dim(self) -> int:
        return self.height * self.width * self.channels

    def reset(self, generator: torch.Generator, n: int):
        states = torch.rand((n, self.obs_dim), generator=generator, device=generator.device)
        return states, self.observe(states)

    def observe(self, states: torch.Tensor) -> torch.Tensor:
        return states.view(-1, self.height, self.width, self.channels)

    def step(self, states: torch.Tensor, actions: torch.Tensor):
        img = self.observe(states)
        n = img.shape[0]
        value = actions.reshape(n).to(torch.float32) / float(self.action_dim - 1)
        d = value - img[:, 0, 5, 0]
        col = value[:, None, None, None].expand(n, self.height, 1, self.channels)
        new = torch.cat([col, img[:, :, :-1] * 0.9], dim=2)
        return (new.reshape(n, -1), new, -(d * d),
                torch.zeros((n,), dtype=torch.bool, device=img.device))

    def behavior(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        return obs[:, 0, :4, 0]


def jax_pixel_env(env: PixelShift = PixelShift()):
    """:class:`PixelShift` as a JAX package device env (one member's pure
    ``reset(key)`` / ``step(state, action)``), written alike."""
    import jax
    import jax.numpy as jnp

    h, w, c = env.height, env.width, env.channels

    @dataclasses.dataclass(frozen=True)
    class JaxPixelShift:
        obs_dim: int = env.obs_dim
        action_dim: int = env.action_dim
        discrete: bool = True
        default_horizon: int = env.default_horizon
        bc_dim: int = env.bc_dim

        def reset(self, key):
            s = jax.random.uniform(key, (self.obs_dim,), jnp.float32)
            return s, s.reshape(h, w, c)

        def step(self, state, action):
            img = state.reshape(h, w, c)
            value = jnp.reshape(action, ()).astype(jnp.float32) / float(self.action_dim - 1)
            d = value - img[0, 5, 0]
            new = jnp.concatenate([jnp.full((h, 1, c), value, jnp.float32),
                                   img[:, :-1] * 0.9], axis=1)
            return new.reshape(-1), new, -(d * d), jnp.bool_(False)

        def behavior(self, state, obs):
            return obs[0, :4, 0]

    return JaxPixelShift()


# name: (port policy, policy kwargs, env: "pixel" or "cartpole")
CASES = {
    "cnn": (NatureCNN, {"action_dim": 2, "use_vbn": False}, "pixel"),
    "cnn_vbn": (NatureCNN, {"action_dim": 2, "use_vbn": True}, "pixel"),
    "mlp_vbn": (MLPPolicy, {"action_dim": 2, "hidden": (16, 16), "use_vbn": True}, "cartpole"),
}


def _env(kind: str):
    from estorch_tpu_torch import CartPole

    return PixelShift() if kind == "pixel" else CartPole()


def sharded_es(case: str, mesh=None, **over) -> ES:
    policy, pk, env = CASES[case]
    kw = dict(population_size=POP, sigma=0.05, seed=0, policy_kwargs=pk,
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 18, eval_chunk=4,
              telemetry=False, shard_params=True)
    kw.update(over)
    if mesh is None:
        kw.setdefault("device", "cpu")
    else:
        kw["mesh"] = mesh
    return ES(policy, DeviceAgent(_env(env), horizon=HORIZON), adam, **kw)


def forward_pair(es, members: int = 4):
    """The sharded forward of generation 0's first ``members`` members on
    their reset observations, and the replicated ``population_apply`` of
    the same members' gathered θ."""
    from estorch_tpu_torch.envs.rollout import population_forward

    eng = es.engine
    draws = eng._draws(es.state, None)
    rows, signs = eng._member_rows_signs(torch.arange(members))
    theta = eng._perturbed(es.state, rows, signs, draws)
    obs = eng.env.observe(draws["states"][rows].to(eng.device))
    got = eng._sharded_apply(eng.layout.tree(theta))(obs)
    full = torch.stack([eng.layout.gather(t) for t in theta])
    want = population_forward(es.module, es.spec.unravel(full))(obs)
    return got.cpu().numpy(), want.cpu().numpy()


# ---------------------------------------------------------------- the ranks


def _replay_jax(es, ref, case: str) -> dict:
    """``GENS`` table-mode generations from JAX's table, params, VBN
    statistics, offsets and reset states."""
    es.engine.table = es.table = interop.table_from_numpy(ref[f"{case}_table"])
    flat, _ = interop.params_from_jax(ref[f"{case}_params0"], es.spec)
    stats = {k[len(case) + 7:]: v for k, v in ref.items() if k.startswith(f"{case}_stats_")}
    if stats:
        es.module.vbn_stats = interop.vbn_stats_from_jax(
            {f"vbn_{i}": {"mean": stats[f"{i}_mean"], "var": stats[f"{i}_var"]}
             for i in range(len(stats) // 2)})
    es.state = es.engine.init_state(flat, seed=0)
    out = {}
    for g in range(GENS):
        sample = Sample(torch.from_numpy(ref[f"{case}_offsets{g}"]),
                        torch.from_numpy(ref[f"{case}_states{g}"]))
        es.state, m = es.engine.generation_step(es.state, sample)
        out[f"{case}_fitness{g}"] = m["fitness"].cpu().numpy()
        out[f"{case}_steps{g}"] = np.int64(m["steps"])
        out[f"{case}_params{g}"] = es.state.params_flat.cpu().numpy()
    return out


def rank_main(rank: int, pop: int, model: int, rdv: str, work: Path) -> None:
    mesh = _join(rank, pop, model, rdv)
    ref = dict(np.load(work / "jax.npz"))
    out = {}
    for case in CASES:
        out.update(_replay_jax(sharded_es(case, mesh, noise_mode="table"), ref, case))
        es = sharded_es(case, mesh)
        out[f"{case}_noise0"] = noise_rows(es, 2)
        out[f"{case}_forward"], out[f"{case}_forward_want"] = forward_pair(es)
        es.train(GENS, verbose=False)
        out[f"{case}_program_params"] = es.state.params_flat.numpy()
        out[f"{case}_report"] = np.asarray(str(sorted(es.engine.sharding_report().items())))
    np.savez(work / f"{pop}x{model}_rank{rank}.npz", **out)


def rank_card(rank: int, pop: int, model: int, rdv: str, work: Path,
              device: str = "cuda:0") -> None:
    """NatureCNN with VBN in program mode on ``device`` (the card test):
    generation 0's noise, the forward against the replicated one, 2
    generations."""
    mesh = _join(rank, pop, model, rdv, device)
    es = sharded_es("cnn_vbn", mesh)
    noise = noise_rows(es, 2)
    got, want = forward_pair(es)
    es.train(GENS, verbose=False)
    np.savez(work / f"card_{pop}x{model}_rank{rank}.npz", noise0=noise, forward=got,
             forward_want=want, params=es.state.params_flat.cpu().numpy())


MODES = {"main": rank_main, "card": rank_card}


def launch(mode: str, pop: int, model: int, work: Path, deadline_s: float = 240.0,
           device: str | None = None) -> list:
    """Start the ``pop·model`` ranks of ``mode`` and wait for them; returns
    their (returncode, stderr tail)."""
    rdv = work / f"{mode}{pop}x{model}.rdv"
    rdv.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("ESTORCH_CHAOS", None)
    extra = [device] if device else []
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r), str(pop), str(model),
                               str(rdv), str(work), *extra],
                              env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                              text=True)
             for r in range(pop * model)]
    outs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=deadline_s)
            outs.append((p.returncode, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# ----------------------------------------------------- the JAX reference


def _jax_reference(work: Path) -> dict:
    """JAX's ``ShardedESEngine`` in table mode on a (1, 2) ``Auto`` mesh,
    ``GENS`` generations of each case, its draws saved for the ranks.
    Returns JAX's results.  Not (2, 2): with 2 pop shards JAX's NatureCNN
    generation on the CPU ``Auto`` mesh gives other returns than its own
    replicated engine and its (1, 1) and (1, 2) meshes (ROADMAP F26)."""
    import jax
    import optax
    from jax.sharding import AxisType, Mesh
    from test_torch_envs import jax_resets

    import estorch_tpu.envs as jenvs
    from estorch_tpu import ES as JES
    from estorch_tpu import JaxAgent
    from estorch_tpu import MLPPolicy as JMLPPolicy
    from estorch_tpu import NatureCNN as JNatureCNN
    from estorch_tpu.parallel import mesh as jmesh
    from estorch_tpu.parallel.engine import _gen_keys

    def auto_mesh(pop_shards=None, model_shards=None, devices=None):
        devs = np.asarray(jax.devices()[:2]).reshape(1, 2)
        return Mesh(devs, (jmesh.POP_AXIS, jmesh.MODEL_AXIS), axis_types=(AxisType.Auto,) * 2)

    jpolicies = {NatureCNN: JNatureCNN, MLPPolicy: JMLPPolicy}
    saved, jout = {}, {}
    orig = jmesh.hyperscale_mesh
    jmesh.hyperscale_mesh = auto_mesh  # estorch_tpu/algo/es.py imports it at call time
    try:
        for case, (policy, pk, env) in CASES.items():
            jenv = jax_pixel_env() if env == "pixel" else jenvs.CartPole()
            tenv = _env(env)
            jes = JES(jpolicies[policy], JaxAgent(jenv, horizon=HORIZON), optax.adam,
                      population_size=POP, sigma=0.05, seed=0, policy_kwargs=pk,
                      optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 18,
                      eval_chunk=4, shard_params=True, noise_mode="table", telemetry=False)
            eng = jes.engine
            assert dict(zip(eng.mesh.axis_names, eng.mesh.devices.shape)) == {"pop": 1,
                                                                               "model": 2}
            saved[f"{case}_table"] = np.asarray(jes.table.data)
            saved[f"{case}_params0"] = np.asarray(jes.state.params_flat)
            for name, st in jes._frozen.get("vbn_stats", {}).items():
                for stat, v in st.items():
                    saved[f"{case}_stats_{name[4:]}_{stat}"] = np.asarray(v)
            for g in range(GENS):
                st = jes.state
                okey, rkey = _gen_keys(st)
                saved[f"{case}_states{g}"] = jax_resets(
                    eng.env, tenv, jax.random.split(rkey, eng.rows_global)).numpy()
                saved[f"{case}_offsets{g}"] = np.asarray(eng._offsets(okey))
                jes.state, jm = eng.generation_step(st)
                jout[f"{case}_fitness{g}"] = np.asarray(jm["fitness"])
                jout[f"{case}_steps{g}"] = int(jm["steps"])
                jout[f"{case}_params{g}"] = np.asarray(jes.state.params_flat)
    finally:
        jmesh.hyperscale_mesh = orig
    np.savez(work / "jax.npz", **saved)
    return jout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's reference, then the ranks at (1, 2), (2, 1) and (2, 2)."""
    work = tmp_path_factory.mktemp("sharded_conv")
    jout = _jax_reference(work)
    outs = {}
    for pop, model in SHAPES:
        outs[(pop, model)] = launch("main", pop, model, work)
    for shape, o in outs.items():
        for rc, err in o:
            assert rc == 0, (shape, err)
    ranks = {(pop, model): [dict(np.load(work / f"{pop}x{model}_rank{r}.npz"))
                            for r in range(pop * model)]
             for pop, model in SHAPES}
    return jout, ranks


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1", "2x2"])
def test_table_mode_matches_jax_sharded(runs, shape, case):
    """Table mode from JAX's table, params, VBN statistics, offsets and
    reset states: each generation's fitness, alive steps and params within
    JAX's gate, on every rank."""
    jout, ranks = runs
    spec = sharded_es(case).spec
    for r, got in enumerate(ranks[shape]):
        for g in range(GENS):
            what = f"{case} {shape} rank {r} generation {g}"
            _close(got[f"{case}_fitness{g}"], jout[f"{case}_fitness{g}"], what)
            assert int(got[f"{case}_steps{g}"]) == jout[f"{case}_steps{g}"], what
            want, _ = interop.params_from_jax(jout[f"{case}_params{g}"], spec)
            _close(got[f"{case}_params{g}"], want.numpy(), what)


@pytest.mark.parametrize("case", list(CASES))
def test_program_noise_and_training_are_mesh_shape_invariant(runs, case):
    """The port's program stream: generation 0's noise bit-identical at
    (1, 1), (1, 2), (2, 1) and (2, 2), and the params after ``GENS``
    generations within the gate of the (1, 1) run's."""
    _, ranks = runs
    es = sharded_es(case)
    noise = noise_rows(es, 2)
    es.train(GENS, verbose=False)
    for shape in SHAPES:
        for got in ranks[shape]:
            assert got[f"{case}_noise0"].tobytes() == noise.tobytes(), shape
            _close(got[f"{case}_program_params"], es.state.params_flat.numpy(), f"{shape}")


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_forward_is_the_replicated_forward(runs, case):
    """On every rank of every shape, the sharded forward of 4 members
    equals ``population_apply`` of their gathered θ within float32
    reassociation (1e-5); at (1, 2) and (2, 2) every conv, fc and dense
    kernel is split on its output channels."""
    _, ranks = runs
    for shape in SHAPES:
        for got in ranks[shape]:
            np.testing.assert_allclose(got[f"{case}_forward"], got[f"{case}_forward_want"],
                                       rtol=1e-5, atol=1e-5, err_msg=f"{case} {shape}")
    report = dict(eval(str(ranks[(1, 2)][0][f"{case}_report"])))  # noqa: S307 — our own repr
    kernels = [k for k in report if k.endswith("/kernel")]
    assert kernels and all("'model')" in report[k] for k in kernels), report


def test_layer_splits_other_than_channels_and_other_modules_raise():
    """A conv kernel split along a spatial dim names its layer; a module
    the port does not bundle names the families covered and README's
    section; a recurrent policy is refused as JAX refuses it."""
    from estorch_tpu_torch import RecurrentPolicy
    from estorch_tpu_torch.ops.params import make_param_spec
    from estorch_tpu_torch.parallel import mesh as tmesh
    from estorch_tpu_torch.parallel.engine import EngineConfig
    from estorch_tpu_torch.parallel.sharded import ShardedESEngine

    cnn = NatureCNN(action_dim=2)
    _, spec = make_param_spec(cnn.init_params((36, 36, 4), torch.Generator().manual_seed(0)))
    cfg = EngineConfig(population_size=4, sigma=0.1, horizon=2)
    rules = ((r"conv_1/kernel$", tmesh.P(tmesh.MODEL_AXIS)), (r".*", tmesh.P()))
    one_of_two = tmesh.HyperscaleMesh(1, 2, 0, "cpu", groups=(None, None, None))
    with pytest.raises(ValueError, match=r"layer 'conv_1'.*split along dim 0"):
        ShardedESEngine(PixelShift(), cnn, spec, None, adam(1e-2), cfg, one_of_two,
                        partition_rules=rules)

    class Linear(torch.nn.Module):
        pass

    with pytest.raises(ValueError, match="MLPPolicy and NatureCNN.*The sharded forward"):
        ShardedESEngine(PixelShift(), Linear(), spec, None, adam(1e-2), cfg,
                        tmesh.hyperscale_mesh(devices="cpu"))
    rec = RecurrentPolicy(action_dim=2)
    _, rspec = make_param_spec(rec.init_params(4, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="MLPPolicy and NatureCNN"):
        ShardedESEngine(PixelShift(), rec, rspec, None, adam(1e-2), cfg,
                        tmesh.hyperscale_mesh(devices="cpu"))


if __name__ == "__main__":
    mode, rank, pop, model, rdv, work = sys.argv[1:7]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        MODES[mode](int(rank), int(pop), int(model), rdv, Path(work), *sys.argv[7:])
