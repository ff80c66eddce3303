"""The port's adapters and host recipes against the JAX package's, on the CPU.

- ``models/torch_adapter.py``: a torch ``Linear`` MLP ↔ the port's
  ``MLPPolicy`` params, against ``torch_mlp_to_flax``/``flax_mlp_to_torch``.
- ``envs/gym_adapter.py``: ``GymFromDeviceEnv`` against ``GymFromJax`` over
  the same env from the same injected state (the two packages draw initial
  states from different generators).
- ``configs.halfcheetah_vbn`` / ``humanoid_mirrored``: the JAX recipes'
  layout and hyperparameters, and one generation on HalfCheetah-v5.

Tolerances: the adapters copy floats (exact).  The gym steps are the envs'
own float32 arithmetic, which XLA fuses into multiply-adds and torch does
not: classic control is held to 1e-6 over 30 steps, the chaotic planar
hopper to 1e-4 over 10 (measured at most 2.4e-7 and 6.6e-7).
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import estorch_tpu.configs as jconfigs
import estorch_tpu.envs as jenvs
from estorch_tpu.envs.gym_adapter import GymFromJax
from estorch_tpu.models import MLPPolicy as JMLPPolicy
from estorch_tpu.models.torch_adapter import flax_mlp_to_torch, torch_mlp_to_flax
from estorch_tpu_torch import configs, interop
from estorch_tpu_torch import envs as tenvs
from estorch_tpu_torch.envs.gym_adapter import GymFromDeviceEnv
from estorch_tpu_torch.models import MLPPolicy
from estorch_tpu_torch.models.torch_adapter import params_to_torch_mlp, torch_mlp_to_params
from estorch_tpu_torch.ops.params import make_param_spec


def _torch_mlp(sizes, bias=True):
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        layers.append(torch.nn.Linear(a, b, bias=bias))
        if i < len(sizes) - 2:
            layers.append(torch.nn.Tanh())
    return torch.nn.Sequential(*layers)


# ------------------------------------------------------------ torch adapter


@pytest.mark.parametrize("sizes", [(4, 32, 32, 2), (3, 8, 1), tuple([5] + [7] * 11 + [3])],
                         ids=["cartpole", "one_hidden", "eleven_hidden"])
def test_torch_mlp_to_params_matches_flax_layout(sizes):
    """The flat vector is JAX's ravel_pytree of torch_mlp_to_flax (so
    dense_10 sorts before dense_2), and the MLPPolicy forward is the torch
    forward."""
    torch.manual_seed(0)
    tp = _torch_mlp(sizes)
    hidden, n_out = sizes[1:-1], sizes[-1]
    params = torch_mlp_to_params(tp, MLPPolicy(action_dim=n_out, hidden=hidden))
    flat, _ = make_param_spec(params)
    jparams = torch_mlp_to_flax(tp, JMLPPolicy(action_dim=n_out, hidden=hidden))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ravel_pytree(jparams)[0]))
    obs = torch.randn((6, sizes[0]), generator=torch.Generator().manual_seed(1))
    module = MLPPolicy(action_dim=n_out, hidden=hidden)  # discrete: the head's logits
    torch.testing.assert_close(module.apply_params(params, obs), tp(obs).detach(),
                               rtol=1e-6, atol=1e-6)


def test_params_round_trip_through_torch():
    """MLPPolicy params → a fresh torch MLP → params: the same floats, and
    the same outputs as JAX's flax_mlp_to_torch of the same params."""
    gen = torch.Generator().manual_seed(2)
    module = MLPPolicy(action_dim=2, hidden=(16, 16))
    params = module.init_params(4, gen)
    tp, jtp = _torch_mlp((4, 16, 16, 2)), _torch_mlp((4, 16, 16, 2))
    params_to_torch_mlp(params, tp)
    flax_mlp_to_torch({k: {n: v.numpy() for n, v in d.items()} for k, d in params.items()}, jtp)
    back = torch_mlp_to_params(tp, module)
    for name in params:
        for leaf in ("bias", "kernel"):
            torch.testing.assert_close(back[name][leaf], params[name][leaf], rtol=0, atol=0)
    obs = torch.randn((5, 4), generator=gen)
    torch.testing.assert_close(tp(obs), jtp(obs), rtol=0, atol=0)
    torch.testing.assert_close(tp(obs).detach(), module.apply_params(params, obs),
                               rtol=1e-6, atol=1e-6)


def test_adapter_errors_as_in_jax():
    """A bias-free Linear, a layer-count mismatch and a shape mismatch raise
    in both directions, as the JAX adapter's; a size-1 mismatch is not
    broadcast."""
    module = MLPPolicy(action_dim=2, hidden=(8,))
    with pytest.raises(ValueError, match="bias=False"):
        torch_mlp_to_params(_torch_mlp((4, 8, 2), bias=False), module)
    with pytest.raises(ValueError, match="bias=False"):
        torch_mlp_to_flax(_torch_mlp((4, 8, 2), bias=False), JMLPPolicy(action_dim=2,
                                                                        hidden=(8,)))
    with pytest.raises(ValueError, match="layer count mismatch"):
        torch_mlp_to_params(_torch_mlp((4, 8, 8, 2)), module)
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_mlp_to_params(_torch_mlp((4, 9, 2)), module, obs_dim=4)
    params = module.init_params(4, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="layer count mismatch"):
        params_to_torch_mlp(params, _torch_mlp((4, 8, 8, 2)))
    one_row = _torch_mlp((4, 8, 1))  # head (1, 8) against the params' (8, 2).T
    with pytest.raises(ValueError, match="shape mismatch"):
        params_to_torch_mlp(params, one_row)
    with pytest.raises(ValueError, match="shape mismatch"):
        flax_mlp_to_torch({k: {n: v.numpy() for n, v in d.items()} for k, d in params.items()},
                          _torch_mlp((4, 8, 1)))


# -------------------------------------------------------------- gym adapter


def _inject(jenv, tenv, seed):
    """JAX's reset state of ``seed`` into both adapters."""
    jstate, jobs = jenv.reset(jax.random.PRNGKey(seed))
    jg = GymFromJax(jenv, max_steps=25)
    tg = GymFromDeviceEnv(tenv, max_steps=25, device="cpu")
    jg._state, jg._steps = jstate, 0
    js = jax.tree_util.tree_map(lambda v: np.asarray(v)[None], jstate)
    tg._state, tg._steps = interop.env_states_from_jax(tenv, js), 0
    return jg, tg, np.asarray(jobs)


GYM_CASES = [("CartPole", 30, 1e-6), ("Pendulum", 30, 1e-6), ("Hopper2D", 10, 1e-4)]


@pytest.mark.parametrize("name,steps,atol", GYM_CASES, ids=[c[0] for c in GYM_CASES])
def test_gym_adapter_steps_match_jax(name, steps, atol):
    """Observations, rewards, done and truncation at max_steps (25) from
    the same injected state and the same actions."""
    jenv, tenv = getattr(jenvs, name)(), getattr(tenvs, name)()
    jg, tg, _ = _inject(jenv, tenv, seed=3)
    rng = np.random.default_rng(0)
    for t in range(steps):
        a = (int(rng.integers(0, 2)) if jenv.discrete
             else rng.uniform(-1, 1, jenv.action_dim).astype(np.float32))
        jo, jr, jd, jt, _ = jg.step(a)
        to, tr, td, tt, _ = tg.step(a)
        assert to.dtype == np.float32 and to.shape == (tenv.obs_dim,)
        np.testing.assert_allclose(to, jo, rtol=0, atol=atol, err_msg=f"{name} step {t}")
        assert tr == pytest.approx(jr, rel=1e-5, abs=atol), (name, t)
        assert (td, tt) == (jd, jt), (name, t)
        assert tt == (t + 1 >= 25)


@pytest.mark.parametrize("name", ["CartPole", "Pendulum", "Hopper2D", "MountainCarContinuous"])
def test_gym_adapter_spaces_and_errors_match_jax(name):
    """Spaces and bounds, the step-before-reset error, max_steps=0 and the
    default horizon, and a seeded reset that repeats."""
    jenv, tenv = getattr(jenvs, name)(), getattr(tenvs, name)()
    jg, tg = GymFromJax(jenv), GymFromDeviceEnv(tenv, device="cpu")
    assert type(tg.action_space) is type(jg.action_space)
    assert tg.action_space == jg.action_space
    assert tg.observation_space == jg.observation_space
    assert tg._max_steps == jg._max_steps == tenv.default_horizon
    with pytest.raises(RuntimeError, match="before calling env.reset"):
        tg.step(tg.action_space.sample())
    with pytest.raises(RuntimeError, match="before calling env.reset"):
        jg.step(jg.action_space.sample())
    zero = GymFromDeviceEnv(tenv, max_steps=0, device="cpu")
    zero.reset()
    assert zero.step(zero.action_space.sample())[3] is True
    o1, _ = tg.reset(seed=7)
    o2, _ = tg.reset(seed=7)
    np.testing.assert_array_equal(o1, o2)
    assert tg.observation_space.contains(o1)


def test_package_import_needs_no_gymnasium():
    """The card machine has no gymnasium: importing the package, its recipes
    and the host backend must not import it (only ``envs/gym_adapter.py``
    and the gym pools do, when used)."""
    code = ("import sys, estorch_tpu_torch, estorch_tpu_torch.configs, estorch_tpu_torch.host\n"
            "sys.exit(1 if 'gymnasium' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --------------------------------------------------------------- recipes


def _layout(policy) -> list:
    return [(n, tuple(p.shape)) for n, p in policy.named_parameters()] + \
        [(n, tuple(b.shape)) for n, b in policy.named_buffers()]


@pytest.mark.parametrize("name", ["halfcheetah_vbn", "humanoid_mirrored"])
def test_host_recipes_take_the_jax_layout_and_options(name):
    """The port's host recipes build the JAX recipes' torch policy (names,
    shapes, VBN buffers) with the same hyperparameters, on the host backend."""
    pop = 8 if name == "halfcheetah_vbn" else 10000
    over = {"population_size": pop} if name == "halfcheetah_vbn" else {}
    tes = getattr(configs, name)(device="cpu", **over)
    jes = getattr(jconfigs, name)(**over)
    try:
        assert tes.backend == jes.backend == "host"
        assert _layout(tes.engine.master) == _layout(jes.engine.master)
        for attr in ("population_size", "sigma", "weight_decay", "mirrored", "dim",
                     "table_size"):
            assert getattr(tes.engine, attr) == getattr(jes.engine, attr), attr
        assert type(tes.engine.optimizer) is type(jes.engine.optimizer) is torch.optim.Adam
        assert tes.engine._optimizer_kwargs == jes.engine._optimizer_kwargs == {"lr": 1e-2}
        assert tes.population_size == pop and tes.sigma == 0.02
        if name == "halfcheetah_vbn":
            assert bool(tes.engine.master.net[1].initialized)  # frozen by the recipe
    finally:
        tes.engine.close()
        jes.engine.close()


def test_halfcheetah_vbn_trains_one_generation():
    """One generation at population 8 on HalfCheetah-v5, device="cpu": each
    member runs the env's 1000 steps with the frozen VBN policy."""
    es = configs.halfcheetah_vbn(population_size=8, device="cpu")
    p0 = es.state.params_flat.clone()
    try:
        es.train(1, n_proc=2, verbose=False)
    finally:
        es.engine.close()
    rec = es.history[0]
    assert rec["n_failed"] == 0 and rec["env_steps"] == 8 * 1000
    assert np.isfinite(rec["reward_mean"]) and not torch.equal(p0, es.state.params_flat)
