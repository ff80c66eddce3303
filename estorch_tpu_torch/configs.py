"""Ready-to-run recipes, counterpart of ``estorch_tpu/configs.py``.

The device recipes run here with the JAX package's options and defaults:

- ``cartpole_smoke``     — CartPole-v1, MLP (32, 32), vanilla ES, pop 64;
- ``swimmer2d_device``, ``hopper2d_device``, ``walker2d_device``,
  ``humanoid2d_device``, ``cheetah2d_device`` — the planar locomotion envs
  (``envs/locomotion.py``), physics on the card, MLP policy, Adam;
- ``humanoid2d_pop10k``  — Humanoid2D at population 10240, MLP (256, 256),
  rank-1 noise, obs normalization with 4 probe episodes, chunks of 1024.

The pooled recipes (``PooledAgent``: host envs, the population's forward
on the card):

- ``pong84_conv``        — NatureCNN with VBN on the C++ pixel pong
  (84×84, 4 stacked frames, action repeat 2, sticky actions 0.25), pop 256;
- ``halfcheetah_pooled``, ``humanoid_pooled`` — gymnasium MuJoCo in
  ``gym.vector`` workers (wherever gymnasium and MuJoCo are installed);
- ``atari_frostbite``    — gated on ``ale_py``, as in the JAX package.

Every recipe takes ``**over`` to override any ``ES`` argument, ``device``
included.  The host and novelty recipes of the JAX package raise
``NotImplementedError`` naming their ``ROADMAP.md`` port item.

Use:  python -m estorch_tpu_torch.configs <name> [--generations N]
      [--population P] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable

from .algo import ES
from .envs import (CartPole, Cheetah2D, DeviceAgent, Hopper2D, Humanoid2D, PooledAgent,
                   Swimmer2D, Walker2D)
from .models import MLPPolicy, NatureCNN
from .optim import adam


def cartpole_smoke(**over) -> ES:
    """Device-native CartPole ES, population 64."""
    kw = dict(
        policy=MLPPolicy,
        agent=DeviceAgent,
        optimizer=adam,
        population_size=64,
        sigma=0.1,
        policy_kwargs={"action_dim": 2, "hidden": (32, 32)},
        agent_kwargs={"env": CartPole()},
        optimizer_kwargs={"learning_rate": 3e-2},
    )
    kw.update(over)
    return ES(**kw)


def _planar_device(env, population, hidden, horizon, lr, over, sigma=0.08) -> ES:
    """The locomotion recipes' body: MLP policy, physics on the device."""
    kw = dict(
        policy=MLPPolicy,
        agent=DeviceAgent,
        optimizer=adam,
        population_size=population,
        sigma=sigma,
        policy_kwargs={"action_dim": env.action_dim, "hidden": hidden,
                       "discrete": False, "action_scale": 1.0},
        agent_kwargs={"env": env, "horizon": horizon},
        optimizer_kwargs={"learning_rate": lr},
    )
    kw.update(over)
    return ES(**kw)


def swimmer2d_device(**over) -> ES:
    """Planar swimmer: contact-free, the easiest locomotion task."""
    return _planar_device(Swimmer2D(), 512, (32, 32), 300, 3e-2, over)


def hopper2d_device(**over) -> ES:
    """Planar hopper: contact and falling termination."""
    return _planar_device(Hopper2D(), 1024, (64, 64), 400, 2e-2, over)


def walker2d_device(**over) -> ES:
    """Planar biped walker: two-legged balance and gait."""
    return _planar_device(Walker2D(), 1024, (64, 64), 400, 2e-2, over)


def humanoid2d_device(**over) -> ES:
    """Planar humanoid (11 bodies, 10 joints), with obs normalization and 4
    probe episodes a generation on by default, as in the JAX recipe (pass
    ``obs_norm=False`` for the raw-observation variant)."""
    return _planar_device(Humanoid2D(), 1024, (64, 64), 400, 2e-2,
                          {"obs_norm": True, "obs_probe_episodes": 4, **over})


def cheetah2d_device(**over) -> ES:
    """Planar 7-body runner (HalfCheetah-class)."""
    return _planar_device(Cheetah2D(), 1024, (64, 64), 500, 2e-2, over)


def humanoid2d_pop10k(**over) -> ES:
    """Humanoid2D at population 10240 with a Humanoid-sized policy (256×256):
    rank-1 noise, obs normalization with 4 probe episodes, and chunks of
    1024 members to bound the materialized member weights."""
    return _planar_device(Humanoid2D(), 10240, (256, 256), 400, 2e-2,
                          {"low_rank": 1, "obs_norm": True, "obs_probe_episodes": 4,
                           "eval_chunk": 1024, **over})


def halfcheetah_pooled(**over) -> ES:
    """HalfCheetah physics in ``gym.vector`` workers, the population's MLP
    forwards on the card; pass ``obs_norm=True`` for the OpenAI-ES MuJoCo
    setup."""
    kw = dict(
        policy=MLPPolicy,
        agent=PooledAgent,
        optimizer=adam,
        population_size=1000,
        sigma=0.02,
        policy_kwargs={"action_dim": 6, "hidden": (64, 64), "discrete": False},
        agent_kwargs={"env_name": "gym:HalfCheetah-v5", "horizon": 1000},
        optimizer_kwargs={"learning_rate": 1e-2},
        weight_decay=0.005,
    )
    kw.update(over)
    return ES(**kw)


def humanoid_pooled(**over) -> ES:
    """Humanoid-v5 physics in ``gym.vector`` workers: MLP 348 → 256×256 →
    17, actions squashed to the env's ±0.4, mirrored sampling, obs
    normalization; population 512 (pass ``population_size=10000`` for the
    full scale)."""
    kw = dict(
        policy=MLPPolicy,
        agent=PooledAgent,
        optimizer=adam,
        population_size=512,
        sigma=0.02,
        policy_kwargs={"action_dim": 17, "hidden": (256, 256), "discrete": False,
                       "action_scale": 0.4},
        agent_kwargs={"env_name": "gym:Humanoid-v5", "horizon": 1000},
        optimizer_kwargs={"learning_rate": 1e-2},
        weight_decay=0.005,
        obs_norm=True,
    )
    kw.update(over)
    return ES(**kw)


def pong84_conv(**over) -> ES:
    """NatureCNN with VBN on the bundled C++ pixel pong (84×84), with the
    Atari preprocessing (4 stacked frames → the CNN's 84×84×4 input, action
    repeat 2, sticky actions 0.25): the pooled conv path without ALE."""
    kw = dict(
        policy=NatureCNN,
        agent=PooledAgent,
        optimizer=adam,
        population_size=256,
        sigma=0.02,
        policy_kwargs={"action_dim": 3, "use_vbn": True},
        agent_kwargs={"env_name": "pong84", "horizon": 500, "frame_stack": 4,
                      "action_repeat": 2, "sticky_prob": 0.25},
        optimizer_kwargs={"learning_rate": 1e-2},
        table_size=1 << 23,
    )
    kw.update(over)
    return ES(**kw)


def atari_frostbite(**over) -> ES:
    """Frostbite, Nature CNN, pop 5k: gated on ``ale_py``, as in the JAX
    package."""
    try:
        import ale_py  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "the Atari config needs ale_py, which is not installed; the NatureCNN policy "
            "and the pooled path are ready for it once ALE is available") from e
    raise NotImplementedError("wire up ALE via PooledAgent once available")


def _not_ported(name: str, item: str) -> Callable[..., ES]:
    def recipe(**over) -> ES:
        raise NotImplementedError(
            f"the {name} recipe is not ported yet (ROADMAP.md, port queue item: {item})")

    recipe.__name__ = name
    return recipe


_HOST = "2, the host backend"
_NOVELTY = "4, the novelty family"

CONFIGS: dict[str, Callable[..., ES]] = {
    "cartpole_smoke": cartpole_smoke,
    "swimmer2d_device": swimmer2d_device,
    "hopper2d_device": hopper2d_device,
    "walker2d_device": walker2d_device,
    "humanoid2d_device": humanoid2d_device,
    "humanoid2d_pop10k": humanoid2d_pop10k,
    "cheetah2d_device": cheetah2d_device,
    # host agents on gymnasium MuJoCo
    "halfcheetah_vbn": _not_ported("halfcheetah_vbn", _HOST),
    "humanoid_mirrored": _not_ported("humanoid_mirrored", _HOST),
    "humanoid_nsres": _not_ported("humanoid_nsres", _NOVELTY),
    "halfcheetah_pooled": halfcheetah_pooled,
    "halfcheetah_nsres": _not_ported("halfcheetah_nsres", _NOVELTY),
    "humanoid_pooled": humanoid_pooled,
    "pong84_conv": pong84_conv,
    "atari_frostbite": atari_frostbite,
}


def main(argv=None) -> ES:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config", choices=sorted(CONFIGS))
    p.add_argument("--generations", type=int, default=10)
    p.add_argument("--population", type=int, default=None)
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    over = {}
    if args.population:
        over["population_size"] = args.population
    if args.device:
        over["device"] = args.device
    es = CONFIGS[args.config](**over)
    es.train(args.generations)
    print(f"\nbest reward: {es.best_reward:.2f}")
    return es


if __name__ == "__main__":
    main()
