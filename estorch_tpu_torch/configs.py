"""Ready-to-run recipes, counterpart of ``estorch_tpu/configs.py``.

The device recipes run here with the JAX package's options and defaults:

- ``cartpole_smoke``     — CartPole-v1, MLP (32, 32), vanilla ES, pop 64;
- ``swimmer2d_device``, ``hopper2d_device``, ``walker2d_device``,
  ``humanoid2d_device``, ``cheetah2d_device`` — the planar locomotion envs
  (``envs/locomotion.py``), physics on the card, MLP policy, Adam;
- ``humanoid2d_pop10k``  — Humanoid2D at population 10240, MLP (256, 256),
  rank-1 noise, obs normalization with 4 probe episodes, chunks of 1024.

Every recipe takes ``**over`` to override any ``ES`` argument, ``device``
included.  The host, pooled, novelty and Atari recipes of the JAX package
raise ``NotImplementedError`` naming their ``ROADMAP.md`` port item.

Use:  python -m estorch_tpu_torch.configs <name> [--generations N]
      [--population P] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable

from .algo import ES
from .envs import CartPole, Cheetah2D, DeviceAgent, Hopper2D, Humanoid2D, Swimmer2D, Walker2D
from .models import MLPPolicy
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


def _not_ported(name: str, item: str) -> Callable[..., ES]:
    def recipe(**over) -> ES:
        raise NotImplementedError(
            f"the {name} recipe is not ported yet (ROADMAP.md, port queue item: {item})")

    recipe.__name__ = name
    return recipe


_HOST_POOLED = "2, the host and pooled backends"
_NOVELTY = "4, the novelty family"

CONFIGS: dict[str, Callable[..., ES]] = {
    "cartpole_smoke": cartpole_smoke,
    "swimmer2d_device": swimmer2d_device,
    "hopper2d_device": hopper2d_device,
    "walker2d_device": walker2d_device,
    "humanoid2d_device": humanoid2d_device,
    "humanoid2d_pop10k": humanoid2d_pop10k,
    "cheetah2d_device": cheetah2d_device,
    # host agents on gymnasium MuJoCo (VBN: item 3)
    "halfcheetah_vbn": _not_ported("halfcheetah_vbn", _HOST_POOLED),
    "humanoid_mirrored": _not_ported("humanoid_mirrored", _HOST_POOLED),
    "humanoid_nsres": _not_ported("humanoid_nsres", _NOVELTY),
    "halfcheetah_pooled": _not_ported("halfcheetah_pooled", _HOST_POOLED),
    "halfcheetah_nsres": _not_ported("halfcheetah_nsres", _NOVELTY),
    "humanoid_pooled": _not_ported("humanoid_pooled", _HOST_POOLED),
    # the pooled C++ pixel pong and Atari (NatureCNN: item 3)
    "pong84_conv": _not_ported("pong84_conv", _HOST_POOLED),
    "atari_frostbite": _not_ported("atari_frostbite", _HOST_POOLED),
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
