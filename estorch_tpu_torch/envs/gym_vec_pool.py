"""Gymnasium vector-env pool with the ``NativeEnvPool`` interface.

Counterpart of ``estorch_tpu/envs/gym_vec_pool.py``: any gymnasium env
(MuJoCo included) rides the pooled path through the ``gym:`` prefix,
``PooledAgent(env_name="gym:HalfCheetah-v5")``.  gymnasium is imported
inside these functions only, so the package imports where it is absent.

One documented difference from the C++ pool: gymnasium ≥ 1.0 vector envs
auto-reset in NEXT_STEP mode, so on the done step they return the terminal
observation (the C++ pool returns the fresh reset state).  The pooled
engine stops reading an env after its done, so both evaluate alike.
``asynchronous`` defaults to one forked worker per env when there are
enough cores, as in the JAX package.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

_NATIVE_KWARGS = ("env_kwargs only apply to gym: envs; {!r} is an in-tree native env "
                  "with a fixed construction")


class GymVecPool:
    """N gymnasium envs behind the pool interface (auto-reset semantics)."""

    def __init__(self, env_id: str, n_envs: int, n_threads: int = 0, seed: int = 0,
                 asynchronous: bool | None = None, env_kwargs: dict | None = None):
        import gymnasium as gym

        self.env_name = f"gym:{env_id}"
        self.env_kwargs = dict(env_kwargs or {})
        self.n_envs = int(n_envs)
        if n_threads:
            warnings.warn(
                f"n_threads={n_threads} has no effect on gym: envs (it tunes the C++ native "
                "pool); gym.vector parallelism is controlled by `asynchronous` instead",
                stacklevel=3)
        if asynchronous is None:
            cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
                     else (os.cpu_count() or 1))
            asynchronous = cores > 1 and 1 < self.n_envs <= 2 * cores
        ctor = gym.vector.AsyncVectorEnv if asynchronous else gym.vector.SyncVectorEnv
        self._vec = ctor([self._make_one(env_id, self.env_kwargs) for _ in range(self.n_envs)])
        self._seed = int(seed)
        self._seeded = False

        obs_space = self._vec.single_observation_space
        act_space = self._vec.single_action_space
        self.obs_shape = tuple(obs_space.shape)
        self.obs_dim = int(np.prod(self.obs_shape))
        if hasattr(act_space, "n"):  # Discrete
            self.discrete, self.n_actions, self.act_dim = True, int(act_space.n), 1
        else:
            self.discrete, self.n_actions = False, 0
            self.act_dim = int(np.prod(act_space.shape))
        self._act_shape = tuple(getattr(act_space, "shape", ()) or ())

    @staticmethod
    def _make_one(env_id: str, env_kwargs: dict):
        def thunk():
            import gymnasium as gym

            return gym.make(env_id, **env_kwargs)

        return thunk

    @property
    def is_native(self) -> bool:
        return False

    def reset(self) -> np.ndarray:
        # seed only once: later resets continue the envs' streams, so every
        # generation draws fresh initial states, as the C++ pool's do
        if not self._seeded:
            obs, _ = self._vec.reset(seed=self._seed)
            self._seeded = True
        else:
            obs, _ = self._vec.reset()
        return np.asarray(obs, np.float32).reshape(self.n_envs, self.obs_dim)

    def step(self, actions: np.ndarray):
        a = np.asarray(actions)
        if self.discrete:
            a = a.reshape(self.n_envs).astype(np.int64)
        else:
            a = a.reshape((self.n_envs,) + self._act_shape).astype(np.float32)
        obs, rew, term, trunc, _ = self._vec.step(a)
        done = np.asarray(term) | np.asarray(trunc)
        return (np.asarray(obs, np.float32).reshape(self.n_envs, self.obs_dim),
                np.asarray(rew, np.float32), done)

    def close(self) -> None:
        self._vec.close()


def make_pool(env_name: str, n_envs: int, n_threads: int = 0, seed: int = 0,
              env_kwargs: dict | None = None):
    """``gym:<EnvId>`` → :class:`GymVecPool`, else the C++ ``NativeEnvPool``.
    ``env_kwargs`` go to ``gym.make``; the native envs take none."""
    if env_name.startswith("gym:"):
        return GymVecPool(env_name[4:], n_envs, n_threads=n_threads, seed=seed,
                          env_kwargs=env_kwargs)
    if env_kwargs:
        raise ValueError(_NATIVE_KWARGS.format(env_name))
    from .native_pool import NativeEnvPool

    return NativeEnvPool(env_name, n_envs, n_threads=n_threads, seed=seed)


def pool_env_spec(env_name: str, env_kwargs: dict | None = None) -> dict:
    """``env_spec`` for both pool families.  Rejects ``env_kwargs`` for
    native envs here too: ES reads the spec before it builds a pool."""
    if env_name.startswith("gym:"):
        import gymnasium as gym

        env = gym.make(env_name[4:], **(env_kwargs or {}))
        obs_shape = tuple(env.observation_space.shape)
        act = env.action_space
        spec = {
            "obs_dim": int(np.prod(obs_shape)),
            "obs_shape": obs_shape,
            "discrete": hasattr(act, "n"),
            "n_actions": int(getattr(act, "n", 0)),
            "act_dim": 1 if hasattr(act, "n") else int(np.prod(act.shape)),
        }
        env.close()
        return spec
    if env_kwargs:
        raise ValueError(_NATIVE_KWARGS.format(env_name))
    from .native_pool import env_spec

    return env_spec(env_name)
