"""A gymnasium ``Env`` over one of the port's device envs.

``GymFromDeviceEnv`` is the counterpart of ``GymFromJax`` in
``estorch_tpu/envs/gym_adapter.py``: a batched device env
(``envs/cartpole.py`` and the others) driven by gym-consuming code — a
reference ``Agent.rollout`` loop, an evaluation script, a video recorder —
one episode at a time, with no second env implementation.  It composes with
gymnasium's wrappers.

This module imports gymnasium, so ``envs/__init__.py`` does not import it:
``from estorch_tpu_torch.envs.gym_adapter import GymFromDeviceEnv``.
"""

from __future__ import annotations

from typing import Any

import gymnasium as gym
import numpy as np
import torch

from estorch_tpu_torch.utils.backend import resolve_device


class GymFromDeviceEnv(gym.Env):
    """gymnasium.Env over a device env (one member of its batch).

    The env steps on ``device`` (``"cuda"`` unless the caller passes
    ``device="cpu"``); observations and rewards come back as NumPy values.
    Episodes are truncated at ``max_steps`` (the env's ``default_horizon``
    when None; 0 truncates at the first step).  Initial states come from a
    ``torch.Generator`` on ``device``, seeded by ``seed`` or by
    ``reset(seed=...)``.
    """

    metadata: dict = {"render_modes": []}
    render_mode = None

    def __init__(self, env: Any, seed: int = 0, max_steps: int | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self._env = env
        self._device = resolve_device(device)
        self._generator = torch.Generator(device=self._device).manual_seed(int(seed))
        self._state: torch.Tensor | None = None
        self._steps = 0
        self._max_steps = int(env.default_horizon) if max_steps is None else int(max_steps)
        if env.discrete:
            self.action_space = gym.spaces.Discrete(env.action_dim)
        else:
            # the env's bounds where declared (action_bound), unbounded otherwise
            bound = float(getattr(env, "action_bound", np.inf))
            self.action_space = gym.spaces.Box(low=-bound, high=bound, shape=(env.action_dim,),
                                               dtype=np.float32)
        self.observation_space = gym.spaces.Box(low=-np.inf, high=np.inf, shape=(env.obs_dim,),
                                                dtype=np.float32)

    def reset(self, *, seed: int | None = None, options=None):
        if seed is not None:
            self._generator.manual_seed(int(seed))
        self._state, obs = self._env.reset(self._generator, 1)
        self._steps = 0
        return obs[0].cpu().numpy().astype(np.float32), {}

    def step(self, action):
        if self._state is None:
            raise RuntimeError("Cannot call env.step() before calling env.reset()")
        if self._env.discrete:
            a = torch.tensor([int(np.asarray(action).reshape(()))], device=self._device)
        else:
            a = torch.as_tensor(np.asarray(action, np.float32),
                                device=self._device).reshape(1, -1)
        self._state, obs, reward, done = self._env.step(self._state, a)
        self._steps += 1
        truncated = self._steps >= self._max_steps
        return (obs[0].cpu().numpy().astype(np.float32), float(reward[0]), bool(done[0]),
                bool(truncated), {})

    def close(self) -> None:
        pass
