"""ALE-standard preprocessing for the pooled path: stack, repeat, sticky.

Counterpart of ``estorch_tpu/envs/atari_wrappers.py``, NumPy, with the
same semantics step for step:

- **frame stacking**: the policy sees the last N macro-frames along the
  channel axis, (84, 84, 1) → (84, 84, 4), NatureCNN's input;
- **action repeat**: each action is applied for K raw steps, rewards
  summed, those after an env's first done within the repeat masked out
  (they belong to the auto-reset successor episode);
- **sticky actions**: with probability ς an env repeats its previous
  macro-action, drawn from ``default_rng(seed ^ 0xA7A21)``;
- **2-frame max-pooling** (``max_pool2``): the max of the last two raw
  frames of a repeat.

An env that finished in a macro-step gets its whole stack refilled with
its fresh frame at the next macro-step.  ``is_native`` is a property here,
as on the pools (the JAX wrapper has it as a method).
"""

from __future__ import annotations

import numpy as np


class AtariPreprocessPool:
    """Wrap any pool with frame stack, action repeat and sticky actions."""

    def __init__(self, pool, frame_stack: int = 4, action_repeat: int = 1,
                 sticky_prob: float = 0.0, max_pool2: bool = False, seed: int = 0):
        if frame_stack < 1 or action_repeat < 1:
            raise ValueError(
                f"frame_stack and action_repeat must be ≥1, got {frame_stack}/{action_repeat}")
        if not 0.0 <= sticky_prob < 1.0:
            raise ValueError(f"sticky_prob must be in [0, 1), got {sticky_prob}")
        if max_pool2 and action_repeat < 2:
            raise ValueError("max_pool2 needs action_repeat ≥ 2 (it maxes the last two raw "
                             "frames of a repeat)")
        self._pool = pool
        self.frame_stack = int(frame_stack)
        self.action_repeat = int(action_repeat)
        self.sticky_prob = float(sticky_prob)
        self.max_pool2 = bool(max_pool2)
        self._rng = np.random.default_rng(seed ^ 0xA7A21)

        self.env_name = getattr(pool, "env_name", "?")
        self.n_envs = pool.n_envs
        self.discrete = pool.discrete
        self.n_actions = pool.n_actions
        self.act_dim = pool.act_dim
        base_shape = tuple(pool.obs_shape)
        if len(base_shape) == 1:  # vector obs: stack along a trailing axis
            base_shape = base_shape + (1,)
        self._base_shape = base_shape
        self.obs_shape = base_shape[:-1] + (base_shape[-1] * self.frame_stack,)
        self.obs_dim = int(np.prod(self.obs_shape))

        self._stack = np.zeros((self.n_envs,) + self.obs_shape, np.float32)
        self._prev_action: np.ndarray | None = None
        self._pending_refill = np.zeros(self.n_envs, bool)

    @property
    def is_native(self) -> bool:
        return bool(self._pool.is_native)

    def _push(self, frames: np.ndarray, refill_mask=None) -> np.ndarray:
        """Shift the ring one macro-frame left and append ``frames``."""
        c = self._base_shape[-1]
        frames = frames.reshape((self.n_envs,) + self._base_shape)
        if refill_mask is not None and refill_mask.any():
            # envs that auto-reset since the last macro-step: their history is
            # the dead episode's, so every slot gets the fresh frame
            self._stack[refill_mask] = np.concatenate([frames[refill_mask]] * self.frame_stack,
                                                      -1)
            live = ~refill_mask
            self._stack[live, ..., :-c] = self._stack[live, ..., c:]
            self._stack[live, ..., -c:] = frames[live]
        else:
            self._stack[..., :-c] = self._stack[..., c:]
            self._stack[..., -c:] = frames
        return self._stack.reshape(self.n_envs, self.obs_dim).copy()

    def reset(self) -> np.ndarray:
        obs = self._pool.reset().reshape((self.n_envs,) + self._base_shape)
        self._stack = np.concatenate([obs] * self.frame_stack, -1)
        self._prev_action = None
        self._pending_refill[:] = False
        return self._stack.reshape(self.n_envs, self.obs_dim).copy()

    def step(self, actions: np.ndarray):
        a = np.asarray(actions, np.float32).reshape(self.n_envs, -1)
        if self.sticky_prob and self._prev_action is not None:
            sticky = self._rng.random(self.n_envs) < self.sticky_prob
            a = np.where(sticky[:, None], self._prev_action, a)
        self._prev_action = a.copy()

        total_rew = np.zeros(self.n_envs, np.float32)
        done = np.zeros(self.n_envs, bool)
        prev_frame = frame = None
        for k in range(self.action_repeat):
            frame, rew, d = self._pool.step(a)
            total_rew += np.where(done, 0.0, rew)
            done |= np.asarray(d, bool)
            if self.max_pool2 and k == self.action_repeat - 2:
                prev_frame = frame
        if prev_frame is not None:
            frame = np.maximum(frame, prev_frame)

        refill = self._pending_refill
        obs = self._push(frame, refill_mask=refill if refill.any() else None)
        self._pending_refill = done.copy()
        return obs, total_rew, done

    def close(self) -> None:
        self._pool.close()


def apply_prep_to_spec(spec: dict, frame_stack: int = 4) -> dict:
    """A pool spec with the wrapper's stacked observation shape."""
    base = tuple(spec["obs_shape"])
    if len(base) == 1:
        base = base + (1,)
    shape = base[:-1] + (base[-1] * int(frame_stack),)
    return dict(spec, obs_shape=shape, obs_dim=int(np.prod(shape)))
