"""ctypes bindings for the C++ envpool, and its NumPy plain version.

Counterpart of ``estorch_tpu/envs/native_pool.py``.  N envs step in
parallel C++ threads (``native/envpool.cpp``, a copy of the JAX package's
source) while the card runs one batched policy forward for the whole
population.  Env ids: CartPole 0, Pendulum 1, Pong84 2.

The library is built at first use with ``g++`` (the JAX package's
Makefile flags) into ``build/estorch_tpu_torch/`` at the repository root,
named by a hash of the source and flags, under a file lock and through an
atomic rename, so concurrent processes build it once and never load half a
file.  There is no silent fallback: a failed build raises with the
compiler's output.  :class:`NumpyEnvPool` is the plain version that the
tests hold the C++ pool against; nothing picks it in place of the C++ one.

Each env's RNG is seeded by its index (``Pool::Pool``), so one seed gives
the same streams in both packages whatever the thread count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR, note_library_load

SOURCE = Path(__file__).resolve().parents[1] / "native" / "envpool.cpp"
# estorch_tpu/native/Makefile's flags: a portable ISA, since the library may
# be loaded on another CPU than the one that built it
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
CXX_TIMEOUT_S = 300

ENV_IDS = {"cartpole": 0, "pendulum": 1, "pong84": 2}
# policy-facing observation shape; differs from the flat buffer for pixels
_OBS_SHAPES = {0: (4,), 1: (3,), 2: (84, 84, 1)}
_OBS_DIMS = {k: int(np.prod(v)) for k, v in _OBS_SHAPES.items()}
_ACT_DIMS = {0: 1, 1: 1, 2: 1}
_DISCRETE = {0: True, 1: False, 2: True}
_N_ACTIONS = {0: 2, 1: 0, 2: 3}  # discrete action count (0 = continuous)


def env_spec(env_name: str) -> dict:
    """Static facts about a pool env, without building a pool."""
    if env_name not in ENV_IDS:
        raise ValueError(f"unknown env {env_name!r}; available: {sorted(ENV_IDS)}")
    eid = ENV_IDS[env_name]
    return {
        "env_id": eid,
        "obs_dim": _OBS_DIMS[eid],
        "obs_shape": _OBS_SHAPES[eid],
        "act_dim": _ACT_DIMS[eid],
        "discrete": _DISCRETE[eid],
        "n_actions": _N_ACTIONS[eid],
    }


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libenvpool-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/envpool.cpp`` unless the hashed library exists.

    Concurrent processes (test workers) serialize on a lock file; the loser
    finds the winner's library on its second look.  Raises
    ``RuntimeError`` with the compiler's stderr when the build fails.
    """
    import fcntl

    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "envpool.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
               "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=CXX_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"envpool build failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"envpool build failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


_library: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """The envpool library, built on first call and kept for the process."""
    global _library
    if _library is None:
        cached = library_path().exists()
        t0 = time.perf_counter()
        path = build()
        t1 = time.perf_counter()
        lib = ctypes.CDLL(str(path))
        lib.envpool_create.restype = ctypes.c_void_p
        lib.envpool_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_uint64]
        lib.envpool_destroy.restype = None
        lib.envpool_destroy.argtypes = [ctypes.c_void_p]
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.envpool_reset.restype = None
        lib.envpool_reset.argtypes = [ctypes.c_void_p, f32p]
        lib.envpool_step.restype = None
        lib.envpool_step.argtypes = [ctypes.c_void_p, f32p, f32p, f32p,
                                     ctypes.POINTER(ctypes.c_uint8)]
        _library = lib
        # a compile in the port's sense (ops/_build.py): the build's
        # seconds (0.0 on a hash hit) and the dlopen's
        note_library_load("envpool", 0.0 if cached else t1 - t0, time.perf_counter() - t1,
                          cached, path)
    return _library


class _PoolFacts:
    """The static facts of a pool env as attributes."""

    def _set_facts(self, env: str, n_envs: int) -> None:
        spec = env_spec(env)
        self.env_name = env
        self.env_id = spec["env_id"]
        self.n_envs = int(n_envs)
        self.obs_dim = spec["obs_dim"]
        self.obs_shape = spec["obs_shape"]
        self.act_dim = spec["act_dim"]
        self.discrete = spec["discrete"]
        self.n_actions = spec["n_actions"]


class NativeEnvPool(_PoolFacts):
    """N batched envs stepped by the C++ thread pool.

    All arrays are (n_envs, ...) float32::

        obs = pool.reset()
        obs, rew, done = pool.step(actions)   # auto-resets finished envs
    """

    def __init__(self, env: str, n_envs: int, n_threads: int = 0, seed: int = 0):
        self._handle = None
        self._set_facts(env, n_envs)
        if self.n_envs <= 0:
            raise ValueError(f"n_envs must be positive, got {n_envs}")
        n_threads = n_threads or min(os.cpu_count() or 1, 16)
        self._lib = load_library()
        self._handle = self._lib.envpool_create(self.env_id, self.n_envs, int(n_threads),
                                                int(seed))
        if not self._handle:
            raise RuntimeError(f"envpool_create({env!r}, {n_envs}) failed")
        self._obs = np.empty((self.n_envs, self.obs_dim), np.float32)
        self._rew = np.empty((self.n_envs,), np.float32)
        self._done = np.empty((self.n_envs,), np.uint8)

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def _check_open(self) -> None:
        if self._handle is None:
            raise RuntimeError("the pool is closed")

    def reset(self) -> np.ndarray:
        self._check_open()
        self._lib.envpool_reset(self._handle,
                                self._obs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return self._obs.copy()

    def step(self, actions: np.ndarray):
        self._check_open()
        acts = np.ascontiguousarray(
            np.asarray(actions, np.float32).reshape(self.n_envs, self.act_dim))
        f32p = ctypes.POINTER(ctypes.c_float)
        self._lib.envpool_step(
            self._handle,
            acts.ctypes.data_as(f32p),
            self._obs.ctypes.data_as(f32p),
            self._rew.ctypes.data_as(f32p),
            self._done.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return self._obs.copy(), self._rew.copy(), self._done.astype(bool)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.envpool_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NumpyEnvPool(_PoolFacts):
    """Vectorized NumPy twin of the C++ pool for CartPole and Pendulum: the
    same dynamics and auto-reset, its own reset stream (``default_rng``).
    Its ``state`` can be set to the C++ pool's, as the tests do."""

    def __init__(self, env: str, n_envs: int, seed: int = 0):
        self._set_facts(env, n_envs)
        if self.env_id not in (0, 1):
            raise ValueError(f"NumpyEnvPool implements cartpole and pendulum, not {env!r}")
        self.rng = np.random.default_rng(seed)
        self.state: np.ndarray | None = None

    @property
    def is_native(self) -> bool:
        return False

    def reset(self) -> np.ndarray:
        n = self.n_envs
        if self.env_id == 0:
            self.state = self.rng.uniform(-0.05, 0.05, (n, 4)).astype(np.float32)
            return self.state.copy()
        th = self.rng.uniform(-np.pi, np.pi, n).astype(np.float32)
        thdot = self.rng.uniform(-1.0, 1.0, n).astype(np.float32)
        self.state = np.stack([th, thdot], 1)
        return self._pendulum_obs()

    def _reset_rows(self, rows: np.ndarray) -> None:
        k = int(rows.sum())
        if k == 0:
            return
        if self.env_id == 0:
            self.state[rows] = self.rng.uniform(-0.05, 0.05, (k, 4)).astype(np.float32)
        else:
            th = self.rng.uniform(-np.pi, np.pi, k)
            thdot = self.rng.uniform(-1.0, 1.0, k)
            self.state[rows] = np.stack([th, thdot], 1).astype(np.float32)

    def _pendulum_obs(self) -> np.ndarray:
        th, thdot = self.state[:, 0], self.state[:, 1]
        return np.stack([np.cos(th), np.sin(th), thdot], 1).astype(np.float32)

    def step(self, actions: np.ndarray):
        n = self.n_envs
        a = np.asarray(actions, np.float32).reshape(n, -1)
        if self.env_id == 0:
            g, mc, mp, l, fm, tau = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
            x, x_dot, th, th_dot = (self.state[:, i] for i in range(4))
            force = np.where(a[:, 0] > 0.5, fm, -fm)
            costh, sinth = np.cos(th), np.sin(th)
            tm = mc + mp
            pml = mp * l
            temp = (force + pml * th_dot**2 * sinth) / tm
            thacc = (g * sinth - costh * temp) / (l * (4.0 / 3.0 - mp * costh**2 / tm))
            xacc = temp - pml * thacc * costh / tm
            self.state = np.stack(
                [x + tau * x_dot, x_dot + tau * xacc, th + tau * th_dot, th_dot + tau * thacc],
                1).astype(np.float32)
            done = (np.abs(self.state[:, 0]) > 2.4) | (np.abs(self.state[:, 2]) > 12 * 2 * np.pi / 360)
            rew = np.ones(n, np.float32)
            self._reset_rows(done)
            return self.state.copy(), rew, done
        ms, mt, dt, g, m, l = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0
        th, thdot = self.state[:, 0], self.state[:, 1]
        u = np.clip(a[:, 0], -mt, mt)
        an = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = an**2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = np.clip(thdot + (3 * g / (2 * l) * np.sin(th) + 3.0 / (m * l**2) * u) * dt,
                           -ms, ms)
        self.state = np.stack([th + newthdot * dt, newthdot], 1).astype(np.float32)
        return self._pendulum_obs(), (-cost).astype(np.float32), np.zeros(n, bool)

    def close(self) -> None:
        pass
