"""ES — the user-facing algorithm class.

Counterpart of ``estorch_tpu/algo/es.py``'s ``ES.__init__`` and ``train``.
The signature keeps the JAX package's names for the options this port
supports; every other option raises ``NotImplementedError`` naming its
``ROADMAP.md`` item:

    es = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=200), adam,
            population_size=4096, sigma=0.05,
            policy_kwargs={"action_dim": 1, "hidden": (64, 64),
                           "discrete": False, "action_scale": 2.0},
            optimizer_kwargs={"learning_rate": 1e-2},
            streamed=True, noise_kernel=True)
    es.train(10)

``device`` is ``"cuda"`` unless the caller passes ``"cpu"``.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from ..models.decomposed import supports_decomposed
from ..ops.noise import DEFAULT_TABLE_SIZE, make_noise_table
from ..ops.noise_kernels import flat_layer_offsets, mlp_streamed_apply
from ..ops.params import make_param_spec
from ..parallel.engine import EngineConfig, ESEngine
from ..utils.backend import resolve_device

_ROADMAP = "ROADMAP.md, port queue"
_PATHS = "1, the standard/decomposed/low_rank/obs_norm/bf16 paths"
_BACKENDS = "2, the remaining envs and the host and pooled backends"


def _instantiate(cls_or_obj, kwargs, what: str):
    if isinstance(cls_or_obj, type):
        return cls_or_obj(**kwargs)
    if kwargs:
        raise ValueError(
            f"{what}_kwargs were given alongside an already-constructed {what} "
            f"instance; they would be ignored: {kwargs}")
    return cls_or_obj


def _unsupported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({_ROADMAP} item: {item})")


class ES:
    """Vanilla OpenAI-ES (Salimans et al. 2017) on the streamed engine."""

    def __init__(
        self,
        policy,
        agent,
        optimizer,
        population_size: int = 256,
        sigma: float = 0.02,
        device: str | torch.device | None = None,
        policy_kwargs: dict | None = None,
        agent_kwargs: dict | None = None,
        optimizer_kwargs: dict | None = None,
        seed: int = 0,
        table_size: int = DEFAULT_TABLE_SIZE,
        eval_chunk: int = 0,
        weight_decay: float = 0.0,
        mesh=None,
        compute_dtype: str = "float32",
        sigma_decay: float = 1.0,
        sigma_min: float = 0.0,
        mirrored: bool = True,
        episodes_per_member: int = 1,
        decomposed: bool = False,
        noise_kernel: bool = False,
        streamed: bool = False,
        low_rank: int = 0,
        obs_norm: bool = False,
        shard_params: bool = False,
        scenarios=None,
    ):
        if not streamed:
            _unsupported("streamed=False (the standard forward)", _PATHS)
        if not noise_kernel:
            _unsupported("noise_kernel=False (the chunked plain update)", _PATHS)
        if decomposed:
            _unsupported("decomposed=True", _PATHS)
        if low_rank:
            _unsupported("low_rank", _PATHS)
        if obs_norm:
            _unsupported("obs_norm", _PATHS)
        if compute_dtype != "float32":
            _unsupported(f"compute_dtype={compute_dtype!r}", _PATHS)
        if episodes_per_member != 1:
            _unsupported("episodes_per_member != 1", _PATHS)
        if eval_chunk:
            _unsupported("eval_chunk", _PATHS)
        if shard_params or mesh is not None:
            _unsupported("shard_params / mesh", "7, multi-GPU")
        if scenarios is not None:
            _unsupported("scenarios", "8, scenarios")

        self.device = resolve_device(device)
        self.population_size = int(population_size)
        self.sigma = float(sigma)
        self.seed = int(seed)

        self.agent = _instantiate(agent, dict(agent_kwargs or {}), "agent")
        if hasattr(self.agent, "rollout"):
            _unsupported("host agents (rollout(policy))", _BACKENDS)
        if hasattr(self.agent, "env_name"):
            _unsupported("pooled agents (env_name)", _BACKENDS)
        if not hasattr(self.agent, "env"):
            raise TypeError("agent must be a DeviceAgent wrapping a batched device env")
        self.env = self.agent.env

        self.module = _instantiate(policy, dict(policy_kwargs or {}), "policy")
        if getattr(self.module, "is_recurrent", False):
            _unsupported("recurrent policies", "3, recurrent and VBN")
        if not supports_decomposed(self.module):
            raise ValueError(
                "streamed=True supports MLPPolicy without VBN "
                f"(ops/noise_kernels.py); got {type(self.module).__name__}")

        # params are drawn on the CPU and moved, so a seed gives the same
        # initial center on every device
        init_gen = torch.Generator().manual_seed(self.seed)
        params = self.module.init_params(self.env.obs_dim, init_gen)
        flat, self.spec = make_param_spec(params)
        self.table = make_noise_table(table_size, seed=self.seed, device=self.device)
        self.optimizer = _instantiate_optimizer(optimizer, optimizer_kwargs)
        self.config = EngineConfig(
            population_size=self.population_size,
            sigma=self.sigma,
            horizon=self.agent.rollout_horizon,
            weight_decay=float(weight_decay),
            sigma_decay=float(sigma_decay),
            sigma_min=float(sigma_min),
            mirrored=bool(mirrored),
            noise_kernel=True,
            streamed=True,
        )
        layer_offs = flat_layer_offsets(params)
        module = self.module

        def streamed_apply(shared, table_data, offs, c, obs):
            return mlp_streamed_apply(module, shared, table_data, offs, c, obs, layer_offs)

        self.engine = ESEngine(self.env, self.spec, self.table, self.optimizer,
                               self.config, streamed_apply, self.device)
        self.state = self.engine.init_state(flat, self.seed)
        self.best_reward = -np.inf
        self.history: list[dict] = []
        self.generation = 0

    # ------------------------------------------------------------------ train

    def train(self, n_steps: int, n_proc: int = 1,
              log_fn: Callable[[dict], None] | None = None, verbose: bool = True,
              max_consecutive_rejections: int = 3) -> "ES":
        """Run ``n_steps`` generations (``n_proc`` is accepted for API
        parity and ignored: the device batches the population).

        A generation whose population collapsed (<2 valid members) or whose
        update came out non-finite is rejected: the state is restored and
        the same generation re-runs.  Its sample is keyed on
        ``(seed, generation)``, so the re-run is bit-identical to a run that
        never faulted.  More than ``max_consecutive_rejections`` in a row
        raise.
        """
        del n_proc
        done = 0
        rejected_streak = 0
        while done < n_steps:
            t0 = time.perf_counter()
            prev_state = self.state
            self.state, metrics = self.engine.generation_step(prev_state)
            fitness = metrics["fitness"].cpu().numpy()  # waits for the device
            dt = time.perf_counter() - t0

            reason = self._update_anomaly(metrics)
            if reason is not None:
                self.state = prev_state
                rejected_streak += 1
                if rejected_streak > max_consecutive_rejections:
                    raise RuntimeError(
                        f"{reason}; {rejected_streak} consecutive generations "
                        "rejected — check env/rollout health")
                continue
            rejected_streak = 0
            record = self._record(prev_state, fitness, int(metrics["steps"]),
                                  float(metrics["grad_norm"]), dt)
            self.history.append(record)
            self.generation += 1
            if log_fn is not None:
                log_fn(record)
            elif verbose:
                print(
                    f"gen {record['generation']:4d}  max {record['reward_max']:9.2f}  "
                    f"mean {record['reward_mean']:9.2f}  best {record['best_reward']:9.2f}  "
                    f"steps/s {record['env_steps_per_sec']:,.0f}")
            done += 1
        return self

    def _update_anomaly(self, metrics: dict) -> str | None:
        """The rejection reason for a generation, or None."""
        n_valid = int(metrics["n_valid"])
        if n_valid < 2:
            return (f"only {n_valid}/{self.population_size} population members "
                    "produced valid fitness — cannot form an update")
        if not bool(metrics["update_finite"]):
            return "non-finite parameters/update norm after the optimizer step"
        return None

    def _record(self, prev_state, fitness: np.ndarray, steps: int,
                grad_norm: float, dt: float) -> dict:
        finite_any = bool(np.isfinite(fitness).any())
        gen_best = float(np.nanmax(fitness)) if finite_any else float("nan")
        improved = finite_any and gen_best > self.best_reward
        if improved:
            self.best_reward = gen_best
        return {
            "generation": self.generation,
            "reward_max": gen_best,
            "reward_mean": float(np.nanmean(fitness)) if finite_any else float("nan"),
            "reward_min": float(np.nanmin(fitness)) if finite_any else float("nan"),
            "n_failed": int(fitness.size - np.isfinite(fitness).sum()),
            "best_reward": self.best_reward,
            "improved_best": improved,
            "env_steps": steps,
            "env_steps_per_sec": steps / dt if dt > 0 else 0.0,
            "grad_norm": grad_norm,
            "sigma": float(prev_state.sigma),
            "wall_time_s": dt,
        }

    # ------------------------------------------------------------- inspection

    @property
    def policy(self):
        """The module with the current center params (reference: es.policy)."""
        return self.module.set_params(self.state.params_flat, self.spec)


def _instantiate_optimizer(optimizer: Any, optimizer_kwargs: dict | None):
    """An optimizer with ``init(params)`` / ``update(grad, state)`` (such as
    ``optim.adam``), from a factory plus kwargs or an instance."""
    kwargs = dict(optimizer_kwargs or {})
    if not isinstance(optimizer, type) and hasattr(optimizer, "init") \
            and hasattr(optimizer, "update"):
        if kwargs:
            raise ValueError(
                "optimizer_kwargs were given alongside a constructed optimizer; "
                f"they would be ignored: {kwargs}")
        return optimizer
    if callable(optimizer):
        return optimizer(**kwargs)
    raise TypeError(f"optimizer must be a factory such as optim.adam, got {optimizer!r}")
