"""ES — the user-facing algorithm class.

Counterpart of ``estorch_tpu/algo/es.py``'s ``ES.__init__`` and ``train``
on one device, for the device and pooled backends.  The signature keeps
the JAX package's names and defaults, so the default call runs the
standard forward with the chunked plain update:

    es = ES(MLPPolicy, DeviceAgent(Pendulum(), horizon=200), adam,
            population_size=4096, sigma=0.05,
            policy_kwargs={"action_dim": 1, "hidden": (64, 64),
                           "discrete": False, "action_scale": 2.0},
            optimizer_kwargs={"learning_rate": 1e-2})
    es.train(10)

A ``DeviceAgent`` runs the device backend (``parallel/engine.py``: env and
policy on the card); a ``PooledAgent`` the pooled backend
(``parallel/pooled.py``: the envs in a host pool, the population's forward
on the card), e.g. ``NatureCNN`` with VBN on the C++ pixel pong
(``configs.pong84_conv``).  ``es.backend`` says which.

``decomposed``, ``low_rank``, ``streamed``, ``noise_kernel``, ``obs_norm``,
``compute_dtype="bfloat16"``, ``episodes_per_member``, ``eval_chunk`` and
``grad_chunk`` combine as in the JAX package, which rejects the same
combinations with the same ``ValueError``s.  The options not ported yet
(``mesh``/``shard_params``, ``scenarios``, host agents, recurrent
policies, VBN on the device path) raise ``NotImplementedError`` naming
their ``ROADMAP.md`` item.  ``device`` is ``"cuda"`` unless the caller
passes ``"cpu"``.  ``best_policy`` keeps the best member seen, and
``evaluate_policy`` rolls out fresh episodes of the center or of it.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable

import numpy as np
import torch

from ..models.decomposed import supports_decomposed
from ..models.vbn import capture_reference_stats
from ..ops.lowrank import make_lowrank_spec
from ..ops.noise import DEFAULT_TABLE_SIZE, make_noise_table
from ..ops.noise_kernels import flat_layer_offsets, mlp_streamed_apply
from ..ops.params import make_param_spec
from ..parallel.engine import EngineConfig, ESEngine
from ..parallel.pooled import PooledEngine
from ..utils.backend import resolve_device

_ROADMAP = "ROADMAP.md, port queue"
_HOST = "2, the host backend"
_RECURRENT = "3, recurrent policies and device-path VBN"
_NOVELTY = "4, the novelty family"


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
    """Vanilla OpenAI-ES (Salimans et al. 2017) on the one-device engine."""

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
        grad_chunk: int = 256,
        weight_decay: float = 0.0,
        mesh=None,
        vbn_batch: int = 128,
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
        obs_clip: float = 5.0,
        obs_probe_episodes: int = 1,
        obs_warmup_episodes: int = 0,
        shard_params: bool = False,
        scenarios=None,
    ):
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
        if obs_warmup_episodes and not obs_norm:
            raise ValueError(
                "obs_warmup_episodes warm-starts the running obs stats; "
                "it requires obs_norm=True")
        self.agent = _instantiate(agent, dict(agent_kwargs or {}), "agent")
        if hasattr(self.agent, "rollout"):
            _unsupported("host agents (rollout(policy))", _HOST)
        pooled = hasattr(self.agent, "env_name")
        if pooled:
            if shard_params:
                raise ValueError(
                    "shard_params needs device-native rollouts: the pooled path "
                    "materializes per-member thetas host-side, the exact replicate "
                    "the sharded engine exists to avoid")
            if obs_warmup_episodes:
                raise ValueError(
                    "obs_warmup_episodes is a device-path option; the pooled path's "
                    "stats are fed by every member's observations from generation 0, "
                    "so its init transient is one generation long already")
            if scenarios is not None:
                raise ValueError(
                    "scenarios needs device-native rollouts (traced physics constants); "
                    "the pooled path steps C++ envs host-side with compiled-in constants")
        elif not hasattr(self.agent, "env"):
            raise TypeError("agent must be a DeviceAgent wrapping a batched device env or a "
                            "PooledAgent naming a pool env")
        if shard_params or mesh is not None:
            _unsupported("shard_params / mesh", "7, multi-GPU")
        if scenarios is not None:
            _unsupported("scenarios", "8, scenarios")
        policy_kwargs = dict(policy_kwargs or {})
        if pooled and (getattr(policy, "learned_carry", False)
                       or policy_kwargs.get("learned_carry")):
            raise ValueError(
                "learned_carry is a device-path feature: the pooled backend initializes "
                "episode carries before member params exist (parallel/pooled.py), so a "
                "params-dependent episode-start carry has no pooled form yet")

        self.device = resolve_device(device)
        self.population_size = int(population_size)
        self.sigma = float(sigma)
        self.seed = int(seed)
        self.backend = "pooled" if pooled else "device"
        self.module = _instantiate(policy, policy_kwargs, "policy")
        if getattr(self.module, "is_recurrent", False):
            _unsupported("recurrent policies", _RECURRENT)
        use_vbn = bool(getattr(self.module, "use_vbn", False))
        if pooled:
            spec_info = self._pool_spec()
            self.env = None
            obs_shape, horizon = tuple(spec_info["obs_shape"]), int(self.agent.horizon)
        else:
            if use_vbn:
                _unsupported("VBN on the device path (collect_reference_batch)", _RECURRENT)
            if hasattr(self.module, "population_layout"):
                _unsupported(f"{type(self.module).__name__} on the device path", _RECURRENT)
            self.env = self.agent.env
            obs_shape, horizon = self.env.obs_dim, self.agent.rollout_horizon
            for option, on, where in (("decomposed", decomposed, "models/decomposed.py"),
                                      ("streamed", streamed, "ops/noise_kernels.py"),
                                      ("low_rank", low_rank, "ops/lowrank.py")):
                if on and not supports_decomposed(self.module):
                    raise ValueError(
                        f"{option} supports MLPPolicy without VBN ({where}); "
                        f"got {type(self.module).__name__}")

        # params are drawn on the CPU and moved, so a seed gives the same
        # initial center on every device
        init_gen = torch.Generator().manual_seed(self.seed)
        params = self.module.init_params(obs_shape, init_gen)
        flat, self.spec = make_param_spec(params)
        if use_vbn:
            if obs_norm:
                raise ValueError(
                    "VirtualBatchNorm + obs_norm is unsupported: the VBN reference batch "
                    "is captured in RAW observation space at init, so its frozen stats "
                    "would mis-calibrate against normalized rollout inputs — pick one "
                    "input-normalization scheme")
            self.module.vbn_stats = capture_reference_stats(
                self.module, self.spec.unravel(flat.to(self.device)),
                self._pooled_reference_batch(vbn_batch))
        self.table = make_noise_table(table_size, seed=self.seed, device=self.device)
        self.optimizer = _instantiate_optimizer(optimizer, optimizer_kwargs)
        self.config = EngineConfig(
            population_size=self.population_size,
            sigma=self.sigma,
            horizon=horizon,
            eval_chunk=int(eval_chunk),
            grad_chunk=int(grad_chunk),
            weight_decay=float(weight_decay),
            compute_dtype=compute_dtype,
            sigma_decay=float(sigma_decay),
            sigma_min=float(sigma_min),
            mirrored=bool(mirrored),
            episodes_per_member=int(episodes_per_member),
            decomposed=bool(decomposed),
            noise_kernel=bool(noise_kernel),
            streamed=bool(streamed),
            low_rank=int(low_rank),
            obs_norm=bool(obs_norm),
            obs_clip=float(obs_clip),
            obs_probe_episodes=int(obs_probe_episodes),
            obs_warmup_episodes=int(obs_warmup_episodes),
        )
        if pooled:
            a = self.agent
            self.engine = PooledEngine(
                a.env_name, self.module, self.spec, self.table, self.optimizer, self.config,
                self.device, n_threads=a.n_threads, seed=self.seed,
                double_buffer=a.double_buffer, prep=a.prep, env_kwargs=a.env_kwargs,
                bc_indices=a.bc_indices)
        else:
            self.engine = self._device_engine(params, streamed, low_rank)
        self.state = self.engine.init_state(flat, self.seed)
        self.best_reward = -np.inf
        self._best_flat: torch.Tensor | None = None  # the best member's params
        self._best_module = None  # best_policy's module, built at first use
        self.history: list[dict] = []
        self.generation = 0

    def _device_engine(self, params: dict, streamed: bool, low_rank: int) -> ESEngine:
        module = self.module
        streamed_apply = None
        if streamed:
            layer_offs = flat_layer_offsets(params)

            def streamed_apply(shared, table_data, offs, c, obs):
                return mlp_streamed_apply(module, shared, table_data, offs, c, obs, layer_offs)

        lr_spec = make_lowrank_spec(params, int(low_rank)) if low_rank else None
        return ESEngine(self.env, module, self.spec, self.table, self.optimizer, self.config,
                        self.device, streamed_apply=streamed_apply, lowrank_spec=lr_spec)

    # --------------------------------------------------------- pooled backend

    def _pool_spec(self) -> dict:
        """The pool env's spec, with the preprocessing's stacked shape."""
        from ..envs.atari_wrappers import apply_prep_to_spec
        from ..envs.gym_vec_pool import pool_env_spec

        spec = pool_env_spec(self.agent.env_name, self.agent.env_kwargs)
        prep = self.agent.prep
        return apply_prep_to_spec(spec, prep["frame_stack"]) if prep else spec

    def _pooled_reference_batch(self, n: int) -> torch.Tensor:
        """Random-action observations of the pool for the VBN statistics, in
        the policy's input shape (stacked frames with preprocessing), drawn
        as the JAX package draws them: a pool of n // 4 envs, ``default_rng
        (seed)``, the reset frame and 4 steps."""
        from ..envs.gym_vec_pool import make_pool

        pool = make_pool(self.agent.env_name, max(1, n // 4), env_kwargs=self.agent.env_kwargs)
        prep = self.agent.prep
        if prep:
            from ..envs.atari_wrappers import AtariPreprocessPool

            pool = AtariPreprocessPool(pool, seed=self.seed, **prep)
        rng = np.random.default_rng(self.seed)
        try:
            frames = [pool.reset()]
            for _ in range(4):
                if pool.discrete:
                    acts = rng.integers(0, pool.n_actions, (pool.n_envs, 1)).astype(np.float32)
                else:
                    acts = rng.uniform(-1, 1, (pool.n_envs, pool.act_dim)).astype(np.float32)
                obs, _, _ = pool.step(acts)
                frames.append(obs)
        finally:
            pool.close()
        batch = np.concatenate(frames, axis=0)[:n]
        return torch.from_numpy(batch.reshape((-1,) + tuple(pool.obs_shape))).to(self.device)

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
            fitness = np.asarray(_host(metrics["fitness"]))  # waits for the device
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

    def _track_best(self, prev_state, fitness: np.ndarray) -> tuple[float, bool]:
        """Best-member snapshot: (generation max, whether it is a new best).
        A new best's params are rebuilt from the generation's offsets."""
        finite_any = bool(np.isfinite(fitness).any())
        gen_best = float(np.nanmax(fitness)) if finite_any else float("nan")
        improved = finite_any and gen_best > self.best_reward
        if improved:
            self.best_reward = gen_best
            self._best_flat = self.engine.member_params(prev_state, int(np.nanargmax(fitness)))
        return gen_best, improved

    def _record(self, prev_state, fitness: np.ndarray, steps: int,
                grad_norm: float, dt: float) -> dict:
        finite_any = bool(np.isfinite(fitness).any())
        gen_best, improved = self._track_best(prev_state, fitness)
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

    @property
    def best_policy(self):
        """A module with the best-ever member's params (reference:
        es.best_policy); the center's policy before any generation."""
        if self._best_flat is None:
            return self.policy
        if self._best_module is None:
            self._best_module = copy.deepcopy(self.module)
        return self._best_module.set_params(self._best_flat, self.spec)

    def evaluate_policy(self, n_episodes: int = 10, use_best: bool = False, seed: int = 0,
                        meta_index: int | None = None, return_details: bool = False) -> dict:
        """Mean/std/min/max episode return of the current (or best) policy
        over ``n_episodes`` fresh episodes, batched in one rollout, in
        float32, normalized with the current obs stats when ``obs_norm`` is
        on.  ``seed`` seeds the episodes' initial states.

        ``return_details=True`` adds per-episode ``rewards``, ``bc``,
        ``steps`` and, for envs with the gait protocol (``step_metrics`` /
        ``episode_metrics``, the locomotion family), ``gait``: per-episode
        ``forward_velocity_mps`` and ``upright_fraction``.

        On the pooled backend the episodes run in one pooled pass from a
        fresh pool seeded by ``seed``, in the compute dtype, as in the JAX
        package; the details are ``rewards`` and ``bc``.
        """
        if meta_index is not None:
            _unsupported("meta_index (per-center evaluation)", _NOVELTY)
        flat = self._best_flat if use_best and self._best_flat is not None else None
        if self.backend == "pooled":
            # one pooled pass of fresh episodes from a pool seeded by ``seed``,
            # in the compute dtype, as the JAX package's pooled path evaluates
            state = self.state if flat is None else self.state._replace(params_flat=flat)
            res = self.engine.evaluate_center_batch(state, int(n_episodes), seed=seed)
            rewards = np.asarray(res.fitness, np.float32)
            summary = _summary(rewards, n_episodes)
            if return_details:
                summary.update(rewards=rewards, bc=res.bc)
            return summary
        states0, _ = self.env.reset(torch.Generator().manual_seed(int(seed)), int(n_episodes))
        want_gait = return_details and hasattr(self.env, "step_metrics")
        out = self.engine.evaluate_episodes(self.state, states0, flat, with_env_metrics=want_gait)
        res, gait_sums = out if want_gait else (out, None)
        rewards = res.total_reward.cpu().numpy()
        summary = _summary(rewards, n_episodes)
        if return_details:
            bc, steps = res.bc.cpu().numpy(), res.steps.cpu().numpy()
            summary.update(rewards=rewards, bc=bc, steps=steps)
            if gait_sums is not None:
                sums = gait_sums.cpu().numpy()
                per_ep = [self.env.episode_metrics(bc[i], steps[i], sums[i])
                          for i in range(int(n_episodes))]
                summary["gait"] = {k: np.asarray([m[k] for m in per_ep], np.float32)
                                   for k in per_ep[0]}
        return summary


def _host(x):
    """A metric on the host: device tensors are copied, the pooled
    engine's numpy arrays pass through."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _summary(rewards: np.ndarray, n_episodes: int) -> dict:
    return {"mean": float(rewards.mean()), "std": float(rewards.std()),
            "min": float(rewards.min()), "max": float(rewards.max()),
            "episodes": int(n_episodes)}


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
