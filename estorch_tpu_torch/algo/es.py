"""ES — the user-facing algorithm class.

Counterpart of ``estorch_tpu/algo/es.py``'s ``ES.__init__`` and ``train``
on one device, for the device, pooled and host backends.  The signature
keeps the JAX package's names and defaults, so the default call runs the
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
(``configs.pong84_conv``); an agent with ``rollout(policy)`` the host
backend (``host/engine.py``): the reference's own contract, a torch
policy class and a torch optimizer class,

    es = ES(TorchPolicy, GymAgent, torch.optim.Adam, optimizer_kwargs={"lr": 1e-2})
    es.train(n_steps, n_proc=8)

with the policies, the center, the noise and the update on ``device``
(``worker_mode="process"`` forks CPU workers for the rollouts).  The
``rollout`` marker is checked first, so a reference agent that also holds a
gym ``env`` runs on the host backend.  ``es.backend`` says which.

``decomposed``, ``low_rank``, ``streamed``, ``noise_kernel``, ``obs_norm``,
``compute_dtype="bfloat16"``, ``episodes_per_member``, ``eval_chunk`` and
``grad_chunk`` combine as in the JAX package, which rejects the same
combinations with the same ``ValueError``s.  A recurrent policy
(``RecurrentPolicy``, ``RecurrentNatureCNN``) runs the standard forward
with its carry threaded through the rollouts, or with ``low_rank`` the
low-rank tree form, on the device and pooled backends; ``MLPPolicy`` with
VBN on the device path freezes its statistics from
``collect_reference_batch`` of the agent's env.  The options not ported yet
(``mesh``/``shard_params`` and the sharding options, ``telemetry``,
``scenarios``, ``meta_index``) raise ``NotImplementedError`` naming their
``ROADMAP.md`` item.  ``device`` is ``"cuda"`` unless the caller passes
``"cpu"``.  ``best_policy`` keeps the best member seen, and
``evaluate_policy`` rolls out fresh episodes of the center or of it.
"""

from __future__ import annotations

import copy
import time
import warnings
from typing import Any, Callable

import numpy as np
import torch

from ..envs.agent import collect_reference_batch
from ..host.engine import HostEngine, load_flat
from ..models.decomposed import supports_decomposed
from ..models.vbn import capture_reference_stats
from ..ops.lowrank import make_lowrank_spec, make_lowrank_tree_spec
from ..ops.noise import DEFAULT_TABLE_SIZE, make_noise_table
from ..ops.noise_kernels import flat_layer_offsets, mlp_streamed_apply
from ..ops.params import make_param_spec
from ..parallel.engine import _VBN_STREAM, EngineConfig, ESEngine, _seed_of
from ..parallel.pooled import PooledEngine
from ..utils.backend import resolve_device

_ROADMAP = "ROADMAP.md, port queue"
_NOVELTY = "4, the novelty family"
_OBSERVABILITY = "6, checkpoint, resilience and observability"
_MULTI_GPU = "7, multi-GPU"

# options that only the device and pooled backends have: (keyword, its
# default, the JAX package's ValueError for a host agent)
_DEVICE_ONLY = (
    ("shard_params", False, "shard_params is a device-path option "
     "(parallel/sharded.py); host torch agents replicate"),
    ("compute_dtype", "float32", "compute_dtype is a device/pooled-path option; the host "
     "backend runs torch policies in their native dtype"),
    ("episodes_per_member", 1, "episodes_per_member is a device-path option; host agents "
     "control their own rollout count inside rollout()"),
    ("decomposed", False, "decomposed is a device-path option (models/decomposed.py)"),
    ("noise_kernel", False, "noise_kernel is a device/pooled-path option (the host path's "
     "update runs the reduction kernel already)"),
    ("streamed", False, "streamed is a device-path option (ops/noise_kernels.py)"),
    ("low_rank", 0, "low_rank is a device-path option (ops/lowrank.py)"),
    ("obs_norm", False, "obs_norm is a device/pooled-path option (running stats ride the "
     "training state); host agents own their rollouts — use models.TorchRunningObsNorm "
     "there"),
    ("scenarios", None, "scenarios is a device-path option: randomized physics constants "
     "enter the rollout as operands; host agents step their envs in Python"),
)


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
        worker_mode: str = "thread",
        decomposed: bool = False,
        noise_kernel: bool = False,
        streamed: bool = False,
        low_rank: int = 0,
        obs_norm: bool = False,
        obs_clip: float = 5.0,
        obs_probe_episodes: int = 1,
        obs_warmup_episodes: int = 0,
        telemetry=None,
        shard_params: bool = False,
        model_shards: int | None = None,
        partition_rules=None,
        noise_mode: str = "auto",
        scenarios=None,
    ):
        if telemetry not in (None, False):
            _unsupported("telemetry", _OBSERVABILITY)
        if model_shards is not None or partition_rules is not None or noise_mode != "auto":
            _unsupported("model_shards / partition_rules / noise_mode (the param-sharded "
                         "engine)", _MULTI_GPU)
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
        if obs_warmup_episodes and not obs_norm:
            raise ValueError(
                "obs_warmup_episodes warm-starts the running obs stats; "
                "it requires obs_norm=True")
        self.population_size = int(population_size)
        self.sigma = float(sigma)
        self.seed = int(seed)
        self.best_reward = -np.inf
        self._best_flat: torch.Tensor | None = None  # the best member's params
        self._best_module = None  # best_policy's module, built at first use
        self.history: list[dict] = []
        self.generation = 0
        self.agent = _instantiate(agent, dict(agent_kwargs or {}), "agent")
        # a reference agent usually holds a gym ``env`` AND rollout(): the
        # rollout contract is the host marker, so it is checked first
        if hasattr(self.agent, "rollout"):
            given = dict(shard_params=shard_params, compute_dtype=compute_dtype,
                         episodes_per_member=episodes_per_member, decomposed=decomposed,
                         noise_kernel=noise_kernel, streamed=streamed, low_rank=low_rank,
                         obs_norm=obs_norm, scenarios=scenarios)
            for option, default, message in _DEVICE_ONLY:
                if given[option] != default:
                    raise ValueError(message)
            if mesh is not None:
                _unsupported("mesh", _MULTI_GPU)
            self.backend = "host"
            self._init_host(policy, dict(policy_kwargs or {}), agent, dict(agent_kwargs or {}),
                            optimizer, dict(optimizer_kwargs or {}), table_size, device,
                            weight_decay, worker_mode, sigma_decay, sigma_min, mirrored)
            return
        if worker_mode != "thread":
            raise ValueError(
                "worker_mode is a host-path option (thread|process); device/"
                "pooled paths parallelize on the device")
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
            _unsupported("shard_params / mesh", _MULTI_GPU)
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
        self.backend = "pooled" if pooled else "device"
        self.module = _instantiate(policy, policy_kwargs, "policy")
        self._recurrent = bool(getattr(self.module, "is_recurrent", False))
        use_vbn = bool(getattr(self.module, "use_vbn", False))
        if pooled:
            spec_info = self._pool_spec()
            self.env = None
            obs_shape, horizon = tuple(spec_info["obs_shape"]), int(self.agent.horizon)
        else:
            self.env = self.agent.env
            obs_shape, horizon = self.env.obs_dim, self.agent.rollout_horizon
            for option, on, where in (("decomposed", decomposed, "models/decomposed.py"),
                                      ("streamed", streamed, "ops/noise_kernels.py"),
                                      ("low_rank", low_rank and not self._recurrent,
                                       "ops/lowrank.py")):
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
            if pooled:
                reference = self._pooled_reference_batch(vbn_batch)
            else:
                # random-action observations of the agent's env, from a
                # stream of the seed of their own
                gen = torch.Generator().manual_seed(_seed_of(self.seed, 0, _VBN_STREAM))
                reference = collect_reference_batch(self.env, vbn_batch, gen).to(self.device)
            self.module.vbn_stats = capture_reference_stats(
                self.module, self.spec.unravel(flat.to(self.device)), reference)
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
        carry_init = self.module.carry_init if self._recurrent else None
        if pooled:
            a = self.agent
            self.engine = PooledEngine(
                a.env_name, self.module, self.spec, self.table, self.optimizer, self.config,
                self.device, n_threads=a.n_threads, seed=self.seed,
                double_buffer=a.double_buffer, prep=a.prep, env_kwargs=a.env_kwargs,
                bc_indices=a.bc_indices, carry_init=carry_init)
        else:
            self.engine = self._device_engine(params, streamed, low_rank, carry_init)
        self.state = self.engine.init_state(flat, self.seed)

    def _device_engine(self, params: dict, streamed: bool, low_rank: int,
                       carry_init) -> ESEngine:
        module = self.module
        streamed_apply = None
        if streamed:
            layer_offs = flat_layer_offsets(params)

            def streamed_apply(shared, table_data, offs, c, obs):
                return mlp_streamed_apply(module, shared, table_data, offs, c, obs, layer_offs)

        lr_spec = None
        if low_rank:
            # a recurrent policy: the tree form over its whole param dict
            # (trunk, cell gates, head), each member's perturbation formed
            # once a chunk and the standard rollout
            make = make_lowrank_tree_spec if self._recurrent else make_lowrank_spec
            lr_spec = make(params, int(low_rank))
        return ESEngine(self.env, module, self.spec, self.table, self.optimizer, self.config,
                        self.device, streamed_apply=streamed_apply, lowrank_spec=lr_spec,
                        carry_init=carry_init)

    # ----------------------------------------------------------- host backend

    def _init_host(self, policy, policy_kwargs: dict, agent, agent_kwargs: dict, optimizer,
                   optimizer_kwargs: dict, table_size: int, device, weight_decay: float,
                   worker_mode: str, sigma_decay: float, sigma_min: float,
                   mirrored: bool) -> None:
        """The reference's path: a torch policy, ``rollout(policy)`` workers and
        a torch optimizer class (``host/engine.py``)."""
        if isinstance(policy, type):
            def policy_factory():
                return policy(**policy_kwargs)
        else:
            if policy_kwargs:
                raise ValueError("policy_kwargs were given alongside a policy instance; "
                                 "pass the class, or the instance without kwargs")

            def policy_factory():
                return copy.deepcopy(policy)

        if isinstance(agent, type):
            def agent_factory():
                return agent(**agent_kwargs)
        else:
            def agent_factory():  # one shared instance: train() keeps n_proc at 1
                return agent
        self._agent_is_shared_instance = not isinstance(agent, type)
        self.env = None
        self.module = None
        self.device = resolve_device(device)
        # the master's initial weights come from torch's global generator on
        # the CPU, seeded here as the JAX package's host path seeds it
        torch.manual_seed(self.seed)
        self.engine = HostEngine(
            policy_factory=policy_factory, agent_factory=agent_factory,
            optimizer_ctor=optimizer, optimizer_kwargs=optimizer_kwargs,
            population_size=self.population_size, sigma=self.sigma, table_size=table_size,
            seed=self.seed, device=self.device,
            prototype_agent=self.agent,  # the dispatch probe doubles as worker 0
            weight_decay=weight_decay, worker_mode=worker_mode, sigma_decay=sigma_decay,
            sigma_min=sigma_min, mirrored=mirrored)
        self.state = self.engine.init_state()

    def _setup_n_proc(self, n_proc: int) -> None:
        if self.backend != "host":
            return
        if self._agent_is_shared_instance and n_proc > 1:
            warnings.warn(
                "agent was passed as a shared instance; host workers would race on it — "
                "running with n_proc=1. Pass the agent CLASS (with agent_kwargs) to "
                "parallelize.", stacklevel=3)
            n_proc = 1
        self.engine.set_n_proc(n_proc)

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
        """Run ``n_steps`` generations.  On the host backend ``n_proc`` sizes
        the worker pool, as the reference's ``train(n_steps, n_proc)``; the
        device and pooled backends batch the population and ignore it.

        A generation whose population collapsed (<2 valid members) or whose
        update came out non-finite is rejected: the state is restored and
        the same generation re-runs.  Its sample is keyed on
        ``(seed, generation)``, so the re-run is bit-identical to a run that
        never faulted.  More than ``max_consecutive_rejections`` in a row
        raise.
        """
        self._setup_n_proc(n_proc)
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
        """The current center's policy (reference: es.policy): on the host
        backend the torch master module, else the module with the center's
        params."""
        if self.backend == "host":
            load_flat(self.engine.master, self.state.params_flat)
            return self.engine.master
        return self.module.set_params(self.state.params_flat, self.spec)

    @property
    def policy_variables(self) -> dict:
        """The JAX package's param-dict accessor, device-path only there;
        not ported: ``.policy`` holds the params on every backend."""
        raise AttributeError("policy_variables is device-path only in the JAX package and "
                             "not ported; use .policy")

    @property
    def best_policy(self):
        """A policy with the best-ever member's params (reference:
        es.best_policy); the center's policy before any generation."""
        if self._best_flat is None:
            return self.policy
        if self._best_module is None:
            self._best_module = (self.engine._new_scratch_policy() if self.backend == "host"
                                 else copy.deepcopy(self.module))
        if self.backend == "host":
            load_flat(self._best_module, self._best_flat)
            return self._best_module
        return self._best_module.set_params(self._best_flat, self.spec)

    @property
    def best_policy_variables(self) -> dict:
        """Not ported, as ``policy_variables``."""
        raise AttributeError("best_policy_variables is device-path only in the JAX package "
                             "and not ported; use .best_policy")

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
        package; the details are ``rewards`` and ``bc``.  On the host
        backend they are serial ``rollout`` calls of worker 0's agent (the
        agent owns its episodes' randomness, so ``seed`` is not used); the
        details are ``rewards``, with ``bc`` None.
        """
        if meta_index is not None:
            _unsupported("meta_index (per-center evaluation)", _NOVELTY)
        flat = self._best_flat if use_best and self._best_flat is not None else None
        if self.backend == "host":
            state = self.state if flat is None else self.state._replace(params_flat=flat)
            rewards = np.asarray([self.engine.evaluate_center(state).total_reward
                                  for _ in range(int(n_episodes))], np.float32)
            summary = _summary(rewards, n_episodes)
            if return_details:
                summary.update(rewards=rewards, bc=None)
            return summary
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
