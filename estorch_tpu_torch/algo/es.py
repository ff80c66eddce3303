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
``collect_reference_batch`` of the agent's env.  ``scenarios`` (a
``scenarios.ScenarioDistribution``) wraps the device env in a
``ScenarioEnv``: every episode runs under a drawn variant of the physics,
and every record carries the per-variant fitness block ``scenarios``
(``_attach_scenarios``, shared with the overlap scheduler).  ``mesh`` (a
``parallel.mesh.PopulationMesh``, e.g. ``multihost.global_population_mesh()``
in each of N processes) makes the device and pooled backends one rank of a
data-parallel group: each rank evaluates its block of the population and
the ranks sum the update (``parallel/engine.py``); every rank ends each
generation with the same bits.  The JAX package's ``device=None`` spans
every local chip; here one process drives one device (ROADMAP F21), and a
multi-card run is one process a card.  ``shard_params=True`` runs the
param-sharded engine (``parallel/sharded.py``) over a ``HyperscaleMesh``
(``multihost.global_hyperscale_mesh(model_shards=…)`` in each of N
processes, or the one-process ``(1, 1)`` mesh): each rank holds its shards
of the params and of the optimizer state per ``partition_rules``, with
``noise_mode`` "program" (the default: ε generated where it is used, no
table) or "table"; it partitions the forward of ``MLPPolicy`` and
``NatureCNN``, each with or without VBN.  The device path takes the
policy's input shape from the observation the env's reset returns, as the
JAX package inits from ``obs0``: ``NatureCNN`` trains on a device env
with (H, W, C) observations.  The novelty
family (``algo/nses.py``) and IW-ES (``algo/iwes.py``) subclass ``ES`` and
share its record plumbing (``_base_record``, ``_emit_record``,
``_format_record``).  ``device`` is ``"cuda"`` unless
the caller passes ``"cpu"``.  ``best_policy`` keeps the best member seen, and
``evaluate_policy`` rolls out fresh episodes of the center or of it.
``predict`` runs the serving forward (``serve/predictor.py``) with the
center's or the best member's params, and ``export_bundle`` writes a
bundle that ``python -m estorch_tpu_torch.serve`` serves.

``es.obs`` is the run's telemetry hub (``obs/spans.py``; ``telemetry=None``
is on unless ``ESTORCH_OBS=0``, a bool forces it, or pass a
``Telemetry``): every record carries ``phases``, the seconds of each span
of its generation, and the hub counts ``env_steps``, ``rollout_failures``
and ``generations_rejected``.  With the hub on, the first record also
carries ``cost_model``, the analytic FLOPs and bytes of a generation of
this configuration (``obs/profile/costmodel.py``), which ``python -m
estorch_tpu_torch.obs profile`` turns into achieved rates.  A record
carries ``compile_events`` when the generation loaded one of the port's
native libraries for the first time in the process: the CUDA kernels
(``ops/_build.py``, program ``noise_kernels``) or the envpool
(``envs/native_pool.py``, program ``envpool``, loaded while the ES is
built, so in the first record).  These builds at first use are the port's
compiles: torch compiles nothing ahead of time, and nothing runs a
throw-away generation to imitate the JAX package's AOT step.
``compile_time_s`` sums them (0.0 where this ES loaded neither).  ``train_async`` runs barrier-free
generations (``algo/scheduler.py``): the fold scheduler on the host
backend, the overlap scheduler elsewhere, and the replay of a fold run's
event log (``async_event_log``); ``train_elastic`` folds whole-population
dispatches from elastic remote hosts (``parallel/elastic.py``).
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
from ..obs.spans import cuda_done_event, resolve_telemetry
from ..ops._build import claim_library_loads
from ..ops.lowrank import make_lowrank_spec, make_lowrank_tree_spec
from ..ops.noise import DEFAULT_TABLE_SIZE, make_noise_table
from ..ops.noise_kernels import flat_layer_offsets, mlp_streamed_apply
from ..ops.params import make_param_spec
from ..parallel.engine import _VBN_STREAM, EngineConfig, ESEngine, _seed_of
from ..parallel.pooled import PooledEngine
from ..utils.backend import resolve_device


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


class ES:
    """Vanilla OpenAI-ES (Salimans et al. 2017) on the one-device engine."""

    _scenarios = None  # the ScenarioDistribution, when domain randomization is on

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
        # the hub first, so every backend's init runs with it
        self.obs = resolve_telemetry(telemetry)
        self._t_created = time.monotonic()  # native loads from here on are this ES's
        self.obs.note("init")
        # the param-sharded engine (parallel/sharded.py): params and optimizer
        # state sharded over a (pop, model) mesh per regex partition rules
        self._shard_params = bool(shard_params)
        if noise_mode not in ("auto", "program", "table"):
            raise ValueError(f"noise_mode must be auto|program|table, got {noise_mode!r}")
        self._noise_mode = "program" if noise_mode == "auto" else noise_mode
        if not shard_params and (model_shards is not None or partition_rules is not None
                                 or noise_mode != "auto"):
            raise ValueError(
                "model_shards/partition_rules/noise_mode configure the "
                "param-sharded engine; pass shard_params=True")
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
        if obs_warmup_episodes and not obs_norm:
            raise ValueError(
                "obs_warmup_episodes warm-starts the running obs stats; "
                "it requires obs_norm=True")
        # domain randomization over the native env families: the device env
        # is wrapped in a ScenarioEnv below; the host and pooled backends
        # refuse it (their envs step host-side with their own constants)
        self._scenarios = scenarios
        if scenarios is not None:
            from ..scenarios import ScenarioDistribution

            if not isinstance(scenarios, ScenarioDistribution):
                raise TypeError(
                    "scenarios must be a ScenarioDistribution "
                    "(estorch_tpu_torch.scenarios; e.g. "
                    "default_distribution(env, n_variants=10)), got "
                    f"{scenarios!r}")
        self.population_size = int(population_size)
        self.sigma = float(sigma)
        self.seed = int(seed)
        self.best_reward = -np.inf
        self._best_flat: torch.Tensor | None = None  # the best member's params
        self._best_module = None  # best_policy's module, built at first use
        self._predict_fn = None  # predict's serving program, built at first use
        self.history: list[dict] = []
        self.generation = 0
        self._d2h_stream = None  # the metrics' side stream on CUDA, built at first use
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
                raise ValueError(
                    "mesh is a device/pooled-path option: the host backend's workers "
                    "(n_proc) parallelize its rollouts, and its update runs in this process")
            self.backend = "host"
            self.mesh = None
            self._init_host(policy, dict(policy_kwargs or {}), agent, dict(agent_kwargs or {}),
                            optimizer, dict(optimizer_kwargs or {}), table_size, device,
                            weight_decay, worker_mode, sigma_decay, sigma_min, mirrored)
            self._post_engine_init()
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
        if shard_params:
            from ..parallel.mesh import HyperscaleMesh, hyperscale_mesh

            if mesh is None:
                mesh = hyperscale_mesh(model_shards=model_shards, devices=device)
            elif not isinstance(mesh, HyperscaleMesh):
                raise TypeError(
                    "shard_params needs a HyperscaleMesh (estorch_tpu_torch.parallel: "
                    "multihost.global_hyperscale_mesh() or hyperscale_mesh()), got "
                    f"{mesh!r}")
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device={device!r} but this rank's mesh device is "
                                 f"{mesh.device}")
        elif mesh is not None:
            from ..parallel.mesh import PopulationMesh

            if not isinstance(mesh, PopulationMesh):
                raise TypeError(
                    "mesh must be a PopulationMesh (estorch_tpu_torch.parallel: "
                    "multihost.global_population_mesh() or population_mesh()), "
                    f"got {mesh!r}")
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device={device!r} but this rank's mesh device is "
                                 f"{mesh.device}")
        policy_kwargs = dict(policy_kwargs or {})
        if pooled and (getattr(policy, "learned_carry", False)
                       or policy_kwargs.get("learned_carry")):
            raise ValueError(
                "learned_carry is a device-path feature: the pooled backend initializes "
                "episode carries before member params exist (parallel/pooled.py), so a "
                "params-dependent episode-start carry has no pooled form yet")

        self.device = mesh.device if mesh is not None else resolve_device(device)
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
            if scenarios is not None:
                from ..scenarios import ScenarioEnv

                self.env = ScenarioEnv(self.env, scenarios)
            obs_shape, horizon = self._device_obs_shape(obs_norm), self.agent.rollout_horizon
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
        self._obs_shape = obs_shape
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
        # sharded program noise never reads a table: none is allocated
        self.table = (None if shard_params and self._noise_mode != "table"
                      else make_noise_table(table_size, seed=self.seed, device=self.device))
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
        if shard_params:
            from ..parallel.sharded import ShardedESEngine

            if self._recurrent:
                raise ValueError(
                    "shard_params currently supports feedforward policies; "
                    "recurrent carries stay on the replicated engine "
                    "(docs/sharding.md)")
            self.engine = ShardedESEngine(
                self.env, self.module, self.spec, self.table, self.optimizer, self.config,
                mesh, partition_rules=partition_rules, noise_mode=self._noise_mode)
        elif pooled:
            a = self.agent
            self.engine = PooledEngine(
                a.env_name, self.module, self.spec, self.table, self.optimizer, self.config,
                self.device, n_threads=a.n_threads, seed=self.seed,
                double_buffer=a.double_buffer, prep=a.prep, env_kwargs=a.env_kwargs,
                bc_indices=a.bc_indices, carry_init=carry_init, mesh=mesh)
        else:
            self.engine = self._device_engine(params, streamed, low_rank, carry_init, mesh)
        self.mesh = self.engine.mesh
        self.engine.telemetry = self.obs
        self.state = self.engine.init_state(flat, self.seed)
        self._post_engine_init()

    def _device_obs_shape(self, obs_norm: bool):
        """The policy's input shape on the device path, from the
        observation the env's reset returns, as the JAX package inits from
        ``obs0``: ``obs_dim`` for a flat env, (H, W, C) for a pixel env.
        ``obs_norm`` keeps (obs_dim,) statistics, so it needs a flat one."""
        _, obs0 = self.env.reset(torch.Generator().manual_seed(0), 1)
        shape = tuple(int(d) for d in obs0.shape[1:])
        if len(shape) == 1:
            return int(self.env.obs_dim)
        if obs_norm:
            raise ValueError(
                f"obs_norm keeps (obs_dim,) running statistics of flat observations; this "
                f"env's observations are {shape}")
        return shape

    def _post_engine_init(self) -> None:
        """Once the engine exists (every backend): the native loads its
        construction caused (a pooled engine's envpool), and the cost
        model, built only with the hub on."""
        self.compile_time_s = 0.0
        self._claim_compiles()
        if self.obs.enabled:
            self.obs.set_cost_model(self._build_cost_model())
        self._cost_model_emitted = False

    def _claim_compiles(self) -> None:
        """Record in this hub the native libraries first loaded in the
        process since this ES was built (``ops/_build.py``), and add their
        seconds to ``compile_time_s``."""
        for e in claim_library_loads(self._t_created):
            self.compile_time_s += e["compile_s"]
            self.obs.compile_event(e["program"], e["compile_s"], cached=e["cached"],
                                   library=e["library"])

    def _build_cost_model(self) -> dict | None:
        """Analytic per-phase FLOPs/bytes of THIS configuration
        (``obs/profile/costmodel.py``), as the JAX package builds it: the
        2-D kernels' shapes and ``param_dim`` from the flat spec on the
        device and pooled backends, from ``engine.master``'s parameters on
        the host backend (whose agents own their horizon: None); 2 bytes a
        value under bfloat16; the noise is always the table.  Diagnostic
        only: None rather than a failed construction (a policy without 2-D
        kernels has no matmul model, a note in ``obs profile``)."""
        from ..obs.profile.costmodel import generation_cost

        try:
            if self.backend == "host":
                params = list(self.engine.master.parameters())
                shapes = [tuple(p.shape) for p in params if p.dim() == 2]
                param_dim = int(sum(p.numel() for p in params))
                horizon, dtype_bytes, episodes, low_rank = None, 4, 1, 0
                mirrored = bool(self.engine.mirrored)
            else:
                cfg = self.config
                shapes = [s for s in self.spec.shapes if len(s) == 2]
                param_dim = int(self.spec.dim)
                horizon = int(cfg.horizon)
                dtype_bytes = 2 if cfg.compute_dtype == "bfloat16" else 4
                episodes, low_rank, mirrored = cfg.episodes_per_member, cfg.low_rank, cfg.mirrored
            if not shapes:
                return None
            mesh = getattr(self, "mesh", None)
            return generation_cost(
                population=self.population_size, matmul_shapes=shapes, param_dim=param_dim,
                horizon=horizon, episodes_per_member=episodes, mirrored=mirrored,
                low_rank=low_rank, dtype_bytes=dtype_bytes,
                noise=self._noise_mode if self._shard_params else "table",
                n_devices=mesh.devices.size if mesh is not None else 1,
                model_shards=mesh.model_shards if self._shard_params else 1)
        except Exception:  # noqa: BLE001 — diagnostic, never a failed construction
            return None

    def _device_engine(self, params: dict, streamed: bool, low_rank: int,
                       carry_init, mesh) -> ESEngine:
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
                        carry_init=carry_init, mesh=mesh)

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
        self.engine.telemetry = self.obs
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
        update came out non-finite is rejected: the state is restored,
        ``generations_rejected`` counted, and the same generation re-runs.
        Its sample is keyed on ``(seed, generation)``, so the re-run is
        bit-identical to a run that never faulted.  More than
        ``max_consecutive_rejections`` in a row raise.

        The device backend's generation is queued on the card as a whole,
        so its spans are ``dispatch`` (the host's launches), ``device`` (the
        wait on a CUDA event recorded after them) and ``host_sync`` (the
        metrics' copy); the host and pooled engines span their own
        ``sample``/``eval``/``update``.
        """
        self._setup_n_proc(n_proc)
        obs = self.obs
        obs.discard_phases()  # partial spans of a generation that raised
        done = 0
        rejected_streak = 0
        while done < n_steps:
            t0 = time.perf_counter()
            prev_state = self.state
            if self.backend == "device":
                with obs.phase("dispatch"):
                    self.state, metrics = self.engine.generation_step(prev_state)
                    queued = cuda_done_event(self.device)
                with obs.phase("device"):
                    if queued is not None:
                        queued.synchronize()
                with obs.phase("host_sync"):
                    metrics = self._metrics_on_host(metrics, queued, prev_state)
            else:
                self.state, metrics = self.engine.generation_step(prev_state)
                metrics = self._metrics_on_host(metrics, cuda_done_event(self.device),
                                                prev_state)
            dt = time.perf_counter() - t0

            reason = self._update_anomaly(metrics)
            if reason is not None:
                # the sharded engine rolled back already: it returned the
                # input state, the same generation on every rank
                if not self._shard_params:
                    self.state = prev_state
                rejected_streak += 1
                self._count_rejection(reason, metrics)
                if rejected_streak > max_consecutive_rejections:
                    raise RuntimeError(
                        f"{reason}; {rejected_streak} consecutive generations "
                        "rejected — check env/rollout health")
                continue
            rejected_streak = 0
            record = self._base_record(prev_state, metrics["fitness"], metrics["steps"],
                                       metrics["grad_norm"], dt, sigma=metrics["sigma"],
                                       metrics=metrics)
            self._attach_scenarios(record, metrics["fitness"], metrics)
            self._emit_record(record, log_fn, verbose)
            done += 1
        return self

    def _attach_scenarios(self, record: dict, fitness, metrics: dict) -> None:
        """The per-variant fitness block onto a generation's record: the
        variant id is the BC's last column (``ScenarioEnv.behavior``).  One
        definition for the sync loop and the overlap scheduler."""
        if self._scenarios is None or "bc" not in (metrics or {}):
            return
        from ..scenarios import scenario_fitness_block, variant_of_bc

        record["scenarios"] = scenario_fitness_block(
            fitness, variant_of_bc(metrics["bc"]), self._scenarios.n_variants)

    def _metrics_on_host(self, metrics: dict, queued, prev_state) -> dict:
        """A generation's metrics as host values, with the σ it sampled
        under: ``fitness`` (NumPy), ``steps``, ``grad_norm``, ``n_valid``,
        ``update_finite``, ``sigma``; under scenarios also ``bc`` (NumPy),
        whose last column is each member's variant.  The sharded engine's
        ``best_theta`` (this rank's shard) passes through on the device.

        Tensors on the card are copied into pinned buffers on a side stream
        that waits on ``queued`` (a CUDA event recorded after the
        generation's work), then the copy's own event is waited on.  A
        plain ``.cpu()`` would wait for the whole default stream, on which
        the overlap scheduler's thread has already queued the next
        generation.
        """
        keys = ("fitness", "steps", "grad_norm", "n_valid", "update_finite")
        if self._scenarios is not None and "bc" in metrics:
            keys += ("bc",)
        vals = {k: metrics[k] for k in keys}
        vals["sigma"] = prev_state.sigma if prev_state.sigma is not None else self.sigma
        on_card = [k for k, v in vals.items()
                   if isinstance(v, torch.Tensor) and v.device.type == "cuda"]
        if on_card:
            if self._d2h_stream is None:
                self._d2h_stream = torch.cuda.Stream(self.device)
            side = self._d2h_stream
            with torch.cuda.stream(side):
                side.wait_event(queued)
                for k in on_card:
                    buf = torch.empty(vals[k].shape, dtype=vals[k].dtype, pin_memory=True)
                    buf.copy_(vals[k], non_blocking=True)
                    vals[k] = buf
                copied = torch.cuda.Event()
                copied.record(side)
            copied.synchronize()
        vals = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in vals.items()}
        out = {"fitness": np.asarray(vals["fitness"]), "steps": int(vals["steps"]),
               "grad_norm": float(vals["grad_norm"]), "n_valid": int(vals["n_valid"]),
               "update_finite": bool(vals["update_finite"]), "sigma": float(vals["sigma"])}
        if "bc" in vals:
            out["bc"] = np.asarray(vals["bc"])
        if "best_theta" in metrics:
            out["best_theta"] = metrics["best_theta"]
        return out

    def _count_rejection(self, reason: str, metrics: dict) -> None:
        obs = self.obs
        obs.counters.inc("generations_rejected")
        obs.event("generation_rejected", reason=reason, n_valid=int(metrics["n_valid"]))
        obs.discard_phases()  # the rejected generation's spans

    def _update_anomaly(self, metrics: dict) -> str | None:
        """The rejection reason for a generation, or None: the one
        definition ``train`` and the async schedulers share."""
        n_valid = int(metrics["n_valid"])
        if n_valid < 2:
            return (f"only {n_valid}/{self.population_size} population members "
                    "produced valid fitness — cannot form an update")
        if not bool(metrics["update_finite"]):
            return "non-finite parameters/update norm after the optimizer step"
        return None

    # ------------------------------------------------------- async generations

    def train_async(self, n_steps: int, n_proc: int = 1,
                    log_fn: Callable[[dict], None] | None = None, verbose: bool = True,
                    max_consecutive_rejections: int = 3, strategy: str = "auto",
                    max_stale: int = 16, iw_clip: float = 2.0, replay=None) -> "ES":
        """Barrier-free generations (``algo/scheduler.py``).

        ``strategy="fold"`` (host backend) runs the event-driven scheduler:
        member rollouts are tasks on the workers' queues, an update fires
        whenever a population's worth of results has arrived, and late
        results fold into it with clipped importance weights keyed on the
        σ and θ they were sampled under.  ``"overlap"`` (every backend)
        queues generation g+1 before g's metrics are read, bit-identical to
        :meth:`train`.  ``"auto"`` picks fold on the host backend, overlap
        elsewhere.

        ``max_stale`` is the fold's horizon in center versions (older
        results are discarded and counted in ``stale_discarded``);
        ``iw_clip`` truncates the mean-normalized importance ratios.
        ``replay`` (an ``AsyncEventLog`` or its dict, the JAX package's
        schema) re-drives that recorded schedule instead of running live,
        bit-identical to the live run; the live run's log is left on
        :attr:`async_event_log`.
        """
        from .scheduler import GenerationScheduler, train_overlap

        if strategy not in ("auto", "fold", "overlap"):
            raise ValueError(f"strategy must be auto|fold|overlap, got {strategy!r}")
        if strategy == "auto":
            strategy = "fold" if self.backend == "host" else "overlap"
        self._setup_n_proc(n_proc)
        if strategy == "overlap":
            if replay is not None:
                raise ValueError(
                    "replay re-drives a fold-mode event log; the overlap "
                    "scheduler is bit-identical to train() already")
            return train_overlap(self, n_steps, log_fn=log_fn, verbose=verbose,
                                 max_consecutive_rejections=max_consecutive_rejections)
        sched = GenerationScheduler(self, max_stale=max_stale, iw_clip=iw_clip,
                                    max_consecutive_rejections=max_consecutive_rejections)
        if replay is not None:
            return sched.replay(replay, log_fn=log_fn, verbose=verbose, n_steps=n_steps)
        return sched.run(n_steps, log_fn=log_fn, verbose=verbose)

    def train_elastic(self, n_steps: int, fleet=None,
                      log_fn: Callable[[dict], None] | None = None, verbose: bool = True,
                      max_consecutive_rejections: int = 3, max_stale: int = 16,
                      iw_clip: float = 2.0, replay=None) -> "ES":
        """Elastic multi-host generations (``parallel/elastic.py``): remote
        hosts evaluate whole-population dispatches as async sources, this
        process folds their fitness with clipped importance weights and
        sends only the ``dim``-float center back after each update.  A slow
        host costs throughput; a dead host costs ``results_lost``, replaced
        by more dispatches, never the run.

        ``fleet`` is an ``ElasticCoordinator`` that hosts have joined or
        will join (membership may change mid-run).  ``replay`` re-drives a
        recorded ``AsyncEventLog`` as pure math, with no fleet:
        bit-identical params.  The live run's log is left on
        :attr:`async_event_log`."""
        from .scheduler import ElasticScheduler

        if fleet is None and replay is None:
            raise ValueError(
                "train_elastic needs a fleet (ElasticCoordinator) to run live, or replay= to "
                "re-drive a recorded log")
        sched = ElasticScheduler(self, fleet, max_stale=max_stale, iw_clip=iw_clip,
                                 max_consecutive_rejections=max_consecutive_rejections)
        if replay is not None:
            return sched.replay(replay, log_fn=log_fn, verbose=verbose, n_steps=n_steps)
        return sched.run(n_steps, log_fn=log_fn, verbose=verbose)

    @property
    def async_event_log(self):
        """The last fold-mode ``train_async`` or ``train_elastic`` run's event
        log (None before one)."""
        return getattr(self, "_async_log", None)

    def _track_best(self, prev_state, fitness: np.ndarray,
                    metrics: dict | None = None) -> tuple[float, bool]:
        """Best-member snapshot: (generation max, whether it is a new best).
        A new best's params are rebuilt from the generation's offsets, or,
        on the sharded engine, gathered from ``metrics["best_theta"]`` (the
        ranks' shards; the improvement is the global fitness's, so every
        rank gathers)."""
        finite_any = bool(np.isfinite(fitness).any())
        gen_best = float(np.nanmax(fitness)) if finite_any else float("nan")
        improved = finite_any and gen_best > self.best_reward
        if improved:
            self.best_reward = gen_best
            if metrics is not None and "best_theta" in metrics:
                self._best_flat = self.engine.layout.gather(metrics["best_theta"])
            else:
                self._best_flat = self.engine.member_params(prev_state,
                                                            int(np.nanargmax(fitness)))
        return gen_best, improved

    def _base_record(self, prev_state, fitness: np.ndarray, steps: int,
                     grad_norm: float, dt: float, sigma: float | None = None,
                     metrics: dict | None = None) -> dict:
        """A generation's record, shared by every train loop (ES, the
        novelty family, IW-ES and the overlap scheduler add their fields to
        it).  ``sigma`` is the σ the generation sampled under, when the
        caller has it on the host already; ``metrics`` carries the sharded
        engine's ``best_theta``."""
        fitness = np.asarray(fitness)
        finite_any = bool(np.isfinite(fitness).any())
        with self.obs.phase("record"):  # a new best's params are device work
            gen_best, improved = self._track_best(prev_state, fitness, metrics)
        record = {
            "generation": self.generation,
            "reward_max": gen_best,
            "reward_mean": float(np.nanmean(fitness)) if finite_any else float("nan"),
            "reward_min": float(np.nanmin(fitness)) if finite_any else float("nan"),
            "n_failed": int(fitness.size - np.isfinite(fitness).sum()),
            "best_reward": self.best_reward,
            "improved_best": improved,
            "env_steps": int(steps),
            "env_steps_per_sec": steps / dt if dt > 0 else 0.0,
            "grad_norm": float(grad_norm),
            "sigma": float(prev_state.sigma) if sigma is None else float(sigma),
            "wall_time_s": dt,
        }
        return self._finalize_record(record)

    def _finalize_record(self, record: dict) -> dict:
        """The plumbing every train loop shares (sync, fold, overlap): the
        native loads of the generation claimed, the spans flushed into
        ``phases``, the compile events since the last record, the cost
        model once a run, and the run's counters."""
        self._claim_compiles()
        record["phases"] = self.obs.take_phases()
        compile_events = self.obs.take_compile_events()
        if compile_events:
            record["compile_events"] = compile_events
        if not self._cost_model_emitted and self.obs.cost_model is not None:
            record["cost_model"] = self.obs.cost_model
            self._cost_model_emitted = True
        self.obs.counters.inc("env_steps", record["env_steps"])
        if record["n_failed"]:
            self.obs.counters.inc("rollout_failures", record["n_failed"])
        return record

    def _emit_record(self, record: dict, log_fn: Callable[[dict], None] | None,
                     verbose: bool) -> None:
        self.history.append(record)
        self.generation += 1
        if log_fn is not None:
            log_fn(record)
        elif verbose:
            print(self._format_record(record))

    def _format_record(self, r: dict) -> str:
        return (f"gen {r['generation']:4d}  max {r['reward_max']:9.2f}  "
                f"mean {r['reward_mean']:9.2f}  best {r['best_reward']:9.2f}  "
                f"steps/s {r['env_steps_per_sec']:,.0f}")

    # ----------------------------------------------------------- observability

    def run_manifest(self, extra: dict | None = None) -> dict:
        """The facts of this run (``obs/manifest.py``): the JAX package's
        config keys, torch's versions, the run's device, the git sha."""
        from ..obs.manifest import collect_manifest

        cfg = getattr(self, "config", None)  # the device and pooled engines' config
        config = {
            "algorithm": type(self).__name__,
            "backend": self.backend,
            "population_size": self.population_size,
            "sigma": self.sigma,
            "seed": self.seed,
            "compute_dtype": cfg.compute_dtype if cfg else "float32",
            "mirrored": cfg.mirrored if cfg else bool(self.engine.mirrored),
            "obs_norm": bool(cfg and cfg.obs_norm),
            "low_rank": cfg.low_rank if cfg else 0,
            "decomposed": bool(cfg and cfg.decomposed),
            "streamed": bool(cfg and cfg.streamed),
            "shard_params": self._shard_params,
        }
        if self._scenarios is not None:
            # the spec and its draw seed are the scenarios: the manifest
            # names exactly what this run trained under
            config["scenarios"] = self._scenarios.spec_json()
        mesh = getattr(self, "mesh", None)
        if self._shard_params:
            from ..parallel.mesh import partition_rules_to_json

            config["noise_mode"] = self._noise_mode
            config["mesh_axes"] = mesh.shape
            config["partition_rules"] = partition_rules_to_json(self.engine.partition_rules)
        elif mesh is not None and mesh.devices.size > 1:
            # this process lists its own device (process_index = its rank);
            # the mesh's size says how many ranks the run spans
            config["mesh_axes"] = mesh.shape
        return collect_manifest(config=config, devices=[self.device], extra=extra)

    def write_manifest(self, path: str, extra: dict | None = None) -> str | None:
        """Write :meth:`run_manifest` atomically; under a mesh only rank 0
        writes (the others get None)."""
        from ..obs.manifest import write_manifest

        return write_manifest(path, self.run_manifest(extra))

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

    def predict(self, obs, use_best: bool = False, carry=None):
        """Policy forward pass with the current (or best) parameters, on the
        ES's device.

        Recurrent policies return ``(out, new_carry)``; pass the returned
        carry back in on the next step (``carry=None`` starts an episode
        from the policy's ``carry_init``).

        Runs the SAME function the serving stack builds
        (``serve/predictor.py``): normalization composed inside, params and
        running obs stats as arguments, under ``torch.inference_mode()``.
        So an exported bundle's ``predict`` and a server's batched
        responses are bit-comparable to this method on the same device.
        Batched ``obs`` (a leading batch axis) is supported and is the
        server's forward at that batch size.  The host backend returns its
        torch policy's forward.
        """
        from ..serve.predictor import as_obs, make_single_predict

        if self.backend == "host":
            policy = self.best_policy if use_best else self.policy
            with torch.no_grad():
                return policy(torch.as_tensor(np.asarray(obs), dtype=torch.float32)
                              .to(self.device))
        flat = self._best_flat if use_best and self._best_flat is not None else None
        params = self.spec.unravel(self.state.params_flat if flat is None else flat)
        stats = self.state.obs_stats if self.config.obs_norm else None
        if self._predict_fn is None:
            self._predict_fn = make_single_predict(
                self.module.apply_params, recurrent=self._recurrent,
                obs_norm=self.config.obs_norm, obs_clip=self.config.obs_clip)
        obs = as_obs(obs, self.device)
        if self._recurrent:
            if carry is None:
                from ..envs.rollout import episode_carry

                carry = episode_carry(self.module, params, self.device)
            return self._predict_fn(params, stats, obs, carry)
        return self._predict_fn(params, stats, obs)

    def export_bundle(self, path: str, use_best: bool = False,
                      version: str | int | None = None,
                      extra: dict | None = None, **kwargs) -> str:
        """Export this policy as a versioned serving bundle
        (``serve/bundle.py``): params + frozen VBN stats + obs-normalization
        moments + a manifest (module spec, git sha, torch/CUDA versions, the
        card, provenance), committed atomically.  Serve it with ``python -m
        estorch_tpu_torch.serve --bundle <path>``.  The host backend is
        refused (``NotImplementedError``)."""
        from ..serve.bundle import export_bundle

        return export_bundle(self, path, use_best=use_best, version=version,
                             extra=extra, **kwargs)

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

        ``meta_index`` evaluates that center of the novelty family's
        meta-population (``NS_ES`` and its variants) in place of
        ``self.state``, meta-population center 0.
        """
        if meta_index is not None:
            if not hasattr(self, "meta_states"):
                raise ValueError("meta_index applies to the novelty family (NS/NSR/NSRA)")
            if use_best:
                raise ValueError(
                    "use_best evaluates the GLOBAL best member snapshot — "
                    "it cannot be combined with meta_index (per-center eval)")
            base_state = self.meta_states[meta_index]
        else:
            base_state = self.state
        flat = self._best_flat if use_best and self._best_flat is not None else None
        if self.backend == "host":
            state = base_state if flat is None else base_state._replace(params_flat=flat)
            rewards = np.asarray([self.engine.evaluate_center(state).total_reward
                                  for _ in range(int(n_episodes))], np.float32)
            summary = _summary(rewards, n_episodes)
            if return_details:
                summary.update(rewards=rewards, bc=None)
            return summary
        if self.backend == "pooled":
            # one pooled pass of fresh episodes from a pool seeded by ``seed``,
            # in the compute dtype, as the JAX package's pooled path evaluates
            state = base_state if flat is None else base_state._replace(params_flat=flat)
            res = self.engine.evaluate_center_batch(state, int(n_episodes), seed=seed)
            rewards = np.asarray(res.fitness, np.float32)
            summary = _summary(rewards, n_episodes)
            if return_details:
                summary.update(rewards=rewards, bc=res.bc)
            return summary
        states0, _ = self.env.reset(torch.Generator().manual_seed(int(seed)), int(n_episodes))
        want_gait = return_details and hasattr(self.env, "step_metrics")
        out = self.engine.evaluate_episodes(base_state, states0, flat, with_env_metrics=want_gait)
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
