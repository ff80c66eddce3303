"""The ES generation engine on one device.

Counterpart of ``estorch_tpu/parallel/engine.py``: ``EngineConfig``,
``ESState``, the obs-normalization helpers and ``ESEngine``.  One
generation

1. samples the row offsets (one per mirrored pair, or per member) and the
   initial env states from a generator seeded from ``(seed, generation)``;
2. rolls the population out in ``eval_chunk``-member chunks, one policy
   call per env step for a whole chunk, through one of four forwards:

   - standard: each member's θ_i = θ + σ s_i ε_i materialized once per
     chunk, then one batched product per layer per step;
   - ``decomposed``: x @ W once over the chunk plus a batched noise term
     (``models/decomposed.py``);
   - ``low_rank``: the same with factored noise A Bᵀ/√r (``ops/lowrank.py``);
   - ``streamed``: the noise term read from the table by the
     ``population_noise_matvec`` kernel (``ops/noise_kernels.py``);

   a recurrent policy (``carry_init`` given) runs the standard forward,
   or with ``low_rank`` each member's tree perturbed by the tree form's
   dense noise (``ops/lowrank.py``), both formed once a chunk; its carry
   starts each episode at ``carry_init`` of the member's params (a learned
   carry) and freezes after termination;

3. ranks the fitness (``centered_rank_safe``);
4. reduces the rank weights against the noise: the ``weighted_noise_sum``
   kernel (``noise_kernel=True``), the chunked plain reduction
   (``ops/gradient.py``), or one einsum per layer for ``low_rank``;
5. applies weight decay, the optimizer step and σ annealing, and, with
   ``obs_norm``, refreshes the running observation moments from episodes
   of the center policy.

The JAX package runs this as one program over a device mesh with a psum;
with one device the psum is the identity.  The mesh waits for ROADMAP.md
port queue item 7.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..envs.rollout import (
    carry_init_takes_params,
    make_batched_rollout,
    map_carry,
    member_params_apply,
)
from ..models.decomposed import mlp_decomposed_population_apply, mlp_lowrank_population_apply
from ..ops.gradient import es_gradient, fold_mirrored_weights, rank_weighted_noise_sum
from ..ops.lowrank import (
    LowRankSpec,
    LowRankTreeSpec,
    lowrank_noise_tree,
    lowrank_tree_noise,
    lowrank_tree_perturb,
    lowrank_tree_weighted_sum,
    lowrank_weighted_sum,
)
from ..ops.noise import NoiseTable, gather_rows, member_offsets, pair_signs, sample_pair_offsets
from ..ops.noise_kernels import weighted_noise_sum
from ..ops.params import ParamSpec, map_tree
from ..ops.ranks import centered_rank_safe


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration (the JAX package's ``EngineConfig``)."""

    population_size: int
    sigma: float
    horizon: int
    eval_chunk: int = 0  # members per rollout chunk; 0 → the whole population
    grad_chunk: int = 256  # noise rows per chunk of the plain update reduction
    weight_decay: float = 0.0  # L2 pull toward 0, applied with the update
    compute_dtype: str = "float32"  # "bfloat16" runs the policy forward in bf16;
    # params, noise table, env dynamics and the update stay float32
    sigma_decay: float = 1.0  # per-generation multiplicative σ annealing
    sigma_min: float = 0.0  # σ floor when annealing
    mirrored: bool = True  # antithetic pairs
    episodes_per_member: int = 1  # rollouts averaged per member
    decomposed: bool = False  # z = x@W + c(x@E): one shared product per layer
    noise_kernel: bool = False  # the weighted_noise_sum kernel update
    low_rank: int = 0  # >0: per-layer kernel noise A·Bᵀ/√r of this rank
    streamed: bool = False  # the streamed population forward (kernel noise term)
    obs_norm: bool = False  # running observation normalization
    obs_clip: float = 5.0  # normalized-obs clip range
    obs_probe_episodes: int = 1  # center episodes a generation feeding the stats
    obs_warmup_episodes: int = 0  # init-policy probe episodes folded in at init


class ESState(NamedTuple):
    """Everything needed to resume a run exactly."""

    params_flat: torch.Tensor  # (dim,) float32 — center of the search distribution
    opt_state: Any
    seed: int  # with ``generation``, seeds the per-generation sample
    generation: int
    sigma: torch.Tensor  # () float32 — current perturbation scale
    obs_stats: Any = None  # obs_norm only: the (count, mean, m2) Welford triple
    # of the raw observations, float32 tensors of shapes (), (obs_dim,), (obs_dim,)


class Sample(NamedTuple):
    """One generation's random draws: one table offset and the initial env
    states of one noise row (per pair when mirrored, per member otherwise),
    and the probe episodes' initial states."""

    offsets: torch.Tensor  # (rows,) int32
    states: torch.Tensor  # (rows, state_dim), or (rows, e, state_dim) when
    # episodes_per_member = e > 1
    probe_states: torch.Tensor | None = None  # (obs_probe_episodes, state_dim);
    # obs_norm only


def normalize_obs(obs: torch.Tensor, obs_stats, clip: float) -> torch.Tensor:
    """(obs − mean)·rsqrt(var) clipped to ±clip, in float32; var = m2/count,
    floored at 1e-8."""
    cnt, mean, m2 = obs_stats
    var = torch.clamp(m2 / cnt, min=1e-8)
    x = (obs.to(torch.float32) - mean) * torch.rsqrt(var)
    return torch.clamp(x, -clip, clip)


def merge_obs_moments(obs_stats, cnt1, osum1, osumsq1):
    """Chan's parallel update in float32: fold one generation's raw probe
    sums (a few episodes' worth) into the running Welford triple.  For
    larger sums use :func:`merge_obs_moments_np`."""
    c0, mean0, m2_0 = obs_stats
    mean1 = osum1 / cnt1
    m2_1 = torch.clamp(osumsq1 - osum1 * mean1, min=0.0)
    tot = c0 + cnt1
    delta = mean1 - mean0
    mean = mean0 + delta * (cnt1 / tot)
    m2 = m2_0 + m2_1 + delta * delta * (c0 * cnt1 / tot)
    return tot, mean, m2


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def merge_obs_moments_np(obs_stats, cnt1: float, osum1, osumsq1):
    """The same merge in float64 on the host, for sums of many episodes
    (where ``sumsq − sum·mean`` cancels in float32).  Returns float32
    tensors on the device of ``obs_stats``; the stored count is a float32,
    exact below 2^24 samples."""
    device = obs_stats[1].device
    c0 = float(_np64(obs_stats[0]))
    m0, big_m0 = _np64(obs_stats[1]), _np64(obs_stats[2])
    c1 = float(cnt1)
    s1, q1 = _np64(osum1), _np64(osumsq1)
    mean1 = s1 / c1
    m2_1 = np.maximum(q1 - s1 * mean1, 0.0)
    tot = c0 + c1
    delta = mean1 - m0
    mean = m0 + delta * (c1 / tot)
    m2 = big_m0 + m2_1 + delta * delta * (c0 * c1 / tot)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    return f32(tot), f32(mean), f32(m2)


def _choose_eval_chunk(requested: int, members: int) -> int:
    """Largest divisor of ``members`` that is ≤ the requested chunk."""
    if requested <= 0 or requested >= members:
        return members
    c = requested
    while members % c != 0:
        c -= 1
    return c


def generation_seed(seed: int, generation: int) -> int:
    """The generator seed of ``generation``: a hash of (seed, generation),
    so a re-run of a generation draws the same sample."""
    return _seed_of(seed, generation)


def _seed_of(*words: int) -> int:
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


# streams besides the per-generation sample, each with a seed of its own
_CENTER_STREAM = 1  # evaluate_center's initial state
_WARMUP_STREAM = 2  # init_state's obs-norm warm-up episodes
_VBN_STREAM = 3  # ES's device-path VBN reference batch


class ESEngine:
    """Runs generations of ES on one device.

    ``module`` is the policy (its ``apply_params`` is the standard and the
    probe forward); ``streamed_apply(shared, table_data, member_offsets, c,
    obs)`` is needed for ``streamed``, ``lowrank_spec`` for ``low_rank``
    (a ``LowRankTreeSpec`` for a recurrent policy).  ``carry_init`` marks a
    recurrent policy (``module.population_layout`` /
    ``population_apply(layout, obs, carry)``): ``carry_init(params)`` or
    the zero-argument ``carry_init()`` gives the episode-start carry.

    With ``env=None`` the engine builds no rollouts (update-only mode): the
    evaluation happens elsewhere (the pooled path, ``parallel/pooled.py``),
    which draws this generation's offsets with :meth:`all_pair_offsets` and
    hands the rank weights back to :meth:`apply_weights`.
    """

    def __init__(self, env: Any, module: Any, spec: ParamSpec, table: NoiseTable,
                 optimizer: Any, config: EngineConfig, device: torch.device,
                 streamed_apply: Callable[..., torch.Tensor] | None = None,
                 lowrank_spec: LowRankSpec | LowRankTreeSpec | None = None,
                 carry_init: Callable[..., Any] | None = None):
        if carry_init is not None and (config.decomposed or config.streamed):
            # these restructure the forward around the MLP's layers; low_rank
            # composes through the tree form and the standard rollout
            raise ValueError(
                "recurrent policies run the standard forward; they are "
                "mutually exclusive with decomposed/streamed")
        if config.obs_norm and env is None:
            raise ValueError(
                "obs_norm needs device-native rollouts to carry the running stats "
                "in-program; it is a device-path option")
        if config.low_rank:
            if config.decomposed or config.streamed or config.noise_kernel:
                raise ValueError(
                    "low_rank replaces the full-rank noise pathway; it is "
                    "mutually exclusive with decomposed/streamed/noise_kernel")
            if lowrank_spec is None:
                raise ValueError(
                    "EngineConfig.low_rank needs a lowrank_spec "
                    "(ops/lowrank.py; ES builds it for MLPPolicy)")
        if config.streamed:
            if config.decomposed:
                raise ValueError("streamed IS the kernel form of decomposed — enable one")
            if config.episodes_per_member != 1:
                raise ValueError("streamed currently supports episodes_per_member=1")
            if config.compute_dtype != "float32":
                raise ValueError("streamed runs in float32 (the table and kernel are f32)")
            if streamed_apply is None and env is not None:
                raise ValueError(
                    "EngineConfig.streamed=True needs a streamed_apply "
                    "(ops/noise_kernels.py::mlp_streamed_apply for MLPPolicy)")
        if config.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32 or bfloat16, got {config.compute_dtype!r}")
        if config.episodes_per_member < 1:
            raise ValueError(
                f"episodes_per_member must be >= 1, got {config.episodes_per_member}")
        if config.mirrored and config.population_size % 2:
            raise ValueError(
                f"mirrored sampling needs an even population, got {config.population_size}")
        self.env = env
        self.module = module
        self.spec = spec
        self.table = table
        self.optimizer = optimizer
        self.config = config
        self.device = torch.device(device)
        self._streamed_apply = streamed_apply
        self._carry_init = carry_init
        self.recurrent = carry_init is not None
        self._ci_takes_params = self.recurrent and carry_init_takes_params(carry_init)
        self.lr_spec = lowrank_spec if config.low_rank else None
        # the per-row noise vector the table serves: (dim,) full-rank, the
        # packed factors for low rank; everything that samples offsets or
        # slices noise uses this, not spec.dim
        self.noise_dim = self.lr_spec.noise_dim if config.low_rank else spec.dim
        self._dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
        self._rollout = make_batched_rollout(env, config.horizon) if env is not None else None
        self._probe_rollout = (make_batched_rollout(env, config.horizon, with_obs_moments=True)
                               if config.obs_norm else None)
        self._eval_rollouts: dict[bool, Callable[..., Any]] = {}  # evaluate_episodes
        self.rows = config.population_size // 2 if config.mirrored else config.population_size
        self.eval_chunk = _choose_eval_chunk(config.eval_chunk, config.population_size)

    # ------------------------------------------------------------- state

    def init_state(self, params_flat: torch.Tensor, seed: int,
                   warmup_states: torch.Tensor | None = None) -> ESState:
        """The state before generation 0.

        With ``obs_norm`` the stats start at count 1, mean 0, m2 1 (var 1);
        ``obs_warmup_episodes`` > 0 then folds that many episodes of the
        initial policy in, in float64 on the host.  Their initial states
        are ``warmup_states`` (obs_warmup_episodes, state_dim), or drawn from
        a stream of ``seed`` of their own.
        """
        if params_flat.shape != (self.spec.dim,):
            raise ValueError(f"params_flat must be ({self.spec.dim},), got {tuple(params_flat.shape)}")
        params_flat = params_flat.to(self.device, torch.float32)
        if not bool(torch.isfinite(params_flat).all()):
            raise ValueError("initial params contain non-finite values")
        obs_stats = None
        if self.config.obs_norm:
            obs_dim = int(self.env.obs_dim)
            obs_stats = (torch.tensor(1.0, device=self.device),
                         torch.zeros((obs_dim,), device=self.device),
                         torch.ones((obs_dim,), device=self.device))
            warm = self.config.obs_warmup_episodes
            if warm > 0:
                if warmup_states is None:
                    gen = torch.Generator().manual_seed(_seed_of(seed, 0, _WARMUP_STREAM))
                    warmup_states, _ = self.env.reset(gen, warm)
                c, s, q = self._probe_moments(params_flat, obs_stats,
                                              warmup_states.to(self.device))
                obs_stats = merge_obs_moments_np(obs_stats, float(c), s, q)
        return ESState(
            params_flat=params_flat,
            opt_state=self.optimizer.init(params_flat),
            seed=int(seed),
            generation=0,
            sigma=torch.tensor(self.config.sigma, dtype=torch.float32, device=self.device),
            obs_stats=obs_stats,
        )

    def sample(self, state: ESState) -> Sample:
        """This generation's offsets and initial states.

        Drawn on the CPU from a generator seeded by
        :func:`generation_seed`, then moved, so one ``(seed, generation)``
        gives the same sample on every device.  Pair members share their
        initial states (all e of them), as the JAX package's shared pair
        keys give them.
        """
        cfg = self.config
        gen = self._generation_generator(state)
        offsets = sample_pair_offsets(gen, self.rows, self.table.size, self.noise_dim)
        e = cfg.episodes_per_member
        states, _ = self.env.reset(gen, self.rows * e)
        if e > 1:
            states = states.view(self.rows, e, -1)
        probe = None
        if cfg.obs_norm:
            probe, _ = self.env.reset(gen, cfg.obs_probe_episodes)
            probe = probe.to(self.device)
        return Sample(offsets.to(self.device), states.to(self.device), probe)

    @staticmethod
    def _generation_generator(state: ESState) -> torch.Generator:
        """The generator of ``state``'s generation; the offsets are its
        first draw."""
        return torch.Generator().manual_seed(generation_seed(state.seed, state.generation))

    def all_pair_offsets(self, state: ESState) -> torch.Tensor:
        """This generation's offsets, per pair (mirrored) or per member, on
        the device: exactly those :meth:`sample` draws first, so an outside
        evaluator perturbs with the noise the update reduces."""
        return sample_pair_offsets(self._generation_generator(state), self.rows,
                                   self.table.size, self.noise_dim).to(self.device)

    # --------------------------------------------------------- generation

    def generation_step(self, state: ESState, sample: Sample | None = None):
        """One fused ES generation: returns ``(new_state, metrics)``.

        ``sample`` replaces this generation's draws (tests hand in the JAX
        package's); ``ES.train`` never passes it.  Nothing here waits for
        the device; the metrics are device tensors.
        """
        sample = self.sample(state) if sample is None else sample
        fitness, bc, steps = self._evaluate(state, sample)
        weights, n_valid = centered_rank_safe(fitness)
        grad = self._grad(state, weights, sample.offsets)
        new_state, gnorm = self._finish_update(state, grad, sample.probe_states)
        metrics = {
            "fitness": fitness,
            "bc": bc,
            "steps": steps,
            "grad_norm": gnorm,
            "n_valid": n_valid,
            # post-update guard input: ES.train rejects the generation when
            # the new params or the update norm are non-finite
            "update_finite": torch.logical_and(
                torch.isfinite(gnorm), torch.isfinite(new_state.params_flat).all()),
        }
        return new_state, metrics

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        """bf16 path: a member's params are cast once, where they are built."""
        return t.to(self._dtype)

    def _members(self, sample: Sample):
        """Per-member (offsets, signs, initial states (n, e, state_dim))."""
        cfg = self.config
        states = sample.states
        if states.ndim == 2:
            states = states[:, None, :]
        if cfg.mirrored:
            return (member_offsets(sample.offsets),
                    pair_signs(cfg.population_size, self.device),
                    torch.repeat_interleave(states, 2, dim=0))
        ones = torch.ones((cfg.population_size,), dtype=torch.float32, device=self.device)
        return sample.offsets, ones, states

    def _evaluate(self, state: ESState, sample: Sample):
        """Fitness (n,), BC (n, bc_dim) and the summed alive steps of the
        population, rolled out chunk by chunk."""
        cfg = self.config
        offs, signs, states = self._members(sample)
        e = cfg.episodes_per_member
        # the center, unraveled (and cast) once a generation: its product
        # is one matmul over each chunk (the standard forward forms θ_i
        # instead)
        shared = self.spec.unravel(self._cast(state.params_flat))
        fits, bcs, steps = [], [], []
        for lo in range(0, cfg.population_size, self.eval_chunk):
            hi = lo + self.eval_chunk
            apply, carry0 = self._chunk_apply(state, shared, offs[lo:hi], signs[lo:hi])
            states0 = states[lo:hi].reshape((hi - lo) * e, -1)
            res = self._rollout(apply, states0, self.env.observe(states0), carry0)
            # fitness = mean return; BC = the first episode's; steps summed
            fits.append(res.total_reward.view(hi - lo, e).mean(dim=1))
            bcs.append(res.bc.view(hi - lo, e, -1)[:, 0])
            steps.append(res.steps.sum())
        return torch.cat(fits), torch.cat(bcs), torch.stack(steps).sum()

    def _episode_carry(self, params: dict, k: int, e: int, dtype: torch.dtype):
        """The episode-start carry of k policies' e episodes each, leaves
        (k·e, size) in ``dtype`` on the device, cast once: ``carry_init`` of
        ``params`` (a member-batched tree gives each member its own learned
        carry; a single policy's tree, or the zero-argument form, one carry
        for all)."""
        h0 = self._carry_init(params) if self._ci_takes_params else self._carry_init()

        def rows(x: torch.Tensor) -> torch.Tensor:
            x = x.to(self.device, dtype)
            if x.ndim == 1:
                x = x.expand(k, x.shape[0])
            return x.repeat_interleave(e, dim=0)

        return map_carry(rows, h0)

    def _chunk_apply(self, state: ESState, shared, offs: torch.Tensor, signs: torch.Tensor):
        """``(batched_apply, carry0)`` for the k members of one chunk, their
        noise read once here: ``batched_apply(raw obs (k·e, obs_dim)) -> (k·e,
        act)``, and for a recurrent policy ``batched_apply(obs, carry) ->
        (out, carry')`` from the episode-start ``carry0`` (else None)."""
        cfg = self.config
        data = self.table.data
        k = offs.shape[0]
        c = state.sigma * signs
        carry0 = None
        if cfg.streamed:  # float32 and one episode a member: x is (k, 1, d)
            def fwd(x):
                return self._streamed_apply(shared, data, offs, c, x[:, 0])
        elif self.recurrent:
            if cfg.low_rank:
                # the tree form: each member's dense perturbation formed once,
                # in float32, then cast
                noise = gather_rows(data, offs, self.noise_dim)
                tree = lowrank_tree_perturb(self.lr_spec, self.spec.unravel(state.params_flat),
                                            noise, c)
                members = map_tree(self._cast, tree)
            else:
                theta = state.params_flat + c[:, None] * gather_rows(data, offs, self.spec.dim)
                members = self.spec.unravel(self._cast(theta))
            layout = self.module.population_layout(members)
            carry0 = self._episode_carry(members, k, cfg.episodes_per_member, self._dtype)

            def fwd(x, carry):
                return self.module.population_apply(layout, x, carry)
        elif cfg.low_rank:
            lrn = self.lr_spec.unpack(self._cast(gather_rows(data, offs, self.noise_dim)))
            cc = self._cast(c)

            def fwd(x):
                return mlp_lowrank_population_apply(self.module, shared, lrn, cc, x)
        elif cfg.decomposed:
            noise = self.spec.unravel(self._cast(gather_rows(data, offs, self.spec.dim)))
            cc = self._cast(c)

            def fwd(x):
                return mlp_decomposed_population_apply(self.module, shared, noise, cc, x)
        else:
            theta = state.params_flat + c[:, None] * gather_rows(data, offs, self.spec.dim)
            members = self.spec.unravel(self._cast(theta))

            def fwd(x):
                return member_params_apply(self.module, members, x)

        def batched_apply(obs: torch.Tensor, *carry):
            if cfg.obs_norm:
                # normalized in float32 against this generation's stats,
                # then cast: every member sees the same snapshot
                obs = normalize_obs(obs, state.obs_stats, cfg.obs_clip)
            n = obs.shape[0]
            x = self._cast(obs).reshape(k, -1, obs.shape[-1])
            if not carry:
                return fwd(x).reshape(n, -1).to(torch.float32)
            out, h = fwd(x, map_carry(lambda t: t.reshape(k, -1, t.shape[-1]), carry[0]))
            return out.reshape(n, -1).to(torch.float32), map_carry(lambda t: t.reshape(n, -1), h)

        return batched_apply, carry0

    def _center_apply(self, params_flat: torch.Tensor, obs_stats, rows: int,
                      dtype: torch.dtype | None = None):
        """``(apply, carry0)``: the standard forward of one policy for
        ``rows`` episodes, for the probe and :meth:`evaluate_center` (in the
        compute dtype) and for :meth:`evaluate_episodes`
        (``dtype=torch.float32``); ``carry0`` as in :meth:`_chunk_apply`."""
        cfg = self.config
        dtype = self._dtype if dtype is None else dtype
        params = self.spec.unravel(params_flat.to(dtype))

        def norm(obs: torch.Tensor) -> torch.Tensor:
            if cfg.obs_norm:
                obs = normalize_obs(obs, obs_stats, cfg.obs_clip)
            return obs.to(dtype)

        if not self.recurrent:
            def apply(obs: torch.Tensor) -> torch.Tensor:
                return self.module.apply_params(params, norm(obs)).to(torch.float32)

            return apply, None
        layout = self.module.population_layout(params)

        def recurrent_apply(obs: torch.Tensor, carry):
            out, carry = self.module.population_apply(layout, norm(obs), carry)
            return out.to(torch.float32), carry

        return recurrent_apply, self._episode_carry(params, rows, 1, dtype)

    # -------------------------------------------------------------- update

    def _grad(self, state: ESState, weights: torch.Tensor, red_offs: torch.Tensor):
        """The ascent direction from per-member rank weights; ``red_offs``
        is per pair (mirrored: folded estimator) or per member."""
        cfg = self.config
        row_w = fold_mirrored_weights(weights) if cfg.mirrored else weights
        scale = cfg.population_size * state.sigma
        if cfg.low_rank:
            # one einsum per layer over the stacked factors: no member's
            # dense E is formed
            noise = gather_rows(self.table.data, red_offs, self.noise_dim)
            wsum = (lowrank_tree_weighted_sum if isinstance(self.lr_spec, LowRankTreeSpec)
                    else lowrank_weighted_sum)
            return self.spec.flatten(wsum(self.lr_spec, noise, row_w)) / scale
        if cfg.noise_kernel:
            return weighted_noise_sum(self.table.data, red_offs, row_w.contiguous(),
                                      self.spec.dim) / scale
        if cfg.mirrored:
            return es_gradient(self.table, red_offs, weights, sigma=state.sigma,
                               population_size=cfg.population_size, dim=self.spec.dim,
                               chunk=cfg.grad_chunk)
        return rank_weighted_noise_sum(self.table, red_offs, weights, dim=self.spec.dim,
                                       chunk=cfg.grad_chunk) / scale

    def apply_weights(self, state: ESState, weights: torch.Tensor,
                      pair_offsets: torch.Tensor | None = None):
        """The update from per-member rank weights of an evaluation made
        elsewhere: ``(new_state, grad_norm)``.  ``pair_offsets`` are the
        generation's offsets (tests hand in the JAX package's), by default
        :meth:`all_pair_offsets`."""
        offs = self.all_pair_offsets(state) if pair_offsets is None else pair_offsets
        grad = self._grad(state, weights.to(self.device, torch.float32), offs.to(self.device))
        return self._finish_update(state, grad)

    def _finish_update(self, state: ESState, grad_ascent: torch.Tensor,
                       probe_states: torch.Tensor | None = None):
        """Weight decay, the optimizer step, σ annealing and, with
        ``obs_norm``, the stats refresh from probe episodes of the
        generation's (pre-update) center, from ``probe_states``."""
        cfg = self.config
        if cfg.weight_decay > 0.0:
            grad_ascent = grad_ascent - cfg.weight_decay * state.params_flat
        updates, new_opt_state = self.optimizer.update(-grad_ascent, state.opt_state)
        new_sigma = state.sigma
        if cfg.sigma_decay != 1.0:
            new_sigma = torch.clamp(state.sigma * cfg.sigma_decay, min=cfg.sigma_min)
        new_obs_stats = state.obs_stats
        if cfg.obs_norm:
            if probe_states is None:
                raise ValueError("obs_norm needs the sample's probe_states")
            moments = self._probe_moments(state.params_flat, state.obs_stats, probe_states)
            new_obs_stats = merge_obs_moments(state.obs_stats, *moments)
        new_state = ESState(
            params_flat=state.params_flat + updates,
            opt_state=new_opt_state,
            seed=state.seed,
            generation=state.generation + 1,
            sigma=new_sigma,
            obs_stats=new_obs_stats,
        )
        return new_state, torch.linalg.vector_norm(grad_ascent)

    def _probe_moments(self, params_flat: torch.Tensor, obs_stats, states0: torch.Tensor):
        """Summed (count, obs_sum, obs_sumsq) of one probe episode of the
        policy at ``params_flat`` from each row of ``states0``."""
        apply, carry0 = self._center_apply(params_flat, obs_stats, states0.shape[0])
        _, m = self._probe_rollout(apply, states0, self.env.observe(states0), carry0)
        return m.count.sum(), m.obs_sum.sum(dim=0), m.obs_sumsq.sum(dim=0)

    # --------------------------------------------------------- inspection

    def evaluate_center(self, state: ESState, states0: torch.Tensor | None = None):
        """One episode of the unperturbed center → a RolloutResult of one
        row.  ``states0`` (1, state_dim), or drawn from a stream of
        ``(seed, generation)`` of its own."""
        if states0 is None:
            gen = torch.Generator().manual_seed(
                _seed_of(state.seed, state.generation, _CENTER_STREAM))
            states0, _ = self.env.reset(gen, 1)
        states0 = states0.to(self.device)
        apply, carry0 = self._center_apply(state.params_flat, state.obs_stats, 1)
        return self._rollout(apply, states0, self.env.observe(states0), carry0)

    def evaluate_episodes(self, state: ESState, states0: torch.Tensor,
                          params_flat: torch.Tensor | None = None,
                          with_env_metrics: bool = False):
        """One episode from each row of ``states0`` (n, state_dim) of the
        policy at ``params_flat`` (the center by default), in float32 and,
        with ``obs_norm``, normalized with ``state``'s current stats — the
        JAX package's ``ES.evaluate_policy`` rollout.  Returns a
        RolloutResult, or ``(RolloutResult, metric_sums (n, k))`` with
        ``with_env_metrics``."""
        key = bool(with_env_metrics)
        if key not in self._eval_rollouts:
            self._eval_rollouts[key] = make_batched_rollout(
                self.env, self.config.horizon, with_env_metrics=key)
        flat = state.params_flat if params_flat is None else params_flat
        states0 = states0.to(self.device)
        apply, carry0 = self._center_apply(flat.to(self.device, torch.float32), state.obs_stats,
                                           states0.shape[0], torch.float32)
        return self._eval_rollouts[key](apply, states0, self.env.observe(states0), carry0)

    def member_params(self, state: ESState, member_index: int,
                      sample: Sample | None = None) -> torch.Tensor:
        """One member's flat params θ + σ s ε (dense, also for low rank),
        rebuilt from this generation's offsets, e.g. to keep the best
        member."""
        offsets = self.all_pair_offsets(state) if sample is None else sample.offsets
        if self.config.mirrored:
            off = int(offsets[member_index // 2])
            sign = 1.0 if member_index % 2 == 0 else -1.0
        else:
            off = int(offsets[member_index])
            sign = 1.0
        if self.config.low_rank:
            dense = (lowrank_tree_noise if isinstance(self.lr_spec, LowRankTreeSpec)
                     else lowrank_noise_tree)
            noise = self.spec.flatten(dense(self.lr_spec, self.table.slice(off, self.noise_dim)))
        else:
            noise = self.table.slice(off, self.spec.dim)
        return state.params_flat + state.sigma * sign * noise
