"""The ES generation engine on one device.

Counterpart of ``estorch_tpu/parallel/engine.py`` for the streamed path:
``EngineConfig``, ``ESState`` and ``ESEngine.generation_step``.  One
generation

1. samples the pair offsets and the pairs' initial env states from a
   generator seeded from ``(seed, generation)``;
2. rolls the whole population out with one streamed forward per env step
   (``ops.noise_kernels.mlp_streamed_apply``);
3. ranks the fitness (``centered_rank_safe``);
4. reduces the folded pair weights against the noise with the
   ``weighted_noise_sum`` kernel, divided by n·σ;
5. applies weight decay, the optimizer step and σ annealing.

The JAX package runs this as one program over a device mesh with a psum;
with one device the psum is the identity.  The other noise paths
(standard, decomposed, low-rank), obs normalization, bf16 and the mesh are
not ported yet (ROADMAP.md, port queue).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..envs.rollout import make_batched_rollout
from ..ops.gradient import fold_mirrored_weights
from ..ops.noise import NoiseTable, member_offsets, pair_signs, sample_pair_offsets
from ..ops.noise_kernels import weighted_noise_sum
from ..ops.params import ParamSpec
from ..ops.ranks import centered_rank_safe


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration (the fields of the JAX package's
    ``EngineConfig`` that this path reads)."""

    population_size: int
    sigma: float
    horizon: int
    weight_decay: float = 0.0  # L2 pull toward 0, applied with the update
    sigma_decay: float = 1.0  # per-generation multiplicative σ annealing
    sigma_min: float = 0.0  # σ floor when annealing
    mirrored: bool = True  # antithetic pairs
    noise_kernel: bool = False  # the weighted_noise_sum kernel update
    streamed: bool = False  # the streamed population forward


class ESState(NamedTuple):
    """Everything needed to resume a run exactly."""

    params_flat: torch.Tensor  # (dim,) float32 — center of the search distribution
    opt_state: Any
    seed: int  # with ``generation``, seeds the per-generation sample
    generation: int
    sigma: torch.Tensor  # () float32 — current perturbation scale


class Sample(NamedTuple):
    """One generation's random draws: one table offset and one initial env
    state per noise row (per pair when mirrored, per member otherwise)."""

    offsets: torch.Tensor  # (rows,) int32
    states: torch.Tensor  # (rows, state_dim) float32


def generation_seed(seed: int, generation: int) -> int:
    """The generator seed of ``generation``: a hash of (seed, generation),
    so a re-run of a generation draws the same sample."""
    return int(np.random.SeedSequence([int(seed), int(generation)]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class ESEngine:
    """Runs generations of streamed-noise ES on one device."""

    def __init__(self, env: Any, spec: ParamSpec, table: NoiseTable, optimizer: Any,
                 config: EngineConfig,
                 streamed_apply: Callable[..., torch.Tensor],
                 device: torch.device):
        if not (config.streamed and config.noise_kernel):
            raise NotImplementedError(
                "the port's engine runs streamed=True with noise_kernel=True; "
                "the standard and decomposed paths are not ported yet "
                "(ROADMAP.md, port queue item 1)")
        if config.mirrored and config.population_size % 2:
            raise ValueError(
                f"mirrored sampling needs an even population, got {config.population_size}")
        self.env = env
        self.spec = spec
        self.table = table
        self.optimizer = optimizer
        self.config = config
        self.device = torch.device(device)
        # streamed_apply(shared_params, table_data, member_offsets, c, obs)
        self._streamed_apply = streamed_apply
        self._rollout = make_batched_rollout(env, config.horizon)
        self.rows = config.population_size // 2 if config.mirrored else config.population_size

    def init_state(self, params_flat: torch.Tensor, seed: int) -> ESState:
        if params_flat.shape != (self.spec.dim,):
            raise ValueError(f"params_flat must be ({self.spec.dim},), got {tuple(params_flat.shape)}")
        params_flat = params_flat.to(self.device, torch.float32)
        if not bool(torch.isfinite(params_flat).all()):
            raise ValueError("initial params contain non-finite values")
        return ESState(
            params_flat=params_flat,
            opt_state=self.optimizer.init(params_flat),
            seed=int(seed),
            generation=0,
            sigma=torch.tensor(self.config.sigma, dtype=torch.float32, device=self.device),
        )

    def sample(self, state: ESState) -> Sample:
        """This generation's offsets and initial states.

        Drawn on the CPU from a generator seeded by
        :func:`generation_seed`, then moved, so one ``(seed, generation)``
        gives the same sample on every device.  Pair members share their
        initial state, as the JAX package's shared pair keys give them.
        """
        gen = torch.Generator().manual_seed(generation_seed(state.seed, state.generation))
        offsets = sample_pair_offsets(gen, self.rows, self.table.size, self.spec.dim)
        states, _ = self.env.reset(gen, self.rows)
        return Sample(offsets.to(self.device), states.to(self.device))

    def generation_step(self, state: ESState, sample: Sample | None = None):
        """One fused ES generation: returns ``(new_state, metrics)``.

        ``sample`` replaces this generation's draws (tests hand in the JAX
        package's); ``ES.train`` never passes it.  Nothing here waits for
        the device; the metrics are device tensors.
        """
        cfg = self.config
        sample = self.sample(state) if sample is None else sample
        if cfg.mirrored:
            member_offs = member_offsets(sample.offsets)
            signs = pair_signs(cfg.population_size, self.device)
            states0 = torch.repeat_interleave(sample.states, 2, dim=0)
        else:
            member_offs = sample.offsets
            signs = torch.ones((cfg.population_size,), dtype=torch.float32, device=self.device)
            states0 = sample.states
        obs0 = self.env.observe(states0)
        c = state.sigma * signs
        shared = self.spec.unravel(state.params_flat)
        table_data = self.table.data

        def batched_apply(obs):
            return self._streamed_apply(shared, table_data, member_offs, c, obs)

        res = self._rollout(batched_apply, states0, obs0)
        fitness = res.total_reward
        weights, n_valid = centered_rank_safe(fitness)
        row_w = fold_mirrored_weights(weights) if cfg.mirrored else weights
        grad = weighted_noise_sum(table_data, sample.offsets, row_w.contiguous(),
                                  self.spec.dim) / (cfg.population_size * state.sigma)
        new_state, gnorm = self._finish_update(state, grad)
        metrics = {
            "fitness": fitness,
            "bc": res.bc,
            "steps": res.steps.sum(),
            "grad_norm": gnorm,
            "n_valid": n_valid,
            # post-update guard input: ES.train rejects the generation when
            # the new params or the update norm are non-finite
            "update_finite": torch.logical_and(
                torch.isfinite(gnorm), torch.isfinite(new_state.params_flat).all()),
        }
        return new_state, metrics

    def _finish_update(self, state: ESState, grad_ascent: torch.Tensor):
        """Weight decay, the optimizer step and σ annealing."""
        cfg = self.config
        if cfg.weight_decay > 0.0:
            grad_ascent = grad_ascent - cfg.weight_decay * state.params_flat
        updates, new_opt_state = self.optimizer.update(-grad_ascent, state.opt_state)
        new_sigma = state.sigma
        if cfg.sigma_decay != 1.0:
            new_sigma = torch.clamp(state.sigma * cfg.sigma_decay, min=cfg.sigma_min)
        new_state = ESState(
            params_flat=state.params_flat + updates,
            opt_state=new_opt_state,
            seed=state.seed,
            generation=state.generation + 1,
            sigma=new_sigma,
        )
        return new_state, torch.linalg.vector_norm(grad_ascent)
