"""NS-ES, NSR-ES and NSRA-ES — the novelty-search family (Conti et al. 2018).

Counterpart of ``estorch_tpu/algo/nses.py``, on the device, pooled and host
backends:

- a meta-population of M centers sharing one engine and one noise table;
  each generation picks one to update, with probability proportional to
  the novelty of its center's behavior characterization (BC);
- the population's rollouts return (reward, BC); a member's novelty is the
  mean k-NN distance of its BC to the archive (``algo/archive.py``);
- the update direction: NS follows novelty ranks only; NSR ½(reward +
  novelty ranks); NSRA w·reward + (1−w)·novelty ranks, w rising on a new
  best and decaying toward novelty after ``stagnation_patience``
  generations without one;
- after the update, the unperturbed center's BC joins the archive.

A generation is the engine's split path: ``evaluate`` (on the device path
the streamed forward and its matvec kernel when asked for), the k-NN and
the ranks on the host, ``apply_weights`` (the ``weighted_noise_sum`` kernel
with ``noise_kernel=True``), then one center episode.  Each is a span of
the JAX package's names (``select``, ``eval``, ``novelty_knn``,
``update``, ``archive``) in the record's ``phases``; each ends in a copy to
the host, so the device's work lands in the span that spent it.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..ops.ranks import centered_rank_np
from ..parallel.engine import _seed_of
from ..utils.fault import mask_and_renormalize, valid_mask
from .archive import NoveltyArchive
from .es import ES, _host

# the fresh centers' streams, as the JAX package folds them into its key:
# center m's params from (seed, 1000 + m), its engine seed (seed, 2000 + m)
_PARAMS_STREAM, _ENGINE_STREAM = 1000, 2000
_HOST_CENTER_KEY = 7919  # host centers: key seed + 7919·m


def _center_bc(res) -> np.ndarray:
    """A center episode's BC as a (bc_dim,) float32 array on the host (the
    device engine returns a batch of one)."""
    return np.asarray(_host(res.bc), np.float32).reshape(-1)


class NS_ES(ES):
    """Novelty-Search ES: follows novelty ranks only (pure exploration)."""

    def __init__(self, policy, agent, optimizer, *, k: int = 10,
                 meta_population_size: int = 3, archive_max_size: int = 0, **kwargs):
        if kwargs.get("scenarios") is not None:
            raise ValueError(
                "scenarios is not wired into the novelty family: the "
                "ScenarioEnv appends the variant id to the BC vector, "
                "which would silently distort archive k-NN novelty "
                "(estorch_tpu/scenarios; use plain ES or PBTController)")
        super().__init__(policy, agent, optimizer, **kwargs)
        self.k = k
        self.meta_population_size = int(meta_population_size)
        self.archive = NoveltyArchive(k=k, bc_dim=getattr(self.engine, "bc_dim", None) or None,
                                      max_size=archive_max_size)
        # meta-population: center 0 is the base class's; the others start
        # from fresh initializations, so the centers are distinct
        self.meta_states = [self.state]
        for m in range(1, self.meta_population_size):
            self.meta_states.append(self._new_center_state(m))
        self._center_bc: list[np.ndarray] = []
        self._seed_archive()
        self._rng = np.random.default_rng(self.seed)

    def _new_center_state(self, m: int):
        """Center m: a freshly initialized policy and a seed of its own."""
        if self.backend == "host":
            fresh = self.engine.policy_factory()
            with torch.no_grad():
                flat = torch.nn.utils.parameters_to_vector(fresh.parameters()).cpu().numpy()
            return self.engine.init_state(flat, key=self.seed + _HOST_CENTER_KEY * m)
        gen = torch.Generator().manual_seed(_seed_of(self.seed, _PARAMS_STREAM + m))
        flat = self.spec.flatten(self.module.init_params(self._obs_shape, gen))
        return self.engine.init_state(flat, _seed_of(self.seed, _ENGINE_STREAM + m))

    def _seed_archive(self) -> None:
        """The archive's first entries: each center's BC, in center order,
        as the reference seeds it."""
        for st in self.meta_states:
            bc = _center_bc(self.engine.evaluate_center(st))
            self._center_bc.append(bc)
            self.archive.add(bc)

    # ----------------------------------------------- variant-specific weights

    def _combine_weights(self, fitness: np.ndarray, novelty: np.ndarray) -> np.ndarray:
        """NS-ES: novelty ranks only."""
        return centered_rank_np(novelty)

    def _weights_with_failures(self, fitness: np.ndarray, novelty: np.ndarray) -> np.ndarray:
        """The variant's weights with failed (NaN-fitness) members dropped:
        the valid members ranked among themselves, failures weighted 0 and
        the survivors renormalized (``utils/fault.py``).  Without it a NaN
        would sort last and take the top rank."""
        valid = valid_mask(fitness)
        if valid.all():
            return self._combine_weights(fitness, novelty)
        w = np.zeros(fitness.shape[0], dtype=np.float32)
        w[valid] = self._combine_weights(fitness[valid], novelty[valid])
        return mask_and_renormalize(w, valid)

    # ------------------------------------------------------------ training

    def _select_meta_index(self) -> int:
        """P(m) ∝ novelty of center m's BC against the archive."""
        nov = self.archive.novelty(np.stack(self._center_bc))
        total = float(nov.sum())
        if total <= 0 or not np.isfinite(total):
            probs = np.full(len(nov), 1.0 / len(nov))
        else:
            probs = nov / total
        return int(self._rng.choice(len(nov), p=probs))

    def _post_update(self, record: dict) -> None:
        """Hook for NSRA's w schedule."""

    def train(self, n_steps: int, n_proc: int = 1,
              log_fn: Callable[[dict], None] | None = None, verbose: bool = True) -> "NS_ES":
        """Run ``n_steps`` generations, each on one center of the
        meta-population; ``n_proc`` sizes the host backend's workers."""
        self._setup_n_proc(n_proc)
        obs = self.obs
        obs.discard_phases()  # partial spans of a generation that raised
        for _ in range(n_steps):
            t0 = time.perf_counter()
            with obs.phase("select"):
                m = self._select_meta_index()
            st = self.meta_states[m]
            with obs.phase("eval"):
                ev = self.engine.evaluate(st)
                fitness = np.asarray(_host(ev.fitness))  # waits for the evaluation
                bc = np.asarray(_host(ev.bc))
            with obs.phase("novelty_knn"):
                novelty = self.archive.novelty(bc)
                weights = self._weights_with_failures(fitness, novelty)
                if self.backend == "device":
                    weights = torch.as_tensor(weights).to(self.device)
            with obs.phase("update"):
                new_st, gnorm = self.engine.apply_weights(st, weights)
                gnorm = float(_host(gnorm))  # waits for the update
            self.meta_states[m] = new_st
            if m == 0:
                self.state = new_st  # the base class's accessors follow center 0
            with obs.phase("archive"):  # the updated center: its BC joins the archive
                cres = self.engine.evaluate_center(new_st)
                cbc = _center_bc(cres)
                self.archive.add(cbc)
                self._center_bc[m] = cbc
            dt = time.perf_counter() - t0
            record = self._base_record(st, fitness, int(ev.steps), gnorm, dt)
            record.update(
                meta_index=m,
                center_reward=float(cres.total_reward),
                novelty_mean=float(novelty.mean()),
                novelty_max=float(novelty.max()),
                archive_size=len(self.archive),
            )
            self._post_update(record)
            self._emit_record(record, log_fn, verbose)
        return self

    def _format_record(self, r: dict) -> str:
        return (f"gen {r['generation']:4d}  meta {r['meta_index']}  "
                f"max {r['reward_max']:9.2f}  nov {r['novelty_mean']:7.3f}  "
                f"archive {r['archive_size']:4d}  steps/s {r['env_steps_per_sec']:,.0f}")


class NSR_ES(NS_ES):
    """Novelty+Reward ES: an equal mix of reward and novelty ranks."""

    def _combine_weights(self, fitness: np.ndarray, novelty: np.ndarray) -> np.ndarray:
        return 0.5 * centered_rank_np(fitness) + 0.5 * centered_rank_np(novelty)


class NSRA_ES(NSR_ES):
    """Adaptive NSR-ES: w·reward + (1−w)·novelty, w adapted on progress.

    ``weight`` is the initial w, ``weight_delta`` its step, and
    ``stagnation_patience`` the generations without a new best before w
    decays toward novelty.
    """

    def __init__(self, policy, agent, optimizer, *, weight: float = 1.0,
                 weight_delta: float = 0.05, stagnation_patience: int = 10, **kwargs):
        self.weight = float(weight)
        self.weight_delta = float(weight_delta)
        self.stagnation_patience = int(stagnation_patience)
        self._stagnation = 0
        super().__init__(policy, agent, optimizer, **kwargs)

    def _combine_weights(self, fitness: np.ndarray, novelty: np.ndarray) -> np.ndarray:
        w = self.weight
        return w * centered_rank_np(fitness) + (1.0 - w) * centered_rank_np(novelty)

    def _post_update(self, record: dict) -> None:
        # ``improved_best`` is the base record's best tracking
        if record["improved_best"]:
            self.weight = min(1.0, self.weight + self.weight_delta)
            self._stagnation = 0
        else:
            self._stagnation += 1
            if self._stagnation >= self.stagnation_patience:
                self.weight = max(0.0, self.weight - self.weight_delta)
                self._stagnation = 0
        record["nsra_weight"] = self.weight
