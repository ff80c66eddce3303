"""IW-ES — importance-weighted reuse of earlier generations' rollouts.

Counterpart of ``estorch_tpu/algo/iwes.py`` ("Importance Weighted
Evolution Strategies", arXiv 1811.04624).  After the center moves θ_t →
θ_{t+1}, the generation-t members θ_i = θ_t + σ_t s_i ε_i are still
Monte-Carlo samples for the gradient at θ_{t+1}: under the new search
distribution they are the perturbations

    ε'_i = (θ_i − θ_{t+1}) / σ_{t+1} = d + c·s_i ε_i,
    d = (θ_t − θ_{t+1})/σ_{t+1},   c = σ_t/σ_{t+1}

with importance ratio

    λ_i = N(θ_i; θ_{t+1}, σ²_{t+1}) / N(θ_i; θ_t, σ²_t)
        = c^dim · exp((‖ε_i‖² − ‖ε'_i‖²)/2).

Each generation evaluates the fresh population, then forms the update from
the fresh members' ranks plus up to ``reuse_window`` earlier generations'
members with rank × self-normalized λ, each earlier generation admitted on
its own effective sample size ESS = (Σλ)²/Σλ² ≥ ``ess_min``·n.  A big
center move collapses the ratios and the generation runs as plain ES.

Nothing reused is evaluated again and no old noise is stored: old ε_i come
back from the table through the old state's offsets, old fitness is a host
(n,) array, and the engine's ``noise_stats`` and ``apply_weights_reuse``
compute ε·d, ‖ε‖² and Σ wλε (plain torch, as the JAX package computes them
outside Pallas).  The device backend only, with the standard or decomposed
forward; the reuse ring is not part of a checkpoint.

The three module functions are the ratio rule the async scheduler's late
folds share (``algo/scheduler.py``).
"""

from __future__ import annotations

import collections
import time
import warnings
from typing import Callable

import numpy as np
import torch

from ..utils.fault import rank_weights_with_failures
from .es import ES


def stale_log_ratios(dots, norms, d2: float, c: float, dim: int):
    """Per-member log importance ratios of samples drawn under an older
    (θ_old, σ_old), seen from the current (θ_new, σ_new).

    ``dots`` are the signed per-member ε·d (s_i applied; the mirrored
    expansion is the caller's), ``norms`` the per-member ‖ε‖², ``d2`` = ‖d‖²
    with d = (θ_old − θ_new)/σ_new, and ``c`` = σ_old/σ_new.  Returns log λ,
    unnormalized: λ only enters self-normalized, so callers shift by the
    max before exponentiating.
    """
    dots = np.asarray(dots)
    norms = np.asarray(norms)
    eps_new_sq = d2 + 2.0 * c * dots + c * c * norms
    return dim * np.log(c) + 0.5 * (norms - eps_new_sq)


def mirrored_member_stats(dots, norms):
    """Per-pair noise stats (``engine.noise_stats``) expanded to the
    mirrored member layout: member 2k is +ε_k, member 2k+1 is −ε_k."""
    dots = np.asarray(dots)
    return (np.repeat(dots, 2) * np.tile([1.0, -1.0], dots.shape[0]),
            np.repeat(np.asarray(norms), 2))


def clipped_stale_lambdas(dots, norms, d2: float, c: float, dim: int,
                          iw_clip: float) -> np.ndarray:
    """Per-member truncated importance weights for one stale source:
    :func:`stale_log_ratios`, shifted by the max, normalized to mean 1
    within the source, then truncated at ``iw_clip`` so that one wild
    ratio cannot take over the update.  ``dots`` are signed per-member
    values (the mirrored expansion applied)."""
    log_lam = stale_log_ratios(dots, norms, d2, c, dim)
    log_lam -= log_lam.max()
    lam = np.exp(log_lam)
    lam = lam * (len(lam) / max(lam.sum(), 1e-30))
    return np.minimum(lam, iw_clip).astype(np.float32)


class IW_ES(ES):
    """ES with importance-weighted reuse of earlier generations."""

    DRY_WARN_AFTER = 20

    def __init__(self, *args, ess_min: float = 0.5, reuse_window: int = 1, **kwargs):
        if not 0.0 < ess_min <= 1.0:
            raise ValueError(f"ess_min must be in (0, 1], got {ess_min}")
        if reuse_window < 1:
            raise ValueError(f"reuse_window must be >= 1, got {reuse_window}")
        self.ess_min = float(ess_min)
        self.reuse_window = int(reuse_window)
        super().__init__(*args, **kwargs)
        if self.backend != "device":
            raise ValueError(
                "IW_ES is a device-path algorithm (the reuse terms are "
                f"sharded table reductions); got backend={self.backend!r}")
        cfg = self.config
        if cfg.low_rank:
            raise ValueError(
                "IW_ES does not support low_rank — and not merely as "
                "pending work: the reused perturbation seen from the "
                "drifted center, dense(v) + (c_old - c_new)/sigma, "
                "generally has no rank-r preimage, so the factor-space "
                "importance ratio is ill-posed (ROADMAP item 7)")
        if cfg.streamed or cfg.noise_kernel:
            raise ValueError(
                "IW_ES supports the standard/decomposed forwards; "
                "streamed/noise_kernel are untested with reuse")
        if cfg.obs_norm:
            raise ValueError(
                "IW_ES does not support obs_norm: buffered generations' "
                "fitness was measured under OLDER running stats, so the "
                "effective policy f(θ) the density ratio assumes fixed "
                "drifts with the normalization — the reuse estimate would "
                "be silently biased")
        # newest-last ring of (params_flat, sigma, pair_offsets, fitness):
        # not whole states, which would keep the optimizer's moments alive
        self._prev = collections.deque(maxlen=self.reuse_window)
        self._dry_gens = 0  # consecutive full-ring generations without reuse
        self._dry_best_ess = 0.0  # the best ESS seen in that streak
        self._warned_never_reusing = False

    def train(self, n_steps: int, n_proc: int = 1,
              log_fn: Callable[[dict], None] | None = None, verbose: bool = True) -> "IW_ES":
        """Run ``n_steps`` generations.  Fewer than 2 valid fresh members
        raise with the state intact: reuse never trains through a dead
        generation.  (Nothing is compiled ahead here: the JAX package's
        warm-up of its reuse programs has no counterpart in torch.)"""
        n = self.population_size
        obs = self.obs
        obs.discard_phases()  # partial spans of a generation that raised
        for _ in range(n_steps):
            t0 = time.perf_counter()
            st = self.state
            with obs.phase("eval"):
                ev = self.engine.evaluate(st)
                fitness = ev.fitness.cpu().numpy()  # waits for the evaluation
            n_valid = int(np.isfinite(fitness).sum())
            if n_valid < 2:
                raise RuntimeError(
                    f"only {n_valid}/{n} population members produced valid fitness — "
                    "cannot form an update; check env/rollout health")

            with obs.phase("reuse_ratios"):  # each buffered generation on its own ESS
                accepted, best_ess = [], 0.0
                for entry in self._prev:
                    lam, d_vec, c, offs = self._ratios(entry, st)
                    ess = float(lam.sum() ** 2 / (lam**2).sum()) if lam.sum() > 0 else 0.0
                    best_ess = max(best_ess, ess)
                    if ess >= self.ess_min * n:
                        accepted.append((entry[3], lam, d_vec, c, offs))
            reused = bool(accepted)
            with obs.phase("update"):
                if reused:
                    self._dry_gens = 0
                    self._dry_best_ess = 0.0
                    new_st, gnorm = self._reuse_update(st, fitness, accepted)
                else:
                    if len(self._prev) == self.reuse_window:
                        self._dry_gens += 1
                        self._dry_best_ess = max(self._dry_best_ess, best_ess)
                        self._maybe_warn_never_reusing()
                    weights = torch.as_tensor(rank_weights_with_failures(fitness)).to(self.device)
                    new_st, gnorm = self.engine.apply_weights(st, weights)
                gnorm = float(gnorm)  # waits for the update

            self.state = new_st
            with obs.phase("sample"):  # this generation, buffered for reuse
                self._prev.append((st.params_flat, float(st.sigma),
                                   self.engine.all_pair_offsets(st), fitness))
            dt = time.perf_counter() - t0
            record = self._base_record(st, fitness, int(ev.steps), gnorm, dt)
            record.update(reused_prev=reused, reused_gens=len(accepted),
                          ess=round(best_ess, 2), effective_samples=n * (1 + len(accepted)))
            self._emit_record(record, log_fn, verbose)
        return self

    # ------------------------------------------------------------ internals

    def _maybe_warn_never_reusing(self) -> None:
        """One warning when the ESS guard has rejected every generation for
        ``DRY_WARN_AFTER`` generations.  The log-ratio spread is d·ε ~
        N(0, ‖Δθ/σ‖²), so reuse survives only small center moves: with Adam,
        lr ≲ σ/√dim."""
        if self._warned_never_reusing or self._dry_gens < self.DRY_WARN_AFTER:
            return
        self._warned_never_reusing = True
        sigma = float(self.state.sigma)
        warnings.warn(
            f"IW_ES: no generation passed the ESS guard in the last "
            f"{self._dry_gens} generations (best ESS over the streak "
            f"{self._dry_best_ess:.1f} < ess_min*n = "
            f"{self.ess_min * self.population_size:.1f}); every "
            "update ran as vanilla ES while paying the ratio-computation "
            "overhead. The center is moving too far per generation for "
            "reuse: shrink the step so that lr ≲ sigma/sqrt(dim) "
            f"(≈ {sigma / max(self.spec.dim, 1) ** 0.5:.1e} here), or raise "
            "sigma, or drop back to plain ES.",
            RuntimeWarning, stacklevel=3)

    def _ratios(self, entry, st):
        """The old members' importance ratios λ under the current state,
        shifted by their max: ``(λ, d, c, offsets)``.  ``entry`` is a ring
        record (params_flat, sigma, pair_offsets, fitness)."""
        prev_params, sigma_old, offsets, _ = entry
        sigma_new = float(st.sigma)
        c = sigma_old / sigma_new
        d_vec = (prev_params - st.params_flat) / sigma_new
        dots, norms = self.engine.noise_stats(offsets, d_vec)
        dots, norms = dots.cpu().numpy(), norms.cpu().numpy()
        d2 = float(torch.dot(d_vec, d_vec))
        if self.config.mirrored:
            dots, norms = mirrored_member_stats(dots, norms)
        log_lam = stale_log_ratios(dots, norms, d2, c, self.spec.dim)
        log_lam -= log_lam.max()  # λ̃ and the ESS are shift-invariant in log space
        return np.exp(log_lam), d_vec, c, offsets

    def _reuse_update(self, st, fitness: np.ndarray, accepted: list):
        """One update from the fresh ranks and the λ-weighted old ranks of
        every accepted generation.  The fresh weights are scaled by n/n_tot,
        so the engine's 1/(n·σ) becomes 1/(n_tot·σ); the old side's
        coefficients arrive fully scaled (``apply_weights_reuse``)."""
        n = self.population_size
        n_tot = n * (1 + len(accepted))
        sigma_new = float(st.sigma)
        w_all = rank_weights_with_failures(np.concatenate([fitness] + [a[0] for a in accepted]))
        old_w_parts, offs_parts, d_rows, coeff_rows = [], [], [], []
        for g, (_, lam, d_vec, c, offs) in enumerate(accepted):
            w_old = w_all[n * (g + 1): n * (g + 2)]
            lam_tilde = lam * (n / max(lam.sum(), 1e-30))  # mean 1
            w_old_eff = w_old * lam_tilde
            # the old ε term Σ w λ̃ (d + c·s·ε): the s·ε part folds per pair
            w32 = torch.as_tensor(w_old_eff.astype(np.float32))
            folded = w32[0::2] - w32[1::2] if self.config.mirrored else w32
            old_w_parts.append(folded * (c / (n_tot * sigma_new)))
            offs_parts.append(offs)
            d_rows.append(d_vec)
            coeff_rows.append(w_old_eff.sum() / (n_tot * sigma_new))
        dev = self.device
        weights = torch.as_tensor(np.asarray(w_all[:n] * (n / n_tot), np.float32)).to(dev)
        return self.engine.apply_weights_reuse(
            st, weights, torch.cat(offs_parts), torch.cat(old_w_parts).to(dev),
            torch.stack(d_rows), torch.tensor(coeff_rows, dtype=torch.float32))
