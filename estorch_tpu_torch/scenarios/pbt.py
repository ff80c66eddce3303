"""PBTController — population-based self-tuning of sigma / learning rate.

Counterpart of ``estorch_tpu/scenarios/pbt.py``.  K concurrent ES centers
share ONE engine (the ``meta_states`` pattern of the novelty family,
``algo/nses.py`` — K centers cost K states, not K engines).  Every
``explore_every`` generations the controller ranks centers by recent
objective (per-scenario mean fitness when scenario randomization is on — so
a center that only wins easy variants doesn't look tuned), and the bottom
quantile EXPLOITS a top center (copies its params + optimizer state +
hyperparameters) then EXPLORES by perturbing ``sigma`` — and
``learning_rate``, when the run's optimizer was built with
:func:`tunable_optimizer` — by a random factor.

Every decision is a structured event in a deterministic log: ``run(...,
replay=log)`` re-applies the recorded decisions instead of re-deciding, and
because each generation step is a deterministic function of state, the
replayed run's final parameters are bit for bit the live run's.  The
decisions are NumPy's (``default_rng(seed)``), so for one seed and one base
σ and learning rate the JAX package's log and the port's start with the
same ``init`` events.  Centers 1..K−1 start from the same params under
engine seeds derived from ``(es.seed, 90000 + k)`` (the port's
``SeedSequence`` derivation, where JAX folds the key); an exploit copies
the source's state but keeps the destination's own ``seed`` (the port's
``ESState`` carries a seed where JAX's carries a key).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..optim import tunable_optimizer
from ..parallel.engine import _seed_of

LOG_SCHEMA = 1


def _state_lr(state) -> float | None:
    """The learning rate carried in a tunable optimizer's state, or None
    when the optimizer was not built tunable."""
    hp = getattr(state.opt_state, "hyperparams", None)
    if isinstance(hp, dict) and "learning_rate" in hp:
        return float(hp["learning_rate"])
    return None


def _with_lr(state, lr: float):
    opt = state.opt_state
    hp = dict(opt.hyperparams)
    hp["learning_rate"] = torch.tensor(lr, dtype=torch.float32,
                                       device=state.params_flat.device)
    return state._replace(opt_state=opt._replace(hyperparams=hp))


__all__ = ["LOG_SCHEMA", "PBTController", "tunable_optimizer"]


class PBTController:
    """Drive ``es`` as a K-center self-tuning population."""

    def __init__(self, es, n_centers: int = 4, explore_every: int = 5,
                 seed: int = 0, perturb_factors=(0.8, 1.25),
                 exploit_fraction: float = 0.25,
                 sigma_bounds=(1e-4, 2.0), lr_bounds=(1e-5, 1.0),
                 init_spread: float = 2.0):
        if es.backend != "device":
            raise ValueError(
                "PBTController drives the device-path engines (their "
                "init_state(params, key) builds fresh centers); the "
                "host/pooled backends have no cheap multi-center form")
        if es._shard_params:
            raise ValueError(
                "PBTController currently drives the replicated device "
                "engine: the sharded engine's centers are each rank's shards, "
                "and an exploited center is a whole param vector (the JAX "
                "package refuses a sharded ES here too)")
        if n_centers < 2:
            raise ValueError(f"n_centers must be >= 2, got {n_centers}")
        if explore_every < 1:
            raise ValueError(
                f"explore_every must be >= 1, got {explore_every}")
        if init_spread < 1.0:
            raise ValueError(
                f"init_spread must be >= 1.0, got {init_spread}")
        self.es = es
        self.n_centers = int(n_centers)
        self.explore_every = int(explore_every)
        self.seed = int(seed)
        self.perturb_factors = tuple(float(f) for f in perturb_factors)
        self.exploit_fraction = float(exploit_fraction)
        self.sigma_bounds = (float(sigma_bounds[0]), float(sigma_bounds[1]))
        self.lr_bounds = (float(lr_bounds[0]), float(lr_bounds[1]))
        self.init_spread = float(init_spread)
        self.lr_tunable = _state_lr(es.state) is not None
        self.event_log: dict | None = None

    # ---- hyperparameter plumbing ----------------------------------------

    def _apply_hypers(self, state, sigma: float, lr: float | None):
        state = state._replace(sigma=torch.tensor(
            sigma, dtype=torch.float32, device=state.params_flat.device))
        if lr is not None and self.lr_tunable:
            state = _with_lr(state, lr)
        return state

    def _clip(self, value: float, bounds) -> float:
        return float(min(max(value, bounds[0]), bounds[1]))

    # ---- objective -------------------------------------------------------

    @staticmethod
    def _objective(record: dict) -> float:
        """Per-scenario mean of means when the run is randomized (a
        balanced score no easy-variant lottery can inflate), else the
        plain generation mean."""
        block = record.get("scenarios")
        if isinstance(block, dict):
            means = np.asarray(block.get("mean", []), np.float64)
            finite = means[np.isfinite(means)]
            if finite.size:
                return float(finite.mean())
        v = float(record.get("reward_mean", np.nan))
        return v if np.isfinite(v) else -np.inf

    # ---- the run ---------------------------------------------------------

    def run(self, n_generations: int,
            log_fn: Callable[[dict], None] | None = None,
            verbose: bool = False, replay: dict | None = None):
        """``n_generations`` generations PER CENTER.  Returns the event
        log (also left on ``self.event_log``); ``es.state`` ends on the
        best-scoring center and ``es.meta_states`` holds all K."""
        es = self.es
        events: list[dict] = []
        meta = {"n_centers": self.n_centers,
                "explore_every": self.explore_every,
                "seed": self.seed, "n_generations": int(n_generations),
                "lr_tunable": self.lr_tunable}
        replay_events: list[dict] | None = None
        if replay is not None:
            if replay.get("schema") != LOG_SCHEMA:
                raise ValueError(
                    f"unknown PBT log schema {replay.get('schema')!r}")
            if replay.get("meta") != meta:
                raise ValueError(
                    "replay log was recorded under a different PBT "
                    f"configuration: {replay.get('meta')} != {meta}")
            replay_events = list(replay.get("events", []))
        rng = np.random.default_rng(self.seed)

        def pop_replay(expected_type: str) -> dict:
            if not replay_events:
                raise ValueError(
                    f"replay log exhausted while expecting a "
                    f"{expected_type!r} event — truncated log?")
            ev = replay_events.pop(0)
            if ev.get("type") != expected_type:
                raise ValueError(
                    f"replay log out of order: expected {expected_type!r}, "
                    f"got {ev.get('type')!r}")
            return ev

        # ---- centers: state 0 is es.state; the rest re-seed the SAME
        # initial params (PBT tunes hypers from one start, unlike the
        # novelty family's distinct fresh inits) ----
        base_state = es.state
        base_sigma = float(base_state.sigma)
        base_lr = _state_lr(base_state)
        states = [base_state]
        for k in range(1, self.n_centers):
            states.append(es.engine.init_state(
                base_state.params_flat, _seed_of(es.seed, 90000 + k)))
        hypers: list[tuple[float, float | None]] = []
        for k in range(self.n_centers):
            if replay_events is not None:
                ev = pop_replay("init")
                if ev.get("center") != k:
                    raise ValueError(
                        f"replay init event for center {ev.get('center')} "
                        f"out of order (expected {k})")
                sigma, lr = float(ev["sigma"]), ev.get("lr")
            else:
                # log-uniform ladder around the base hypers, center 0
                # kept at the base as the control arm
                if k == 0:
                    sigma, lr = base_sigma, base_lr
                else:
                    sigma = self._clip(
                        base_sigma * self.init_spread ** rng.uniform(-1, 1),
                        self.sigma_bounds)
                    lr = (self._clip(
                        base_lr * self.init_spread ** rng.uniform(-1, 1),
                        self.lr_bounds) if base_lr is not None else None)
            states[k] = self._apply_hypers(states[k], sigma, lr)
            hypers.append((sigma, lr))
            ev = {"type": "init", "center": k, "sigma": sigma, "lr": lr}
            events.append(ev)
            es.obs.event("pbt_init", **ev)
        scores: list[list[float]] = [[] for _ in range(self.n_centers)]

        n_bottom = max(1, int(round(self.n_centers
                                    * self.exploit_fraction)))
        n_bottom = min(n_bottom, self.n_centers - 1)

        for g in range(int(n_generations)):
            for k in range(self.n_centers):
                es.state = states[k]

                def annotate(rec, _k=k):
                    rec["pbt_center"] = _k
                    if log_fn is not None:
                        log_fn(rec)

                es.train(1, log_fn=annotate, verbose=verbose)
                states[k] = es.state
                scores[k].append(self._objective(es.history[-1]))
            es.meta_states = list(states)

            last_round = g == int(n_generations) - 1
            if (g + 1) % self.explore_every != 0 or last_round:
                continue

            # ---- exploit / explore --------------------------------------
            window = self.explore_every
            recent = [float(np.mean(s[-window:])) for s in scores]
            order = sorted(range(self.n_centers),
                           key=lambda i: recent[i], reverse=True)
            top = order[:max(1, n_bottom)]
            bottom = order[-n_bottom:]
            rnd = (g + 1) // self.explore_every
            for dst in bottom:
                if replay_events is not None:
                    ev = pop_replay("exploit")
                    src = int(ev["src"])
                    if int(ev["dst"]) != dst:
                        # the ranking is deterministic, so a mismatched
                        # dst means the log belongs to another run
                        raise ValueError(
                            f"replay exploit event targets center "
                            f"{ev['dst']}, live ranking chose {dst}")
                    sigma, lr = float(ev["sigma"]), ev.get("lr")
                else:
                    src = int(top[rng.integers(0, len(top))])
                    src_sigma = float(states[src].sigma)
                    src_lr = _state_lr(states[src])
                    factor = float(
                        self.perturb_factors[
                            rng.integers(0, len(self.perturb_factors))])
                    sigma = self._clip(src_sigma * factor,
                                       self.sigma_bounds)
                    if src_lr is not None:
                        lf = float(self.perturb_factors[
                            rng.integers(0, len(self.perturb_factors))])
                        lr = self._clip(src_lr * lf, self.lr_bounds)
                    else:
                        lr = None
                # copy the src center wholesale (params, optimizer
                # moments, obs stats) but keep dst's OWN seed so center
                # noise streams stay decorrelated after the copy
                states[dst] = self._apply_hypers(
                    states[src]._replace(seed=states[dst].seed), sigma, lr)
                scores[dst] = list(scores[src])
                hypers[dst] = (sigma, lr)
                ev = {"type": "exploit", "round": rnd, "dst": int(dst),
                      "src": int(src), "sigma": sigma, "lr": lr,
                      "score_src": recent[src], "score_dst": recent[dst]}
                events.append(ev)
                es.obs.event("pbt_exploit", **ev)
            es.meta_states = list(states)

        if replay_events:
            raise ValueError(
                f"replay log has {len(replay_events)} unconsumed events")
        final_scores = [float(np.mean(s[-self.explore_every:]))
                        for s in scores]
        best = int(np.argmax(final_scores))
        es.state = states[best]
        es.meta_states = list(states)
        self.event_log = {"schema": LOG_SCHEMA, "meta": meta,
                          "events": events,
                          "final": {"best_center": best,
                                    "scores": final_scores,
                                    "hypers": [list(h) for h in hypers]}}
        return self.event_log
