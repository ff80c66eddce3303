"""The numbers that decide ``correct`` for a training cell.

The program's first steps (``ES.train`` in the run's set-up) and the plain
reference's are compared by:

- ``loss_gap``: the widest gap, over the steps, between the program's mean
  return and the reference's, over the reference's (``loss0_gap``: the
  first step's alone);
- ``grad_gap``: the first gradient as Adam was given it (the program's
  worked out from Adam's first moment after one step, ``mu / (1 − b1)``), by
  the worst leaf: the gap between the program's norm of the leaf and the
  reference's, over the larger of the reference's norm of that leaf and of
  the median leaf;
- ``change_gap``: the parameters' change over the steps, by the worst leaf
  in the same way, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (such a leaf moves under Adam by
  round-off alone); ``grad_med`` and ``change_med`` take the median leaf
  instead of the worst;
- ``action_gap``, for a discrete policy: the reference replays the actions
  the program took (its env recorded them) and gives the widest gap, over
  every member's every step, by which the logit of the program's action
  lies below the reference's best.  An argmax over near-equal logits flips
  with float32 rounding, and a flipped action changes a member's whole
  episode and rank, so two rollouts are not compared; replayed, the
  returns, ranks and update are the program's own, compared as above, and
  each action is judged by the logits it was chosen from;
- ``flip_share``, with the replay: the share of members of which some
  replayed action is not the reference's argmax, that is the members whose
  episode the reference would not have taken itself.  Float32 rounding
  flips a near-tie now and then; a forward that shifts the logits, however
  little, flips many.

A cell's ``limits`` name the numbers it compares.

A leaf is one ``(layer, leaf)`` block of the flat vector
(``es.flat_layout``).
"""

from __future__ import annotations

import math

import torch

NOUGHT_SHARE = 1e-3  # a leaf's reference gradient under this share of the median leaf's


def leaf_norms(vec: torch.Tensor, layout: list) -> list[float]:
    v = vec.detach().to("cpu", torch.float64)
    return [float(torch.linalg.vector_norm(v[start:start + math.prod(shape)]))
            for _, _, shape, start in layout]


def _median(values: list[float]) -> float:
    s = sorted(values)
    m = len(s) // 2
    return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])


def leaf_gaps(program: torch.Tensor, reference: torch.Tensor, layout: list,
              keep: list[bool] | None = None) -> list[float]:
    """Over the kept leaves: |‖p_ℓ‖ − ‖r_ℓ‖| / max(‖r_ℓ‖, median_ℓ ‖r_ℓ‖)."""
    pn, rn = leaf_norms(program, layout), leaf_norms(reference, layout)
    med = _median(rn)
    gaps = [abs(p - r) / max(r, med) for p, r in zip(pn, rn)]
    if keep is not None:
        gaps = [g for g, k in zip(gaps, keep) if k]
    return gaps or [0.0]


def moving_leaves(ref_grad: torch.Tensor, layout: list) -> list[bool]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    norms = leaf_norms(ref_grad, layout)
    med = _median(norms)
    return [n >= NOUGHT_SHARE * med for n in norms]


def readings(program: dict, reference: dict, layout: list) -> dict:
    """The numbers that a cell's ``limits`` may compare, from both sides'
    ``{"losses": [...], "grad0": (dim,), "theta0": (dim,), "theta":
    (dim,)}``: ``loss_gap`` over every step and ``loss0_gap`` over the
    first; the first gradient's and the change's leaf gaps by the worst
    leaf (``grad_gap``, ``change_gap``) and by the median leaf
    (``grad_med``, ``change_med``); where the reference replayed the
    program's discrete actions, ``action_gap``, the widest gap by which the
    reference's logit of a replayed action lies below its best, and
    ``flip_share``, the largest share over the steps of members with such an
    action."""
    steps = min(len(program["losses"]), len(reference["losses"]))
    loss = [abs(p - r) / abs(r) for p, r in zip(program["losses"][:steps],
                                                reference["losses"][:steps])]
    grad = leaf_gaps(program["grad0"], reference["grad0"], layout)
    keep = moving_leaves(reference["grad0"], layout)
    change = leaf_gaps(program["theta"] - program["theta0"],
                       reference["theta"] - reference["theta0"], layout, keep)
    out = {"loss_gap": max(loss), "loss0_gap": loss[0], "grad_gap": max(grad),
           "grad_med": _median(grad), "change_gap": max(change),
           "change_med": _median(change)}
    if reference.get("action_gap") is not None:
        out["action_gap"] = reference["action_gap"]
        out["flip_share"] = reference["flip_share"]
    return out


def reference_steps(ref, steps: int, given: list | None = None) -> dict:
    """Run ``steps`` generations of a ``ReferenceES`` and keep what
    :func:`readings` compares.  ``given`` holds each generation's (n,
    horizon) actions for a discrete policy to replay (the program's, as its
    env recorded them); ``actions`` are the ones taken."""
    losses, grad0, fitness0, actions, gap, flips = [], None, None, [], None, None
    for g in range(steps):
        out = ref.generation(g, None if given is None else given[g])
        losses.append(out["loss"])
        actions.append(out["actions"])
        if given is not None:
            gap = max(gap or 0.0, out["action_gap"])
            flips = max(flips or 0.0, out["flip_share"])
        if g == 0:
            grad0, fitness0 = out["grad"].detach().cpu(), out["fitness"].detach().cpu()
    return {"losses": losses, "grad0": grad0, "theta0": ref.theta0.detach().cpu(),
            "theta": ref.theta.detach().cpu(), "fitness0": fitness0, "actions": actions,
            "action_gap": gap, "flip_share": flips}


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number at or under
    its limit (a NaN is over)."""
    checks = {k: {"value": float(values[k]), "limit": float(limits[k])} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
