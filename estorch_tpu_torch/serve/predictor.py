"""The serving forward pass — ONE definition shared by ``ES.predict``,
:mod:`estorch_tpu_torch.serve.bundle` and the inference server.

Counterpart of ``estorch_tpu/serve/predictor.py``.  Bit-exactness is the
point of this module: a served response must equal what the exporting
run's ``ES.predict`` computes, and that holds only if every consumer runs
the SAME function (normalize, then apply; params and running stats as
arguments) on the same device, so the builders live here and everyone
imports them.

* A program is the policy's ``apply_params`` over the observation: one
  observation ``(*obs_shape)`` or a batch ``(B, *obs_shape)``.  The batched
  program is that same forward over the batch (what the JAX package's
  ``vmap`` lowers to), not a loop over rows.
* Each call enters ``torch.inference_mode()`` itself: grad mode is
  thread-local, and the dynamic batcher calls the batched program from its
  own worker thread, where a caller's ``no_grad`` does not reach.
* Rows are bit-identical across batch sizes only where the BLAS kernel
  does not change with the batch size; the batcher MEASURES that per
  loaded bundle (``serve/batcher.py::verify_stable_buckets``) and never
  assumes it.  Batch 1 is a matrix-vector product, which is why its
  buckets start at 2.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

SERVE_DTYPES = ("f32", "bf16")


def as_obs(obs, device) -> torch.Tensor:
    """An observation (array, list or tensor) as a tensor on ``device``:
    float64 becomes float32 (the JAX package's arrays are 32-bit), other
    dtypes (integer pixels) are kept."""
    t = torch.as_tensor(obs)
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t.to(device)


def _bf16_obs(obs: torch.Tensor) -> torch.Tensor:
    """Floating observations cast to bf16; integer pixel bytes pass through
    so that the policy's own scaling still applies."""
    return obs.to(torch.bfloat16) if obs.is_floating_point() else obs


def _apply_for_dtype(policy_apply: Callable[..., Any], dtype: str,
                     recurrent: bool = False) -> Callable[..., Any]:
    """The engine's bf16 I/O contract applied to a serving forward.

    ``dtype="bf16"``: the params must ALREADY be bf16 (cast once where they
    are built, ``Bundle._params_for``), observations are cast in and the
    output is cast back to float32, as the bf16 training path does
    (``parallel/engine.py``); a recurrent carry keeps the dtype it was given.
    Normalization composes OUTSIDE this wrapper exactly like the engine:
    raw observations are normalized in float32, then cast.
    """
    if dtype not in SERVE_DTYPES:
        raise ValueError(f"serving dtype must be one of {SERVE_DTYPES}, got {dtype!r}")
    if dtype == "f32":
        return policy_apply
    if recurrent:
        def stateful(p, obs, h):
            out, h_new = policy_apply(p, _bf16_obs(obs), h)
            return out.to(torch.float32), h_new

        return stateful

    def stateless(p, obs):
        return policy_apply(p, _bf16_obs(obs)).to(torch.float32)

    return stateless


def make_single_predict(
    policy_apply: Callable[..., Any],
    *,
    recurrent: bool = False,
    obs_norm: bool = False,
    obs_clip: float = 5.0,
    dtype: str = "f32",
) -> Callable[..., Any]:
    """``f(params, obs_stats, obs[, carry])`` for one observation, or for a
    batch of them (a leading batch axis).

    ``params`` is the policy's param dict; ``obs_stats`` is the (count,
    mean, m2) Welford triple when ``obs_norm`` (normalization runs inside
    ``f``, as in the rollout path), and None otherwise.  Recurrent policies
    take and return the hidden carry: ``f(...) -> (out, new_carry)``.

    ``dtype="bf16"`` builds the quantized program (see
    :func:`_apply_for_dtype`); params must already be bf16.
    """
    policy_apply = _apply_for_dtype(policy_apply, dtype, recurrent=recurrent)
    if obs_norm:
        from ..parallel.engine import normalize_obs

        def prep(stats, obs):
            return normalize_obs(obs, stats, obs_clip)
    else:
        def prep(stats, obs):
            return obs

    if recurrent:
        def f(params, stats, obs, carry):
            with torch.inference_mode():
                return policy_apply(params, prep(stats, obs), carry)
    else:
        def f(params, stats, obs):
            with torch.inference_mode():
                return policy_apply(params, prep(stats, obs))
    return f


def make_batched_predict(
    policy_apply: Callable[..., Any],
    *,
    obs_norm: bool = False,
    obs_clip: float = 5.0,
    dtype: str = "f32",
) -> Callable[..., Any]:
    """``f(params, obs_stats, obs_batch (B, *obs_shape)) -> (B, ...)`` — the
    dynamic batcher's program: the policy's forward over the whole batch,
    the same function :func:`make_single_predict` runs on a batch.

    Stateless policies only: a recurrent policy's carry belongs to a
    session, and the batcher coalesces *unrelated* requests — the server
    refuses recurrent bundles rather than silently mixing carries.

    ``dtype="bf16"`` builds the quantized fast path (params must already be
    bf16).  Its accuracy against the f32 program is MEASURED per bucket at
    load (``serve/batcher.py::measure_quant_divergence``), never assumed.
    """
    return make_single_predict(policy_apply, obs_norm=obs_norm, obs_clip=obs_clip,
                               dtype=dtype)
