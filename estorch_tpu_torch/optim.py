"""Optimizers on the flat parameter vector, matching optax.

The JAX package's ES takes an optax factory; these are the port's
counterparts of ``optax.adam`` (the same moments, bias correction and
epsilon placement, outside the square root) and ``optax.sgd``, as pure
``init``/``update`` pairs so that a generation's state can be kept and
restored whole.  :func:`tunable_optimizer` is the counterpart of
``optax.inject_hyperparams``: the learning rate rides the optimizer state,
where population-based training (``scenarios/pbt.py``) tunes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch


class AdamState(NamedTuple):
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Adam:
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(0, torch.zeros_like(params), torch.zeros_like(params))

    def update(self, grad: torch.Tensor, state: AdamState) -> tuple[torch.Tensor, AdamState]:
        """(updates, new_state); the new params are ``params + updates``."""
        mu = (1 - self.b1) * grad + self.b1 * state.mu
        nu = (1 - self.b2) * grad * grad + self.b2 * state.nu
        count = state.count + 1
        # optax forms the bias corrections 1 - b**count in float32
        b1 = torch.tensor(self.b1, dtype=mu.dtype, device=mu.device)
        b2 = torch.tensor(self.b2, dtype=nu.dtype, device=nu.device)
        mu_hat = mu / (1 - b1**count)
        nu_hat = nu / (1 - b2**count)
        updates = -self.learning_rate * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return updates, AdamState(count, mu, nu)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Adam:
    """Factory with ``optax.adam``'s signature."""
    return Adam(float(learning_rate), float(b1), float(b2), float(eps))


@dataclasses.dataclass(frozen=True)
class SGD:
    learning_rate: float

    def init(self, params: torch.Tensor) -> None:
        return None

    def update(self, grad: torch.Tensor, state: None) -> tuple[torch.Tensor, None]:
        """(updates, state): ``-learning_rate · grad``, no momentum."""
        return -self.learning_rate * grad, state


def sgd(learning_rate: float) -> SGD:
    """Factory with ``optax.sgd``'s first argument (no momentum)."""
    return SGD(float(learning_rate))


class TunableState(NamedTuple):
    """A tunable optimizer's state: ``hyperparams`` holds the learning rate
    as a () float32 tensor on the params' device, ``inner_state`` the
    wrapped optimizer's own state."""

    hyperparams: dict
    inner_state: Any


@dataclasses.dataclass(frozen=True)
class Tunable:
    """An optimizer (``Adam`` or ``SGD``) whose learning rate is read from
    its state at each update, as ``optax.inject_hyperparams`` reads it: the
    update is the wrapped optimizer's at the state's rate, bit for bit (the
    rate's float32 value multiplies as the Python float's would)."""

    inner: Any

    def init(self, params: torch.Tensor) -> TunableState:
        lr = torch.tensor(self.inner.learning_rate, dtype=torch.float32, device=params.device)
        return TunableState({"learning_rate": lr}, self.inner.init(params))

    def update(self, grad: torch.Tensor, state: TunableState) -> tuple[torch.Tensor, TunableState]:
        opt = dataclasses.replace(self.inner, learning_rate=state.hyperparams["learning_rate"])
        updates, inner_state = opt.update(grad, state.inner_state)
        return updates, TunableState(state.hyperparams, inner_state)


def tunable_optimizer(factory=None, **kwargs) -> Tunable:
    """``factory(**kwargs)`` (``adam`` by default) with its learning rate in
    the optimizer state: ``tunable_optimizer(learning_rate=0.01)``."""
    return Tunable((adam if factory is None else factory)(**kwargs))
