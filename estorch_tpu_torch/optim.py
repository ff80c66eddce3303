"""Adam on the flat parameter vector, matching ``optax.adam``.

The JAX package's ES takes an optax factory; this is the port's
counterpart for ``optax.adam``: the same moments, bias correction and
epsilon placement (outside the square root), as a pure ``init``/``update``
pair so that a generation's state can be kept and restored whole.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

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
