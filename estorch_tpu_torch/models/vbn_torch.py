"""VirtualBatchNorm as a ``torch.nn.Module``, for host-path torch policies.

Counterpart of ``estorch_tpu/models/vbn_torch.py``.  Host-path users drop it
into their own torch policies; the port's bundled policies use the
functional ``models/vbn.py``.  The statistics are computed once from the
first batch seen (the reference batch) and frozen; later calls normalize
with them and a learned affine.  The statistics are buffers, so
``state_dict()`` carries them to worker policies and ES never perturbs them.
"""

from __future__ import annotations

import torch


class TorchVirtualBatchNorm(torch.nn.Module):
    """Freeze normalization stats on the first (reference) forward pass."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.scale = torch.nn.Parameter(torch.ones(num_features))
        self.bias = torch.nn.Parameter(torch.zeros(num_features))
        self.register_buffer("ref_mean", torch.zeros(num_features))
        self.register_buffer("ref_var", torch.ones(num_features))
        self.register_buffer("initialized", torch.tensor(False))

    @torch.no_grad()
    def set_reference(self, reference_batch: torch.Tensor) -> None:
        """Explicitly freeze statistics from a reference batch."""
        dims = tuple(range(reference_batch.dim() - 1))
        self.ref_mean.copy_(reference_batch.mean(dim=dims))
        self.ref_var.copy_(reference_batch.var(dim=dims, unbiased=False))
        self.initialized.fill_(True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not bool(self.initialized):
            if x.dim() < 2 or x.shape[0] < 2:
                # a single observation has zero variance: freezing from it
                # would scale activations by rsqrt(eps)
                raise RuntimeError(
                    "TorchVirtualBatchNorm statistics are not initialized; "
                    "call set_reference(reference_batch) with a batch of "
                    "observations before rollouts (or run one batched forward)")
            self.set_reference(x)  # the first batched call is the reference pass
        inv = torch.rsqrt(self.ref_var + self.eps)
        return (x - self.ref_mean) * inv * self.scale + self.bias
