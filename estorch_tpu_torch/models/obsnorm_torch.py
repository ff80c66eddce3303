"""Running observation normalization for host-path torch policies.

Counterpart of ``estorch_tpu/models/obsnorm_torch.py``.  The device and
pooled paths normalize inside the engine (``ES(..., obs_norm=True)``);
host-path users own their rollout loops, so they normalize there, with the
same math: a Welford ``(count, mean, m2)`` triple, the Chan parallel merge,
and clipped ``(obs − mean)·rsqrt(var)``.

Usage in a ``rollout(policy)`` agent::

    norm = TorchRunningObsNorm(obs_dim)
    def rollout(self, policy):
        ...
        action = policy(norm(obs_tensor))
        ...
        norm.update(episode_obs)   # raw observations, (n, obs_dim)

The stats are buffers: ``state_dict()`` round-trips them.
"""

from __future__ import annotations

import torch


class TorchRunningObsNorm(torch.nn.Module):
    def __init__(self, obs_dim: int, clip: float = 5.0):
        super().__init__()
        self.clip = float(clip)
        # count 1, mean 0, m2 1 → var 1 until fed, as the engines' initial stats
        self.register_buffer("count", torch.tensor(1.0))
        self.register_buffer("mean", torch.zeros(obs_dim))
        self.register_buffer("m2", torch.ones(obs_dim))

    @torch.no_grad()
    def update(self, obs_batch: torch.Tensor) -> None:
        """Fold an (n, obs_dim) batch of raw observations into the running
        stats (the Chan parallel update)."""
        obs_batch = obs_batch.reshape(-1, self.mean.shape[0]).float()
        n = obs_batch.shape[0]
        if n == 0:
            return
        c1 = torch.tensor(float(n), device=self.count.device)
        mean1 = obs_batch.mean(dim=0)
        m2_1 = ((obs_batch - mean1) ** 2).sum(dim=0)
        tot = self.count + c1
        delta = mean1 - self.mean
        self.mean += delta * (c1 / tot)
        self.m2 += m2_1 + delta * delta * (self.count * c1 / tot)
        self.count.copy_(tot)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = torch.clamp(self.m2 / self.count, min=1e-8)
        out = (x.float() - self.mean) * torch.rsqrt(var)
        return torch.clamp(out, -self.clip, self.clip)
