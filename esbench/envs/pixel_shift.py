"""A pixel device env: a frozen copy of ``chip_smoke.py``'s ``PixelShiftEnv``.

(84, 84, 4) float observations of a leaky shift register driven by the
action: each step moves the image one column right, scaled by 0.9, and
writes a / 2 into column 0; the reward is −(a / 2 − pixel (0, 5, 0))².
Never ends.  The state is the flat image, so a step is a copy and a few
elementwise ops and the policy's forward holds the time.

The returns depend on the actions alone, and an argmax over 3 logits flips
where float32 rounding moves a near-tie, so the benchmark does not compare
returns of two rollouts: with ``record`` a list, each step appends the
actions it was given, and the reference replays the program's actions and
judges each by its own logits (``reference/es.py``).
"""

from __future__ import annotations

import torch


class PixelShiftEnv:
    height = width = 84
    channels = 4
    action_dim = 3
    discrete = True
    default_horizon = 200
    bc_dim = 4
    obs_dim = 84 * 84 * 4

    def __init__(self):
        self.record: list | None = None

    def reset(self, generator: torch.Generator, n: int):
        states = torch.rand((n, self.obs_dim), generator=generator, device=generator.device)
        return states, self.observe(states)

    def observe(self, states: torch.Tensor) -> torch.Tensor:
        return states.view(-1, self.height, self.width, self.channels)

    def step(self, states: torch.Tensor, actions: torch.Tensor):
        if self.record is not None:
            self.record.append(actions.reshape(-1).detach().clone())
        img = self.observe(states)
        n = img.shape[0]
        value = actions.reshape(n).to(torch.float32) / 2.0
        d = value - img[:, 0, 5, 0]
        col = value[:, None, None, None].expand(n, self.height, 1, self.channels)
        new = torch.cat([col, img[:, :, :-1] * 0.9], dim=2)
        return (new.reshape(n, -1), new, -(d * d),
                torch.zeros((n,), dtype=torch.bool, device=img.device))

    def behavior(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        return obs[:, 0, :4, 0]
