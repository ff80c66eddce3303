"""The benchmark's envs, handed alike to the program and the reference.

Frozen copies: the program's own envs may change, these do not.  A
configuration names its env by ``kind`` (``make_env``).
"""

from __future__ import annotations


def make_env(spec: dict):
    """The env a configuration's ``env`` block describes."""
    kind = spec["kind"]
    if kind == "synthetic":
        from .synthetic import SyntheticEnv

        return SyntheticEnv(obs_dim=int(spec["obs_dim"]), action_dim=int(spec["action_dim"]))
    if kind == "pixel_shift":
        from .pixel_shift import PixelShiftEnv

        return PixelShiftEnv()
    raise ValueError(f"unknown env kind {kind!r}")
