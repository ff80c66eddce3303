"""Novelty archive and mean-k-NN novelty (Conti et al. 2018, the NS-ES family).

Counterpart of ``estorch_tpu/algo/archive.py``, kept as the port's own
copy.  The archive stays on the host: it holds one behavior
characterization (BC) a generation, grows by one row at a time, and its
k-NN over a population is O(|archive|·pop) flops, nothing beside the
rollouts.  BCs arrive as one device-to-host copy of the (population,
bc_dim) array.
"""

from __future__ import annotations

import numpy as np


class NoveltyArchive:
    """Append-only store of BCs with mean-k-NN novelty.

    ``max_size`` bounds long runs: beyond it the oldest entries are evicted
    (FIFO), which keeps novelty about recent behavior and the k-NN cost
    constant.  0 (the default) is unbounded, the reference's behavior.
    """

    def __init__(self, k: int = 10, bc_dim: int | None = None, max_size: int = 0):
        self.k = int(k)
        self.bc_dim = bc_dim
        if max_size < 0:
            raise ValueError(f"max_size must be >= 0 (0 = unbounded), got {max_size}")
        self.max_size = int(max_size)
        self._bcs: list[np.ndarray] = []

    def __len__(self) -> int:
        return len(self._bcs)

    @property
    def bcs(self) -> np.ndarray:
        if not self._bcs:
            return np.zeros((0, self.bc_dim or 0), dtype=np.float32)
        return np.stack(self._bcs)

    def add(self, bc) -> None:
        bc = np.asarray(bc, dtype=np.float32).reshape(-1)
        if self.bc_dim is None:
            self.bc_dim = bc.shape[0]
        elif bc.shape[0] != self.bc_dim:
            raise ValueError(f"BC dim {bc.shape[0]} != archive dim {self.bc_dim}")
        self._bcs.append(bc)
        if self.max_size and len(self._bcs) > self.max_size:
            del self._bcs[: len(self._bcs) - self.max_size]

    def novelty(self, bcs) -> np.ndarray:
        """Mean distance to the k nearest archived BCs, per query row.

        ``bcs`` is (n, bc_dim) or (bc_dim,).  With an empty archive every
        query is equally novel: ones (only relative novelty matters to
        selection and ranking).
        """
        q = np.asarray(bcs, dtype=np.float32)
        single = q.ndim == 1
        q = np.atleast_2d(q)
        if not self._bcs:
            out = np.ones(q.shape[0], dtype=np.float32)
            return out[0] if single else out
        a = self.bcs
        # pairwise distances through |q - a|² = |q|² + |a|² - 2 q·a, so no
        # (n, m, d) intermediate; in float64, where the identity does not
        # cancel catastrophically for large |q|, |a| and a small distance
        q64 = q.astype(np.float64)
        a64 = a.astype(np.float64)
        d2 = (q64**2).sum(1)[:, None] + (a64**2).sum(1)[None, :] - 2.0 * (q64 @ a64.T)
        d = np.sqrt(np.maximum(d2, 0.0))
        k = min(self.k, d.shape[1])
        part = np.partition(d, k - 1, axis=1)[:, :k]
        out = part.mean(axis=1).astype(np.float32)
        return out[0] if single else out

    def state_dict(self) -> dict:
        """The archive as plain values, for a checkpoint."""
        return {"k": self.k, "bc_dim": self.bc_dim, "max_size": self.max_size,
                "bcs": self.bcs}

    @classmethod
    def from_state_dict(cls, d: dict) -> "NoveltyArchive":
        bc_dim = d.get("bc_dim")
        ar = cls(k=int(d["k"]), bc_dim=None if bc_dim is None else int(bc_dim),
                 max_size=int(d.get("max_size", 0)))
        for row in np.asarray(d["bcs"]):
            ar.add(row)
        return ar
