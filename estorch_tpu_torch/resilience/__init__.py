"""Resilience: deterministic chaos injection (counterpart of the JAX
package's ``resilience/chaos.py``).  The supervisor, ``run_resilient``
and the interleaver wait for ROADMAP.md port item 6."""

from .chaos import CHAOS_ENV, ChaosError, ChaosPlan

__all__ = ["CHAOS_ENV", "ChaosError", "ChaosPlan"]
