"""Deterministic fault injection and classified retry (port of
``repro/resilience``).

- :mod:`repro_torch.resilience.faults` — the seeded fault registry: a
  :class:`FaultPlan` maps the registered seams to fault specs, and
  ``faults.probe(seam)`` call sites probe it (one ``None`` check when no
  plan is installed).
- :mod:`repro_torch.resilience.policy` — :class:`RetryPolicy`: bounded
  attempts, exponential backoff with deterministic seeded jitter,
  per-attempt deadlines, transient-vs-deterministic classification.
"""
from .faults import (SEAMS, DeterministicFault, FaultPlan, FaultSpec,
                     TransientError)
from .policy import DeadlineExceeded, RetryPolicy, RetryStats

__all__ = [
    "SEAMS", "DeterministicFault", "DeadlineExceeded", "FaultPlan",
    "FaultSpec", "RetryPolicy", "RetryStats", "TransientError",
]
