"""Runtime factor sanitizer — finite and non-negative (port of
``repro/analysis/sanitizer.py``; the masked-column check comes with the
masked steps).

``sanitize_state`` is the hook every MU step calls.  With
``enabled=False`` (the default everywhere) it returns its inputs and
touches nothing, so the off path costs one Python call.  Enabled, it
copies two booleans to the host per call, which synchronises the device.
"""
from __future__ import annotations

import torch

__all__ = ["FactorSanitizerError", "sanitize_state"]


class FactorSanitizerError(AssertionError):
    """A factor violated finiteness or non-negativity."""


def _problems(name: str, x: torch.Tensor) -> list[str]:
    out = []
    finite = torch.isfinite(x)
    if not bool(finite.all()):
        out.append(f"{name} has {int((~finite).sum())} non-finite entries")
    neg = (x < 0) & finite
    if bool(neg.any()):
        out.append(f"{name} has {int(neg.sum())} negative entries "
                   f"(min {float(x[neg].min()):.3e})")
    return out


def sanitize_state(A: torch.Tensor, R: torch.Tensor, *, where: str,
                   enabled: bool = False):
    """Assert (A, R) are finite and non-negative.  Returns (A, R)
    unchanged."""
    if not enabled:
        return A, R
    problems = _problems("A", A) + _problems("R", R)
    if problems:
        raise FactorSanitizerError(f"[sanitize] {where}: "
                                   + "; ".join(problems))
    return A, R
