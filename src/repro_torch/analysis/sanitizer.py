"""Runtime factor sanitizer — finite, non-negative and, on k_max-padded
factors, exactly zero in the masked columns (port of
``repro/analysis/sanitizer.py``).

``sanitize_state`` is the hook every MU step calls.  With
``enabled=False`` (the default everywhere) it returns its inputs and
touches nothing, so the off path costs one Python call.  Enabled, it
copies two booleans to the host per call, which synchronises the device.
"""
from __future__ import annotations

import torch

__all__ = ["FactorSanitizerError", "sanitize_state"]


class FactorSanitizerError(AssertionError):
    """A factor violated finiteness, non-negativity or the mask."""


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


def _masked(A: torch.Tensor, R: torch.Tensor, mask: torch.Tensor
            ) -> list[str]:
    """Non-zero entries in the padded columns of A and rows and columns
    of R; ``mask`` (..., k) is 1 for an active column."""
    out = []
    off = 1.0 - mask.to(A.dtype)
    bad_a = int(torch.count_nonzero(A * off.unsqueeze(-2)))
    if bad_a:
        out.append(f"A has {bad_a} non-zero entries in masked (padded) "
                   f"columns")
    on = mask.to(R.dtype)
    off2 = 1.0 - on.unsqueeze(-1) * on.unsqueeze(-2)
    bad_r = int(torch.count_nonzero(R * off2.unsqueeze(-3)))
    if bad_r:
        out.append(f"R has {bad_r} non-zero entries in masked (padded) "
                   f"rows/columns")
    return out


def sanitize_state(A: torch.Tensor, R: torch.Tensor, *, where: str,
                   mask: torch.Tensor | None = None, enabled: bool = False):
    """Assert (A, R) are finite and non-negative, and zero where ``mask``
    (..., k) is 0.  Returns (A, R) unchanged."""
    if not enabled:
        return A, R
    problems = _problems("A", A) + _problems("R", R)
    if mask is not None:
        problems += _masked(A, R, mask)
    if problems:
        raise FactorSanitizerError(f"[sanitize] {where}: "
                                   + "; ".join(problems))
    return A, R
