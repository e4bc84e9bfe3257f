"""Runtime factor sanitizer — finite, non-negative and, on k_max-padded
factors, exactly zero in the masked columns (port of
``repro/analysis/sanitizer.py``).

``check_factors`` makes the checks and raises ``FactorSanitizerError``
with ``repro``'s message, character for character; the newest message is
also kept for ``last_failure()``.  ``sanitize_state`` is the hook every MU
step calls: with ``enabled=False`` (the default everywhere) it returns
its inputs and touches nothing, so the off path costs one Python call;
enabled, it runs ``check_factors``, which copies a few scalars to the
host per call and so synchronises the device.
"""
from __future__ import annotations

import torch

__all__ = ["FactorSanitizerError", "sanitize_state", "check_factors",
           "last_failure", "reset_failures"]


class FactorSanitizerError(AssertionError):
    """A factor violated finiteness, non-negativity or the mask."""


_LAST_FAILURE: str | None = None


def last_failure() -> str | None:
    """Message of the most recent sanitizer failure in this process."""
    return _LAST_FAILURE


def reset_failures() -> None:
    global _LAST_FAILURE
    _LAST_FAILURE = None


def _first(cond: torch.Tensor) -> list[int]:
    """Index of the first true entry in row-major order (numpy's
    ``argwhere(...)[0]``)."""
    return torch.nonzero(cond)[0].tolist()


def _describe_bad(name: str, x: torch.Tensor) -> list[str]:
    problems = []
    finite = torch.isfinite(x)
    if not bool(finite.all()):
        problems.append(f"{name} has {int((~finite).sum())} non-finite "
                        f"entries (first at {_first(~finite)})")
    neg = (x < 0) & finite
    if bool(neg.any()):
        problems.append(f"{name} has {int(neg.sum())} negative entries "
                        f"(min {float(x[finite].min()):.3e}, first at "
                        f"{_first(neg)})")
    return problems


def check_factors(A, R, mask=None, *, where: str = "host") -> None:
    """Raise FactorSanitizerError with a located message unless A and R
    are finite and non-negative, and zero where ``mask`` is 0.

    A: (..., n, k); R: (..., m, k, k); mask: (..., k) with 1 = active
    column, 0 = k_max padding that must hold exactly zero.  Leading batch
    dims (members, (k, q) cells) broadcast through.  Tensors on any
    device, or arrays."""
    global _LAST_FAILURE
    A = torch.as_tensor(A)
    R = torch.as_tensor(R)
    problems = _describe_bad("A", A) + _describe_bad("R", R)
    if mask is not None:
        m = torch.as_tensor(mask, device=A.device).to(A.dtype)
        bad_a = int(torch.count_nonzero(A * (1.0 - m).unsqueeze(-2)))
        if bad_a:
            problems.append(f"A has {bad_a} non-zero entries in masked "
                            f"(padded) columns — zeros are the MU fixed "
                            f"point the cross-k batching relies on")
        m2 = m.unsqueeze(-1) * m.unsqueeze(-2)
        bad_r = int(torch.count_nonzero(R * (1.0 - m2).unsqueeze(-3)))
        if bad_r:
            problems.append(f"R has {bad_r} non-zero entries in masked "
                            f"(padded) rows/columns")
    if problems:
        msg = f"[sanitizer:{where}] " + "; ".join(problems)
        _LAST_FAILURE = msg
        raise FactorSanitizerError(msg)


def sanitize_state(A: torch.Tensor, R: torch.Tensor, *, where: str,
                   mask: torch.Tensor | None = None, enabled: bool = False):
    """Identity on (A, R); when enabled, ``check_factors(A, R, mask,
    where=where)`` first.  Returns (A, R) unchanged."""
    if enabled:
        check_factors(A, R, mask, where=where)
    return A, R
