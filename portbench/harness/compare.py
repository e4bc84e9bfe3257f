"""How the program's answers are held to the reference's: each number is
a gap, and each gap has a limit (``limits/<cell>.json``)."""
from __future__ import annotations

import numpy as np
import torch


def worst_gap(got, ref) -> float:
    """The largest element-wise gap between ``got`` and ``ref``, over the
    largest magnitude in ``ref``: a single altered element shows in
    full, whatever the size of the tensor."""
    got = torch.as_tensor(np.asarray(got) if not torch.is_tensor(got)
                          else got)
    ref = torch.as_tensor(np.asarray(ref) if not torch.is_tensor(ref)
                          else ref).to(got.device)
    if got.shape != ref.shape:
        return float("inf")
    scale = float(ref.abs().max())
    gap = float((got.double() - ref.double()).abs().max())
    if not np.isfinite(gap):
        return float("inf")
    return gap / scale if scale > 0 else gap


def relative_gap(got: float, ref: float) -> float:
    """|got - ref| / |ref| of two numbers (inf when either is not
    finite)."""
    if not (np.isfinite(got) and np.isfinite(ref)):
        return float("inf")
    return abs(got - ref) / abs(ref) if ref != 0 else abs(got - ref)


def judge(readings: dict[str, float], limits: dict[str, float]) -> dict:
    """Each number that has a limit beside its limit, and whether all are
    within: ``{"correct": bool, "checks": {name: {"value", "limit"}}}``.
    A limit without its number is not correct."""
    checks, ok = {}, True
    for name in sorted(limits):
        value, limit = readings.get(name), limits[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and bool(np.isfinite(value)) \
            and value <= limit
    return {"correct": bool(ok), "checks": checks}


def over(gaps: dict[str, float], limits: dict[str, float]) -> bool:
    """Whether any of ``gaps`` is past its limit."""
    return any(not gaps.get(n, np.inf) <= limit
               for n, limit in limits.items())
