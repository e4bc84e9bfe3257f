"""Elasticity and fault-tolerance primitives (port of
``repro/dist/elastic.py``), host logic only: straggler detection, the
member-to-pod plan of the ensemble, square-grid sizing, and the
deprecated replay-from-checkpoint retry driver."""
from __future__ import annotations

import math
import statistics
import warnings
from typing import Callable, Iterable, Sequence


class StragglerMonitor:
    """Flags durations above ``factor`` x the running median.

    Flagged durations are not folded into the baseline, so a persistent
    straggler keeps flagging; the first duration never flags (warmup)."""

    def __init__(self, factor: float = 2.5, window: int = 128):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.flagged: list[tuple[int, float]] = []

    @property
    def baseline(self) -> float | None:
        """Median of the non-flagged durations (None before the first)."""
        return statistics.median(self.times) if self.times else None

    def record(self, step: int, seconds: float) -> bool:
        """Record one duration; True iff it is a straggler."""
        if not self.times:
            self.times.append(seconds)
            return False
        if seconds > self.factor * statistics.median(self.times):
            self.flagged.append((step, seconds))
            return True
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)
        return False


def choose_grid(n_devices: int) -> int:
    """Largest square-grid side p with p * p <= n_devices (the diagonal
    broadcasts of Alg. 3 need p_r == p_c, paper §6.1.3)."""
    return math.isqrt(n_devices)


def ensemble_plan(r: int, n_pods: int, spares_per_pod: int = 0
                  ) -> list[list[int]]:
    """The r members of RESCALk split contiguously over ``n_pods`` pods
    (pod q gets ceil or floor of r / n_pods), each pod with
    ``spares_per_pod`` spare slots of ids >= r.  Every real member appears
    in exactly one pod."""
    if n_pods <= 0:
        raise ValueError("n_pods must be positive")
    plan: list[list[int]] = []
    spare_id = r
    base, extra = divmod(r, n_pods)
    start = 0
    for q in range(n_pods):
        count = base + (1 if q < extra else 0)
        members = list(range(start, start + count))
        start += count
        members.extend(range(spare_id, spare_id + spares_per_pod))
        spare_id += spares_per_pod
        plan.append(members)
    return plan


def retry_loop(run: Callable[[int], None], steps: Iterable[int], *,
               restore: Callable[[], int], max_restarts: int = 3) -> None:
    """Deprecated: use ``repro_torch.resilience.RetryPolicy``.  Drives
    ``run(step)`` over ``steps`` and, on any exception, replays from the
    step ``restore()`` returns, at most ``max_restarts`` times."""
    warnings.warn(
        "dist.elastic.retry_loop is deprecated and will be removed next "
        "release; use repro_torch.resilience.RetryPolicy (classified retry "
        "with deterministic backoff)", DeprecationWarning, stacklevel=2)
    items: Sequence[int] = list(steps)
    restarts = 0
    i = 0
    while i < len(items):
        try:
            run(items[i])
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            resume = restore()
            i = next((j for j, s in enumerate(items) if s >= resume),
                     len(items))
            continue
        i += 1
