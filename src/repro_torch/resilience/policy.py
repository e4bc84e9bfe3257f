"""RetryPolicy — the classified attempt loop (port of
``repro/resilience/policy.py``).

- **Classification.** :class:`~repro_torch.resilience.faults.
  TransientError` subclasses, ``OSError``, ``ConnectionError``,
  ``TimeoutError`` and whatever the ``classify`` predicate accepts are
  retried; any other exception fails fast through a bare ``raise``, with
  its original traceback and a ``sched/fail_fast`` event.
- **Backoff.** Attempt ``a`` sleeps ``min(base_delay * 2**(a-2),
  max_delay) * (1 + jitter * u)`` with ``u`` in [-1, 1] from
  ``zlib.crc32(f"{seed}:{key}:{a}")``: a pure function of (seed, key,
  attempt), equal to ``repro``'s and stable across processes.
- **Deadline.** With ``deadline`` (or a per-attempt ``deadline_fn``) the
  attempt runs on a worker thread and an overrun raises
  :class:`DeadlineExceeded`, a TransientError.  ``deadline=None`` runs
  inline, with no thread.

``call`` returns ``(result, RetryStats)``, which the scheduler's
``UnitRecord`` reports.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Any, Callable

from repro_torch.obs import trace as obs

from .faults import TransientError

__all__ = ["DeadlineExceeded", "RetryPolicy", "RetryStats"]

_TRANSIENT_TYPES = (TransientError, OSError, ConnectionError, TimeoutError)


class DeadlineExceeded(TransientError):
    """An attempt overran its per-attempt deadline.  Transient: the retry
    gets a fresh (possibly shrunken) budget."""


@dataclasses.dataclass(frozen=True)
class RetryStats:
    """One ``RetryPolicy.call``: attempts run, seconds slept between them,
    and whether a non-transient error cut the budget short."""
    attempts: int = 1
    backoff_seconds: float = 0.0
    fail_fast: bool = False


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded, classified, deterministically jittered retry.

    max_attempts  total tries including the first (1 = no retry)
    base_delay    backoff before attempt 2; doubles per attempt
    max_delay     backoff ceiling
    jitter        +/- fraction of the backoff drawn from the seeded hash
    seed          jitter seed (same seed, key and attempt: same sleep)
    deadline      per-attempt wall-clock budget in seconds (None = off)
    classify      extra predicate: True retries an exception the built-in
                  taxonomy would fail fast on
    """
    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 5.0
    jitter: float = 0.25
    seed: int = 0
    deadline: float | None = None
    classify: Callable[[BaseException], bool] | None = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")

    def is_transient(self, err: BaseException) -> bool:
        if isinstance(err, _TRANSIENT_TYPES):
            return True
        return bool(self.classify and self.classify(err))

    def backoff(self, attempt: int, key: str = "") -> float:
        """Sleep before ``attempt`` (attempt 2 is the first retry)."""
        if attempt <= 1:
            return 0.0
        delay = min(self.base_delay * 2.0 ** (attempt - 2), self.max_delay)
        u = zlib.crc32(f"{self.seed}:{key}:{attempt}".encode()) / 0xFFFFFFFF
        return max(0.0, delay * (1.0 + self.jitter * (2.0 * u - 1.0)))

    def call(self, fn: Callable[[int], Any], *, key: str = "",
             on_retry: Callable[[int, BaseException, float], None]
             | None = None,
             deadline_fn: Callable[[int], float | None] | None = None,
             sleep: Callable[[float], None] = time.sleep,
             ) -> tuple[Any, RetryStats]:
        """Run ``fn(attempt)`` (0-based) under this policy.
        ``on_retry(next_attempt, err, backoff)`` runs before each backoff
        sleep; ``deadline_fn(attempt)`` overrides ``deadline`` per attempt.
        Non-transient errors and an exhausted budget re-raise the original
        exception."""
        backoff_total = 0.0
        for attempt in range(self.max_attempts):
            limit = (deadline_fn(attempt) if deadline_fn is not None
                     else self.deadline)
            try:
                result = (_run_with_deadline(fn, attempt, limit)
                          if limit is not None else fn(attempt))
            except Exception as err:
                if not self.is_transient(err):
                    obs.event(
                        "sched/fail_fast", key=key,  # rescal-lint: disable=key-discipline -- string label, not a PRNG key
                        attempt=attempt + 1, error=type(err).__name__)
                    raise
                if attempt + 1 >= self.max_attempts:
                    raise
                pause = self.backoff(attempt + 2, key)  # rescal-lint: disable=key-discipline -- string label, not a PRNG key
                if on_retry is not None:
                    on_retry(attempt + 1, err, pause)
                if pause > 0.0:
                    sleep(pause)
                backoff_total += pause
                continue
            return result, RetryStats(attempts=attempt + 1,
                                      backoff_seconds=backoff_total)
        raise AssertionError("unreachable")     # pragma: no cover


def _run_with_deadline(fn: Callable[[int], Any], attempt: int,
                       limit: float) -> Any:
    """``fn(attempt)`` on a daemon thread; an overrun of ``limit`` seconds
    raises DeadlineExceeded and abandons the thread (a retried unit starts
    over, so its fn is replay-safe)."""
    box: dict[str, Any] = {}

    def _target():
        try:
            box["result"] = fn(attempt)
        except BaseException as err:        # noqa: BLE001 — relayed below
            box["error"] = err

    t = threading.Thread(target=_target, daemon=True,
                         name=f"retry-attempt-{attempt}")
    t.start()
    t.join(limit)
    if t.is_alive():
        raise DeadlineExceeded(
            f"attempt {attempt} exceeded its {limit:.3f}s deadline")
    if "error" in box:
        raise box["error"]
    return box["result"]
