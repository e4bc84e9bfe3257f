"""Pluggable k-selection criteria for the RESCALk sweep (paper §3.3).

A copy of ``repro/selection/criteria.py`` (numpy only): the port imports
nothing of ``repro``.

The paper selects k_opt as "the maximum number of stable clusters
corresponding to a good accuracy" — a threshold rule on the minimum
silhouette with reconstruction error as the tie-breaker.  This module makes
that rule one of several interchangeable criteria so the scheduler (and the
CLI) can switch selection policies without touching the sweep itself:

  threshold      — the paper rule: largest k whose min-silhouette clears
                   ``sil_threshold``; falls back to ``stability_fit`` when
                   nothing clears the bar (pathological data).
  stability_fit  — argmax of the combined score s_min - rel_err (the
                   fallback of [63] promoted to a first-class rule).
  elbow          — reconstruction-error elbow: the k of maximum deviation
                   below the chord of the (k, rel_err) curve (a kneedle-
                   style rule).  Degrades to ``threshold`` when the curve
                   has no knee: fewer than 3 candidates, a non-decreasing
                   curve, or a near-linear (monotone, knee-free) descent.

All criteria are pure NumPy on the per-k summary arrays — they never touch
the factors, so swapping criteria is free after a sweep (the JSON report
stores the curves; see report.py).
"""
from __future__ import annotations

from typing import Callable

import numpy as np


def _prep(ks, s_min, rel_err):
    ks = np.asarray(ks)
    s_min = np.asarray(s_min, dtype=np.float64)
    rel_err = np.asarray(rel_err, dtype=np.float64)
    if ks.size == 0:
        raise ValueError("no candidate ks")
    if not (ks.shape == s_min.shape == rel_err.shape):
        raise ValueError(f"curve shapes disagree: ks {ks.shape}, "
                         f"s_min {s_min.shape}, rel_err {rel_err.shape}")
    return ks, s_min, rel_err


def select_stability_fit(ks, s_min, s_mean, rel_err, *,
                         sil_threshold: float = 0.75) -> int:
    """argmax of the stability x fit score s_min - rel_err."""
    ks, s_min, rel_err = _prep(ks, s_min, rel_err)
    return int(ks[int(np.argmax(s_min - rel_err))])


def select_threshold(ks, s_min, s_mean, rel_err, *,
                     sil_threshold: float = 0.75) -> int:
    """Paper §3.3 / [63]: the largest k with stable clusters and good fit.

    Stable = min silhouette above threshold.  Among stable ks,
    reconstruction error decreases with k, so "largest stable k" implements
    "maximum number of stable clusters corresponding to a good accuracy".
    If nothing clears the bar, fall back to the stability x fit score.
    """
    ks, s_min, rel_err = _prep(ks, s_min, rel_err)
    stable = s_min >= sil_threshold
    if stable.any():
        return int(ks[stable][-1])
    return select_stability_fit(ks, s_min, s_mean, rel_err,
                                sil_threshold=sil_threshold)


def select_elbow(ks, s_min, s_mean, rel_err, *, sil_threshold: float = 0.75,
                 min_knee: float = 0.05) -> int:
    """Reconstruction-error elbow: the error curve of an over-complete sweep
    drops steeply until k reaches the true rank and flattens after it; the
    knee is the candidate of maximum deviation below the first-to-last
    chord of the normalized curve.  ``min_knee`` guards the degenerate
    shapes: a near-linear monotone descent (no knee), a flat or increasing
    curve, or fewer than 3 candidates all defer to the threshold rule.
    """
    ks, s_min, rel_err = _prep(ks, s_min, rel_err)
    if ks.size == 1:
        return int(ks[0])
    span = rel_err[0] - rel_err[-1]
    if ks.size < 3 or span <= 0.0:
        return select_threshold(ks, s_min, s_mean, rel_err,
                                sil_threshold=sil_threshold)
    x = (ks - ks[0]) / (ks[-1] - ks[0])
    y = (rel_err - rel_err[-1]) / span          # 1 -> 0, decreasing overall
    knee = (1.0 - x) - y                        # deviation below the chord
    if float(knee.max()) < min_knee:            # monotone, knee-free curve
        return select_threshold(ks, s_min, s_mean, rel_err,
                                sil_threshold=sil_threshold)
    return int(ks[int(np.argmax(knee))])


CRITERIA: dict[str, Callable] = {
    "threshold": select_threshold,
    "stability_fit": select_stability_fit,
    "elbow": select_elbow,
}


def require(name: str) -> None:
    """Fail fast (ValueError listing the registry) on an unknown criterion
    name — the one shared validation used by select() and by constructors
    that want the error before any work runs."""
    if name not in CRITERIA:
        raise ValueError(f"unknown selection criterion {name!r}; "
                         f"available: {sorted(CRITERIA)}")


def select(name: str, ks, s_min, s_mean, rel_err, *,
           sil_threshold: float = 0.75, **kwargs) -> int:
    """Dispatch to a named criterion."""
    require(name)
    return CRITERIA[name](ks, s_min, s_mean, rel_err,
                          sil_threshold=sil_threshold, **kwargs)
