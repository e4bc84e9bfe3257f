"""Linear sum assignment (Hungarian algorithm) — paper Alg. 5 line 8.

A copy of ``repro/core/lsa.py`` (numpy only): the port imports nothing
of ``repro``.

The custom clustering permutes the k columns of each perturbation's A factor
to maximize total cosine similarity to the current medoid, i.e. a k x k
linear sum assignment.  k is small (<= a few hundred), so this runs on host
numpy in O(k^3) — exactly the complexity the paper cites [58].

We implement the Jonker-Volgenant-style shortest augmenting path variant
(no scipy dependency in the hot path, though scipy's implementation is used
as a cross-check in tests when available).
"""
from __future__ import annotations

import numpy as np


def linear_sum_assignment(cost: np.ndarray) -> np.ndarray:
    """Minimize sum_i cost[i, perm[i]].  Returns perm (col index per row).

    Shortest-augmenting-path Hungarian; O(k^3).  `cost` may be any finite
    float matrix (we shift internally, no non-negativity requirement).
    """
    cost = np.asarray(cost, dtype=np.float64)
    k = cost.shape[0]
    assert cost.shape == (k, k), "LSA cost must be square"
    INF = 1e18
    # JV with 1-based padding row/col 0
    u = np.zeros(k + 1)
    v = np.zeros(k + 1)
    p = np.zeros(k + 1, dtype=np.int64)      # p[j] = row matched to col j
    way = np.zeros(k + 1, dtype=np.int64)
    for i in range(1, k + 1):
        p[0] = i
        j0 = 0
        minv = np.full(k + 1, INF)
        used = np.zeros(k + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = -1
            cur_row = cost[i0 - 1]
            for j in range(1, k + 1):
                if used[j]:
                    continue
                cur = cur_row[j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(k + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    perm = np.zeros(k, dtype=np.int64)
    for j in range(1, k + 1):
        perm[p[j] - 1] = j - 1
    return perm


def max_similarity_assignment(sim: np.ndarray) -> np.ndarray:
    """Maximize sum_i sim[i, perm[i]] — the clustering's objective."""
    return linear_sum_assignment(-np.asarray(sim))
