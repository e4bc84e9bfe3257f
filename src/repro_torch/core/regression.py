"""R regression given a fixed A (paper Alg. 1 line 9; port of
``repro/core/regression.py``): MU updates on R with A frozen."""
from __future__ import annotations

import torch

from .rescal import EPS_DEFAULT, atxa, gram, r_update


def regress_R(X: torch.Tensor, A: torch.Tensor, R0: torch.Tensor, *,
              iters: int = 100, eps: float = EPS_DEFAULT) -> torch.Tensor:
    """Solve for R (m, k, k) >= 0 with A fixed on a dense X (m, n, n),
    from the initial ``R0`` (``repro`` draws it from PRNGKey(17); a draw
    source supplies it here).  X @ A is formed once."""
    G = gram(A)
    ATXA = atxa(A, X @ A)
    R = R0
    for _ in range(iters):
        R = r_update(R, ATXA, G, eps)
    return R
