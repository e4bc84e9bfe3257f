"""Custom clustering of RESCAL ensemble solutions (paper Alg. 5; port of
``repro/core/clustering.py``).

Aligns the k columns of every ensemble member to a common order so that
cluster q holds exactly one column from each member: a k-medians loop of
cosine similarity to the medoid, a k x k linear sum assignment per member
(host numpy, O(k^3)), and the elementwise median over members.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .lsa import max_similarity_assignment


class ClusterResult(NamedTuple):
    A_aligned: torch.Tensor   # (r, n, k) columns reordered per member
    R_aligned: torch.Tensor   # (r, m, k, k) rows+cols reordered consistently
    A_median: torch.Tensor    # (n, k) medoid (cluster medians)
    perms: np.ndarray         # (r, k) the permutation applied to each member
    n_sweeps: int


def _colnorm(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return A / (torch.linalg.vector_norm(A, dim=-2, keepdim=True) + eps)


def _similarity(M: torch.Tensor, A_ens: torch.Tensor) -> torch.Tensor:
    """sim[q, a, b] = <M_hat[:, a], A_hat_q[:, b]> — (r, k, k)."""
    return _colnorm(M).transpose(0, 1).unsqueeze(0) @ _colnorm(A_ens)


def _apply_perms(A_ens: torch.Tensor, R_ens: torch.Tensor,
                 perms: torch.Tensor):
    """Reorder the columns of each A_q and the rows and cols of each
    R_q[t]."""
    A2 = torch.take_along_dim(A_ens, perms[:, None, :], dim=2)
    R2 = torch.take_along_dim(R_ens, perms[:, None, :, None], dim=2)
    R2 = torch.take_along_dim(R2, perms[:, None, None, :], dim=3)
    return A2, R2


def median(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.median``: with an even count, the mean of the two middle
    values ((lo + hi) * 0.5).  ``torch.median`` returns the lower one, so
    it is not used."""
    s = torch.sort(x, dim=dim).values
    r = x.shape[dim]
    lo = s.select(dim, (r - 1) // 2)
    hi = s.select(dim, r // 2)
    return (lo + hi) * 0.5


def custom_cluster(A_ens: torch.Tensor, R_ens: torch.Tensor,
                   max_sweeps: int = 50) -> ClusterResult:
    """Align ensemble members.  A_ens: (r, n, k); R_ens: (r, m, k, k)."""
    r, n, k = A_ens.shape
    total_perm = np.tile(np.arange(k), (r, 1))
    M = A_ens[0]
    sweeps = 0
    for sweeps in range(1, max_sweeps + 1):
        sim = _similarity(M, A_ens).cpu().numpy()       # (r, k, k) host
        # perms[q][a] = member column assigned to medoid slot a
        perms = np.stack([max_similarity_assignment(sim[q])
                          for q in range(r)])
        changed = bool(np.any(perms != np.arange(k)[None, :]))
        A_ens, R_ens = _apply_perms(
            A_ens, R_ens, torch.as_tensor(perms, device=A_ens.device))
        total_perm = np.take_along_axis(total_perm, perms, axis=1)
        M = median(A_ens, dim=0)                         # cluster medians
        if not changed:
            break
    return ClusterResult(A_aligned=A_ens, R_aligned=R_ens, A_median=M,
                         perms=total_perm, n_sweeps=sweeps)
