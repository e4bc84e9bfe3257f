"""Cluster-stability silhouettes on cosine distances (paper Alg. 6; port of
``repro/core/silhouette.py``, including its correction of the paper's
line 19: the standard silhouette on distances, +1 = stable).

  a_i = mean distance from point i to its own cluster's other points
  b_i = min over other clusters of the mean distance to that cluster
  s_i = (b_i - a_i) / max(a_i, b_i)
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SilhouetteResult(NamedTuple):
    s_min: torch.Tensor     # scalar — minimum silhouette width
    s_mean: torch.Tensor    # scalar — average silhouette width
    s_points: torch.Tensor  # (k, r) per-point silhouettes


def silhouettes(A_aligned: torch.Tensor) -> SilhouetteResult:
    """A_aligned: (r, n, k) column-aligned ensemble."""
    r, n, k = A_aligned.shape
    U = A_aligned / (torch.linalg.vector_norm(A_aligned, dim=1, keepdim=True)
                     + 1e-12)
    # gram[a, b, q, p] = <member q's column a, member p's column b>
    gram = torch.einsum("qna,pnb->abqp", U, U)
    dist = 1.0 - gram

    # a: mean distance within own cluster, excluding self (r - 1 others)
    diag = torch.diagonal(dist, dim1=0, dim2=1).permute(2, 0, 1)  # (k, r, r)
    own_sum = diag.sum(dim=-1) - torch.diagonal(diag, dim1=1, dim2=2)
    a = own_sum / max(r - 1, 1)                                   # (k, r)

    # b: min over other clusters of the mean distance to that cluster
    mean_to = dist.sum(dim=3) / r                                 # (k, k, r)
    big = torch.finfo(dist.dtype).max
    eye = torch.eye(k, dtype=torch.bool, device=dist.device)[:, :, None]
    b = torch.where(eye, torch.full_like(mean_to, big), mean_to).amin(dim=1)

    s = (b - a) / torch.maximum(torch.maximum(a, b),
                                torch.full_like(a, 1e-12))
    if r <= 1:
        s = torch.ones_like(s)
    return SilhouetteResult(s_min=s.min(), s_mean=s.mean(), s_points=s)
