"""Plain reference of the RESCALk model selection (paper Alg. 1, 4-6) on
a dense tensor: per candidate rank k, r perturbed copies of X, each
factorized by MU from its own initial factors, normalised and scored
against the unperturbed X; then the per-k reduction (column clustering
by linear sum assignment, silhouettes, R regressed on the median A, its
relative error) and the threshold criterion's k.

float32 on the device for the tensor work (with TF32 off unless the
caller allows it), float64 numpy on the host for the clustering's
assignments, the silhouettes and the criterion.  The draws (noise and
initial factors) come from the caller's draw object, the same one the
program was handed.  Nothing of the program is imported here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from .mu import Dense, atxa, mu_iteration, rel_error

EPS = 1e-16


@dataclasses.dataclass
class RankResult:
    k: int
    s_min: float
    s_mean: float
    rel_err: float
    member_errors: np.ndarray      # (r,)
    A_median: np.ndarray           # (n, k)
    R_regress: np.ndarray          # (m, k, k)


def normalize(A: torch.Tensor, R: torch.Tensor, eps: float = 1e-12):
    """Unit-norm columns of A, the scale folded into R."""
    c = torch.linalg.vector_norm(A, dim=-2).clamp_min(eps)
    cc = c.unsqueeze(-1) * c.unsqueeze(-2)
    return A / c.unsqueeze(-2), R * cc.unsqueeze(-3)


def ensemble(X: torch.Tensor, k: int, members: int, iters: int,
             delta: float, draws):
    """The r members of rank k: (A (r, n, k), R (r, m, k, k), errors
    (r,) against the unperturbed X)."""
    m, n = X.shape[0], X.shape[-1]
    Xq = torch.empty((members,) + tuple(X.shape), dtype=X.dtype,
                     device=X.device)
    A0, R0 = [], []
    for q in range(members):
        draws.noise_into(k, q, Xq[q], delta)
        Xq[q].mul_(X)
        a, r = draws.init(k, q, n, m)
        A0.append(a)
        R0.append(r)
    A, R = torch.stack(A0), torch.stack(R0)
    op = Dense(Xq)
    for _ in range(iters):
        A, R = mu_iteration(op, A, R, EPS)
    del op, Xq
    A, R = normalize(A, R)
    return A, R, rel_error(Dense(X), A, R)


def _unit_columns(A: np.ndarray) -> np.ndarray:
    return A / (np.linalg.norm(A, axis=-2, keepdims=True) + 1e-12)


def cluster(A: np.ndarray, R: np.ndarray, max_sweeps: int = 50):
    """Align the members' columns to a common order (paper Alg. 5): from
    member 0 as the medoid, assign each member's columns to the medoid's
    by the largest total cosine similarity, take the element-wise median
    over members, and repeat until no member's columns move.  Returns
    the aligned A (r, n, k), R (r, m, k, k) and the median (n, k)."""
    r, _, k = A.shape
    M = A[0]
    for _ in range(max_sweeps):
        sim = np.einsum("na,qnb->qab", _unit_columns(M), _unit_columns(A))
        perms = np.stack([linear_sum_assignment(-sim[q])[1]
                          for q in range(r)])
        changed = bool((perms != np.arange(k)).any())
        A = np.take_along_axis(A, perms[:, None, :], axis=2)
        R = np.take_along_axis(R, perms[:, None, :, None], axis=2)
        R = np.take_along_axis(R, perms[:, None, None, :], axis=3)
        M = np.median(A, axis=0)
        if not changed:
            break
    return A, R, M


def silhouettes(A: np.ndarray) -> tuple[float, float]:
    """(min, mean) silhouette of the aligned columns, on cosine distance
    (+1 stable): point (a, q) is member q's column a, its cluster the
    columns a of every member."""
    r, _, k = A.shape
    U = _unit_columns(A)
    dist = 1.0 - np.einsum("qna,pnb->aqbp", U, U)      # (k, r, k, r)
    s = np.empty((k, r))
    for a in range(k):
        for q in range(r):
            own = (dist[a, q, a].sum() - dist[a, q, a, q]) / max(r - 1, 1)
            other = min(dist[a, q, b].mean() for b in range(k) if b != a) \
                if k > 1 else np.inf
            s[a, q] = (other - own) / max(own, other, 1e-12)
    if r <= 1:
        s[:] = 1.0
    return float(s.min()), float(s.mean())


def regress(X: torch.Tensor, A: torch.Tensor, R0: torch.Tensor,
            iters: int) -> torch.Tensor:
    """R >= 0 with A fixed: MU on R alone from R0."""
    op = Dense(X)
    G = A.T @ A
    ATXA = atxa(op, A)
    R = R0
    for _ in range(iters):
        R = R * ATXA / (G @ R @ G + EPS)
    return R


def select_threshold(ks, s_min, rel_err, sil_threshold: float) -> int:
    """The largest k whose minimum silhouette clears the threshold; if
    none does, the k of the largest s_min - rel_err."""
    ks = np.asarray(ks)
    s_min, rel_err = np.asarray(s_min), np.asarray(rel_err)
    stable = s_min >= sil_threshold
    if stable.any():
        return int(ks[stable][-1])
    return int(ks[int(np.argmax(s_min - rel_err))])


def rank(X: torch.Tensor, k: int, *, members: int, iters: int,
         regress_iters: int, delta: float, draws) -> RankResult:
    """One candidate rank: its ensemble, then its reduction."""
    A, R, errs = ensemble(X, k, members, iters, delta, draws)
    A_al, _, M = cluster(A.double().cpu().numpy(),
                         R.double().cpu().numpy())
    s_min, s_mean = silhouettes(A_al)
    Am = torch.as_tensor(M, dtype=X.dtype, device=X.device)
    Rr = regress(X, Am, draws.regress_R0(k, X.shape[0]), regress_iters)
    err = float(rel_error(Dense(X), Am, Rr))
    return RankResult(k=k, s_min=s_min, s_mean=s_mean, rel_err=err,
                      member_errors=errs.double().cpu().numpy(),
                      A_median=M, R_regress=Rr.double().cpu().numpy())


def sweep(X: torch.Tensor, ks, *, members: int, iters: int,
          regress_iters: int, delta: float, draws, sil_threshold: float):
    """Every candidate rank and the selected k: (per-k results, k)."""
    per_k = {k: rank(X, k, members=members, iters=iters,
                     regress_iters=regress_iters, delta=delta, draws=draws)
             for k in ks}
    k_opt = select_threshold(list(ks), [per_k[k].s_min for k in ks],
                             [per_k[k].rel_err for k in ks], sil_threshold)
    return per_k, k_opt
