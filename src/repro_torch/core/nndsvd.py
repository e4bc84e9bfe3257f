"""NNDSVD initialization of A for RESCAL (paper §3.4, §6.1.3; port of
``repro/core/nndsvd.py``).

The concatenated mode-1/mode-2 unfoldings of X (m, n, n) have the row
space of the symmetric (n, n) surrogate C = sum_t (X_t + X_t^T), so the
NNDSVD (Boutsidis & Gallopoulos) runs on C's leading eigenpairs: the same
left singular vectors at a fraction of the cost.  ``nndsvd_init_A`` takes
the exact ``torch.linalg.eigh``; ``randomized_eigh`` is the subspace
iteration for large n, whose only primitives are tall-skinny products.
Its start comes from a ``torch.Generator`` (``repro`` passes a key).
"""
from __future__ import annotations

import torch


def nndsvd_from_pairs(eigvals: torch.Tensor, eigvecs: torch.Tensor, k: int,
                      eps: float = 1e-9) -> torch.Tensor:
    """The NNDSVD columns from (value, vector) pairs: for each pair the
    dominant of the vector's positive and negative parts, scaled by
    sqrt(|value| * |part|); zero entries are lifted to the mean (NNDSVDa),
    since zeros stall multiplicative updates."""
    cols = []
    for j in range(k):
        v = eigvecs[:, j]
        s = eigvals[j].abs()
        vp, vn = v.clamp_min(0.0), (-v).clamp_min(0.0)
        npos = torch.linalg.vector_norm(vp)
        nneg = torch.linalg.vector_norm(vn)
        use_pos = npos >= nneg
        vec = torch.where(use_pos, vp / (npos + eps), vn / (nneg + eps))
        norm = torch.where(use_pos, npos, nneg)
        cols.append(torch.sqrt(s * norm + eps) * vec)
    A0 = torch.stack(cols, dim=1)
    return torch.where(A0 > 0, A0, A0.mean() + eps)


def symmetric_surrogate(X: torch.Tensor) -> torch.Tensor:
    """C = (1/2m) sum_t (X_t + X_t^T) for X (m, n, n): A's column
    space."""
    total = X.sum(dim=0)
    return (total + total.T) / (2.0 * X.shape[0])


def _leading(w: torch.Tensor, V: torch.Tensor, k: int):
    """The k pairs of largest |value|, in that order (a stable sort, as
    ``jnp.argsort``)."""
    order = torch.argsort(-w.abs(), stable=True)[:k]
    return w[order], V[:, order]


def nndsvd_init_A(X: torch.Tensor, k: int) -> torch.Tensor:
    """Exact-eigh NNDSVD init of A (n, k) for X (m, n, n)."""
    w, V = torch.linalg.eigh(symmetric_surrogate(X))
    return nndsvd_from_pairs(*_leading(w, V, k), k)


def randomized_eigh(C_matvec, n: int, k: int, generator: torch.Generator,
                    iters: int = 8, oversample: int = 8,
                    dtype: torch.dtype = torch.float32):
    """The k leading eigenpairs of a symmetric operator given only
    products ``C_matvec(Y)``: subspace iteration on (n, k + oversample)
    blocks, then the small projected eigenproblem."""
    Y = torch.randn((n, k + oversample), generator=generator, dtype=dtype,
                    device=generator.device)
    for _ in range(iters):
        Y, _ = torch.linalg.qr(C_matvec(Y))
    B = Y.T @ C_matvec(Y)
    w, U = torch.linalg.eigh((B + B.T) / 2)
    w, U = _leading(w, U, k)
    return w, Y @ U


def nndsvd_init_A_randomized(X: torch.Tensor, k: int,
                             generator: torch.Generator,
                             iters: int = 8) -> torch.Tensor:
    """NNDSVD init of A from ``randomized_eigh`` of the surrogate."""
    C = symmetric_surrogate(X)
    w, V = randomized_eigh(lambda Y: C @ Y, C.shape[0], k, generator, iters,
                           dtype=X.dtype)
    return nndsvd_from_pairs(w, V, k)
