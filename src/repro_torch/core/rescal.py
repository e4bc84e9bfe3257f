"""Non-negative RESCAL multiplicative updates (port of
``repro/core/rescal.py``: the batched and the sliced schedule, and the
masked k_max-padded primitives of the cross-k grid).

The model: X_t ~= A @ R_t @ A.T for t = 1..m, with A in R+^{n x k} and
R in R+^{m x k x k}; the relation axis leads (X: (m, n, n), R: (m, k, k)).
Every function here also takes a leading member axis written out where
``repro`` used ``vmap``: A (r, n, k) and R (r, m, k, k) update all r
ensemble members at once (the ``...`` in the einsums).

``policy`` (a ``kernels.KernelPolicy``) is where the kernels come in.
Without ``use_fused`` the steps keep ``repro``'s algebra.  With it, the
A update of every step ends in ``kernels.ops.mu_update_a`` (``a_ratio``),
and a dense step takes X_t A and X_t^T A from one pass of
``kernels.ops.fused_xa_xtb`` over X (``dense_products``; the call the
1 x 1 grid engine makes), using (X^T A) R = X^T (A R) where ``repro``
reads X a third time.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.analysis.sanitizer import sanitize_state
from repro_torch.obs.metrics import record_metrics, update_ratio

EPS_DEFAULT = 1e-16


class RescalState(NamedTuple):
    """Factor state for one RESCAL factorization (or r of them)."""

    A: torch.Tensor  # (..., n, k)  non-negative
    R: torch.Tensor  # (..., m, k, k) non-negative
    step: int


def init_factors(n: int, m: int, k: int, *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None,
                 A: torch.Tensor | None = None,
                 R: torch.Tensor | None = None,
                 dtype: torch.dtype = torch.float32) -> RescalState:
    """Random non-negative init, uniform in [0.05, 1): A first, then R,
    from ``generator`` (on ``device``).  Given arrays ``A`` (n, k) and
    ``R`` (m, k, k) are used as they are instead — the parity tests hand
    in ``repro``'s own draws this way."""
    if (A is None) != (R is None):
        raise ValueError("pass both A and R, or neither")
    if A is None:
        dev = generator.device if generator is not None else device
        A = torch.empty((n, k), dtype=dtype, device=dev)
        R = torch.empty((m, k, k), dtype=dtype, device=dev)
        A.uniform_(0.05, 1.0, generator=generator)
        R.uniform_(0.05, 1.0, generator=generator)
    if tuple(A.shape[-2:]) != (n, k) or tuple(R.shape[-3:]) != (m, k, k):
        raise ValueError(f"init shapes {tuple(A.shape)}, {tuple(R.shape)} "
                         f"do not match n={n} m={m} k={k}")
    return RescalState(A=A, R=R, step=0)


def gram(A: torch.Tensor) -> torch.Tensor:
    """G = A.T @ A, the (k, k) Gram matrix (per member)."""
    return A.transpose(-1, -2) @ A


def _r_denominator(G: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """G R_t G for all t: (..., k, k) x (..., m, k, k) -> (..., m, k, k)."""
    return G.unsqueeze(-3) @ R @ G.unsqueeze(-3)


def r_update(R: torch.Tensor, ATXA: torch.Tensor, G: torch.Tensor,
             eps: float) -> torch.Tensor:
    """R_t <- R_t * (A^T X_t A) / (G R_t G + eps)."""
    return R * ATXA / (_r_denominator(G, R) + eps)


def a_denominator(R: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """S = sum_t R_t G R_t^T + R_t^T G R_t, (..., k, k); A @ S is the A
    update's denominator."""
    Gt = G.unsqueeze(-3)
    Rt = R.transpose(-1, -2)
    return (R @ Gt @ Rt).sum(-3) + (Rt @ Gt @ R).sum(-3)


def xart(XA: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """sum_t (X_t A) R_t^T: (..., m, n, k), (..., m, k, k) -> (..., n, k)."""
    return torch.einsum("...mia,...msa->...is", XA, R)


def is_fused(policy) -> bool:
    return policy is not None and policy.use_fused


def a_ratio(A: torch.Tensor, num: torch.Tensor, S: torch.Tensor,
            eps: float, policy=None) -> torch.Tensor:
    """A * num / (A @ S + eps), the last line of every A update (paper
    Alg. 3 line 22).  Under a fused ``policy`` it runs as
    ``kernels.ops.mu_update_a`` (one pass, A @ S never in memory)."""
    if is_fused(policy):
        from repro_torch.kernels import ops
        return ops.mu_update_a(A, num, S, eps, impl=policy.impl)
    return A * num / (A @ S + eps)


def a_update(A: torch.Tensor, XA: torch.Tensor, XTA: torch.Tensor,
             R: torch.Tensor, G: torch.Tensor, eps: float,
             policy=None) -> torch.Tensor:
    """A <- A * NumA / (A @ S + eps) with

      NumA = sum_t X_t A R_t^T + X_t^T A R_t
      S    = sum_t R_t G R_t^T + R_t^T G R_t
    """
    num = xart(XA, R) + torch.einsum("...mia,...mas->...is", XTA, R)
    return a_ratio(A, num, a_denominator(R, G), eps, policy)


def x_times(X: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X_t @ B for every slice: X (..., m, n1, n2), B (..., n2, k) ->
    (..., m, n1, k).  A shared X (m, n1, n2) with member-stacked B
    (r, n2, k) is one product with the members folded into the columns,
    so X is neither broadcast nor copied r times."""
    if X.dim() == 3 and B.dim() == 3:
        r, n2, k = B.shape
        out = X @ B.permute(1, 0, 2).reshape(n2, r * k)
        return out.unflatten(-1, (r, k)).permute(2, 0, 1, 3)
    return X @ B.unsqueeze(-3)


def xt_times(X: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X_t^T @ B_t for every slice: X (..., m, n1, n2), B (..., m, n1, k)
    -> (..., m, n2, k), folding members into the columns as ``x_times``
    does for a shared X."""
    if X.dim() == 3 and B.dim() == 4:
        r, m, n1, k = B.shape
        out = X.transpose(-1, -2) @ B.permute(1, 2, 0, 3).reshape(
            m, n1, r * k)
        return out.unflatten(-1, (r, k)).permute(2, 0, 1, 3)
    return X.transpose(-1, -2) @ B


def atxa(A: torch.Tensor, XA: torch.Tensor) -> torch.Tensor:
    """A^T (X_t A) for all t: (..., n, k), (..., m, n, k) -> (..., m, k, k)."""
    return A.transpose(-1, -2).unsqueeze(-3) @ XA


def update_R(X: torch.Tensor, A: torch.Tensor, R: torch.Tensor,
             G: torch.Tensor, eps: float = EPS_DEFAULT) -> torch.Tensor:
    """R update on a dense X (..., m, n, n)."""
    return r_update(R, atxa(A, x_times(X, A)), G, eps)


def update_A(X: torch.Tensor, A: torch.Tensor, R: torch.Tensor,
             G: torch.Tensor, eps: float = EPS_DEFAULT,
             policy=None) -> torch.Tensor:
    """A update on a dense X (..., m, n, n)."""
    XA = x_times(X, A)
    XTA = x_times(X.transpose(-1, -2), A)
    return a_update(A, XA, XTA, R, G, eps, policy)


def dense_products(X: torch.Tensor, B1: torch.Tensor, B2: torch.Tensor,
                   policy):
    """(X_t B1, X_t^T B2) for every slice from one pass over X:
    ``kernels.ops.fused_xa_xtb`` with B2 broadcast over the m slices
    (stride 0, no copy).  X ([r,] m, n1, n2), B1 ([r,] n2, k), B2 ([r,]
    n1, k); a single-device step passes B1 = B2 = A."""
    from repro_torch.kernels import ops
    m = X.shape[-3]
    B2 = B2.unsqueeze(-3).expand(B2.shape[:-2] + (m,) + B2.shape[-2:])
    return ops.fused_xa_xtb(X, B1, B2, impl=policy.impl)


def mu_step_batched(X: torch.Tensor, state: RescalState,
                    eps: float = EPS_DEFAULT, sanitize: bool = False,
                    trace_metrics: bool = False, *,
                    policy=None) -> RescalState:
    """One MU iteration on a dense X, all m slices in one product.  A
    fused ``policy`` reads X once (``dense_products``) and ends in
    ``mu_update_a``."""
    A, R = state.A, state.R
    G = gram(A)
    if is_fused(policy):
        XA, XTA = dense_products(X, A, A, policy)
        R = r_update(R, atxa(A, XA), G, eps)
        A = a_update(A, XA, XTA, R, G, eps, policy)
    else:
        R = update_R(X, A, R, G, eps)
        A = update_A(X, A, R, G, eps, policy)
    A, R = sanitize_state(A, R, where="core.rescal.mu_step_batched",
                          enabled=sanitize)
    if trace_metrics:
        record_metrics("core.rescal.mu_step_batched", step=state.step,
                       rel_error=rel_error(X, A, R),
                       a_norm=torch.linalg.vector_norm(A, dim=(-2, -1)),
                       r_norm=torch.linalg.vector_norm(R, dim=(-3, -2, -1)),
                       mu_ratio=update_ratio(state.A, A))
    return RescalState(A=A, R=R, step=state.step + 1)


def mu_step_sliced(X: torch.Tensor, state: RescalState,
                   eps: float = EPS_DEFAULT, sanitize: bool = False,
                   trace_metrics: bool = False, *,
                   policy=None) -> RescalState:
    """One MU iteration with an explicit loop over the m relation slices
    (paper Alg. 3 lines 4-21): R_t is updated, then its contribution to
    NumA and S is accumulated, slice by slice.  A fused ``policy`` takes
    each slice's X_t A and X_t^T A from one ``fused_xa_xtb`` launch
    (m = 1) and ends in ``mu_update_a``."""
    A, R = state.A, state.R
    G = gram(A)
    R = R.clone()
    num = torch.zeros_like(A)
    S = torch.zeros_like(G)
    At = A.transpose(-1, -2)
    for t in range(X.shape[-3]):
        Rt = R[..., t, :, :]
        if is_fused(policy):
            XA, XTA = dense_products(X[..., t:t + 1, :, :], A, A, policy)
            XA, XTA = XA[..., 0, :, :], XTA[..., 0, :, :]
        else:
            Xt = X[..., t, :, :]
            XA = Xt @ A                                   # (..., n, k)
        Rt = Rt * (At @ XA) / (G @ Rt @ G + eps)          # line 9
        R[..., t, :, :] = Rt
        RtT = Rt.transpose(-1, -2)
        if is_fused(policy):                              # 10-14
            num = num + XA @ RtT + XTA @ Rt
        else:
            num = num + XA @ RtT + Xt.transpose(-1, -2) @ (A @ Rt)
        S = S + Rt @ G @ RtT + RtT @ G @ Rt               # lines 15-20
    A = a_ratio(A, num, S, eps, policy)                   # line 22
    A, R = sanitize_state(A, R, where="core.rescal.mu_step_sliced",
                          enabled=sanitize)
    if trace_metrics:
        record_metrics("core.rescal.mu_step_sliced", step=state.step,
                       rel_error=rel_error(X, A, R),
                       a_norm=torch.linalg.vector_norm(A, dim=(-2, -1)),
                       r_norm=torch.linalg.vector_norm(R, dim=(-3, -2, -1)),
                       mu_ratio=update_ratio(state.A, A))
    return RescalState(A=A, R=R, step=state.step + 1)


MU_SCHEDULES = {
    "batched": mu_step_batched,
    "sliced": mu_step_sliced,
}


def check_schedule(schedule: str) -> None:
    """Raise unless ``schedule`` names one of ``MU_SCHEDULES``, the one
    list of schedules the engine and the sweep config accept."""
    if schedule not in MU_SCHEDULES:
        raise ValueError(f"schedule must be one of {tuple(MU_SCHEDULES)}, "
                         f"got {schedule!r}")


# ---------------------------------------------------------------------------
# Masked (k_max-padded) factors: the cross-k grid's primitives
# ---------------------------------------------------------------------------
#
# Padding every cell's factors to a common k_max lets the whole (k, q)
# grid run as one batch.  With A's masked columns and R's masked rows and
# columns exactly zero, every MU quantity they touch is exactly zero and
# the updates are multiplicative, so zeros are a fixed point; the mask
# multiply after each step makes that structural.  The active block sees
# only extra exact-zero terms, so it equals the unpadded run up to the
# order of its sums.

def column_mask(k, k_max: int, *, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """(..., k_max) mask, 1 for the first k (active) columns and 0 for
    the padding.  ``k`` is an int, or a sequence of ranks (one per cell)
    for a (cells, k_max) mask."""
    ks = torch.as_tensor(k, device=device)
    cols = torch.arange(k_max, device=device)
    return (cols < ks.unsqueeze(-1)).to(dtype)


def mask_state(state: RescalState, mask: torch.Tensor) -> RescalState:
    """Force A's masked columns and R's masked rows and columns to exact
    zero.  ``mask`` is (k_max,), or (cells, k_max) for member-stacked
    factors."""
    mask2 = mask.unsqueeze(-1) * mask.unsqueeze(-2)
    return RescalState(A=state.A * mask.unsqueeze(-2),
                       R=state.R * mask2.unsqueeze(-3), step=state.step)


def pad_state(state: RescalState, k_max: int) -> RescalState:
    """Zero-pad ([r,] n, k) / ([r,] m, k, k) factors to rank k_max; the
    padded state is already mask-invariant."""
    k = state.A.shape[-1]
    if k > k_max:
        raise ValueError(f"cannot pad rank {k} down to k_max={k_max}")
    if k == k_max:
        return state
    pad = k_max - k
    return RescalState(A=torch.nn.functional.pad(state.A, (0, pad)),
                       R=torch.nn.functional.pad(state.R, (0, pad, 0, pad)),
                       step=state.step)


def crop_state(state: RescalState, k: int) -> RescalState:
    """Drop the padding columns again: the inverse of ``pad_state``."""
    return RescalState(A=state.A[..., :k], R=state.R[..., :k, :k],
                       step=state.step)


def masked_mu_step(X: torch.Tensor, state: RescalState, mask: torch.Tensor,
                   eps: float = EPS_DEFAULT, schedule: str = "batched",
                   sanitize: bool = False, trace_metrics: bool = False, *,
                   policy=None) -> RescalState:
    """One MU iteration of ``schedule`` on k_max-padded factors, then the
    mask multiply that pins the padding to exact zero (multiplying the
    active columns by 1.0 is exact)."""
    st = mask_state(MU_SCHEDULES[schedule](X, state, eps, policy=policy),
                    mask)
    A, R = sanitize_state(st.A, st.R, mask=mask,
                          where="core.rescal.masked_mu_step",
                          enabled=sanitize)
    if trace_metrics:       # recorded after the mask
        record_metrics("core.rescal.masked_mu_step", step=state.step,
                       rel_error=rel_error(X, A, R),
                       a_norm=torch.linalg.vector_norm(A, dim=(-2, -1)),
                       r_norm=torch.linalg.vector_norm(R, dim=(-3, -2, -1)),
                       mu_ratio=update_ratio(state.A * mask.unsqueeze(-2),
                                             A))
    return RescalState(A=A, R=R, step=st.step)


def masked_normalize(state: RescalState, mask: torch.Tensor,
                     eps: float = 1e-12) -> RescalState:
    """``normalize`` on padded factors: masked columns have zero norm, the
    eps clamp keeps the division finite and the mask restores exact
    zeros."""
    return mask_state(normalize(state, eps), mask)


def normalize(state: RescalState, eps: float = 1e-12) -> RescalState:
    """||A_col|| = 1 with the inverse scaling folded into R (paper §2.2)."""
    c = torch.linalg.vector_norm(state.A, dim=-2).clamp_min(eps)  # (..., k)
    A = state.A / c.unsqueeze(-2)
    cc = c.unsqueeze(-1) * c.unsqueeze(-2)                          # (..., k, k)
    R = state.R * cc.unsqueeze(-3)
    return RescalState(A=A, R=R, step=state.step)


def fit_error(x2: torch.Tensor, ATXA: torch.Tensor, A: torch.Tensor,
              R: torch.Tensor, G: torch.Tensor | None = None
              ) -> torch.Tensor:
    """||X - A R A^T||_F / ||X||_F from ||X||^2 and A^T X_t A:

      ||X - A R A^T||^2 = ||X||^2 - 2 sum_t <A^T X_t A, R_t>
                          + sum_t <G, R_t G R_t^T>

    The identity cancels for a good fit, so it needs true fp32 products
    (TF32 off, device.strict_fp32).  ``G`` is A^T A, formed from ``A``
    when not given (the distributed error passes the all-reduced one)."""
    if G is None:
        G = gram(A)
    cross = (ATXA * R).sum(dim=(-3, -2, -1))
    Gt = G.unsqueeze(-3)
    fit2 = (Gt * (R @ Gt @ R.transpose(-1, -2))).sum(dim=(-3, -2, -1))
    err2 = (x2 - 2.0 * cross + fit2).clamp_min(0.0)
    return torch.sqrt(err2) / torch.sqrt(x2)


def rel_error(X: torch.Tensor, A: torch.Tensor,
              R: torch.Tensor) -> torch.Tensor:
    """Relative Frobenius error of a dense X, without the n x n
    reconstruction."""
    return fit_error((X * X).sum(), atxa(A, x_times(X, A)), A, R)


def reconstruct(A: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Dense reconstruction A R_t A^T, (m, n, n).  For tests and small
    data."""
    return torch.einsum("ia,mab,jb->mij", A, R, A)


def rescal(X: torch.Tensor, k: int, *,
           generator: torch.Generator | None = None, iters: int = 200,
           schedule: str = "batched", eps: float = EPS_DEFAULT,
           init: RescalState | None = None,
           normalize_result: bool = True, sanitize: bool = False,
           trace_metrics: bool = False,
           policy=None) -> tuple[RescalState, torch.Tensor]:
    """Factorize a dense X (m, n, n) at rank k on X's device with the
    ``schedule`` of ``MU_SCHEDULES`` (and the kernels of a fused
    ``policy``).  Returns (state, rel_error)."""
    check_schedule(schedule)
    step = MU_SCHEDULES[schedule]
    m, n, _ = X.shape
    if init is None:
        init = init_factors(n, m, k, generator=generator, device=X.device,
                            dtype=X.dtype)
    state = init
    for _ in range(iters):
        state = step(X, state, eps, sanitize, trace_metrics,
                     policy=policy)
    if normalize_result:
        state = normalize(state)
    return state, rel_error(X, state.A, state.R)
