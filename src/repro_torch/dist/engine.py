"""The distributed RESCAL MU engine on a dense operand (port of
``repro/dist/engine.py:62-482``, dense half).

``repro`` builds these as ``shard_map`` bodies over its mesh.  Here each
grid cell is one process holding its local blocks (``dist/sharding.py``):
X^(i,j) (m, n/g, n/g), A^(i) (n/g, k) and the replicated R (m, k, k);
every collective goes through the cell's ``Grid``.  The member axis is
written out where ``repro`` used ``vmap``: A (r, n/g, k) and R (r, m, k,
k) update r ensemble members at once, with X^(i,j) either one per member
(r, m, n/g, n/g) — the perturbed copies — or shared by all of them; a
collective carries all members at once, so their count does not grow
with r.

schedule  — ``cfg.schedule``: "batched" (all m slices per collective,
            O(1) collectives per iteration) | "sliced" (the paper's
            per-slice Alg. 3 loop, O(m) collectives).
fused     — ``cfg.kernel.use_fused`` routes the two X-sided products of
            an iteration through ``kernels/fused_bilinear.py``
            (``ops.fused_xa_xtb``): one pass over X gives X^(i,j) A^(j)
            and X^(i,j)^T A^(i), and the engine uses (X^T A) R = X^T (A R)
            so the single-pass products feed the reference update;
            the A update of both schedules ends in
            ``kernels/mu_update_a.py`` (``core.rescal.a_ratio``).

Not ported yet: the BCSR iterations (``repro/dist/engine.py:201,254``;
they wait for ``ShardedBCSR``), ``make_gspmd_step`` (an XLA-only
comparison) and the historical four-factory names.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.analysis.sanitizer import sanitize_state
from repro_torch.core.rescal import (EPS_DEFAULT, RescalState, a_denominator,
                                     a_ratio, atxa, check_schedule,
                                     dense_products, fit_error, gram,
                                     init_factors, r_update, x_times, xart,
                                     xt_times)
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.obs.metrics import record_metrics, update_ratio

from .sharding import COL_AXIS, ROW_AXIS, Grid


@dataclasses.dataclass(frozen=True)
class DistRescalConfig:
    schedule: str = "batched"        # "batched" | "sliced"
    eps: float = EPS_DEFAULT
    comm_dtype: str | None = None    # e.g. "bfloat16" on the wire
    kernel: KernelPolicy = KernelPolicy()
    sanitize: bool = False           # runtime factor checks
    trace_metrics: bool = False      # per-iteration telemetry

    def __post_init__(self):
        check_schedule(self.schedule)


def _mu_iter_batched(grid: Grid, Xl, Ai, R, cfg: DistRescalConfig):
    """One MU iteration, all m slices per collective (paper Alg. 3 math,
    O(1) collectives)."""
    cd = cfg.comm_dtype
    eps = cfg.eps
    Aj = grid.diag_row_to_col(Ai, cd)
    G = grid.psum_cast(gram(Ai), ROW_AXIS, cd)                   # line 3

    if cfg.kernel.use_fused:
        # X^(i,j) A^(j) (row-indexed) and X^(i,j)^T A^(i) (col-indexed)
        XA_loc, XTA_loc = dense_products(Xl, Aj, Ai, cfg.kernel)
        XA = grid.psum_cast(XA_loc, COL_AXIS, cd)                 # line 5
    else:
        XA = grid.psum_cast(x_times(Xl, Aj), COL_AXIS, cd)
        XTA_loc = None

    # ---- R update (paper lines 6-9), batched over m ----
    ATXA = grid.psum_cast(atxa(Ai, XA), ROW_AXIS, cd)
    R = r_update(R, ATXA, G, eps)

    # ---- A update (paper lines 10-21), batched over m ----
    XART = xart(XA, R)                                           # line 10
    if XTA_loc is not None:
        # (X^T A) R == X^T (A R): the fused pass already produced X^T A,
        # so only a k-thin contraction with the fresh R remains — X is not
        # read again.  The psum after the contraction keeps the payload at
        # (nc, k).
        XTAR_j = grid.psum_cast(
            torch.einsum("...mja,...mab->...jb", XTA_loc, R), ROW_AXIS, cd)
    else:
        AR = Ai.unsqueeze(-3) @ R                                # line 11
        XTAR_j = grid.psum_cast(xt_times(Xl, AR).sum(-3), ROW_AXIS, cd)
    XTAR = grid.diag_col_to_row(XTAR_j, cd)                      # 12-13
    num = XART + XTAR                                            # line 14
    S = a_denominator(R, G)                                      # 15-19
    Ai_new = a_ratio(Ai, num, S, eps, cfg.kernel)                # line 21
    Ai_new, R = sanitize_state(Ai_new, R,
                               where="dist.engine._mu_iter_batched",
                               enabled=cfg.sanitize)
    if cfg.trace_metrics:
        record_metrics("dist.engine._mu_iter_batched",
                       a_norm=torch.linalg.vector_norm(Ai_new, dim=(-2, -1)),
                       r_norm=torch.linalg.vector_norm(R, dim=(-3, -2, -1)),
                       mu_ratio=update_ratio(Ai, Ai_new))
    return Ai_new, R


def _mu_iter_sliced(grid: Grid, Xl, Ai, R, cfg: DistRescalConfig):
    """One MU iteration with an explicit loop over the m slices — the
    paper's schedule with per-slice collectives (O(m) of them).  With the
    fused policy each slice is one kernel launch (m = 1)."""
    cd = cfg.comm_dtype
    eps = cfg.eps
    Aj = grid.diag_row_to_col(Ai, cd)
    G = grid.psum_cast(gram(Ai), ROW_AXIS, cd)                   # line 3
    AiT = Ai.transpose(-1, -2)
    R = R.clone()
    num = torch.zeros_like(Ai)
    S = torch.zeros_like(G)
    for t in range(Xl.shape[-3]):
        Xt = Xl[..., t:t + 1, :, :]                 # (..., 1, nr, nc)
        Rt = R[..., t, :, :]
        if cfg.kernel.use_fused:
            XA_loc, XTA_loc = dense_products(Xt, Aj, Ai, cfg.kernel)
        else:
            XA_loc, XTA_loc = x_times(Xt, Aj), None
        XA = grid.psum_cast(XA_loc[..., 0, :, :], COL_AXIS, cd)  # line 5
        ATXA = grid.psum_cast(AiT @ XA, ROW_AXIS, cd)            # line 6
        Rt = Rt * ATXA / (G @ Rt @ G + eps)                      # 7-9
        R[..., t, :, :] = Rt
        RtT = Rt.transpose(-1, -2)
        XART = XA @ RtT                                          # line 10
        if XTA_loc is not None:
            XTAR_j = grid.psum_cast(XTA_loc[..., 0, :, :] @ Rt, ROW_AXIS,
                                    cd)                          # line 12
        else:
            AR = (Ai @ Rt).unsqueeze(-3)                         # line 11
            XTAR_j = grid.psum_cast(xt_times(Xt, AR)[..., 0, :, :],
                                    ROW_AXIS, cd)                # line 12
        XTAR = grid.diag_col_to_row(XTAR_j, cd)                  # line 13
        num = num + XART + XTAR                                  # line 14
        S = S + Rt @ G @ RtT + RtT @ G @ Rt                      # 15-20
    Ai_new = a_ratio(Ai, num, S, eps, cfg.kernel)                # line 21
    Ai_new, R = sanitize_state(Ai_new, R,
                               where="dist.engine._mu_iter_sliced",
                               enabled=cfg.sanitize)
    if cfg.trace_metrics:
        record_metrics("dist.engine._mu_iter_sliced",
                       a_norm=torch.linalg.vector_norm(Ai_new, dim=(-2, -1)),
                       r_norm=torch.linalg.vector_norm(R, dim=(-3, -2, -1)),
                       mu_ratio=update_ratio(Ai, Ai_new))
    return Ai_new, R


_ITERS = {
    "batched": _mu_iter_batched,
    "sliced": _mu_iter_sliced,
}


def get_mu_iter(schedule: str) -> Callable:
    """Local MU-iteration body on a dense block ``(grid, Xl, Ai, R, cfg)
    -> (Ai, R)``, the composition point the selection ensemble builds
    on."""
    check_schedule(schedule)
    return _ITERS[schedule]


def local_normalize(grid: Grid, Ai, R, comm_dtype: str | None = None,
                    eps: float = 1e-12):
    """Distributed factor normalization (||A_col|| = 1, the scale folded
    into R): the column norms need one psum over the row blocks."""
    c2 = grid.psum_cast((Ai * Ai).sum(dim=-2), ROW_AXIS, comm_dtype)
    c = torch.sqrt(c2).clamp_min(eps)                           # (..., k)
    cc = c.unsqueeze(-1) * c.unsqueeze(-2)
    return Ai / c.unsqueeze(-2), R * cc.unsqueeze(-3)


def make_mu_step(grid: Grid, cfg: DistRescalConfig, *,
                 iters: int = 1) -> Callable:
    """``step(Xl, Ai, R) -> (Ai, R)``: ``iters`` MU iterations on this
    cell's blocks.  Members ride a leading axis of Ai (r, nr, k) and R
    (r, m, k, k) — on a grid with pods, this pod's members
    (``grid.pod_members``) with X replicated across pods, as ``repro``'s
    ``pod_axis`` step does; Xl is then (m, nr, nc), shared, or
    (r, m, nr, nc), one block per member."""
    it = get_mu_iter(cfg.schedule)

    def step(Xl, Ai, R):
        for _ in range(iters):
            Ai, R = it(grid, Xl, Ai, R, cfg)
        return Ai, R

    return step


def _atxa_gram(grid: Grid, Xl, Ai, cd: str | None):
    """The all-reduced A^T X_t A of every slice and G = A^T A: what the
    error identity and the R regression need from X."""
    Aj = grid.diag_row_to_col(Ai, cd)
    G = grid.psum_cast(gram(Ai), ROW_AXIS, cd)
    XA = grid.psum_cast(x_times(Xl, Aj), COL_AXIS, cd)
    return grid.psum_cast(atxa(Ai, XA), ROW_AXIS, cd), G


def local_rel_error(grid: Grid, Xl, Ai, R, cd: str | None = None):
    """Distributed relative error ||X - A R A^T|| / ||X|| on a dense X
    block, from k-sized collectives only (the identity of
    ``core.rescal.fit_error``).  Members of Ai/R share Xl; returns one
    error per member, equal on every cell."""
    ATXA, G = _atxa_gram(grid, Xl, Ai, cd)
    x2 = grid.psum(grid.psum((Xl * Xl).sum(), ROW_AXIS), COL_AXIS)
    return fit_error(x2, ATXA, Ai, R, G=G)


def make_dist_error(grid: Grid) -> Callable:
    """``err(Xl, Ai, R)``: the distributed relative error on ``grid``."""
    return lambda Xl, Ai, R: local_rel_error(grid, Xl, Ai, R)


def local_regress_R(grid: Grid, Xl, Ai, R0, *, iters: int = 100):
    """R regression with A fixed (``core/regression.py``) on the grid: the
    A^T X_t A of every slice from the engine's collectives, then MU on R
    alone (replicated, no further communication)."""
    ATXA, G = _atxa_gram(grid, Xl, Ai, None)
    R = R0
    for _ in range(iters):
        R = r_update(R, ATXA, G, EPS_DEFAULT)
    return R


def dist_rescal(Xl: torch.Tensor, k: int, grid: Grid, *,
                init: RescalState | None = None,
                generator: torch.Generator | None = None, iters: int = 200,
                cfg: DistRescalConfig | None = None):
    """Distributed factorization of the global X whose block X^(i,j) this
    cell holds (``Xl`` (m, n/g, n/g)).  The initial A (n, k) and R are
    global — ``init``, or uniform draws from ``generator``, which must
    give every cell the same numbers — and A is sliced to row block i.
    Returns (RescalState with this cell's A^(i) and the replicated R,
    rel_error)."""
    cfg = cfg or DistRescalConfig()
    m, nr, nc = Xl.shape
    if nr != nc:
        raise ValueError(f"X^(i,j) must be square, got {tuple(Xl.shape)}")
    n = nr * grid.rows
    if init is None:
        init = init_factors(n, m, k, generator=generator, device=Xl.device,
                            dtype=Xl.dtype)
    Ai, R = grid.row_block(init.A), init.R
    Ai, R = make_mu_step(grid, cfg, iters=iters)(Xl, Ai, R)
    err = make_dist_error(grid)(Xl, Ai, R)
    return RescalState(A=Ai, R=R, step=iters), err
