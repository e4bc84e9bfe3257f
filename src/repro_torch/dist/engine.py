"""The distributed RESCAL MU engine (port of ``repro/dist/engine.py:62-482``):
one set of iteration bodies for a dense block and a BCSR shard.

``repro`` builds these as ``shard_map`` bodies over its mesh.  Here each
grid cell is one process holding its local operand (``dist/sharding.py``):
a dense block X^(i,j) (m, n/g, n/g), or the shard-local ``BCSR`` of a
``ShardedBCSR`` (n = n_loc, front-padded with zero blocks), with A^(i)
(n/g, k) and the replicated R (m, k, k); every collective goes through
the cell's ``Grid``.  The member axis is written out where ``repro`` used
``vmap``: A (r, n/g, k) and R (r, m, k, k) update r ensemble members at
once, with the local operand either one per member — the perturbed
copies, (r, m, n/g, n/g) or stored blocks (r, m, z_max, bs, bs) — or
shared by all of them; a collective carries all members at once, so
their count does not grow with r.  The collective schedule is the same
for both operands (paper §4.1).

operand   — a dense tensor or a ``core.sparse.BCSR``, told apart by type
            (``get_mu_iter(operand, schedule)`` names the bodies).
schedule  — ``cfg.schedule``: "batched" (all m slices per collective,
            O(1) collectives per iteration) | "sliced" (the paper's
            per-slice Alg. 3 loop, O(m) collectives).
fused     — ``cfg.kernel.use_fused`` routes the two X-sided products of
            an iteration through one pass over the operand: a dense block
            through ``kernels/fused_bilinear.py`` (``ops.fused_xa_xtb``),
            a BCSR shard through ``kernels/bcsr_fused.py``
            (``core.sparse.sparse_products``, ``ops.bcsr_xa_xta``), each
            giving X^(i,j) A^(j) and X^(i,j)^T A^(i); the engine uses
            (X^T A) R = X^T (A R), so the single-pass products feed the
            reference update.  The A update of every body ends in
            ``kernels/mu_update_a.py`` (``core.rescal.a_ratio``), and the
            BCSR error and regression take X A from ``bcsr_spmm``.  The
            plain BCSR body takes X^T A from ``spmm_t`` and the same
            contraction (``repro`` contracts X^T with A R instead), as
            ``core.sparse.sparse_mu_step`` does on one device.

Traced (``obs.trace``): each iteration is a ``mu/iter`` span whose
closing record counts the grid's ``collectives`` and the BCSR kernel's
operand ``tilings`` (``bcsr_fused.tiling_count``) made inside it (counted
only while tracing).  Its children
split it so that every launch falls under exactly one: ``mu/gram`` (A^(j),
G and its psum; in the sliced bodies also the transpose, the copy of R
and the zero accumulators), ``mu/products`` (the X-sided products, with
the BCSR wrapper's operand tilings: in the batched body inside its one
call, in the sliced BCSR body one ``mu/products`` before the slices that
tiles A^(j) and A^(i) once for all of them), ``mu/r_update`` (paper
lines 5-9: the XA psum, A^T XA and its psum, the R update) and
``mu/a_update`` (lines 10-21).  In the sliced bodies each slice is a
``mu/slice`` span (arg ``t``) around its own products, R update and A
update terms, and the closing ``a_ratio`` is one more ``mu/a_update``
under ``mu/iter``.  Every collective is a ``grid/<kind>`` span inside
one of these (``dist/sharding.py``).

Not ported: ``make_gspmd_step`` (XLA's own schedule under sharding
constraints, a comparison with no torch counterpart) and the historical
four-factory names.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.analysis.sanitizer import sanitize_state
from repro_torch.core.rescal import (EPS_DEFAULT, RescalState, a_denominator,
                                     a_ratio, atxa, check_schedule,
                                     dense_products, fit_error, gram,
                                     init_factors, r_update, x_times, xart,
                                     xt_times)
from repro_torch.core.sparse import (BCSR, prepare_products, single_product,
                                     sparse_products, sqnorm)
from repro_torch.kernels import bcsr_fused
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.obs import trace as obs
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


def _iteration(body: Callable) -> Callable:
    """``body`` inside a ``mu/iter`` span whose closing record carries the
    ``collectives`` and operand ``tilings`` made inside it; untraced, the
    body alone."""

    @functools.wraps(body)
    def it(grid: Grid, Xl, Ai, R, cfg: DistRescalConfig):
        if obs.current() is None:
            return body(grid, Xl, Ai, R, cfg)
        c0, t0 = grid.collectives, bcsr_fused.tiling_count()
        with obs.span("mu/iter") as closing:
            out = body(grid, Xl, Ai, R, cfg)
            closing["collectives"] = grid.collectives - c0
            closing["tilings"] = bcsr_fused.tiling_count() - t0
        return out

    return it


@_iteration
def _mu_iter_batched(grid: Grid, Xl, Ai, R, cfg: DistRescalConfig):
    """One MU iteration, all m slices per collective (paper Alg. 3 math,
    O(1) collectives)."""
    cd = cfg.comm_dtype
    eps = cfg.eps
    with obs.span("mu/gram"):
        Aj = grid.diag_row_to_col(Ai, cd)
        G = grid.psum_cast(gram(Ai), ROW_AXIS, cd)               # line 3

    with obs.span("mu/products"):
        if cfg.kernel.use_fused:
            # X^(i,j) A^(j) (row-indexed) and X^(i,j)^T A^(i)
            # (col-indexed)
            XA_loc, XTA_loc = dense_products(Xl, Aj, Ai, cfg.kernel)
        else:
            XA_loc, XTA_loc = x_times(Xl, Aj), None

    # ---- R update (paper lines 5-9), batched over m ----
    with obs.span("mu/r_update"):
        XA = grid.psum_cast(XA_loc, COL_AXIS, cd)                # line 5
        ATXA = grid.psum_cast(atxa(Ai, XA), ROW_AXIS, cd)
        R = r_update(R, ATXA, G, eps)

    # ---- A update (paper lines 10-21), batched over m ----
    with obs.span("mu/a_update"):
        XART = xart(XA, R)                                       # line 10
        if XTA_loc is not None:
            # (X^T A) R == X^T (A R): the fused pass already produced
            # X^T A, so only a k-thin contraction with the fresh R
            # remains — X is not read again.  The psum after the
            # contraction keeps the payload at (nc, k).
            XTAR_j = grid.psum_cast(
                torch.einsum("...mja,...mab->...jb", XTA_loc, R),
                ROW_AXIS, cd)
        else:
            AR = Ai.unsqueeze(-3) @ R                            # line 11
            XTAR_j = grid.psum_cast(xt_times(Xl, AR).sum(-3), ROW_AXIS,
                                    cd)
        XTAR = grid.diag_col_to_row(XTAR_j, cd)                  # 12-13
        num = XART + XTAR                                        # line 14
        S = a_denominator(R, G)                                  # 15-19
        Ai_new = a_ratio(Ai, num, S, eps, cfg.kernel)            # line 21
        Ai_new, R = sanitize_state(Ai_new, R,
                                   where="dist.engine._mu_iter_batched",
                                   enabled=cfg.sanitize)
        if cfg.trace_metrics:
            record_metrics(
                "dist.engine._mu_iter_batched",
                a_norm=torch.linalg.vector_norm(Ai_new, dim=(-2, -1)),
                r_norm=torch.linalg.vector_norm(R, dim=(-3, -2, -1)),
                mu_ratio=update_ratio(Ai, Ai_new))
    return Ai_new, R


@_iteration
def _mu_iter_sliced(grid: Grid, Xl, Ai, R, cfg: DistRescalConfig):
    """One MU iteration with an explicit loop over the m slices — the
    paper's schedule with per-slice collectives (O(m) of them).  With the
    fused policy each slice is one kernel launch (m = 1)."""
    cd = cfg.comm_dtype
    eps = cfg.eps
    with obs.span("mu/gram"):
        Aj = grid.diag_row_to_col(Ai, cd)
        G = grid.psum_cast(gram(Ai), ROW_AXIS, cd)               # line 3
        AiT = Ai.transpose(-1, -2)
        R = R.clone()
        num = torch.zeros_like(Ai)
        S = torch.zeros_like(G)
    for t in range(Xl.shape[-3]):
        with obs.span("mu/slice", t=t):
            with obs.span("mu/products"):
                Xt = Xl[..., t:t + 1, :, :]             # (..., 1, nr, nc)
                if cfg.kernel.use_fused:
                    XA_loc, XTA_loc = dense_products(Xt, Aj, Ai, cfg.kernel)
                else:
                    XA_loc, XTA_loc = x_times(Xt, Aj), None
            with obs.span("mu/r_update"):
                XA = grid.psum_cast(XA_loc[..., 0, :, :], COL_AXIS,
                                    cd)                          # line 5
                ATXA = grid.psum_cast(AiT @ XA, ROW_AXIS, cd)    # line 6
                Rt = R[..., t, :, :]
                Rt = Rt * ATXA / (G @ Rt @ G + eps)              # 7-9
                R[..., t, :, :] = Rt
            with obs.span("mu/a_update"):
                RtT = Rt.transpose(-1, -2)
                XART = XA @ RtT                                  # line 10
                if XTA_loc is not None:
                    XTAR_j = grid.psum_cast(XTA_loc[..., 0, :, :] @ Rt,
                                            ROW_AXIS, cd)        # line 12
                else:
                    AR = (Ai @ Rt).unsqueeze(-3)                 # line 11
                    XTAR_j = grid.psum_cast(xt_times(Xt, AR)[..., 0, :, :],
                                            ROW_AXIS, cd)        # line 12
                XTAR = grid.diag_col_to_row(XTAR_j, cd)          # line 13
                num = num + XART + XTAR                          # line 14
                S = S + Rt @ G @ RtT + RtT @ G @ Rt              # 15-20
    with obs.span("mu/a_update"):
        Ai_new = a_ratio(Ai, num, S, eps, cfg.kernel)            # line 21
        Ai_new, R = sanitize_state(Ai_new, R,
                                   where="dist.engine._mu_iter_sliced",
                                   enabled=cfg.sanitize)
        if cfg.trace_metrics:
            record_metrics(
                "dist.engine._mu_iter_sliced",
                a_norm=torch.linalg.vector_norm(Ai_new, dim=(-2, -1)),
                r_norm=torch.linalg.vector_norm(R, dim=(-3, -2, -1)),
                mu_ratio=update_ratio(Ai, Ai_new))
    return Ai_new, R


@_iteration
def _mu_iter_batched_sparse(grid: Grid, spl: BCSR, Ai, R,
                            cfg: DistRescalConfig):
    """One batched MU iteration on a shard-local BCSR: the dense batched
    schedule, with both X-sided products from ``sparse_products`` (one
    pass over the stored blocks under the fused policy)."""
    cd = cfg.comm_dtype
    eps = cfg.eps
    with obs.span("mu/gram"):
        Aj = grid.diag_row_to_col(Ai, cd)
        G = grid.psum_cast(gram(Ai), ROW_AXIS, cd)               # line 3
    with obs.span("mu/products"):
        XA_loc, XTA_loc = sparse_products(spl, Aj, Ai, policy=cfg.kernel)
    with obs.span("mu/r_update"):
        XA = grid.psum_cast(XA_loc, COL_AXIS, cd)                # line 5
        ATXA = grid.psum_cast(atxa(Ai, XA), ROW_AXIS, cd)
        R = r_update(R, ATXA, G, eps)                            # 6-9
    with obs.span("mu/a_update"):
        XART = xart(XA, R)                                       # line 10
        # (X^T A) R == X^T (A R): the block pass already gave X^T A, so
        # only a k-thin contraction with the fresh R remains
        XTAR_j = grid.psum_cast(
            torch.einsum("...mja,...mab->...jb", XTA_loc, R), ROW_AXIS, cd)
        XTAR = grid.diag_col_to_row(XTAR_j, cd)                  # 12-13
        num = XART + XTAR                                        # line 14
        S = a_denominator(R, G)                                  # 15-19
        Ai_new = a_ratio(Ai, num, S, eps, cfg.kernel)            # line 21
        Ai_new, R = sanitize_state(
            Ai_new, R, where="dist.engine._mu_iter_batched_sparse",
            enabled=cfg.sanitize)
        if cfg.trace_metrics:
            record_metrics(
                "dist.engine._mu_iter_batched_sparse",
                a_norm=torch.linalg.vector_norm(Ai_new, dim=(-2, -1)),
                r_norm=torch.linalg.vector_norm(R, dim=(-3, -2, -1)),
                mu_ratio=update_ratio(Ai, Ai_new))
    return Ai_new, R


@_iteration
def _mu_iter_sliced_sparse(grid: Grid, spl: BCSR, Ai, R,
                           cfg: DistRescalConfig):
    """One MU iteration on a shard-local BCSR with the paper's per-slice
    schedule (O(m) collectives): at exabyte-tier n the batched schedule's
    (m, n/g, k) intermediates are m times one A shard; slicing bounds
    them to one slice.  Under the fused policy each slice is one
    ``bcsr_xa_xta`` launch (m = 1, a view of the slice), all of them on
    A^(j) and A^(i) tiled once before the slices (``prepare_products``):
    neither changes inside the loop, and the tiles die with the
    iteration."""
    cd = cfg.comm_dtype
    eps = cfg.eps
    with obs.span("mu/gram"):
        Aj = grid.diag_row_to_col(Ai, cd)
        G = grid.psum_cast(gram(Ai), ROW_AXIS, cd)               # line 3
        AiT = Ai.transpose(-1, -2)
        R = R.clone()
        num = torch.zeros_like(Ai)
        S = torch.zeros_like(G)
    with obs.span("mu/products"):
        tiled = prepare_products(spl, Aj, Ai, policy=cfg.kernel)
    for t in range(spl.m):
        with obs.span("mu/slice", t=t):
            with obs.span("mu/products"):
                sp_t = spl.with_data(spl.data[..., t:t + 1, :, :, :])
                XA_loc, XTA_loc = sparse_products(sp_t, Aj, Ai,
                                                  policy=cfg.kernel,
                                                  operands=tiled)
            with obs.span("mu/r_update"):
                XA = grid.psum_cast(XA_loc[..., 0, :, :], COL_AXIS,
                                    cd)                          # line 5
                ATXA = grid.psum_cast(AiT @ XA, ROW_AXIS, cd)    # line 6
                Rt = R[..., t, :, :]
                Rt = Rt * ATXA / (G @ Rt @ G + eps)              # 7-9
                R[..., t, :, :] = Rt
            with obs.span("mu/a_update"):
                RtT = Rt.transpose(-1, -2)
                XART = XA @ RtT                                  # line 10
                XTAR_j = grid.psum_cast(XTA_loc[..., 0, :, :] @ Rt,
                                        ROW_AXIS, cd)            # line 12
                XTAR = grid.diag_col_to_row(XTAR_j, cd)          # line 13
                num = num + XART + XTAR                          # line 14
                S = S + Rt @ G @ RtT + RtT @ G @ Rt              # 15-20
    with obs.span("mu/a_update"):
        Ai_new = a_ratio(Ai, num, S, eps, cfg.kernel)            # line 21
        Ai_new, R = sanitize_state(
            Ai_new, R, where="dist.engine._mu_iter_sliced_sparse",
            enabled=cfg.sanitize)
        if cfg.trace_metrics:
            record_metrics(
                "dist.engine._mu_iter_sliced_sparse",
                a_norm=torch.linalg.vector_norm(Ai_new, dim=(-2, -1)),
                r_norm=torch.linalg.vector_norm(R, dim=(-3, -2, -1)),
                mu_ratio=update_ratio(Ai, Ai_new))
    return Ai_new, R


_ITERS = {
    ("dense", "batched"): _mu_iter_batched,
    ("dense", "sliced"): _mu_iter_sliced,
    ("bcsr", "batched"): _mu_iter_batched_sparse,
    ("bcsr", "sliced"): _mu_iter_sliced_sparse,
}
OPERANDS = ("dense", "bcsr")


def get_mu_iter(operand: str, schedule: str | None = None) -> Callable:
    """Local MU-iteration body ``(grid, local_operand, Ai, R, cfg) -> (Ai,
    R)`` for ``operand`` ("dense" | "bcsr") and ``schedule``, the
    composition point the selection ensemble builds on.  With one
    argument, that argument is the schedule of the dense body."""
    if schedule is None:
        operand, schedule = "dense", operand
    check_schedule(schedule)
    if operand not in OPERANDS:
        raise ValueError(f"operand must be one of {OPERANDS}, got "
                         f"{operand!r}")
    return _ITERS[(operand, schedule)]


def operand_kind(Xl) -> str:
    """"bcsr" for a ``core.sparse.BCSR`` shard, else "dense"."""
    return "bcsr" if isinstance(Xl, BCSR) else "dense"


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
    (r, m, nr, nc), one block per member, or a shard-local BCSR whose
    data is (m, z, bs, bs) or (r, m, z, bs, bs)."""

    def step(Xl, Ai, R):
        it = get_mu_iter(operand_kind(Xl), cfg.schedule)
        for _ in range(iters):
            Ai, R = it(grid, Xl, Ai, R, cfg)
        return Ai, R

    return step


def _atxa_gram(grid: Grid, Xl, Ai, cd: str | None, policy=None):
    """The all-reduced A^T X_t A of every slice and G = A^T A: what the
    error identity and the R regression need from X.  On a BCSR shard X A
    comes from ``single_product`` (``bcsr_spmm`` under a fused
    ``policy``)."""
    Aj = grid.diag_row_to_col(Ai, cd)
    G = grid.psum_cast(gram(Ai), ROW_AXIS, cd)
    if isinstance(Xl, BCSR):
        XA_loc = single_product(Xl, Aj, policy=policy)
    else:
        XA_loc = x_times(Xl, Aj)
    XA = grid.psum_cast(XA_loc, COL_AXIS, cd)
    return grid.psum_cast(atxa(Ai, XA), ROW_AXIS, cd), G


def local_rel_error(grid: Grid, Xl, Ai, R, cd: str | None = None, *,
                    policy=None):
    """Distributed relative error ||X - A R A^T|| / ||X|| on a dense X
    block or a BCSR shard, from k-sized collectives only (the identity of
    ``core.rescal.fit_error``).  Members of Ai/R share Xl; returns one
    error per member, equal on every cell."""
    ATXA, G = _atxa_gram(grid, Xl, Ai, cd, policy)
    x2_loc = sqnorm(Xl) if isinstance(Xl, BCSR) else (Xl * Xl).sum()
    x2 = grid.psum(grid.psum(x2_loc, ROW_AXIS), COL_AXIS)
    return fit_error(x2, ATXA, Ai, R, G=G)


def local_rel_error_bcsr(grid: Grid, spl: BCSR, Ai, R,
                         cd: str | None = None, *, policy=None):
    """``local_rel_error`` on a shard-local BCSR: X A through
    ``bcsr_spmm`` under a fused ``policy``, ||X||^2 from ``sqnorm``."""
    if not isinstance(spl, BCSR):
        raise TypeError("local_rel_error_bcsr takes a shard-local BCSR")
    return local_rel_error(grid, spl, Ai, R, cd, policy=policy)


def make_dist_error(grid: Grid, policy=None) -> Callable:
    """``err(Xl, Ai, R)``: the distributed relative error on ``grid``."""
    return lambda Xl, Ai, R: local_rel_error(grid, Xl, Ai, R, policy=policy)


def local_regress_R(grid: Grid, Xl, Ai, R0, *, iters: int = 100,
                    policy=None):
    """R regression with A fixed (``core/regression.py``) on the grid, on
    a dense block or a BCSR shard: the A^T X_t A of every slice from the
    engine's collectives, then MU on R alone (replicated, no further
    communication)."""
    ATXA, G = _atxa_gram(grid, Xl, Ai, None, policy)
    R = R0
    for _ in range(iters):
        R = r_update(R, ATXA, G, EPS_DEFAULT)
    return R


def dist_rescal(Xl, k: int, grid: Grid, *,
                init: RescalState | None = None,
                generator: torch.Generator | None = None, iters: int = 200,
                cfg: DistRescalConfig | None = None):
    """Distributed factorization of the global X whose block this cell
    holds: a dense X^(i,j) (m, n/g, n/g), or a shard-local BCSR (n =
    n_loc; the global X is the ShardedBCSR's, over n_pad entities).  The
    initial A (n, k) and R are global — ``init``, or uniform draws from
    ``generator``, which must give every cell the same numbers — and A is
    sliced to row block i.  Returns (RescalState with this cell's A^(i)
    and the replicated R, rel_error)."""
    cfg = cfg or DistRescalConfig()
    if isinstance(Xl, BCSR):
        if Xl.batch_shape:
            raise ValueError("dist_rescal takes one shard, not a member "
                             "stack")
        m, n, dev, dtype = Xl.m, Xl.n * grid.rows, Xl.device, Xl.data.dtype
    else:
        m, nr, nc = Xl.shape
        if nr != nc:
            raise ValueError(f"X^(i,j) must be square, got "
                             f"{tuple(Xl.shape)}")
        n, dev, dtype = nr * grid.rows, Xl.device, Xl.dtype
    if init is None:
        init = init_factors(n, m, k, generator=generator, device=dev,
                            dtype=dtype)
    Ai, R = grid.row_block(init.A), init.R
    Ai, R = make_mu_step(grid, cfg, iters=iters)(Xl, Ai, R)
    err = make_dist_error(grid, cfg.kernel)(Xl, Ai, R)
    return RescalState(A=Ai, R=R, step=iters), err
