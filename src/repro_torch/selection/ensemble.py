"""Perturbation ensembles (port of ``repro/selection/ensemble.py:132,234,
338,421,508,609,720,793,823``): a dense or BCSR operand on one device (a
``ShardedBCSR`` merged into one BCSR), batched or as a sequential loop;
the cross-k grid of padded cells; and a dense block or a BCSR shard on
the 2D process grid, per k or as cross-k chunks (the mesh programs
``make_mesh_ensemble``, ``make_mesh_ensemble_bcsr`` and
``make_mesh_grid_ensemble``).

``repro`` vmaps the member pipeline (perturb -> init -> MU -> normalize ->
rel_error) over the r members of a work unit.  Here the member axis is
written out: the perturbed data is one (r, m, n, n) tensor, or (r, m,
nnzb, bs, bs) stored blocks, and the factors are (r, n, k) and (r, m, k,
k), so each MU iteration is one kernel launch for all r members (the
kernels index the operand and the factors by member).  The r perturbed
copies stay resident for the unit's MU loop, on top of the unperturbed
tensor; loop mode holds one copy at a time.

Every member's noise and initial factors come from a draw source
(``draws.py``); the perturbed copy is the noise, drawn into its slot of
the member buffer and multiplied by X there, so no separate noise tensor
exists.

Traced (``obs.trace``), the grid's member pipeline is four spans:
``ens/perturb`` (draws, the multiply by X, padding, row blocks),
``ens/mu`` (the MU loop with its masks), ``ens/normalize`` and
``ens/errors``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core.nndsvd import nndsvd_init_A
from repro_torch.core.rescal import (EPS_DEFAULT, MU_SCHEDULES, RescalState,
                                     column_mask, mask_state, masked_mu_step,
                                     masked_normalize, normalize, pad_state,
                                     rel_error)
from repro_torch.core.sparse import (BCSR, masked_sparse_mu_step,
                                     sparse_mu_step, sparse_rel_error)
from repro_torch.dist.engine import (DistRescalConfig, get_mu_iter,
                                     local_normalize, local_rel_error,
                                     operand_kind)
from repro_torch.dist.sharding import Grid
from repro_torch.io.partition import CellShard, ShardedBCSR
from repro_torch.obs import trace as obs

from .draws import DrawSource, perturbed_values

MODES = ("batched", "loop")


class EnsembleResult(NamedTuple):
    """Factors and errors for the members of one work unit."""
    A: torch.Tensor        # (r, n, k)
    R: torch.Tensor        # (r, m, k, k)
    errors: torch.Tensor   # (r,) rel. error vs the UNperturbed X


def single_device(X):
    """A ShardedBCSR as the one BCSR a single device runs on (its shards
    merged, the permuted padded entity space); any other operand as it
    is."""
    return X.to_bcsr() if isinstance(X, ShardedBCSR) else X


def _require_random_init(cfg, what: str) -> None:
    if cfg.init != "random":
        raise NotImplementedError(
            f"{what} supports init='random' only (NNDSVD eigensolves the "
            f"dense tensor; distributed/sparse NNDSVD is a ROADMAP item)")


def _perturbed(X, k: int, members: Sequence[int], cfg, draws: DrawSource):
    """The members' perturbed copies of X (one operand with a leading
    member axis) and their initial factors, stacked; under
    init="nndsvd" each member's A0 is the NNDSVD of its own copy."""
    vals = perturbed_values(X)
    buf = torch.empty((len(members),) + tuple(vals.shape), dtype=vals.dtype,
                      device=vals.device)
    A0, R0 = [], []
    for slot, q in enumerate(members):
        _, A_q, R_q = draws.member(k, q, X, cfg.perturbation_delta,
                                   out=buf[slot])
        buf[slot].mul_(vals)
        if cfg.init == "nndsvd":
            A_q = nndsvd_init_A(buf[slot], k).to(vals.dtype)
        A0.append(A_q)
        R0.append(R_q)
    X_q = X.with_data(buf) if isinstance(X, BCSR) else buf
    return X_q, RescalState(A=torch.stack(A0), R=torch.stack(R0), step=0)


def _factorize(X_q, st: RescalState, cfg) -> RescalState:
    """cfg.rescal_iters MU iterations of cfg.schedule under cfg.kernel on
    the perturbed operand (with cfg.sanitize's checks and cfg.trace_metrics'
    records), then the normalization."""
    policy = cfg.kernel
    if isinstance(X_q, BCSR):
        A, R = st.A, st.R
        for _ in range(cfg.rescal_iters):
            A, R = sparse_mu_step(X_q, A, R, EPS_DEFAULT, policy=policy,
                                  sanitize=cfg.sanitize,
                                  trace_metrics=cfg.trace_metrics)
        st = RescalState(A=A, R=R, step=cfg.rescal_iters)
    else:
        step = MU_SCHEDULES[cfg.schedule]
        for _ in range(cfg.rescal_iters):
            st = step(X_q, st, EPS_DEFAULT, cfg.sanitize, cfg.trace_metrics,
                      policy=policy)
    return normalize(st)


def _errors(X, st: RescalState, policy) -> torch.Tensor:
    """Each member's relative error against the unperturbed X."""
    if isinstance(X, BCSR):
        return sparse_rel_error(X, st.A, st.R, policy=policy)
    return rel_error(X, st.A, st.R)


def run_ensemble(X, k: int, cfg, draws: DrawSource, *,
                 members: Sequence[int] | None = None,
                 mode: str = "batched") -> EnsembleResult:
    """Run members of candidate rank k on X (on its device): a dense (m,
    n, n) tensor, an unperturbed ``core.sparse.BCSR``, or a
    ``ShardedBCSR`` (merged here; the scheduler merges once per sweep
    instead).  ``cfg`` is a
    ``RescalkConfig``; ``members`` a subset of the member ids (default
    all).  ``mode`` "batched" runs them as one member-stacked MU loop,
    "loop" one after another (one perturbed copy resident at a time; on
    a dense X each through ``core.rescalk.default_member_runner``, as
    ``repro``'s loop mode runs it)."""
    if mode not in MODES:
        raise ValueError(f"unknown ensemble mode {mode!r}")
    members = tuple(members) if members is not None else \
        tuple(range(cfg.n_perturbations))
    X = single_device(X)
    if isinstance(X, BCSR):
        if X.batch_shape:
            raise ValueError("run_ensemble takes the unperturbed tensor")
        _require_random_init(cfg, "BCSR ensembles")
    if mode == "loop" and not isinstance(X, BCSR):
        # repro's loop mode: each member through the default runner
        from repro_torch.core.rescalk import default_member_runner
        return runner_members(X, k, members, cfg, draws,
                              default_member_runner)
    groups = [members] if mode == "batched" else [(q,) for q in members]
    outs = []
    for group in groups:
        X_q, st = _perturbed(X, k, group, cfg, draws)
        st = _factorize(X_q, st, cfg)
        del X_q
        outs.append((st.A, st.R, _errors(X, st, cfg.kernel)))
    A, R, errs = (torch.cat(parts) for parts in zip(*outs))
    return EnsembleResult(A=A, R=R, errors=errs)


def runner_members(X, k: int, members: Sequence[int], cfg,
                   draws: DrawSource, runner) -> EnsembleResult:
    """Loop mode's members of rank k on a dense X, each factorized by
    ``runner(X_q, k, generator, cfg, init=...)`` (``core.rescalk``'s
    member runner contract): the member's perturbed copy and initial
    factors as loop mode draws them (``_perturbed``), the generator of
    its (seed, k, q) stream, and its error against the unperturbed X."""
    A_l, R_l, errs = [], [], []
    for q in members:
        X_q, st = _perturbed(X, k, (q,), cfg, draws)
        gen = _device.seeded_generator(cfg.seed, k, q, device=X.device)
        out = runner(X_q[0], k, gen, cfg,
                     init=RescalState(A=st.A[0], R=st.R[0], step=0))
        del X_q
        A_l.append(out.A)
        R_l.append(out.R)
        errs.append(rel_error(X, out.A, out.R))
    return EnsembleResult(A=torch.stack(A_l), R=torch.stack(R_l),
                          errors=torch.stack(errs))


def grid_init(cells, X, k_max: int, cfg, draws: DrawSource,
              out: torch.Tensor):
    """Per-cell masks (cells, k_max) and padded initial factors for a
    chunk of (k, q) cells; each cell's noise goes into its slot of
    ``out``.  The draws are made at the reference shape (n, k), exactly as
    the per-k ensemble's, and zero-padded to k_max, so a grid row cropped
    to its k starts where that member starts in batched mode."""
    A0, R0 = [], []
    for row, (k, q) in enumerate(cells):
        _, A_q, R_q = draws.member(k, q, X, cfg.perturbation_delta,
                                   out=out[row])
        st = pad_state(RescalState(A=A_q, R=R_q, step=0), k_max)
        A0.append(st.A)
        R0.append(st.R)
    mask = column_mask([k for k, _ in cells], k_max, dtype=out.dtype,
                       device=out.device)
    return mask, RescalState(A=torch.stack(A0), R=torch.stack(R0), step=0)


def run_sweep_batched(X, cells, cfg, draws: DrawSource) -> EnsembleResult:
    """A chunk of flattened (k, q) cells as one member-stacked MU loop:
    every cell's factors padded to k_max = max(cfg.ks) under its column
    mask (the masked steps), on a dense X or a BCSR.  Rows come back
    padded; the masked columns are exact zeros."""
    cells = tuple(cells)
    _require_random_init(cfg, "the cross-k grid program")
    X = single_device(X)
    k_max = max(cfg.ks)
    policy = cfg.kernel
    vals = perturbed_values(X)
    buf = torch.empty((len(cells),) + tuple(vals.shape), dtype=vals.dtype,
                      device=vals.device)
    mask, st = grid_init(cells, X, k_max, cfg, draws, buf)
    buf.mul_(vals)
    if isinstance(X, BCSR):
        sp_q = X.with_data(buf)
        A, R = st.A, st.R
        for _ in range(cfg.rescal_iters):
            A, R = masked_sparse_mu_step(sp_q, A, R, mask, EPS_DEFAULT,
                                         policy=policy,
                                         sanitize=cfg.sanitize,
                                         trace_metrics=cfg.trace_metrics)
        st = RescalState(A=A, R=R, step=cfg.rescal_iters)
    else:
        for _ in range(cfg.rescal_iters):
            st = masked_mu_step(buf, st, mask, EPS_DEFAULT, cfg.schedule,
                                cfg.sanitize, cfg.trace_metrics,
                                policy=policy)
    del buf
    st = masked_normalize(st, mask)
    return EnsembleResult(A=st.A, R=st.R, errors=_errors(X, st, policy))


def _grid_operand(grid: Grid, Xl):
    """The local operand of this cell and the global entity count: a
    dense block X^(i,j), or a ``CellShard``, checked against the grid as
    ``repro``'s ``make_mesh_ensemble_bcsr`` checks its mesh."""
    if not isinstance(Xl, CellShard):
        return Xl, Xl.shape[-1] * grid.rows
    g = grid.rows
    if Xl.part.grid != g:
        # the shard would silently stand for a different tensor: every
        # cell must hold its own shard of a layout made for this grid
        raise ValueError(f"operand was partitioned for a {Xl.part.grid}x"
                         f"{Xl.part.grid} grid but the process grid is "
                         f"{g}x{grid.cols}; re-partition for this grid")
    if (Xl.i, Xl.j) != (grid.i, grid.j):
        raise ValueError(f"cell ({grid.i}, {grid.j}) was handed shard "
                         f"({Xl.i}, {Xl.j})")
    if Xl.n_pad % g:
        raise ValueError(f"the grid side {g} must divide "
                         f"n_pad={Xl.n_pad}")
    return Xl.sp, Xl.n_pad


def run_grid_ensemble(grid: Grid, Xl, k: int, cfg, draws: DrawSource, *,
                      members: Sequence[int] | None = None
                      ) -> EnsembleResult:
    """This pod's share of ``members`` (default all r) of candidate rank k
    on the grid: perturb this cell's values -> init -> MU
    (``dist.engine``, ``cfg.schedule``, ``cfg.kernel``) ->
    ``local_normalize`` -> ``local_rel_error`` against the unperturbed
    operand.  ``Xl`` is X^(i,j) (m, n/g, n/g), or this cell's
    ``CellShard`` of a ShardedBCSR (each cell holding only its shard; its
    stored blocks are perturbed, its zero padding blocks stay zero, and
    the factors live in the permuted space of n_pad rows).  The members
    split evenly and contiguously over the pods (``grid.pod_members``;
    ``repro``'s ``r_run % pods``).  Returns the pod's members: A^(i)
    (r_u/pods, n/g, k), R and errors, equal on every cell of the pod but
    A."""
    _require_random_init(cfg, "the grid ensemble")
    members = tuple(members) if members is not None else \
        tuple(range(cfg.n_perturbations))
    mine = grid.pod_members(members)
    return _grid_members(grid, Xl, [(k, q) for q in mine], cfg, draws)


def run_grid_sweep_batched(grid: Grid, Xl, cells, cfg,
                           draws: DrawSource) -> EnsembleResult:
    """A chunk of flattened (k, q) cells on the grid (``repro``'s
    ``make_mesh_grid_ensemble``): the cells split evenly over the pods,
    as ``repro`` puts the cell axis on its pod axis, and each pod runs its
    share as one member-stacked MU loop at k_max = max(cfg.ks) under the
    cells' column mask.  Each cell starts from its per-k grid draws
    (``draws.grid_member``: the same noise words and the global init,
    zero-padded to k_max), so a cell cropped to its k is the per-k grid
    ensemble's member.  Returns the pod's cells, padded: A^(i) (cells /
    pods, n/g, k_max), R and errors; the masked columns are exact
    zeros."""
    cells = tuple(cells)
    _require_random_init(cfg, "the cross-k grid program")
    if len(cells) % grid.pods:
        raise ValueError(f"a grid chunk of {len(cells)} cells does not "
                         f"shard evenly over pods={grid.pods}; pick a "
                         f"grid_chunk divisible by the pod count")
    return _grid_members(grid, Xl, grid.pod_members(cells), cfg, draws,
                         k_max=max(cfg.ks))


def _grid_members(grid: Grid, Xl, cells, cfg, draws: DrawSource, *,
                  k_max: int | None = None) -> EnsembleResult:
    """The (k, q) cells of this pod as one member-stacked MU loop on this
    cell's operand: at their own k (one rank), or padded to ``k_max``
    under their column mask (``repro``'s masked grid body: each MU
    iteration, then A *= mask and R *= mask x mask)."""
    local, n = _grid_operand(grid, Xl)
    dcfg = DistRescalConfig(schedule=cfg.schedule, kernel=cfg.kernel,
                            sanitize=cfg.sanitize,
                            trace_metrics=cfg.trace_metrics)
    it = get_mu_iter(operand_kind(local), cfg.schedule)
    with obs.span("ens/perturb"):
        vals = perturbed_values(local)
        buf = torch.empty((len(cells),) + tuple(vals.shape),
                          dtype=vals.dtype, device=vals.device)
        A0, R0 = [], []
        for slot, (k, q) in enumerate(cells):
            A_q, R_q = draws.grid_member(k, q, grid, buf[slot],
                                         cfg.perturbation_delta, n=n)
            buf[slot].mul_(vals)
            if k_max is not None:
                st = pad_state(RescalState(A=A_q, R=R_q, step=0), k_max)
                A_q, R_q = st.A, st.R
            A0.append(grid.row_block(A_q))
            R0.append(R_q)
        X_q = local.with_data(buf) if isinstance(local, BCSR) else buf
        st = RescalState(A=torch.stack(A0), R=torch.stack(R0), step=0)
    with obs.span("ens/mu"):
        mask = None if k_max is None else column_mask(
            [k for k, _ in cells], k_max, dtype=vals.dtype,
            device=vals.device)
        for _ in range(cfg.rescal_iters):
            st = RescalState(*it(grid, X_q, st.A, st.R, dcfg), step=0)
            if mask is not None:
                st = mask_state(st, mask)
    del X_q, buf
    with obs.span("ens/normalize"):
        st = RescalState(*local_normalize(grid, st.A, st.R), step=0)
        if mask is not None:
            st = mask_state(st, mask)
    with obs.span("ens/errors"):
        errors = local_rel_error(grid, local, st.A, st.R, policy=cfg.kernel)
    return EnsembleResult(A=st.A, R=st.R, errors=errors)
