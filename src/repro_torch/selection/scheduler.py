"""The sweep scheduler (port of ``repro/selection/scheduler.py:87,116,157,
482``): plans the (k, q) grid and drives it over a dense, BCSR or
sharded BCSR operand on one device, or over a dense block or a BCSR
shard on the 2D process grid.

``plan_sweep`` lays the (k, q) grid out as work units, as ``repro``'s
does: in "batched" mode one unit per candidate rank k holding all r
members; in "loop" mode one unit per (k, q); in "grid" mode the whole
grid flattened k-major into ``GridChunk``s of ``grid_chunk`` cells, each
run as one member-stacked loop of k_max-padded cells
(``ensemble.run_sweep_batched``).  ``SweepScheduler.run`` executes the
units (selection/ensemble.py), runs the per-k reduction (custom
clustering -> silhouettes -> R regression -> reconstruction error) as
soon as all of a rank's members are in, and the criterion picks k_opt.

On one device a ``ShardedBCSR`` is merged into one BCSR once per sweep
(``ensemble.single_device``), as ``repro``'s scheduler merges it, in
every mode.  With ``grid=`` (``dist/sharding.py``) the operand is this
cell's dense block X^(i,j) (m, n/g, n/g) or its ``io.partition.
CellShard``, and every cell of the grid calls ``run``: the units run
``run_grid_ensemble`` (members split over pods), and ``reduce_k_grid``
gathers the members' factors over the row and pod axes, clusters them
identically on every cell, and takes the regression's A^T X A and the
error's ||X||^2 from the engine's collectives (``bcsr_spmm`` on a shard
under a fused policy) — the numbers ``repro`` computes on its global
array.  The process grid runs batched mode only.

Traced (``obs.trace``): ``sched/plan`` around the plan, one
``sched/execute`` span per unit (closed after the unit's device
synchronisation, so it times the device work) and one ``sched/reduce``
span per rank.  Each unit's record carries the host high-water mark and
the CUDA allocator's peak read at its end.

Not ported yet: member groups over several pods as separate units, the
cross-k grid on the process grid, checkpoint/resume, retry, fault
injection and straggler monitoring (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.clustering import custom_cluster
from repro_torch.core.regression import regress_R
from repro_torch.core.rescal import rel_error
from repro_torch.core.silhouette import silhouettes
from repro_torch.core.sparse import BCSR, sparse_regress_R, sparse_rel_error
from repro_torch.dist.engine import local_regress_R, local_rel_error
from repro_torch.dist.sharding import POD_AXIS, ROW_AXIS, Grid
from repro_torch.io.partition import CellShard, ShardedBCSR
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs
from repro_torch.obs.memory import device_watermark, read_host_memory

from . import criteria
from .draws import DrawSource, TorchDraws
from .ensemble import (EnsembleResult, run_ensemble, run_grid_ensemble,
                       run_sweep_batched, single_device)
from .report import SelectionReport, UnitRecord
from .types import KResult, RescalkConfig, RescalkResult

__all__ = ["GridChunk", "SweepScheduler", "WorkUnit", "plan_sweep",
           "reduce_k", "reduce_k_grid"]

SWEEP_MODES = ("batched", "loop", "grid")


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """One schedulable cell of the (k, q) grid: a contiguous member group
    of one candidate rank."""
    index: int
    k: int
    members: tuple[int, ...]

    @property
    def uid(self) -> str:
        return f"unit_k{self.k}_q{self.members[0]}-{self.members[-1]}"


@dataclasses.dataclass(frozen=True)
class GridChunk:
    """One chunk of the flattened cross-k grid (mode "grid"): a contiguous
    run of (k, q) cells in k-major, member-minor order, run as one
    k_max-padded batch.  The first and last cell determine the chunk."""
    index: int
    cells: tuple[tuple[int, int], ...]   # ((k, q), ...)
    k_max: int

    @property
    def uid(self) -> str:
        (k0, q0), (k1, q1) = self.cells[0], self.cells[-1]
        return f"grid_k{k0}q{q0}-k{k1}q{q1}"


def plan_sweep(cfg: RescalkConfig, *, mode: str = "batched",
               grid_chunk: int | None = None
               ) -> list[WorkUnit] | list[GridChunk]:
    """The sweep's units: "batched", one per rank with all r members;
    "loop", one per (k, q); "grid", the (k, q) grid flattened k-major in
    chunks of ``grid_chunk`` cells (default: one chunk)."""
    if mode == "grid":
        cells = [(k, q) for k in cfg.ks
                 for q in range(cfg.n_perturbations)]
        if grid_chunk is None:
            grid_chunk = len(cells)
        if grid_chunk <= 0:
            raise ValueError(f"grid_chunk must be positive, got "
                             f"{grid_chunk}")
        return [GridChunk(index=i, cells=tuple(cells[c:c + grid_chunk]),
                          k_max=max(cfg.ks))
                for i, c in enumerate(range(0, len(cells), grid_chunk))]
    if mode not in SWEEP_MODES:
        raise ValueError(f"unknown sweep mode {mode!r}")
    if grid_chunk is not None:
        raise ValueError("grid_chunk only applies to mode='grid'")
    members = tuple(range(cfg.n_perturbations))
    groups = [members] if mode == "batched" else [(q,) for q in members]
    return [WorkUnit(index=i, k=k, members=g)
            for i, (k, g) in enumerate((k, g) for k in cfg.ks
                                       for g in groups)]


def _k_result(k, clus, sil, R_reg, err, member_errors) -> KResult:
    return KResult(k=k, s_min=float(sil.s_min), s_mean=float(sil.s_mean),
                   rel_err=err, A_median=clus.A_median.cpu().numpy(),
                   R_regress=R_reg.cpu().numpy(),
                   member_errors=np.asarray(member_errors))


def reduce_k(X, cfg: RescalkConfig, k: int, A_ens: torch.Tensor,
             R_ens: torch.Tensor, member_errors: np.ndarray,
             draws: DrawSource) -> KResult:
    """The per-k reduction of Alg. 1: align the ensemble (custom
    clustering), score stability (silhouettes), regress R against the
    median factor, and measure its reconstruction error.  ``X`` is a
    dense (m, n, n) tensor or a BCSR; on a BCSR under a fused policy the
    regression's and the error's products run on ``bcsr_spmm``."""
    clus = custom_cluster(A_ens, R_ens)
    sil = silhouettes(clus.A_aligned)
    if isinstance(X, BCSR):
        R_reg = sparse_regress_R(X, clus.A_median,
                                 draws.regress_R0(k, X.m),
                                 iters=cfg.regress_iters, policy=cfg.kernel)
        err = float(sparse_rel_error(X, clus.A_median, R_reg,
                                     policy=cfg.kernel))
    else:
        R_reg = regress_R(X, clus.A_median, draws.regress_R0(k, X.shape[0]),
                          iters=cfg.regress_iters)
        err = float(rel_error(X, clus.A_median, R_reg))
    return _k_result(k, clus, sil, R_reg, err, member_errors)


def reduce_k_grid(grid: Grid, Xl, cfg: RescalkConfig, k: int,
                  res: EnsembleResult, draws: DrawSource) -> KResult:
    """``reduce_k`` on the grid, called by every cell with its
    ``run_grid_ensemble`` result: the members' A row blocks are gathered
    over the row axis and the members over the pod axis, the clustering
    and silhouettes run identically on every cell, and the regression and
    its error use the engine's collectives on X^(i,j) or on the cell's
    BCSR shard (``CellShard``; A in the permuted space of n_pad rows)."""
    local = Xl.sp if isinstance(Xl, CellShard) else Xl
    m = local.m if isinstance(Xl, CellShard) else Xl.shape[-3]
    A_ens = grid.all_gather(grid.all_gather(res.A, ROW_AXIS, dim=-2),
                            POD_AXIS, dim=0)
    R_ens = grid.all_gather(res.R, POD_AXIS, dim=0)
    errors = grid.all_gather(res.errors, POD_AXIS, dim=0)
    clus = custom_cluster(A_ens, R_ens)
    sil = silhouettes(clus.A_aligned)
    Ai = grid.row_block(clus.A_median)
    R_reg = local_regress_R(grid, local, Ai, draws.regress_R0(k, m),
                            iters=cfg.regress_iters, policy=cfg.kernel)
    err = float(local_rel_error(grid, local, Ai, R_reg, policy=cfg.kernel))
    return _k_result(k, clus, sil, R_reg, err, errors.cpu().numpy())


def _record(unit, seconds: float, dev: torch.device) -> UnitRecord:
    """A unit's record, with the watermarks read at its end: the host's
    high-water mark and the CUDA allocator's peak (None on the CPU)."""
    peaks = dict(peak_host_bytes=read_host_memory().get("hwm_bytes"),
                 peak_device_bytes=device_watermark(dev))
    if isinstance(unit, GridChunk):
        return UnitRecord(uid=unit.uid, k=-1, members=[], seconds=seconds,
                          reused=False, retries=0, attempts=1,
                          cells=[list(c) for c in unit.cells], **peaks)
    return UnitRecord(uid=unit.uid, k=unit.k, members=list(unit.members),
                      seconds=seconds, reused=False, retries=0, attempts=1,
                      **peaks)


class SweepScheduler:
    """Drives the (k, q) grid over an operand, on the operand's device.

    cfg        : RescalkConfig
    mode       : "batched" | "loop" | "grid" (see ``plan_sweep``)
    grid_chunk : cells per chunk in mode "grid" (default: the whole grid)
    criterion  : key into selection.criteria.CRITERIA
    draws      : the draw source; default ``TorchDraws(cfg.seed)`` on the
                 operand's device
    grid       : a ``dist.sharding.Grid``: ``run`` then takes this cell's
                 dense block X^(i,j) or its ``CellShard``, and every cell
                 of the grid calls it (batched mode only)
    report_path: write the SelectionReport JSON here after the sweep (on
                 the grid, cell 0 writes it)
    """

    def __init__(self, cfg: RescalkConfig, *, mode: str = "batched",
                 grid_chunk: int | None = None,
                 criterion: str = "threshold",
                 draws: DrawSource | None = None, grid: Grid | None = None,
                 report_path: str | None = None, verbose: bool = False):
        criteria.require(criterion)
        if grid is not None and mode != "batched":
            raise ValueError(f"the process grid runs mode='batched' only, "
                             f"got mode={mode!r}")
        if mode == "grid" and cfg.init != "random":
            raise NotImplementedError(
                "mode='grid' supports init='random' only (NNDSVD depends "
                "on the perturbed tensor, which only exists inside the "
                "grid program); use mode='batched' for nndsvd")
        self.cfg = cfg
        self.mode = mode
        self.criterion = criterion
        self.draws = draws
        self.grid = grid
        self.report_path = report_path
        self.verbose = verbose
        with obs.span("sched/plan", mode=mode):
            self.units = plan_sweep(cfg, mode=mode, grid_chunk=grid_chunk)
        self.report: SelectionReport | None = None

    def _check_operand(self, X) -> torch.device:
        if self.grid is not None:
            if isinstance(X, CellShard):
                return X.device
            if not torch.is_tensor(X) or X.dim() != 3:
                raise TypeError("on a grid the sweep runs on this cell's "
                                "dense block X^(i,j) (m, n/g, n/g) or its "
                                "CellShard of a ShardedBCSR")
        elif isinstance(X, (BCSR, ShardedBCSR)):
            if self.cfg.schedule != "batched":
                raise ValueError(f"the BCSR sweep runs the batched schedule "
                                 f"only, got schedule={self.cfg.schedule!r}")
        elif not torch.is_tensor(X) or X.dim() != 3 \
                or X.shape[1] != X.shape[2]:
            raise TypeError("the sweep runs on a BCSR, a ShardedBCSR or a "
                            "dense (m, n, n) tensor")
        return X.device

    def _execute(self, X, unit, draws) -> EnsembleResult:
        if self.grid is not None:
            return run_grid_ensemble(self.grid, X, unit.k, self.cfg, draws)
        if isinstance(unit, GridChunk):
            return run_sweep_batched(X, unit.cells, self.cfg, draws)
        return run_ensemble(X, unit.k, self.cfg, draws,
                            members=unit.members, mode=self.mode)

    def _reduce(self, X, k, rows, draws) -> KResult:
        """Reduce rank k from its (q, A, R, error) rows, in member
        order."""
        rows = sorted(rows, key=lambda row: row[0])
        A = torch.stack([a for _, a, _, _ in rows])
        R = torch.stack([r for _, _, r, _ in rows])
        errs = torch.stack([e for _, _, _, e in rows]).cpu().numpy()
        return reduce_k(X, self.cfg, k, A, R, errs, draws)

    def _rows(self, unit, res: EnsembleResult):
        """(k, q, A, R, error) per member of a unit's result; a grid
        chunk's rows cropped to their own k."""
        if isinstance(unit, GridChunk):
            return [(k, q, res.A[i, :, :k], res.R[i, :, :k, :k],
                     res.errors[i]) for i, (k, q) in enumerate(unit.cells)]
        return [(unit.k, q, res.A[i], res.R[i], res.errors[i])
                for i, q in enumerate(unit.members)]

    def run(self, X) -> RescalkResult:
        cfg = self.cfg
        grid = self.grid
        dev = self._check_operand(X)
        if grid is None:
            X = single_device(X)          # a ShardedBCSR, merged once
        draws = self.draws if self.draws is not None else \
            TorchDraws(cfg.seed, dev)
        launches0 = ops.launch_counts()
        collectives0 = grid.collectives if grid is not None else 0
        pending: dict[int, list] = {k: [] for k in cfg.ks}
        per_k: dict[int, KResult] = {}
        records: list[UnitRecord] = []
        for unit in self.units:
            with obs.span("sched/execute", uid=unit.uid, attempt=1):
                t0 = time.perf_counter()
                res = self._execute(X, unit, draws)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
            records.append(_record(unit, dt, dev))
            done = {}
            if grid is not None:
                with obs.span("sched/reduce", k=unit.k):
                    done[unit.k] = reduce_k_grid(grid, X, cfg, unit.k, res,
                                                 draws)
            else:
                for k, q, A, R, err in self._rows(unit, res):
                    pending[k].append((q, A, R, err))
                for k in cfg.ks:
                    if len(pending.get(k, ())) == cfg.n_perturbations:
                        with obs.span("sched/reduce", k=k):
                            done[k] = self._reduce(X, k, pending.pop(k),
                                                   draws)
            del res
            per_k.update(done)
            for k, r in done.items():
                if self.verbose:
                    print(f"[sweep] k={k:3d} s_min={r.s_min:6.3f} "
                          f"s_mean={r.s_mean:6.3f} err={r.rel_err:7.4f}")

        ks = cfg.ks
        s_min = np.array([per_k[k].s_min for k in ks])
        s_mean = np.array([per_k[k].s_mean for k in ks])
        rel = np.array([per_k[k].rel_err for k in ks])
        k_opt = criteria.select(self.criterion, ks, s_min, s_mean, rel,
                                sil_threshold=cfg.sil_threshold)
        result = RescalkResult(ks=np.asarray(ks), s_min=s_min, s_mean=s_mean,
                               rel_err=rel, k_opt=k_opt, per_k=per_k)
        launches = {name: n - launches0[name]
                    for name, n in ops.launch_counts().items()}
        meta = {"n_units": len(self.units), "n_retries": 0,
                "n_stragglers": 0, "n_kernel_fallbacks": 0,
                "kernel_launches": launches, "device": str(dev)}
        if grid is not None:
            meta["mesh"] = grid.shape
            meta["collectives"] = grid.collectives - collectives0
        self.report = SelectionReport(
            ks=[int(k) for k in ks], s_min=[float(v) for v in s_min],
            s_mean=[float(v) for v in s_mean],
            rel_err=[float(v) for v in rel], k_opt=int(k_opt),
            criterion=self.criterion, mode=self.mode,
            n_perturbations=cfg.n_perturbations, units=records, meta=meta)
        if self.report_path and (grid is None or grid.rank == 0):
            self.report.save(self.report_path)
        return result
