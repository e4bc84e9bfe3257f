"""The sweep scheduler (port of ``repro/selection/scheduler.py:116,157,482``,
batched mode): a BCSR operand on one device, or a dense operand on the 2D
process grid.

``plan_sweep`` lays the (k, q) grid out as work units: one unit per
candidate rank k holding all r members.  ``SweepScheduler.run`` executes
each unit as one batched ensemble (selection/ensemble.py), runs the per-k
reduction on it (custom clustering -> silhouettes -> R regression ->
reconstruction error), and the criterion picks k_opt.

With ``grid=`` (``dist/sharding.py``) the operand is this cell's dense
block X^(i,j) (m, n/g, n/g) and every cell of the grid calls ``run``: the
units run ``run_grid_ensemble`` (members split over pods), and
``reduce_k_grid`` gathers the members' factors over the row and pod axes,
clusters them identically on every cell, and takes the regression's
A^T X A and the error's ||X||^2 from the engine's collectives — the
numbers ``repro`` computes on its global array.

Not ported yet: member groups over several pods as separate units, loop
and grid (cross-k) modes, checkpoint/resume, retry, fault injection,
tracing and straggler monitoring (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.clustering import custom_cluster
from repro_torch.core.silhouette import silhouettes
from repro_torch.core.sparse import BCSR, sparse_regress_R, sparse_rel_error
from repro_torch.dist.engine import local_regress_R, local_rel_error
from repro_torch.dist.sharding import POD_AXIS, ROW_AXIS, Grid
from repro_torch.kernels import ops

from . import criteria
from .draws import DrawSource, TorchDraws
from .ensemble import EnsembleResult, run_ensemble, run_grid_ensemble
from .report import SelectionReport, UnitRecord
from .types import KResult, RescalkConfig, RescalkResult

__all__ = ["SweepScheduler", "WorkUnit", "plan_sweep", "reduce_k",
           "reduce_k_grid"]


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """One schedulable cell of the (k, q) grid: the members of one
    candidate rank."""
    index: int
    k: int
    members: tuple[int, ...]

    @property
    def uid(self) -> str:
        return f"unit_k{self.k}_q{self.members[0]}-{self.members[-1]}"


def plan_sweep(cfg: RescalkConfig) -> list[WorkUnit]:
    """One unit per candidate rank, all r members batched."""
    members = tuple(range(cfg.n_perturbations))
    return [WorkUnit(index=i, k=k, members=members)
            for i, k in enumerate(cfg.ks)]


def _k_result(k, clus, sil, R_reg, err, member_errors) -> KResult:
    return KResult(k=k, s_min=float(sil.s_min), s_mean=float(sil.s_mean),
                   rel_err=err, A_median=clus.A_median.cpu().numpy(),
                   R_regress=R_reg.cpu().numpy(),
                   member_errors=np.asarray(member_errors))


def reduce_k(sp: BCSR, cfg: RescalkConfig, k: int, A_ens: torch.Tensor,
             R_ens: torch.Tensor, member_errors: np.ndarray,
             draws: DrawSource) -> KResult:
    """The per-k reduction of Alg. 1: align the ensemble (custom
    clustering), score stability (silhouettes), regress R against the
    median factor, and measure its reconstruction error.  Under a fused
    policy the regression's and the error's products run on
    ``bcsr_spmm``."""
    clus = custom_cluster(A_ens, R_ens)
    sil = silhouettes(clus.A_aligned)
    R_reg = sparse_regress_R(sp, clus.A_median, draws.regress_R0(k, sp.m),
                             iters=cfg.regress_iters, policy=cfg.kernel)
    err = float(sparse_rel_error(sp, clus.A_median, R_reg,
                                 policy=cfg.kernel))
    return _k_result(k, clus, sil, R_reg, err, member_errors)


def reduce_k_grid(grid: Grid, Xl: torch.Tensor, cfg: RescalkConfig, k: int,
                  res: EnsembleResult, draws: DrawSource) -> KResult:
    """``reduce_k`` on the dense grid, called by every cell with its
    ``run_grid_ensemble`` result: the members' A row blocks are gathered
    over the row axis and the members over the pod axis, the clustering
    and silhouettes run identically on every cell, and the regression and
    its error use the engine's collectives on X^(i,j)."""
    A_ens = grid.all_gather(grid.all_gather(res.A, ROW_AXIS, dim=-2),
                            POD_AXIS, dim=0)
    R_ens = grid.all_gather(res.R, POD_AXIS, dim=0)
    errors = grid.all_gather(res.errors, POD_AXIS, dim=0)
    clus = custom_cluster(A_ens, R_ens)
    sil = silhouettes(clus.A_aligned)
    Ai = grid.row_block(clus.A_median)
    R_reg = local_regress_R(grid, Xl, Ai,
                            draws.regress_R0(k, Xl.shape[-3]),
                            iters=cfg.regress_iters)
    err = float(local_rel_error(grid, Xl, Ai, R_reg))
    return _k_result(k, clus, sil, R_reg, err, errors.cpu().numpy())


class SweepScheduler:
    """Drives the (k, q) grid over an operand, on the operand's device.

    cfg        : RescalkConfig
    criterion  : key into selection.criteria.CRITERIA
    draws      : the draw source; default ``TorchDraws(cfg.seed)`` on the
                 operand's device
    grid       : a ``dist.sharding.Grid``: ``run`` then takes this cell's
                 dense block X^(i,j), and every cell of the grid calls it
    report_path: write the SelectionReport JSON here after the sweep (on
                 the grid, cell 0 writes it)
    """

    def __init__(self, cfg: RescalkConfig, *, criterion: str = "threshold",
                 draws: DrawSource | None = None, grid: Grid | None = None,
                 report_path: str | None = None, verbose: bool = False):
        criteria.require(criterion)
        self.cfg = cfg
        self.criterion = criterion
        self.draws = draws
        self.grid = grid
        self.report_path = report_path
        self.verbose = verbose
        self.units = plan_sweep(cfg)
        self.report: SelectionReport | None = None

    def run(self, X) -> RescalkResult:
        cfg = self.cfg
        grid = self.grid
        if grid is not None:
            if not torch.is_tensor(X) or X.dim() != 3:
                raise TypeError("on a grid the sweep runs on this cell's "
                                "dense block X^(i,j) (m, n/g, n/g)")
            dev = X.device
        elif isinstance(X, BCSR):
            if cfg.schedule != "batched":
                raise ValueError(f"the BCSR sweep runs the batched schedule "
                                 f"only, got schedule={cfg.schedule!r}")
            dev = X.device
        else:
            raise TypeError("without a grid the port's sweep runs on a BCSR "
                            "operand (the single-device dense sweep is not "
                            "ported yet)")
        draws = self.draws if self.draws is not None else \
            TorchDraws(cfg.seed, dev)
        launches0 = ops.launch_counts()
        collectives0 = grid.collectives if grid is not None else 0
        per_k: dict[int, KResult] = {}
        records: list[UnitRecord] = []
        for unit in self.units:
            k = unit.k
            t0 = time.perf_counter()
            if grid is not None:
                res = run_grid_ensemble(grid, X, k, cfg, draws)
            else:
                res = run_ensemble(X, k, cfg, draws)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            records.append(UnitRecord(uid=unit.uid, k=k,
                                      members=list(unit.members),
                                      seconds=time.perf_counter() - t0,
                                      reused=False, retries=0, attempts=1))
            if grid is not None:
                per_k[k] = reduce_k_grid(grid, X, cfg, k, res, draws)
            else:
                per_k[k] = reduce_k(X, cfg, k, res.A, res.R,
                                    res.errors.cpu().numpy(), draws)
            del res
            if self.verbose:
                r = per_k[k]
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
            criterion=self.criterion, mode="batched",
            n_perturbations=cfg.n_perturbations, units=records, meta=meta)
        if self.report_path and (grid is None or grid.rank == 0):
            self.report.save(self.report_path)
        return result
