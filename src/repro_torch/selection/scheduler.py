"""The sweep scheduler (port of ``repro/selection/scheduler.py:116,157,482``,
batched mode on one device).

``plan_sweep`` lays the (k, q) grid out as work units: one unit per
candidate rank k holding all r members.  ``SweepScheduler.run`` executes
each unit as one batched ensemble (selection/ensemble.py), runs the per-k
reduction ``reduce_k`` on it (custom clustering -> silhouettes -> R
regression -> reconstruction error), and the criterion picks k_opt.

Not ported yet: member groups over several pods, loop and grid modes,
checkpoint/resume, retry, fault injection, tracing and straggler
monitoring (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.clustering import custom_cluster
from repro_torch.core.silhouette import silhouettes
from repro_torch.core.sparse import BCSR, sparse_regress_R, sparse_rel_error
from repro_torch.kernels import ops

from . import criteria
from .draws import DrawSource, TorchDraws
from .ensemble import run_ensemble
from .report import SelectionReport, UnitRecord
from .types import KResult, RescalkConfig, RescalkResult

__all__ = ["SweepScheduler", "WorkUnit", "plan_sweep", "reduce_k"]


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
    A_med = clus.A_median
    R_reg = sparse_regress_R(sp, A_med, draws.regress_R0(k, sp.m),
                             iters=cfg.regress_iters, policy=cfg.kernel)
    err = float(sparse_rel_error(sp, A_med, R_reg, policy=cfg.kernel))
    return KResult(k=k, s_min=float(sil.s_min), s_mean=float(sil.s_mean),
                   rel_err=err, A_median=A_med.cpu().numpy(),
                   R_regress=R_reg.cpu().numpy(),
                   member_errors=np.asarray(member_errors))


class SweepScheduler:
    """Drives the (k, q) grid over a BCSR tensor, on the tensor's device.

    cfg        : RescalkConfig
    criterion  : key into selection.criteria.CRITERIA
    draws      : the draw source; default ``TorchDraws(cfg.seed)`` on the
                 operand's device
    report_path: write the SelectionReport JSON here after the sweep
    """

    def __init__(self, cfg: RescalkConfig, *, criterion: str = "threshold",
                 draws: DrawSource | None = None,
                 report_path: str | None = None, verbose: bool = False):
        criteria.require(criterion)
        self.cfg = cfg
        self.criterion = criterion
        self.draws = draws
        self.report_path = report_path
        self.verbose = verbose
        self.units = plan_sweep(cfg)
        self.report: SelectionReport | None = None

    def run(self, sp: BCSR) -> RescalkResult:
        if not isinstance(sp, BCSR):
            raise TypeError("the port's sweep runs on a BCSR operand "
                            "(dense operands are not ported yet)")
        cfg = self.cfg
        draws = self.draws if self.draws is not None else \
            TorchDraws(cfg.seed, sp.device)
        launches0 = ops.launch_counts()
        per_k: dict[int, KResult] = {}
        records: list[UnitRecord] = []
        for unit in self.units:
            t0 = time.perf_counter()
            res = run_ensemble(sp, unit.k, cfg, draws)
            if sp.device.type == "cuda":
                torch.cuda.synchronize(sp.device)
            records.append(UnitRecord(uid=unit.uid, k=unit.k,
                                      members=list(unit.members),
                                      seconds=time.perf_counter() - t0,
                                      reused=False, retries=0, attempts=1))
            k = unit.k
            per_k[k] = reduce_k(sp, cfg, k, res.A, res.R,
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
        self.report = SelectionReport(
            ks=[int(k) for k in ks], s_min=[float(v) for v in s_min],
            s_mean=[float(v) for v in s_mean],
            rel_err=[float(v) for v in rel], k_opt=int(k_opt),
            criterion=self.criterion, mode="batched",
            n_perturbations=cfg.n_perturbations, units=records,
            meta={"n_units": len(self.units), "n_retries": 0,
                  "n_stragglers": 0, "n_kernel_fallbacks": 0,
                  "kernel_launches": launches,
                  "device": str(sp.device)})
        if self.report_path:
            self.report.save(self.report_path)
        return result
