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
CellShard``, and every cell of the grid calls ``run`` with the same
arguments, as ``repro``'s ``SweepScheduler(mesh=...)`` runs one program
on its mesh.  Batched units run ``run_grid_ensemble`` (the unit's members
split over the pods), "grid" chunks ``run_grid_sweep_batched`` (the
chunk's cells split over the pods, each pod's share one k_max-padded
member-stacked loop); loop mode is refused, as ``repro`` refuses it on a
mesh.  Each unit's result is gathered once (``gather_unit``: A's row
blocks over the row axis, the members over the pod axis) into the global
arrays ``repro``'s mesh program returns; they are the unit's checkpoint,
and a rank's rows wait for all of its r members, as on one device,
before ``reduce_k_grid`` clusters them identically on every cell and
takes the regression's A^T X A and the error's ||X||^2 from the engine's
collectives (``bcsr_spmm`` on a shard under a fused policy).

The sweep is resilient, as ``repro``'s
(``repro/selection/scheduler.py:261-560``), on one device and on the
grid:

  * ``ckpt_dir``: every executed unit is checkpointed (``ckpt``, one
    directory per unit uid, ``repro``'s format: the unit's global A, R
    and errors) and a rerun restores the units it finds instead of
    recomputing them, onto the operand's device.  ``sweep.json`` holds
    the sweep's fingerprint (the config, the mode, the operand's
    ``io.manifest`` fingerprint and the grid's shape as ``mesh``); a
    resume under another fingerprint is refused, naming the mismatched
    keys.  A unit whose every checkpoint step fails verification is
    quarantined and recomputed.  The per-k reduction takes its draws
    from the same ``TorchDraws`` words either way, so a resumed sweep
    equals an uninterrupted one bit for bit.
  * ``retry``: each unit attempt probes the
    ``sched/unit`` fault seam and runs under the ``RetryPolicy``:
    transient errors back off and replay (``sched/retry`` events),
    others fail fast (``sched/fail_fast``).  A ``StragglerMonitor`` flags
    units slower than ``straggler_factor`` x the median
    (``sched/straggler``) and shrinks a retried attempt's deadline.
  * ``stop_after_units`` computes at most that many units, then raises
    ``SweepInterrupted`` (the deterministic stand-in for a kill);
    ``async_ckpt`` writes the checkpoints on a thread and surfaces a
    failed write at the next checkpoint boundary; ``n_pods`` splits each
    rank's members into ``dist.elastic.ensemble_plan`` groups, one unit
    each.

On the grid every decision is agreed (``Grid.agree``, a max over every
cell, outside the MU iterations, whose collectives do not change):

  * cell 0 checks the fingerprint, decides whether a unit has a
    verified step (restoring it, healing a torn one), and writes the
    checkpoints and the report; ``ckpt_dir`` must be a path every cell
    sees.  Every cell then reads a restored unit's file; a failed read,
    fingerprint check or write on any cell is raised on every cell;
  * an attempt is bracketed by two agreements, after the ``sched/unit``
    probe (before the unit's first collective) and after the unit's
    device synchronisation.  Each cell contributes ok, transient or
    fatal, and the grid acts on the worst: every cell backs off the same
    ``RetryPolicy.backoff(attempt, uid)`` and retries, or every cell
    fails fast; a cell that did not fail raises the same class as the
    one that did.  A fault plan installed on every cell fires at the
    same call index on every cell, since every cell runs the same
    program;
  * the closing agreement carries the slowest cell's unit time, which
    the ``StragglerMonitor`` records, so every cell flags the same units
    and derives the same deadline.  Unlike on one device, where an
    attempt runs on a thread that an overrun abandons, the grid judges
    the deadline at the closing agreement: an attempt whose grid-wide
    time exceeded it is ``DeadlineExceeded`` on every cell, and no cell
    abandons a thread that is still issuing collectives.

What the grid cannot agree on: an error raised on one cell only between
two collectives inside a unit (a CUDA error mid-MU, say).  The other
cells wait in their collective until the process group's timeout
(``launch.mesh.make_grid(timeout_s=)``), and the sweep is then resumed
from its checkpoints.  ``repro``'s single controller has no such case;
an agreement per MU iteration would close it at the cost of the
iteration's collective count.

Each ``UnitRecord`` reports its attempts, backoff, straggler flag and
kernel fallbacks (``kernels.ops.kernel_fallbacks`` diffed around the
unit; on the grid the largest count of any cell), equal on every cell of
the grid; the report's ``n_retries``, ``n_stragglers`` and
``n_kernel_fallbacks`` are their sums.

Traced (``obs.trace``): ``sched/plan`` around the plan, one
``sched/execute`` span per unit attempt (closed after the unit's device
synchronisation, so it times the device work), ``sched/restore`` and
``sched/checkpoint`` spans, and one ``sched/reduce`` span per rank; on
the grid the reduction splits into ``reduce/cluster``,
``reduce/silhouettes``, ``reduce/regress`` and ``reduce/error``.  Each
unit's record carries the host high-water mark and the CUDA allocator's
peak read at its end, and the trace file is written at the end of each
unit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import ckpt
from repro_torch.core.clustering import custom_cluster
from repro_torch.core.regression import regress_R
from repro_torch.core.rescal import rel_error
from repro_torch.core.silhouette import silhouettes
from repro_torch.core.sparse import BCSR, sparse_regress_R, sparse_rel_error
from repro_torch.dist.elastic import StragglerMonitor, ensemble_plan
from repro_torch.dist.engine import local_regress_R, local_rel_error
from repro_torch.dist.sharding import POD_AXIS, ROW_AXIS, Grid
from repro_torch.io.manifest import manifest_of, operand_dims
from repro_torch.io.partition import CellShard, ShardedBCSR
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs
from repro_torch.obs.memory import device_watermark, read_host_memory
from repro_torch.resilience import (DeadlineExceeded, DeterministicFault,
                                    RetryPolicy, TransientError, faults)

from . import criteria
from .draws import DrawSource, TorchDraws, perturbed_values
from .ensemble import (EnsembleResult, _grid_operand, run_ensemble,
                       run_grid_ensemble, run_grid_sweep_batched,
                       run_sweep_batched, single_device)
from .report import SelectionReport, UnitRecord
from .types import KResult, RescalkConfig, RescalkResult

__all__ = ["GridChunk", "SweepInterrupted", "SweepScheduler", "UnitOutcome",
           "WorkUnit", "gather_unit", "plan_sweep", "reduce_k",
           "reduce_k_grid"]

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
               n_pods: int = 1, grid_chunk: int | None = None
               ) -> list[WorkUnit] | list[GridChunk]:
    """The sweep's units: "batched", per rank the members grouped
    contiguously over ``n_pods`` units (``dist.elastic.ensemble_plan``);
    "loop", one per (k, q); "grid", the (k, q) grid flattened k-major in
    chunks of ``grid_chunk`` cells (default: one chunk per pod)."""
    if mode == "grid":
        cells = [(k, q) for k in cfg.ks
                 for q in range(cfg.n_perturbations)]
        if grid_chunk is None:
            grid_chunk = -(-len(cells) // n_pods)
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
    if mode == "batched":
        groups = [tuple(g) for g in ensemble_plan(cfg.n_perturbations,
                                                  n_pods) if g]
    else:
        groups = [(q,) for q in range(cfg.n_perturbations)]
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


def gather_unit(grid: Grid, res: EnsembleResult) -> EnsembleResult:
    """A unit's global result from every cell's share, equal on every
    cell: A's row blocks gathered over the row axis and the members (or
    cells) over the pod axis, R and the errors over the pod axis — the
    arrays ``repro``'s mesh program returns, and its checkpoint."""
    return EnsembleResult(
        A=grid.all_gather(grid.all_gather(res.A, ROW_AXIS, dim=-2),
                          POD_AXIS, dim=0),
        R=grid.all_gather(res.R, POD_AXIS, dim=0),
        errors=grid.all_gather(res.errors, POD_AXIS, dim=0))


def reduce_k_grid(grid: Grid, Xl, cfg: RescalkConfig, k: int,
                  A_ens: torch.Tensor, R_ens: torch.Tensor,
                  member_errors: np.ndarray, draws: DrawSource) -> KResult:
    """``reduce_k`` on the grid, called by every cell with rank k's
    global ensemble (``gather_unit``'s rows, equal on every cell): the
    clustering and silhouettes run identically on every cell, and the
    regression and its error use the engine's collectives on X^(i,j) or
    on the cell's BCSR shard (``CellShard``; A in the permuted space of
    n_pad rows)."""
    local, _ = _grid_operand(grid, Xl)
    m = local.m if isinstance(local, BCSR) else local.shape[-3]
    with obs.span("reduce/cluster"):
        clus = custom_cluster(A_ens, R_ens)
    with obs.span("reduce/silhouettes"):
        sil = silhouettes(clus.A_aligned)
    with obs.span("reduce/regress"):
        Ai = grid.row_block(clus.A_median)
        R_reg = local_regress_R(grid, local, Ai, draws.regress_R0(k, m),
                                iters=cfg.regress_iters, policy=cfg.kernel)
    with obs.span("reduce/error"):
        err = float(local_rel_error(grid, local, Ai, R_reg,
                                    policy=cfg.kernel))
    return _k_result(k, clus, sil, R_reg, err, member_errors)


class SweepInterrupted(RuntimeError):
    """``stop_after_units`` halted the sweep (the deterministic stand-in
    for a kill: the computed units are checkpointed, the rest are not)."""

    def __init__(self, executed: int, completed: int, total: int,
                 resumable: bool = True):
        self.executed = executed     # units computed this run
        self.completed = completed   # units done overall (incl. reused)
        self.total = total
        self.resumable = resumable   # False when no ckpt_dir was set
        tail = ("rerun with the same ckpt_dir to resume" if resumable else
                "no ckpt_dir was set, so completed units were NOT "
                "checkpointed and a rerun recomputes everything")
        super().__init__(f"sweep interrupted after {executed} computed "
                         f"units ({completed}/{total} done; {tail})")


@dataclasses.dataclass
class UnitOutcome:
    unit: "WorkUnit | GridChunk"
    result: EnsembleResult | None   # dropped once its rows are handed on
    seconds: float
    reused: bool
    retries: int
    attempts: int = 1               # executions this run (0 when reused)
    backoff: float = 0.0            # total RetryPolicy sleep, seconds
    straggler: bool = False         # flagged by the StragglerMonitor
    baseline: float | None = None   # the monitor's median at the unit's end
    peak_host: int | None = None    # host HWM bytes when the unit finished
    peak_device: int | None = None  # CUDA allocator peak (None on the CPU)
    fallbacks: int = 0              # kernel fallbacks within the unit

    def record(self) -> UnitRecord:
        unit = self.unit
        grid = isinstance(unit, GridChunk)
        return UnitRecord(
            uid=unit.uid, k=-1 if grid else unit.k,
            members=[] if grid else list(unit.members),
            seconds=self.seconds, reused=self.reused, retries=self.retries,
            attempts=self.attempts, backoff_seconds=self.backoff,
            cells=[list(c) for c in unit.cells] if grid else None,
            straggler=self.straggler, baseline_seconds=self.baseline,
            peak_host_bytes=self.peak_host,
            peak_device_bytes=self.peak_device,
            kernel_fallbacks=self.fallbacks)


# Errors a cell raises when another cell of the grid failed: the first
# class of this tuple the failure is an instance of (subclasses first, the
# last the catch-all), so every cell raises the same class and the
# RetryPolicy classes it alike.
_PEER_ERRORS = (DeadlineExceeded, TransientError, DeterministicFault,
                ckpt.CheckpointError, ValueError, TimeoutError,
                ConnectionError, OSError, RuntimeError)


class SweepScheduler:
    """Drives the (k, q) grid over an operand, on the operand's device.

    cfg        : RescalkConfig
    mode       : "batched" | "loop" | "grid" (see ``plan_sweep``); the
                 process grid runs "batched" and "grid"
    grid_chunk : cells per chunk in mode "grid" (default: one chunk per
                 pod); not part of the checkpoint fingerprint, since chunk
                 uids name their exact cell range.  On the process grid
                 every chunk must split evenly over ``grid.pods``
    criterion  : key into selection.criteria.CRITERIA
    draws      : the draw source; default ``TorchDraws(cfg.seed)`` on the
                 operand's device
    grid       : a ``dist.sharding.Grid``: ``run`` then takes this cell's
                 dense block X^(i,j) or its ``CellShard``, and every cell
                 of the grid calls it with the same arguments
    ckpt_dir   : per-unit checkpoint root; units found there are restored,
                 not recomputed.  On the grid every cell must see the
                 same directory (one file system); cell 0 writes it
    n_pods     : split each rank's members into this many units (grid
                 mode: the default chunk count); on the grid each unit's
                 members split again over ``grid.pods``
    retry      : the unit RetryPolicy; default two attempts (on the grid
                 too: every cell agrees on each attempt's outcome)
    stop_after_units : compute at most this many units (0 = resume only),
                 then raise SweepInterrupted
    async_ckpt : write unit checkpoints on a thread; a failed write is
                 re-raised at the next checkpoint boundary (on every cell
                 of the grid)
    straggler_factor : a unit slower than this x the median is flagged
    report_path: write the SelectionReport JSON here after the sweep (on
                 the grid, cell 0 writes it)
    """

    def __init__(self, cfg: RescalkConfig, *, mode: str = "batched",
                 grid_chunk: int | None = None,
                 criterion: str = "threshold",
                 draws: DrawSource | None = None, grid: Grid | None = None,
                 ckpt_dir: str | None = None, n_pods: int = 1,
                 retry: RetryPolicy | None = None,
                 stop_after_units: int | None = None,
                 async_ckpt: bool = False, straggler_factor: float = 2.5,
                 report_path: str | None = None, verbose: bool = False):
        criteria.require(criterion)
        if grid is not None and mode not in ("batched", "grid"):
            raise ValueError(
                "mode='loop' is host-only (the sequential reference / "
                "memory-bound fallback); drop grid= or use mode='batched'")
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
        self.ckpt_dir = ckpt_dir
        self.retry = retry or RetryPolicy(max_attempts=2)
        self.stop_after_units = stop_after_units
        self.async_ckpt = async_ckpt
        self._pending_save: ckpt.AsyncSave | None = None
        self.stragglers = StragglerMonitor(factor=straggler_factor)
        self.report_path = report_path
        self.verbose = verbose
        with obs.span("sched/plan", mode=mode):
            self.units = plan_sweep(cfg, mode=mode, n_pods=n_pods,
                                    grid_chunk=grid_chunk)
        if grid is not None:
            self._check_pod_split(grid.pods)
        self.report: SelectionReport | None = None

    def _check_pod_split(self, pods: int) -> None:
        """A unit whose members (or chunk whose cells) do not split evenly
        over the grid's pods is a configuration error: refused here, not
        after the retries."""
        bad = [u.uid for u in self.units
               if len(u.cells if isinstance(u, GridChunk) else u.members)
               % pods]
        if bad:
            raise ValueError(
                f"units {bad} do not shard evenly over pods={pods}; pick a "
                f"grid_chunk (or n_pods) that keeps every unit divisible "
                f"by the pod count")

    @property
    def _lead(self) -> bool:
        """This process writes the checkpoints and decides the restores:
        the one device, or cell 0 of the grid."""
        return self.grid is None or self.grid.rank == 0

    def _agree(self, err: BaseException | None, *values: float
               ) -> list[float]:
        """One cell's failure becomes every cell's: each cell contributes
        its error's code (0 for none, transient codes below fatal ones)
        and ``values``; the grid takes the maximum of each.  The cell
        whose error is the worst re-raises it and every other cell raises
        the same class, so all back off and retry, or all fail fast,
        together.  Returns the agreed ``values``.  On one device: raise
        ``err``, else return ``values``."""
        if self.grid is None:
            if err is not None:
                raise err
            return list(values)
        n = len(_PEER_ERRORS)
        code = 0
        if err is not None:
            kind = next((i for i, cls in enumerate(_PEER_ERRORS)
                         if isinstance(err, cls)), n - 1)
            code = 1 + kind + (0 if self.retry.is_transient(err) else n)
        out = self.grid.agree([code, *values])
        worst = int(out[0])
        if worst:
            if err is not None and code == worst:
                raise err
            cls = _PEER_ERRORS[(worst - 1) % n]
            raise cls(f"{cls.__name__} on another cell of the grid "
                      f"(every cell acts on the worst outcome)") from err
        return out[1:]

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

    def _dims(self, X) -> tuple[int, int, torch.dtype]:
        """(m, n, dtype) of the operand's global factors: on the grid the
        global entity count (n_pad of a sharded operand)."""
        if self.grid is None:
            m, n = operand_dims(X)
            return m, n, perturbed_values(X).dtype
        local, n = _grid_operand(self.grid, X)
        m = local.m if isinstance(local, BCSR) else local.shape[-3]
        return m, n, perturbed_values(local).dtype

    # -- checkpoints ---------------------------------------------------------

    def _fingerprint(self, X) -> dict:
        """What a unit checkpoint's validity depends on: the sweep config,
        the mode, the operand's ``io.manifest`` fingerprint (on the grid,
        cell 0's block or shard) and the grid's shape.  Unit uids are
        config-blind, so this guard is what stops a resume from reusing
        units of another configuration, other data or another grid."""
        grid = self.grid
        fp = dataclasses.asdict(self.cfg)
        local = X.sp if isinstance(X, CellShard) else X
        fp.update(mode=self.mode, manifest=manifest_of(local).fingerprint(),
                  mesh=None if grid is None else grid.shape)
        return fp

    def _check_ckpt_config(self, X) -> None:
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = os.path.join(self.ckpt_dir, "sweep.json")
        fp = json.loads(json.dumps(self._fingerprint(X)))
        if os.path.exists(path):
            with open(path) as f:
                stored = json.load(f)
            if stored != fp:
                bad = sorted(k for k in set(stored) | set(fp)
                             if stored.get(k) != fp.get(k))
                raise ValueError(
                    f"checkpoint dir {self.ckpt_dir!r} was written by a "
                    f"different sweep configuration (mismatched: {bad}); "
                    f"resuming would silently reuse stale units — use a "
                    f"fresh ckpt_dir or delete it")
            return
        ckpt.atomic_json_dump(path, fp, indent=1)

    def _unit_like(self, X, unit) -> dict:
        """The shapes and dtypes of a unit's checkpoint (meta tensors):
        the unit's global result."""
        m, n, dtype = self._dims(X)

        def like(*shape):
            return torch.empty(shape, dtype=dtype, device="meta")

        if isinstance(unit, GridChunk):
            c, km = len(unit.cells), unit.k_max
            return {"A": like(c, n, km), "R": like(c, m, km, km),
                    "errors": like(c)}
        r_u, k = len(unit.members), unit.k
        return {"A": like(r_u, n, k), "R": like(r_u, m, k, k),
                "errors": like(r_u)}

    @staticmethod
    def _restore(tag: str, like: dict, uid: str, dev):
        """The unit's tree from its newest verifiable step, or None when
        every step failed verification (quarantined, with its
        ckpt/quarantine event)."""
        with obs.span("sched/restore", uid=uid):
            try:
                tree, _ = ckpt.restore(tag, like, device=dev)
            except ckpt.CheckpointError:
                return None
        return tree

    def _try_restore(self, X, unit, dev) -> UnitOutcome | None:
        """The unit's checkpointed global result, or None to compute it.
        On the grid cell 0 decides (it restores, healing a torn step
        first); the decision reaches every cell through an agreement, then
        every cell reads the file, and a step that fails on any cell makes
        every cell recompute the unit."""
        if not self.ckpt_dir:
            return None
        tag = os.path.join(self.ckpt_dir, unit.uid)
        like = self._unit_like(X, unit)
        tree = None
        if self._lead and ckpt.latest_step(tag) is not None:
            tree = self._restore(tag, like, unit.uid, dev)
        if self.grid is not None:
            found, = self._agree(None, tree is not None)
            if not found:
                return None
            err = None
            if not self._lead:
                try:
                    tree = self._restore(tag, like, unit.uid, dev)
                except Exception as e:  # agreed below: no shared file
                    err = e
            torn, = self._agree(err, tree is None)
            if torn:
                return None
        if tree is None:
            return None
        if self.verbose:
            print(f"  [ckpt] reused {unit.uid}")
        return UnitOutcome(unit=unit, result=EnsembleResult(**tree),
                           seconds=0.0, reused=True, retries=0, attempts=0)

    def _join_pending_save(self) -> None:
        """Join the in-flight async checkpoint write, re-raising its
        failure."""
        handle, self._pending_save = self._pending_save, None
        if handle is not None:
            handle.join()

    def _surface_pending_save(self) -> None:
        """Surface a failed async write at this (the next) checkpoint
        boundary, on every cell of the grid."""
        if not self.ckpt_dir:
            return
        err = None
        try:
            self._join_pending_save()
        except Exception as e:  # agreed below, raised on every cell
            err = e
        self._agree(err)

    def _checkpoint(self, unit, res: EnsembleResult) -> None:
        """Write the unit's global result (cell 0 on the grid), after
        surfacing the previous async write; a failure of either is
        raised on every cell."""
        with obs.span("sched/checkpoint", uid=unit.uid):
            err = None
            try:
                self._join_pending_save()
                if self._lead:
                    tag = os.path.join(self.ckpt_dir, unit.uid)
                    if self.async_ckpt:
                        self._pending_save = ckpt.save_async(
                            tag, 0, res._asdict())
                    else:
                        ckpt.save(tag, 0, res._asdict())
            except Exception as e:  # agreed below, raised on every cell
                err = e
            self._agree(err)

    # -- execution -----------------------------------------------------------

    def _unit_deadline(self, attempt: int) -> float | None:
        """Per-attempt budget: a retried attempt's deadline shrinks to
        factor x the median unit time once the sweep has a baseline."""
        limit = self.retry.deadline
        if limit is None:
            return None
        base = self.stragglers.baseline
        if attempt > 0 and base is not None:
            limit = min(limit, self.stragglers.factor * base)
        return limit

    def _execute(self, X, unit, draws) -> EnsembleResult:
        grid = self.grid
        if grid is not None:
            if isinstance(unit, GridChunk):
                return run_grid_sweep_batched(grid, X, unit.cells, self.cfg,
                                              draws)
            return run_grid_ensemble(grid, X, unit.k, self.cfg, draws,
                                     members=unit.members)
        if isinstance(unit, GridChunk):
            return run_sweep_batched(X, unit.cells, self.cfg, draws)
        return run_ensemble(X, unit.k, self.cfg, draws,
                            members=unit.members, mode=self.mode)

    def _execute_unit(self, X, unit, draws, dev) -> UnitOutcome:
        grid = self.grid
        fb0 = ops.kernel_fallbacks()
        timing: dict[str, float] = {}

        def _attempt(attempt: int):
            err = None
            try:
                faults.probe("sched/unit", uid=unit.uid, attempt=attempt)
            except Exception as e:  # agreed before the unit's collectives
                err = e
            self._agree(err)
            with obs.span("sched/execute", uid=unit.uid, attempt=attempt):
                t0 = time.perf_counter()
                res = self._execute(X, unit, draws)
                err = None
                try:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                except Exception as e:  # agreed below
                    err = e
                dt = time.perf_counter() - t0
            # the grid's outcome, its slowest cell's time and fallbacks
            dt, fb = self._agree(err, dt, ops.kernel_fallbacks() - fb0)
            limit = self._unit_deadline(attempt) if grid is not None \
                else None
            if limit is not None and dt > limit:
                raise DeadlineExceeded(
                    f"attempt {attempt} took {dt:.3f}s on the slowest cell, "
                    f"over its {limit:.3f}s deadline")
            timing.update(dt=dt, fallbacks=fb)
            return res

        def _on_retry(next_attempt: int, err: BaseException,
                      pause: float) -> None:
            obs.event("sched/retry", uid=unit.uid, attempt=next_attempt,
                      backoff=round(pause, 6), error=type(err).__name__)
            if self.verbose:
                print(f"  [retry] {unit.uid} attempt {next_attempt} after "
                      f"{type(err).__name__} (backoff {pause:.3f}s)")

        # on the grid the deadline is judged at the closing agreement, so
        # no attempt runs on a thread that could be abandoned mid-collective
        res, stats = self.retry.call(
            _attempt, key=unit.uid, on_retry=_on_retry,
            deadline_fn=self._unit_deadline if grid is None
            else lambda attempt: None)
        dt = timing["dt"]
        if grid is not None:
            res = gather_unit(grid, res)
        # flagged durations stay out of the baseline
        straggler = self.stragglers.record(unit.index, dt)
        baseline = self.stragglers.baseline
        if straggler:
            print(f"  [straggler] {unit.uid} took {dt:.3f}s "
                  f"(baseline {baseline:.3f}s)")
            obs.event("sched/straggler", uid=unit.uid, seconds=dt,
                      baseline=baseline)
        if self.ckpt_dir:
            self._checkpoint(unit, res)
        return UnitOutcome(unit=unit, result=res, seconds=dt, reused=False,
                           retries=stats.attempts - 1,
                           attempts=stats.attempts,
                           backoff=stats.backoff_seconds,
                           straggler=straggler, baseline=baseline,
                           peak_host=read_host_memory().get("hwm_bytes"),
                           peak_device=device_watermark(dev),
                           fallbacks=int(timing["fallbacks"]))

    # -- reduction -----------------------------------------------------------

    def _reduce(self, X, k, rows, draws) -> KResult:
        """Reduce rank k from its (q, A, R, error) rows, in member
        order."""
        rows = sorted(rows, key=lambda row: row[0])
        A = torch.stack([a for _, a, _, _ in rows])
        R = torch.stack([r for _, _, r, _ in rows])
        errs = torch.stack([e for _, _, _, e in rows]).cpu().numpy()
        if self.grid is not None:
            return reduce_k_grid(self.grid, X, self.cfg, k, A, R, errs,
                                 draws)
        return reduce_k(X, self.cfg, k, A, R, errs, draws)

    def _rows(self, unit, res: EnsembleResult):
        """(k, q, A, R, error) per member of a unit's (global) result; a
        grid chunk's rows cropped to their own k."""
        if isinstance(unit, GridChunk):
            return [(k, q, res.A[i, :, :k], res.R[i, :, :k, :k],
                     res.errors[i]) for i, (k, q) in enumerate(unit.cells)]
        return [(unit.k, q, res.A[i], res.R[i], res.errors[i])
                for i, q in enumerate(unit.members)]

    # -- the sweep -----------------------------------------------------------

    def _prepare(self, X) -> None:
        """Check the operand against the grid, and the checkpoint
        fingerprint (cell 0 on the grid); a refusal on any cell is raised
        on every cell."""
        err = None
        try:
            if self.grid is not None:
                _grid_operand(self.grid, X)
            if self.ckpt_dir and self._lead:
                self._check_ckpt_config(X)
        except Exception as e:  # agreed below, raised on every cell
            err = e
        self._agree(err)

    def run(self, X) -> RescalkResult:
        cfg = self.cfg
        grid = self.grid
        dev = self._check_operand(X)
        self._prepare(X)
        if grid is None:
            X = single_device(X)          # a ShardedBCSR, merged once
        draws = self.draws if self.draws is not None else \
            TorchDraws(cfg.seed, dev)
        launches0 = ops.launch_counts()
        collectives0 = grid.collectives if grid is not None else 0
        pending: dict[int, list] = {k: [] for k in cfg.ks}
        per_k: dict[int, KResult] = {}
        records: list[UnitRecord] = []
        executed = 0
        for pos, unit in enumerate(self.units):
            out = self._try_restore(X, unit, dev)
            if out is None:
                # checked before computing: stop_after_units=N computes at
                # most N units (0 = resume only); every cell of the grid
                # counts the same units, so all stop at the same one
                if (self.stop_after_units is not None
                        and executed >= self.stop_after_units):
                    self._surface_pending_save()
                    raise SweepInterrupted(executed, pos, len(self.units),
                                           resumable=bool(self.ckpt_dir))
                out = self._execute_unit(X, unit, draws, dev)
                executed += 1
            records.append(out.record())
            res, out.result = out.result, None
            for k, q, A, R, err in self._rows(unit, res):
                pending[k].append((q, A, R, err))
            del res
            for k in cfg.ks:
                if len(pending.get(k, ())) == cfg.n_perturbations:
                    with obs.span("sched/reduce", k=k):
                        per_k[k] = r = self._reduce(X, k, pending.pop(k),
                                                    draws)
                    if self.verbose:
                        print(f"[sweep] k={k:3d} s_min={r.s_min:6.3f} "
                              f"s_mean={r.s_mean:6.3f} "
                              f"err={r.rel_err:7.4f}")
            tracer = obs.current()
            if tracer is not None:
                tracer.flush()      # a killed sweep keeps its trace to here
        self._surface_pending_save()

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
        meta = {"n_units": len(self.units),
                "n_retries": sum(r.retries for r in records),
                "n_stragglers": sum(1 for r in records if r.straggler),
                "n_kernel_fallbacks": sum(r.kernel_fallbacks
                                          for r in records),
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
        if self.verbose and self.ckpt_dir:
            print(f"[sweep] resumed {self.report.n_reused}/"
                  f"{len(self.units)} units from checkpoints in "
                  f"{self.ckpt_dir}")
        return result
