"""The RESCALk model-selection sweep of the port: dense and BCSR operands
on one device (batched, loop and cross-k grid modes, with per-unit
checkpoints, retry and fault seams), and dense or BCSR operands on the 2D
process grid (batched and cross-k grid modes, with the same checkpoints,
pods and retries, agreed by every cell)."""
from .criteria import CRITERIA
from .draws import ArrayDraws, TorchDraws
from .ensemble import (EnsembleResult, grid_init, run_ensemble,
                       run_grid_ensemble, run_grid_sweep_batched,
                       run_sweep_batched)
from .report import SelectionReport, UnitRecord
from .scheduler import (GridChunk, SweepInterrupted, SweepScheduler,
                        UnitOutcome, WorkUnit, gather_unit, plan_sweep,
                        reduce_k, reduce_k_grid)
from .types import INITS, KResult, RescalkConfig, RescalkResult

__all__ = ["CRITERIA", "INITS", "ArrayDraws", "EnsembleResult", "GridChunk",
           "KResult", "RescalkConfig", "RescalkResult", "SelectionReport",
           "SweepInterrupted", "SweepScheduler", "TorchDraws",
           "UnitOutcome", "UnitRecord", "WorkUnit",
           "gather_unit", "grid_init", "plan_sweep", "reduce_k",
           "reduce_k_grid", "run_ensemble", "run_grid_ensemble",
           "run_grid_sweep_batched", "run_sweep_batched"]
