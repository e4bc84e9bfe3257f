"""The RESCALk model-selection sweep of the port (batched mode: BCSR
operands on one device, dense operands on the 2D process grid)."""
from .criteria import CRITERIA
from .draws import ArrayDraws, TorchDraws
from .ensemble import EnsembleResult, run_ensemble, run_grid_ensemble
from .report import SelectionReport, UnitRecord
from .scheduler import (SweepScheduler, WorkUnit, plan_sweep, reduce_k,
                        reduce_k_grid)
from .types import KResult, RescalkConfig, RescalkResult

__all__ = ["CRITERIA", "ArrayDraws", "EnsembleResult", "KResult",
           "RescalkConfig", "RescalkResult", "SelectionReport",
           "SweepScheduler", "TorchDraws", "UnitRecord", "WorkUnit",
           "plan_sweep", "reduce_k", "reduce_k_grid", "run_ensemble",
           "run_grid_ensemble"]
