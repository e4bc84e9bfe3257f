"""The RESCALk model-selection sweep of the port (batched mode on BCSR
operands)."""
from .criteria import CRITERIA
from .draws import ArrayDraws, TorchDraws
from .ensemble import EnsembleResult, run_ensemble
from .report import SelectionReport, UnitRecord
from .scheduler import SweepScheduler, WorkUnit, plan_sweep, reduce_k
from .types import KResult, RescalkConfig, RescalkResult

__all__ = ["CRITERIA", "ArrayDraws", "EnsembleResult", "KResult",
           "RescalkConfig", "RescalkResult", "SelectionReport",
           "SweepScheduler", "TorchDraws", "UnitRecord", "WorkUnit",
           "plan_sweep", "reduce_k", "run_ensemble"]
