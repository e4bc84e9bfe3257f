"""Sweep configuration and result types (port of
``repro/selection/types.py``) — numpy only at import.

``RescalkConfig`` keeps ``repro``'s field names and defaults for what the
port runs.  ``kernel`` is a ``kernels.KernelPolicy``; ``schedule`` is the
dense MU schedule, one of ``core.rescal.MU_SCHEDULES`` (the BCSR sweep
runs only the batched one, as ``repro``'s does, and refuses another);
``init`` is one of ``INITS`` ("nndsvd" on dense operands outside the
cross-k grid only, as in ``repro``); ``sanitize`` and ``trace_metrics``
reach every MU step of the sweep (the runtime factor checks, and the
per-iteration metrics of ``obs.metrics``).  Not ported: ``repro``'s
deprecated aliases (``use_fused_kernel``/``fused_impl``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels.policy import KernelPolicy

INITS = ("random", "nndsvd")


@dataclasses.dataclass(frozen=True)
class RescalkConfig:
    k_min: int = 2
    k_max: int = 8
    n_perturbations: int = 10          # r
    perturbation_delta: float = 0.02   # noise half-width (paper: [0.005, .03])
    rescal_iters: int = 1000           # paper §6.2.1 uses 1000
    regress_iters: int = 100
    init: str = "random"               # "random" | "nndsvd" (paper §6.1.3)
    schedule: str = "batched"          # "batched" | "sliced" (paper-faithful)
    seed: int = 0
    sil_threshold: float = 0.75        # stability bar for k selection
    kernel: KernelPolicy = KernelPolicy()
    # runtime factor sanitizer (analysis.sanitizer): finite / non-negative
    # / masked-columns-zero checks after every MU step; each check waits
    # for the device, so it is off by default
    sanitize: bool = False
    # per-iteration telemetry (obs.metrics): rel_error / factor-norm /
    # mu-ratio trajectories recorded by every MU step; off by default, and
    # then no step computes or records them
    trace_metrics: bool = False

    def __post_init__(self):
        from repro_torch.core.rescal import check_schedule
        check_schedule(self.schedule)
        if self.init not in INITS:
            raise ValueError(f"init must be one of {INITS}, "
                             f"got {self.init!r}")

    @property
    def ks(self) -> list[int]:
        return list(range(self.k_min, self.k_max + 1))


@dataclasses.dataclass
class KResult:
    k: int
    s_min: float
    s_mean: float
    rel_err: float
    A_median: np.ndarray               # (n, k)
    R_regress: np.ndarray              # (m, k, k)
    member_errors: np.ndarray          # (r,)


@dataclasses.dataclass
class RescalkResult:
    ks: np.ndarray
    s_min: np.ndarray                  # stability per k
    s_mean: np.ndarray
    rel_err: np.ndarray                # reconstruction error per k
    k_opt: int
    per_k: dict[int, KResult]

    def summary(self) -> str:
        lines = ["  k   s_min   s_mean  rel_err"]
        for i, k in enumerate(self.ks):
            mark = " <== k_opt" if k == self.k_opt else ""
            lines.append(f"{k:3d}  {self.s_min[i]:6.3f}  {self.s_mean[i]:6.3f}"
                         f"  {self.rel_err[i]:7.4f}{mark}")
        return "\n".join(lines)
