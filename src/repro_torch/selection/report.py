"""The sweep's JSON report (port of ``repro/selection/report.py``).

Field names are those of ``repro``'s ``SelectionReport``/``UnitRecord``,
so tools that read one read the other (``repro``'s
``SelectionReport.load`` reads the port's reports).  The scheduler fills
every field: ``reused`` for a unit restored from its checkpoint,
``attempts``/``retries``/``backoff_seconds`` from the RetryPolicy,
``straggler``/``baseline_seconds`` from the StragglerMonitor,
``kernel_fallbacks`` from the injected fallbacks within the unit, and
``peak_host_bytes`` / ``peak_device_bytes`` from the watermarks read at
its end (the device one ``None`` on the CPU); ``kernel_launches`` and
``device`` are the port's own additions to ``meta``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.ckpt import atomic_json_dump


@dataclasses.dataclass
class UnitRecord:
    """Execution record for one (k, members) work unit."""
    uid: str
    k: int
    members: list[int]
    seconds: float
    reused: bool
    retries: int
    cells: list[list[int]] | None = None
    straggler: bool = False
    baseline_seconds: float | None = None
    peak_host_bytes: int | None = None
    peak_device_bytes: int | None = None
    kernel_fallbacks: int = 0
    attempts: int | None = None
    backoff_seconds: float = 0.0
    fail_fast: bool = False


@dataclasses.dataclass
class SelectionReport:
    ks: list[int]
    s_min: list[float]
    s_mean: list[float]
    rel_err: list[float]
    k_opt: int
    criterion: str
    mode: str                      # "batched"
    n_perturbations: int
    units: list[UnitRecord] = dataclasses.field(default_factory=list)
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def total_seconds(self) -> float:
        return float(sum(u.seconds for u in self.units))

    @property
    def n_reused(self) -> int:
        return sum(1 for u in self.units if u.reused)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["total_seconds"] = self.total_seconds
        d["n_reused"] = self.n_reused
        return d

    def save(self, path: str) -> str:
        """Write the report atomically (temp file + rename)."""
        return atomic_json_dump(path, self.to_dict(), indent=1, default=str)
