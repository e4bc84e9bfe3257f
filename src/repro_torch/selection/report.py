"""The sweep's JSON report (port of ``repro/selection/report.py``).

Field names are those of ``repro``'s ``SelectionReport``/``UnitRecord``,
so tools that read one read the other (``repro``'s
``SelectionReport.load`` reads the port's reports).  The fields of layers
the port has not reached yet (retry, checkpoints, memory watermarks) keep
their defaults; ``kernel_launches`` is the port's own addition to
``meta``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any


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
        folder = os.path.dirname(os.path.abspath(path))
        os.makedirs(folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_dict(), f, indent=1, default=str)
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
        return path
