"""The port's telemetry (port of ``repro/obs``), off unless installed.

* `obs.trace`   — host spans / structured events (JSONL + Chrome export).
* `obs.metrics` — per-iteration trajectories out of the MU steps, recorded
  only under the `trace_metrics` flag.
* `obs.costs`   — achieved-vs-model FLOP/byte accounting per unit.
* `obs.memory`  — the byte ledger: represented-vs-resident accounting,
  per-rank peaks of an executed MU iteration, host and CUDA watermarks
  (`memory.json` trace artifact).

`obs.trace` is stdlib-only; `obs.memory` and `obs.metrics` import torch
and numpy; `obs.memory` imports the MU steps it measures lazily.
"""
from repro_torch.obs.memory import (HostMemorySampler, MemoryLedger,
                                    read_host_memory)
from repro_torch.obs.trace import (Tracer, current, event, install, span,
                                   timed, tracing)

__all__ = [
    "HostMemorySampler",
    "MemoryLedger",
    "Tracer",
    "current",
    "event",
    "install",
    "read_host_memory",
    "span",
    "timed",
    "tracing",
]
