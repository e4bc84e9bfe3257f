"""Memory observability — the byte half of the port's ``obs`` (port of
``repro/obs/memory.py``).

Three layers, joined into one ``MemoryLedger`` (the ``memory.json`` trace
artifact):

* **represented vs resident** — the manifest's ``logical_bytes`` (the
  dense tensor the dataset stands for) against ``resident_bytes`` (what
  the device holds), via ``io.manifest.DatasetManifest.byte_ledger``;
* **per-rank peaks** — ``measure_mu_memory``: one executed single-member
  MU iteration per rank, between ``torch.cuda.reset_peak_memory_stats``
  and ``max_memory_allocated`` (``repro`` asks XLA's AOT analysis of the
  compiled program instead; the port has no compiled program to ask);
* **runtime watermarks** — a stdlib host-RSS sampler (``/proc/self/status``
  + ``resource.getrusage`` high-water mark; background thread owned by the
  tracer) and the CUDA allocator's peak (``device_watermark``).

A quantity the run cannot know is ``None`` (or an empty per-rank entry):
unknown, never 0.
"""
from __future__ import annotations

import dataclasses
import json
import os
import resource
import sys
import threading
import time
from typing import Any

import torch

from repro_torch.obs import trace as obs

__all__ = [
    "HostMemorySampler",
    "MemoryLedger",
    "accounted_ensemble_bytes",
    "device_watermark",
    "measure_mu_memory",
    "read_host_memory",
]

_KIB = 1024

# dtype-string -> itemsize for the manifest-based accounting
_ITEMSIZE = {"float16": 2, "bfloat16": 2, "float32": 4, "float64": 8,
             "int8": 1, "int16": 2, "int32": 4, "int64": 8}


def _itemsize(dtype: str) -> int:
    return _ITEMSIZE.get(str(dtype), 4)


# ---------------------------------------------------------------------------
# Watermarks
# ---------------------------------------------------------------------------

def read_host_memory() -> dict[str, int]:
    """Current host memory of this process: ``{"rss_bytes", "hwm_bytes"}``.

    Linux: ``/proc/self/status`` VmRSS (current resident set) and VmHWM
    (the kernel-maintained high-water mark — it cannot miss a spike the
    way a sampler can).  Elsewhere: ``resource.getrusage`` ``ru_maxrss``
    stands in for both (KiB on Linux, bytes on macOS).
    """
    out: dict[str, int] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss_bytes"] = int(line.split()[1]) * _KIB
                elif line.startswith("VmHWM:"):
                    out["hwm_bytes"] = int(line.split()[1]) * _KIB
    except OSError:
        pass
    if "hwm_bytes" not in out:
        ru = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        hwm = ru if sys.platform == "darwin" else ru * _KIB
        out["hwm_bytes"] = hwm
        out.setdefault("rss_bytes", hwm)
    return out


def device_watermark(device: str | torch.device | None) -> int | None:
    """The CUDA allocator's peak bytes on ``device`` since the last reset
    (``torch.cuda.max_memory_allocated``), or ``None`` for a CPU run."""
    if device is None or torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


class HostMemorySampler:
    """Background host-RSS watermark sampler (stdlib daemon thread).

    The tracer path (``rescalk_run --trace``) starts one for the run and
    stops it when artifacts flush.  Each tick reads ``/proc`` RSS, keeps
    ``(t_seconds, rss_bytes)`` samples plus the running peak, and — when
    a tracer is installed — emits a ``mem/sample`` instant so the
    Perfetto view carries an RSS track.  ``peak_bytes`` folds in the
    kernel VmHWM, so a spike between ticks is still accounted.
    """

    def __init__(self, interval: float = 0.25, *,
                 emit_events: bool = True):
        self.interval = float(interval)
        self.emit_events = emit_events
        self.samples: list[tuple[float, int]] = []
        self.peak_rss_bytes = 0
        self._t0 = time.perf_counter()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def sample_once(self) -> int:
        rss = read_host_memory().get("rss_bytes", 0)
        self.samples.append((time.perf_counter() - self._t0, rss))
        if rss > self.peak_rss_bytes:
            self.peak_rss_bytes = rss
        if self.emit_events:
            obs.event("mem/sample", rss_bytes=rss)
        return rss

    def start(self) -> "HostMemorySampler":
        if self._thread is not None:
            return self
        self.sample_once()
        self._thread = threading.Thread(target=self._loop,
                                        name="obs-mem-sampler", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.sample_once()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        self.sample_once()

    @property
    def peak_bytes(self) -> int:
        """max(sampled RSS, kernel high-water mark)."""
        return max(self.peak_rss_bytes,
                   read_host_memory().get("hwm_bytes", 0))


# ---------------------------------------------------------------------------
# Per-rank peaks of one executed MU iteration
# ---------------------------------------------------------------------------

def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def measure_mu_memory(operand: Any, ks: list[int], *, policy=None,
                      schedule: str = "batched"
                      ) -> dict[int, dict[str, int]]:
    """Bytes of one single-member MU iteration of the sweep's step per
    rank k, on the operand's device: ``argument`` (X, A and R), ``output``
    (the new A and R), ``temp`` (the allocator's peak during the step
    minus the bytes allocated before it) and ``peak`` (that peak).

    CUDA only: it resets the allocator's peak statistics, so a caller
    reads ``device_watermark`` first.  Its launches count in the kernels'
    launch counters like any other.  On the CPU the allocator keeps no
    statistics and the result is ``{}``.
    """
    from repro_torch.core.rescal import (EPS_DEFAULT, MU_SCHEDULES,
                                         RescalState)
    from repro_torch.core.sparse import BCSR, sparse_mu_step

    sparse = isinstance(operand, BCSR)
    dev = operand.device
    if dev.type != "cuda":
        return {}
    if sparse:
        m, n = operand.m, operand.n
        x_bytes = _nbytes(operand.data, operand.block_rows,
                          operand.block_cols, operand.row_ptr)
        dtype = operand.data.dtype
    else:
        m, n = operand.shape[0], operand.shape[1]
        x_bytes = _nbytes(operand)
        dtype = operand.dtype
    gen = torch.Generator(dev).manual_seed(0)
    out: dict[int, dict[str, int]] = {}
    for k in ks:
        A = torch.rand((n, k), generator=gen, device=dev, dtype=dtype)
        R = torch.rand((m, k, k), generator=gen, device=dev, dtype=dtype)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        if sparse:
            A2, R2 = sparse_mu_step(operand, A, R, EPS_DEFAULT,
                                    policy=policy)
        else:
            st = MU_SCHEDULES[schedule](operand, RescalState(A=A, R=R,
                                                             step=0),
                                        EPS_DEFAULT, policy=policy)
            A2, R2 = st.A, st.R
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))
        out[int(k)] = {"argument": x_bytes + _nbytes(A, R),
                       "output": _nbytes(A2, R2),
                       "temp": peak - before, "peak": peak}
        del A, R, A2, R2
    return out


def accounted_ensemble_bytes(manifest: Any, *, n_members: int,
                             k_max: int) -> int:
    """Accounted peak residency of one batched ensemble over the
    manifested operand: the unperturbed stored bytes plus ``n_members``
    live perturbed copies, plus the factor ensembles (A dominates R at
    sweep shapes) — ``repro``'s formula.
    """
    itemsize = _itemsize(manifest.dtype)
    factor_bytes = n_members * (manifest.n_factor * k_max
                                + manifest.m * k_max * k_max) * itemsize
    return int(manifest.resident_bytes) * (1 + n_members) + factor_bytes


# ---------------------------------------------------------------------------
# The ledger
# ---------------------------------------------------------------------------

def _atomic_json_dump(path: str, doc: Any) -> str:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return path


@dataclasses.dataclass
class MemoryLedger:
    """One sweep's byte ledger — represented vs resident vs peaks.

    Serialized as the ``memory.json`` trace artifact (validated by
    ``scripts/check_trace.py --expect-memory``):

    * ``logical_bytes``  — dense bytes the operand *represents*;
    * ``resident_bytes`` — bytes the device holds (stored blocks +
      indices) — manifest-accounted;
    * ``per_k``          — argument/output/temp/peak bytes of one executed
      rank-k MU iteration (``measure_mu_memory``);
    * ``peak_host_bytes`` / ``peak_device_bytes`` — runtime watermarks
      (``None`` = not known, never 0);
    * ``kernel_fallbacks`` — ``kernel/fallback`` instants in the trace
      (the port's wrappers launch or raise, so 0).
    """
    kind: str
    logical_bytes: int
    resident_bytes: int
    per_k: dict[int, dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    peak_host_bytes: int | None = None
    peak_device_bytes: int | None = None
    accounted_sweep_bytes: int | None = None
    kernel_fallbacks: int = 0
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def compression(self) -> float:
        """logical / resident — the exascale ratio."""
        return self.logical_bytes / max(self.resident_bytes, 1)

    @classmethod
    def from_manifest(cls, manifest: Any, **kw: Any) -> "MemoryLedger":
        """Start a ledger from the manifest's byte accounting
        (``DatasetManifest.byte_ledger``)."""
        led = manifest.byte_ledger()
        return cls(kind=led["kind"], logical_bytes=led["logical_bytes"],
                   resident_bytes=led["resident_bytes"], **kw)

    def device_peak(self) -> int | None:
        """Best available device-side peak: the runtime allocator
        watermark when known, else the largest per-rank peak; ``None``
        when neither exists."""
        if self.peak_device_bytes:
            return self.peak_device_bytes
        peaks = [e["peak"] for e in self.per_k.values() if "peak" in e]
        return max(peaks) if peaks else None

    # -- IO -----------------------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return {
            "ledger": {"kind": self.kind,
                       "logical_bytes": int(self.logical_bytes),
                       "resident_bytes": int(self.resident_bytes),
                       "compression": self.compression},
            "per_k": {str(k): dict(v) for k, v in sorted(self.per_k.items())},
            "runtime": {"peak_host_bytes": self.peak_host_bytes,
                        "peak_device_bytes": self.peak_device_bytes,
                        "accounted_sweep_bytes": self.accounted_sweep_bytes},
            "fallbacks": {"count": int(self.kernel_fallbacks)},
            "meta": dict(self.meta),
        }

    def save(self, path: str) -> str:
        return _atomic_json_dump(path, self.to_dict())

    @classmethod
    def load(cls, path: str) -> "MemoryLedger":
        with open(path) as f:
            d = json.load(f)
        led, rt = d["ledger"], d.get("runtime", {})
        return cls(kind=led["kind"], logical_bytes=led["logical_bytes"],
                   resident_bytes=led["resident_bytes"],
                   per_k={int(k): v for k, v in d.get("per_k", {}).items()},
                   peak_host_bytes=rt.get("peak_host_bytes"),
                   peak_device_bytes=rt.get("peak_device_bytes"),
                   accounted_sweep_bytes=rt.get("accounted_sweep_bytes"),
                   kernel_fallbacks=d.get("fallbacks", {}).get("count", 0),
                   meta=d.get("meta", {}))

    # -- rendering ----------------------------------------------------------

    def summary_line(self) -> str:
        """The one-line sweep statement (``[obs] memory: ...``)."""
        dev = self.device_peak()
        parts = [f"represented {self.logical_bytes / 2**30:.2f} GiB",
                 f"resident {self.resident_bytes / 2**20:.1f} MiB "
                 f"({self.compression:.0f}x)"]
        if self.peak_host_bytes is not None:
            parts.append(f"host peak {self.peak_host_bytes / 2**20:.1f} MiB")
        parts.append("device peak "
                     + (f"{dev / 2**20:.1f} MiB" if dev is not None
                        else "n/a"))
        if self.kernel_fallbacks:
            parts.append(f"{self.kernel_fallbacks} kernel fallback(s)")
        return ", ".join(parts)

    def summarize(self) -> str:
        """Multi-line ledger table for summary.txt."""
        lines = [f"memory ledger ({self.kind}): {self.summary_line()}"]
        if self.accounted_sweep_bytes is not None:
            lines.append(f"accounted sweep residency: "
                         f"{self.accounted_sweep_bytes / 2**20:.1f} MiB")
        if self.per_k:
            hdr = (f"{'k':>4} {'arg_MiB':>9} {'out_MiB':>9} "
                   f"{'temp_MiB':>9} {'peak_MiB':>9}")
            lines += [hdr, "-" * len(hdr)]
            for k, e in sorted(self.per_k.items()):
                if not e:
                    lines.append(f"{k:>4} {'(not measured)':>38}")
                    continue
                lines.append(
                    f"{k:>4} {e['argument'] / 2**20:>9.3f} "
                    f"{e['output'] / 2**20:>9.3f} "
                    f"{e['temp'] / 2**20:>9.3f} "
                    f"{e['peak'] / 2**20:>9.3f}")
        return "\n".join(lines)
