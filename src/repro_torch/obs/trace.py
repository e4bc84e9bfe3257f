"""Host-side spans and structured events (port of ``repro/obs/trace.py``;
the port keeps its own copy, stdlib only).

A `Tracer` records nested spans (``with span("sched/execute"): ...``) and
instant events as JSONL records, one JSON object per line.  Each record
carries a monotonic timestamp (`time.perf_counter`, microseconds since the
tracer was created), the pid/tid that emitted it, and arbitrary key/value
args (unit uids, outcomes).  `export_chrome` rewrites the event list into
Chrome `trace_event` format, so a whole sweep renders in Perfetto /
`chrome://tracing` with no post-processing.

The file is written in batches: the records since the last write go out
every ``FLUSH_EVERY`` records, on `Tracer.flush` and on `close`.  The
sweep scheduler calls `flush` at the end of each unit, so a killed sweep
still leaves a readable trace up to its last finished unit; only the
records after it are lost.

One span, two sinks: while a tracer is installed and a ``torch.profiler``
session records, each span also opens a profiler range of the same name
(a user annotation).  The program's spans then land in the profile with
the device's operations, on the profiler's clock, and each operation can
be traced to the innermost span open when it was launched.  torch is
imported on the first span of an installed tracer, so the module itself
stays importable without it.

Spans are host time.  CUDA launches return before the device finishes, so
a span that is meant to time device work closes after a synchronisation
its code already makes (the scheduler's per-unit ``synchronize``, the
serve engine's copy of the scores to the host); tracing adds none, and a
span's args are host values already at hand, never read from the device.
The spans inside an MU iteration (``mu/*``, ``grid/*``) close without a
sync: their device time is read from the profile, by launch.  The port
compiles no XLA programs, so no ``xla/compile`` event is ever emitted and
`summarize` reports ``compile events: 0``.

Zero-cost-off contract: the module-level helpers (`span`, `event`, `timed`)
consult the installed tracer at call time.  With no tracer installed they
return a shared `contextlib.nullcontext()` / return immediately: no
allocation, no profiler range and no I/O.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, IO, Iterator

__all__ = [
    "Tracer",
    "current",
    "event",
    "install",
    "span",
    "timed",
    "tracing",
]

_US = 1e6  # perf_counter seconds -> trace microseconds
# records held before the file is written, between explicit flushes
FLUSH_EVERY = 1024


_RANGES: tuple | None = None


def _range_api() -> tuple:
    """(is a profiler recording, open a range, close it): torch's own
    calls, bound on the first span of an installed tracer."""
    global _RANGES
    if _RANGES is None:
        from torch._C import _autograd
        _RANGES = (_autograd._profiler_enabled,
                   _autograd._record_function_with_args_enter,
                   _autograd._record_function_with_args_exit)
    return _RANGES


def _open_range(name: str):
    """Open a profiler range ``name`` if a ``torch.profiler`` session is
    recording; its handle, or None."""
    recording, enter, _ = _RANGES or _range_api()
    return enter(name) if recording() else None


class _Span:
    """One open span of a `Tracer` (``Tracer.span``).  Entering yields a
    dict whose items join the closing record's args: counters the caller
    computes inside the span."""

    __slots__ = ("tracer", "name", "attrs", "closing", "t0", "tid",
                 "handle")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict[str, Any]):
        # ``attrs`` is the caller's fresh ``**attrs`` dict: the B record
        # keeps it, the E record gets a new one
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.closing: dict[str, Any] = {}

    def __enter__(self) -> dict[str, Any]:
        tr = self.tracer
        self.t0 = t0 = (time.perf_counter() - tr._t0) * _US
        self.tid = tid = threading.get_ident()
        tr._emit({"ph": "B", "name": self.name, "ts": t0, "pid": tr._pid,
                  "tid": tid, "args": self.attrs})
        self.handle = _open_range(self.name)
        return self.closing

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.handle is not None:
            _RANGES[2](self.handle)
        tr = self.tracer
        t1 = (time.perf_counter() - tr._t0) * _US
        tr._emit({"ph": "E", "name": self.name, "ts": t1, "pid": tr._pid,
                  "tid": self.tid, "dur": t1 - self.t0,
                  "args": {**self.attrs, **self.closing,
                           "outcome": "ok" if exc_type is None
                           else "error"}})


class Tracer:
    """Collects span/event records; optionally writes them to a JSONL file
    in batches (module docstring).

    Thread-safe: the host-memory sampler emits from its own thread; one
    append to the record list is atomic, the file's writes and the
    exports' copies happen under one lock (a flush writes the records
    counted when it took the lock; later ones wait for the next), and
    span begin/end pairing is keyed by thread id.
    """

    def __init__(self, out_dir: str | None = None, *,
                 meta: dict[str, Any] | None = None):
        self.out_dir = out_dir
        self.events: list[dict[str, Any]] = []
        # host-RSS watermark sampler (obs.memory); attached by `tracing`
        self.memory_sampler: Any | None = None
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._file: IO[str] | None = None
        self._written = 0            # records already in the file
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            self._file = open(os.path.join(out_dir, "trace.jsonl"), "w")
        # Anchor record: ties the monotonic clock to wall time + run metadata.
        self._emit({"ph": "M", "name": "trace_start", "ts": 0.0,
                    "pid": self._pid, "tid": threading.get_ident(),
                    "args": {"unix_time": time.time(), **(meta or {})}})
        self.flush()

    # -- low-level ----------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * _US

    def _emit(self, rec: dict[str, Any]) -> None:
        # one append is atomic: the lock guards the writes and the copies
        self.events.append(rec)
        if self._file is not None and \
                len(self.events) - self._written >= FLUSH_EVERY:
            self.flush()

    def flush(self) -> None:
        """Write the records not yet in the file, and flush it."""
        with self._lock:
            if self._file is None:
                return
            n = len(self.events)
            for rec in self.events[self._written:n]:
                self._file.write(json.dumps(rec) + "\n")
            self._written = n
            self._file.flush()

    # -- public API ---------------------------------------------------------

    def span(self, name: str, **attrs: Any) -> _Span:
        """Nested timed region, with a profiler range of the same name
        while a profiler records.  Emits a B record on entry and an E
        record (with duration, ok/error outcome and the items put in the
        dict that entering yields) on exit, exception-safe."""
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Instant (zero-duration) event."""
        self._emit({"ph": "i", "name": name, "ts": self._now_us(),
                    "pid": self._pid, "tid": threading.get_ident(),
                    "args": dict(attrs)})

    # -- export / summary ---------------------------------------------------

    def export_chrome(self, path: str) -> None:
        """Write the Chrome `trace_event` JSON (Perfetto-renderable)."""
        out: list[dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": self._pid, "tid": 0,
             "args": {"name": "rescalk"}}]
        with self._lock:
            events = list(self.events)
        for rec in events:
            ph = rec.get("ph")
            if ph in ("B", "E"):
                out.append({"ph": ph, "name": rec["name"], "ts": rec["ts"],
                            "pid": rec["pid"], "tid": rec["tid"],
                            "cat": rec["name"].split("/")[0],
                            "args": rec.get("args", {})})
            elif ph == "i":
                out.append({"ph": "i", "s": "t", "name": rec["name"],
                            "ts": rec["ts"], "pid": rec["pid"],
                            "tid": rec["tid"],
                            "cat": rec["name"].split("/")[0],
                            "args": rec.get("args", {})})
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)

    def summarize(self) -> str:
        """Per-span-name count/total-seconds table + compile event count
        (always 0 here: the port compiles no XLA programs)."""
        totals: dict[str, list[float]] = {}
        compiles = 0
        with self._lock:
            events = list(self.events)
        for rec in events:
            if rec.get("ph") == "E":
                totals.setdefault(rec["name"], []).append(
                    rec.get("dur", 0.0) / _US)
            elif rec.get("ph") == "i" and rec["name"] == "xla/compile":
                compiles += 1
        lines = [f"{'span':<28} {'count':>5} {'total_s':>9}"]
        for name in sorted(totals):
            durs = totals[name]
            lines.append(f"{name:<28} {len(durs):>5} {sum(durs):>9.3f}")
        lines.append(f"compile events: {compiles}")
        return "\n".join(lines)

    def close(self) -> None:
        self.flush()
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# -- module-global installation (mirrors analysis.sanitizer's channel) ------

_TRACER: Tracer | None = None
# nullcontext is stateless -> safe to hand out one shared instance.
_NULL = contextlib.nullcontext()


def install(tracer: Tracer | None) -> Tracer | None:
    """Install `tracer` as the process-wide target; returns the previous
    one."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def current() -> Tracer | None:
    return _TRACER


@contextlib.contextmanager
def tracing(out_dir: str | None = None, *,
            meta: dict[str, Any] | None = None,
            sample_memory: bool = False,
            sample_interval: float = 0.25) -> Iterator[Tracer]:
    """Scoped install: create a Tracer, install it, restore + close on exit.

    With ``sample_memory=True`` the tracer also owns a background host-RSS
    watermark sampler (`obs.memory.HostMemorySampler`) for its lifetime —
    started after install (so its `mem/sample` instants land in this trace)
    and stopped before teardown; the sampler survives on
    ``tracer.memory_sampler`` for peak readout.
    """
    tracer = Tracer(out_dir, meta=meta)
    prev = install(tracer)
    if sample_memory:
        from repro_torch.obs.memory import HostMemorySampler
        tracer.memory_sampler = HostMemorySampler(sample_interval).start()
    try:
        yield tracer
    finally:
        if tracer.memory_sampler is not None:
            tracer.memory_sampler.stop()
        install(prev)
        tracer.close()


def span(name: str, **attrs: Any):
    """`with span("sched/execute", uid=...):` — no-op when untraced.
    ``with span("mu/iter") as closing:`` gives the closing record's extra
    args dict when traced, None when not."""
    tracer = _TRACER
    if tracer is None:
        return _NULL
    return _Span(tracer, name, attrs)


def event(name: str, **attrs: Any) -> None:
    tracer = _TRACER
    if tracer is not None:
        tracer.event(name, **attrs)


class _Stopwatch:
    """Result handle for `timed`; `.seconds` is valid after the block exits."""

    seconds: float = 0.0


@contextlib.contextmanager
def timed(name: str, **attrs: Any) -> Iterator[_Stopwatch]:
    """A span that also hands the measured duration back to the caller —
    one clock for timings and traces.  Works (as a pure timer) even with
    no tracer installed."""
    sw = _Stopwatch()
    t0 = time.perf_counter()
    try:
        with span(name, **attrs):
            yield sw
    finally:
        sw.seconds = time.perf_counter() - t0
