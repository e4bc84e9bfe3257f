"""Host-side spans and structured events (port of ``repro/obs/trace.py``;
the port keeps its own copy, stdlib only).

A `Tracer` records nested spans (``with span("sched/execute"): ...``) and
instant events as JSONL records, one JSON object per line, flushed
incrementally so a killed sweep still leaves a readable trace.  Each record
carries a monotonic timestamp (`time.perf_counter`, microseconds since the
tracer was created), the pid/tid that emitted it, and arbitrary key/value
args (unit uids, outcomes).  `export_chrome` rewrites the event list into
Chrome `trace_event` format, so a whole sweep renders in Perfetto /
`chrome://tracing` with no post-processing.

Spans are host time.  CUDA launches return before the device finishes, so
a span that is meant to time device work closes after a synchronisation
its code already makes (the scheduler's per-unit ``synchronize``, the
serve engine's copy of the scores to the host); tracing adds none.  The
port compiles no XLA programs, so no ``xla/compile`` event is ever
emitted and `summarize` reports ``compile events: 0``.

Zero-cost-off contract: the module-level helpers (`span`, `event`, `timed`)
consult the installed tracer at call time.  With no tracer installed they
return a shared `contextlib.nullcontext()` / return immediately: no
allocation and no I/O.
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


class Tracer:
    """Collects span/event records; optionally streams them to a JSONL file.

    Thread-safe: the host-memory sampler emits from its own thread, so
    every append happens under one lock and span begin/end pairing is
    keyed by thread id.
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
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            self._file = open(os.path.join(out_dir, "trace.jsonl"), "w")
        # Anchor record: ties the monotonic clock to wall time + run metadata.
        self._emit({"ph": "M", "name": "trace_start", "ts": 0.0,
                    "pid": self._pid, "tid": threading.get_ident(),
                    "args": {"unix_time": time.time(), **(meta or {})}})

    # -- low-level ----------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * _US

    def _emit(self, rec: dict[str, Any]) -> None:
        with self._lock:
            self.events.append(rec)
            if self._file is not None:
                self._file.write(json.dumps(rec) + "\n")
                self._file.flush()

    # -- public API ---------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[None]:
        """Nested timed region.  Emits a B record on entry and an E record
        (with duration and ok/error outcome) on exit, exception-safe."""
        tid = threading.get_ident()
        t0 = self._now_us()
        self._emit({"ph": "B", "name": name, "ts": t0, "pid": self._pid,
                    "tid": tid, "args": dict(attrs)})
        outcome = "ok"
        try:
            yield
        except BaseException:
            outcome = "error"
            raise
        finally:
            t1 = self._now_us()
            self._emit({"ph": "E", "name": name, "ts": t1, "pid": self._pid,
                        "tid": tid, "dur": t1 - t0,
                        "args": {**attrs, "outcome": outcome}})

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
    """`with span("sched/execute", uid=...):` — no-op when untraced."""
    tracer = _TRACER
    if tracer is None:
        return _NULL
    return tracer.span(name, **attrs)


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
