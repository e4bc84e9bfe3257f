"""One run of one cell: set-up, the measured window (traced or not), the
comparison with the reference, and the result line's fields."""
from __future__ import annotations

import sys
import time

import torch

from portbench.drivers import synchronize

from . import compare, profile, spec

# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "chip_smoke")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, whole)
    is one of ``FORBIDDEN``."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


class Context:
    """What a metric's reader gets: the cell's ``config`` and ``traffic``;
    what the window finished (``work``, the driver's ``work()``); the
    window's and set-up's seconds and the window's allocator peak
    (``window_s``, ``setup_s``, ``peak_bytes``); and in a traced run the
    window's ``timeline`` (None otherwise)."""

    def __init__(self, config: dict, traffic: dict, work: dict,
                 window_s: float, setup_s: float, peak_bytes: int,
                 timeline=None):
        self.config, self.traffic, self.work = config, traffic, work
        self.window_s, self.setup_s = window_s, setup_s
        self.peak_bytes = peak_bytes
        self.timeline = timeline
        self.share = config["share"]
        self.k = config["k"]


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, *, config: dict | None = None,
             control: bool = False) -> dict:
    """Run cell ``name`` once and return the result line's fields.
    ``t_start`` is the process's start on ``time.perf_counter``'s clock.
    ``config`` replaces the cell's configuration (the tests run the
    harness at small sizes); ``control`` puts the reference in TF32 in
    the program's place."""
    device = torch.device(device)
    cell = spec.workload(bench, name)
    config = config or spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(name)
    from repro_torch import device as port_device
    port_device.strict_fp32()            # as the port's CLI runs
    driver = spec.driver(traffic["driver"])(config, traffic, seed, device,
                                            control=control)
    try:
        driver.setup()
        synchronize(device)
        setup_s = time.perf_counter() - t_start
        setup_peak = _peak(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        timeline = None
        if trace:
            # the profiler's own cost grows with the events it holds: a
            # mix may trace a shorter window than it measures
            timeline = _traced(driver, min(seconds, traffic.get(
                "trace_seconds", seconds)), device)
            window_s = timeline.window_s
        else:
            t0 = time.perf_counter()
            driver.window(seconds)
            synchronize(device)
            window_s = time.perf_counter() - t0
        peak = _peak(device)
        work = driver.work()
        driver.release()
        readings = driver.check()
        verdict = compare.judge(readings, limits)
        failed = driver.failed(limits)
    finally:
        driver.close()

    ctx = Context(config, traffic, work, window_s, setup_s, peak, timeline)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end)(bench, name):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif not trace:
            raise RuntimeError(f"{name}'s end-to-end metric {m['name']} "
                               f"found nothing to read")
    out = {"correct": verdict["correct"], "attempted": driver.attempted(),
           "failed": failed, "metrics": metrics}
    if trace:
        out["breakdown"] = {"device_ops": timeline.by_name(),
                            "idle_gaps": timeline.idle_gaps()}
    out["device"] = {"peak": max(peak, setup_peak), "window_s": window_s,
                     "busy_s": timeline.busy_s if timeline else None}
    out["checks"] = verdict["checks"]
    return out


def _traced(driver, seconds: float, device) -> profile.Timeline:
    """The window under the profiler (``profile.profiled``), with the
    port's tracer installed for its spans and the harness's host ranges
    around the port's layer calls."""
    from repro_torch.obs import trace as port_trace
    with port_trace.tracing(None) as tracer, \
            profile.host_ranges(driver.host_ranges), \
            profile.profiled(device) as prof:
        with torch.profiler.record_function(profile.WINDOW):
            driver.window(seconds)
            synchronize(device)
    return profile.read(prof.events, spans=tracer.events)
