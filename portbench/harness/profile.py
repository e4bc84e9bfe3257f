"""The traced run's reading of the profiler: the device's operations
(kernels, copies, fills) with their times, the harness's own host ranges
(``record_function``), and from them the busy time, the idle gaps named
by what the host was doing, and the time by kernel name.

The profiler records the device's operations and user ranges alone, not
every host operator, which halves what the trace costs the host.  It
still costs some: CUPTI's bookkeeping of each launch slows the dense MU
loop's host from 3.6 to 4.9-5.6 ms an iteration, about the card's 4.97,
so a metric of a host-tight loop divides by device time, not by the
traced window.  The raw events are read directly (``key_averages``
builds a tree of every host op first).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib

import torch

RANGE_PREFIX = "portbench/"
TOP = 10


@dataclasses.dataclass
class Timeline:
    """Device operations and host ranges of a traced window, in seconds
    from the window's start."""
    ops: list[tuple[str, float, float]]       # (name, start, end)
    ranges: list[tuple[str, float, float]]    # (name, start, end)
    window_s: float
    spans: list[dict]                         # the port's span records

    @property
    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        busy, end = 0.0, float("-inf")
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def op_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for name, s, e in self.ops if match(name))

    def by_name(self) -> list[list]:
        """[name, seconds] of the device operations that took most time."""
        total: dict[str, float] = {}
        for name, s, e in self.ops:
            total[name] = total.get(name, 0.0) + (e - s)
        return [[n, t] for n, t in
                sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list[list]:
        """[host range, seconds]: the device's idle time inside the
        window, each gap named by the innermost harness range running on
        the host at the gap's middle ("outside" when none), summed by
        name, longest first.  One pass over gaps and ranges in time
        order; a thread's ranges nest, so the open ones form a stack."""
        gaps, end = [], 0.0
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.window_s > end:
            gaps.append((end, self.window_s))
        ranges = sorted(self.ranges, key=lambda r: r[1])
        total: dict[str, float] = {}
        stack: list[tuple[str, float, float]] = []
        j = 0
        for s, e in gaps:
            mid = 0.5 * (s + e)
            while j < len(ranges) and ranges[j][1] <= mid:
                while stack and stack[-1][2] < ranges[j][1]:
                    stack.pop()
                stack.append(ranges[j])
                j += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            name = stack[-1][0] if stack else "outside"
            total[name] = total.get(name, 0.0) + (e - s)
        return [[n, t] for n, t in
                sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def span_seconds(self, name: str) -> list[float]:
        """Durations of the port's closed spans called ``name``."""
        return [rec["dur"] / 1e6 for rec in self.spans
                if rec.get("ph") == "E" and rec.get("name") == name]


WINDOW = RANGE_PREFIX + "window"


def read(events, spans=()) -> Timeline:
    """A ``Timeline`` from a profile's events whose measured window ran
    inside a ``record_function(WINDOW)`` range that ends after the
    device's synchronize: the range places the window on the profiler's
    clock.  Device operations are clipped to it."""
    cuda = torch.autograd.DeviceType.CUDA
    win = [ev for ev in events if ev.is_user_annotation()
           and ev.device_type() != cuda and ev.name() == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} window ranges")
    t0, dur = win[0].start_ns(), win[0].duration_ns()
    window_s = dur / 1e9
    ops, ranges = [], []
    for ev in events:
        s = (ev.start_ns() - t0) / 1e9
        e = s + ev.duration_ns() / 1e9
        if ev.device_type() == cuda:
            # kernels, copies and fills; not the device side of a range
            if not ev.is_user_annotation():
                s, e = max(s, 0.0), min(e, window_s)
                if e > s:
                    ops.append((ev.name(), s, e))
        elif ev.is_user_annotation() and ev.name() != WINDOW and \
                ev.name().startswith(RANGE_PREFIX):
            ranges.append((ev.name(), s, e))
    return Timeline(ops=ops, ranges=ranges, window_s=window_s,
                    spans=list(spans))


class _Profile:
    events: list = ()


@contextlib.contextmanager
def profiled(device):
    """Profile the host's user ranges and, on a card, the device's
    operations; no host operator is recorded (module docstring).  The
    yielded object's ``events`` holds the profile once the block ends."""
    from torch._C._profiler import RecordScope
    from torch.autograd import (_disable_profiler, _enable_profiler,
                                _prepare_profiler)
    from torch.autograd import profiler as autograd_profiler
    acts = {torch.profiler.ProfilerActivity.CPU}
    if device.type == "cuda":
        acts.add(torch.profiler.ProfilerActivity.CUDA)
    config = autograd_profiler.profile().config()
    out = _Profile()
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
    try:
        yield out
    finally:
        out.events = list(_disable_profiler().events())


@contextlib.contextmanager
def host_ranges(targets):
    """Wrap each ``(module, attribute, label)`` callable in a
    ``record_function`` range named ``portbench/<label>`` for the
    traced run, and put the originals back after."""
    saved = []
    try:
        for modname, attr, label in targets:
            mod = importlib.import_module(modname)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, _ranged(fn, RANGE_PREFIX + label))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _ranged(fn, name: str):
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call
