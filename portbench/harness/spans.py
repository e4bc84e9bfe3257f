"""The program's own spans in a traced run's profile: the device time of
each operation, counted to the spans that were open on the host when it
was launched.

While the port's tracer is installed, each of its spans (``mu/*``,
``grid/*``, ``ens/*``, ``reduce/*``, ``sched/*``) is also a profiler range
of the same name (``repro_torch/obs/trace.py``), so the profile holds the
program's ranges on the clock of the device's operations.  A device
operation (kernel, copy, fill) shares its correlation id with the runtime
call that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), a
host event of the same profile; the program's ranges open at that call
name the operation.  The innermost is its *self* span; it counts in
*total* to every one of them.  The harness's own ranges (``portbench/*``)
are not the program's and name nothing here.  Only the program's main
thread opens spans, so the ranges of every thread are one stack.

``profile.read`` keeps neither the program's ranges nor the launches, so
a metric's reader cannot see them yet: ``portbench/spans.py`` runs a
cell traced and hands the profile's raw events to ``read`` here, which
takes the window and its clipped operations from ``profile.read`` and adds
only the attribution.
"""
from __future__ import annotations

import dataclasses

import torch

from . import profile

PREFIXES = ("mu/", "grid/", "ens/", "reduce/", "sched/")


@dataclasses.dataclass
class Attribution:
    """Device operations of a traced window, each with the program's spans
    open at its launch (outermost first; empty when none was, or when the
    profile holds no launch for it), and the program's host ranges; in
    seconds from the window's start."""
    ops: list[tuple[str, float, float, tuple[str, ...]]]
    ranges: list[tuple[str, float, float]]
    window_s: float
    unlinked_s: float       # device seconds with no launch in the profile

    def span_device_s(self, name: str, self_only: bool = False) -> float:
        """Device seconds of the operations launched while a ``name`` span
        was open: anywhere beneath it, or (``self_only``) where it was
        the innermost program span."""
        if self_only:
            return sum(e - s for _, s, e, st in self.ops
                       if st and st[-1] == name)
        return sum(e - s for _, s, e, st in self.ops if name in st)

    def by_name(self, name: str) -> list[list]:
        """[operation, device seconds] of the operations whose innermost
        program span was ``name``, the longest first."""
        total: dict[str, float] = {}
        for op, s, e, st in self.ops:
            if st and st[-1] == name:
                total[op] = total.get(op, 0.0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:profile.TOP]
        return [[n, t] for n, t in top]

    def unclaimed_s(self) -> float:
        """Device seconds of the operations that no program span claims."""
        return sum(e - s for _, s, e, st in self.ops if not st)

    def count(self, name: str) -> int:
        """How many ``name`` ranges the host opened in the window."""
        return sum(1 for r in self.ranges if r[0] == name)

    def names(self) -> list[str]:
        return sorted({r[0] for r in self.ranges})

    def idle_gaps(self) -> list[list]:
        """``profile.Timeline.idle_gaps`` with the gaps named by the
        innermost program span open at each gap's middle."""
        return profile.Timeline(
            ops=[(n, s, e) for n, s, e, _ in self.ops], ranges=self.ranges,
            window_s=self.window_s, spans=[]).idle_gaps()


class _Op(str):
    """A device operation's name that carries its correlation id."""
    cid: int


class _Linked:
    """A device operation's event whose ``name()`` is an ``_Op``: through
    ``profile.read`` it keeps the launch it came from."""

    def __init__(self, ev):
        self._ev = ev

    def __getattr__(self, attr):
        return getattr(self._ev, attr)

    def name(self):
        op = _Op(self._ev.name())
        op.cid = self._ev.correlation_id()
        return op


def read(events) -> Attribution:
    """The ``Attribution`` of a profile whose window ran inside a
    ``record_function(profile.WINDOW)`` range: ``profile.read`` gives the
    window and its clipped device operations, each linked here to the
    runtime call that launched it and so to the program's ranges open
    then."""
    cuda = torch.autograd.DeviceType.CUDA
    linked, ranges, launch_ns, t0 = [], [], {}, 0
    for ev in events:
        if ev.device_type() == cuda:
            linked.append(ev if ev.is_user_annotation() else _Linked(ev))
            continue
        linked.append(ev)
        if ev.is_user_annotation():
            if ev.name() == profile.WINDOW:
                t0 = ev.start_ns()
            elif ev.name().startswith(PREFIXES):
                ranges.append((ev.name(), ev.start_ns(),
                               ev.start_ns() + ev.duration_ns()))
        else:
            # a runtime or driver call; one launch may hold nested calls
            # of the same id, the outermost starts first
            cid, t = ev.correlation_id(), ev.start_ns()
            if cid and (cid not in launch_ns or t < launch_ns[cid]):
                launch_ns[cid] = t
    tl = profile.read(linked)      # checks the window, clips the ops
    ranges.sort(key=lambda r: r[1])
    launched, unlinked = [], 0.0
    for op, s, e in tl.ops:
        t = launch_ns.get(op.cid)
        if t is None:
            unlinked += e - s
            t = float("inf")
        launched.append((t, (str(op), s, e)))
    launched.sort(key=lambda x: x[0])
    ops, stack, j = [], [], 0
    for t, (name, s, e) in launched:
        # the ranges open at t: they nest, so the open ones are a stack
        while j < len(ranges) and ranges[j][1] <= t:
            while stack and stack[-1][2] <= ranges[j][1]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        ops.append((name, s, e, tuple(r[0] for r in stack)))
    return Attribution(
        ops=ops, window_s=tl.window_s, unlinked_s=unlinked,
        ranges=[(n, (s - t0) / 1e9, (e - t0) / 1e9) for n, s, e in ranges])
