"""The program's spans in a profile (``harness/spans.py``), on a synthetic
event list: each device operation counts to the program's spans open at
its launch, innermost (self) and every ancestor (total), the harness's
ranges skipped; program ranges change nothing ``profile.read`` gives;
and ``collectives_per_iter.mu`` reads the closing ``mu/iter`` records."""
import dataclasses
import types

import pytest
import torch

from portbench.harness import profile, spans, spec

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


@dataclasses.dataclass
class Ev:
    """The methods of a profiler event that the harness calls."""
    n: str
    s: int
    d: int
    dev: object = CPU
    ua: bool = False
    cid: int = 0

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def device_type(self):
        return self.dev

    def is_user_annotation(self):
        return self.ua

    def correlation_id(self):
        return self.cid


def host(name, s, e):
    return Ev(name, s, e - s, ua=True)


def launch(cid, at, op, start, dur):
    """A runtime call at ``at`` and the device operation it launched."""
    return [Ev("cudaLaunchKernel", at, 2, cid=cid),
            Ev(op, start, dur, dev=CUDA, cid=cid)]


T0 = 1_000_000


def approx(seconds):
    return pytest.approx(seconds, rel=1e-9, abs=1e-15)


def base_events():
    """A window (0-1000 ns after T0) with harness ranges, two device
    operations launched under them and one launched outside any range."""
    t = T0
    return [
        host(profile.WINDOW, t, t + 1000),
        host("portbench/mu_step", t + 10, t + 400),
        host("portbench/products", t + 120, t + 180),
        *launch(1, t + 130, "fused_kernel", t + 200, 300),
        *launch(2, t + 300, "gemm", t + 520, 100),
        *launch(3, t + 450, "fill", t + 700, 50),
        Ev("mu/products", t + 200, 300, dev=CUDA, ua=True),  # device side
    ]


PROGRAM = [host("mu/iter", T0 + 20, T0 + 390),
           host("mu/products", T0 + 90, T0 + 200),
           host("mu/a_update", T0 + 250, T0 + 380)]


def test_ops_count_to_innermost_and_every_program_ancestor():
    ev = base_events() + PROGRAM + [
        # a device operation the profile holds no launch for
        Ev("nccl", T0 + 800, 40, dev=CUDA, cid=99)]
    at = spans.read(ev)
    ns = 1e-9
    assert at.span_device_s("mu/products", self_only=True) == \
        approx(300 * ns)            # under portbench/products too
    assert at.span_device_s("mu/products") == approx(300 * ns)
    assert at.span_device_s("mu/a_update", self_only=True) == \
        approx(100 * ns)
    assert at.span_device_s("mu/iter", self_only=True) == 0
    assert at.span_device_s("mu/iter") == approx(400 * ns)
    assert at.span_device_s("portbench/products") == 0
    assert at.unclaimed_s() == approx(90 * ns)   # the fill, nccl
    assert at.unlinked_s == approx(40 * ns)
    assert at.count("mu/iter") == 1
    assert at.names() == ["mu/a_update", "mu/iter", "mu/products"]
    assert at.by_name("mu/a_update") == [["gemm", approx(100 * ns)]]
    assert at.by_name("mu/iter") == []
    stacks = {name: st for name, _, _, st in at.ops}
    assert stacks["fused_kernel"] == ("mu/iter", "mu/products")
    assert stacks["gemm"] == ("mu/iter", "mu/a_update")
    assert stacks["fill"] == stacks["nccl"] == ()


def test_sibling_and_repeated_spans():
    """Ranges that close before the next opens leave the stack."""
    t = T0
    ev = [host(profile.WINDOW, t, t + 1000)]
    for i in range(3):
        a = t + 100 + 300 * i
        ev += [host("mu/slice", a, a + 200), host("mu/r_update", a + 10,
                                                   a + 90)]
        ev += launch(10 + i, a + 50, "k", a + 60, 20)
        ev += launch(20 + i, a + 150, "k2", a + 160, 10)
    at = spans.read(ev)
    assert at.count("mu/slice") == 3
    assert at.span_device_s("mu/r_update") == approx(60e-9)
    assert at.span_device_s("mu/slice", self_only=True) == \
        approx(30e-9)
    assert at.span_device_s("mu/slice") == approx(90e-9)
    assert at.unclaimed_s() == 0


def test_program_ranges_change_nothing_profile_reads():
    plain = profile.read(base_events())
    ranged = profile.read(base_events() + PROGRAM)
    assert ranged.ops == plain.ops
    assert ranged.ranges == plain.ranges
    assert ranged.busy_s == plain.busy_s
    assert ranged.by_name() == plain.by_name()
    assert ranged.idle_gaps() == plain.idle_gaps()


def test_idle_gaps_named_by_program_spans():
    """Each gap is named by the innermost program span open at its
    middle; the harness's names stay as profile.read gives them."""
    at = spans.read(base_events() + PROGRAM)
    gaps = dict(at.idle_gaps())
    # gaps 0-200 (middle 100: mu/products), 500-520, 620-700 and
    # 750-1000 (outside any program span)
    assert gaps == {"mu/products": approx(200e-9),
                    "outside": approx(350e-9)}
    harness = dict(profile.read(base_events() + PROGRAM).idle_gaps())
    assert harness["portbench/mu_step"] == approx(200e-9)


def test_collectives_per_iter_reads_closing_records():
    read = spec.reader("collectives_per_iter.mu")
    recs = [{"ph": "B", "name": "mu/iter", "args": {}},
            {"ph": "E", "name": "mu/iter",
             "args": {"collectives": 82}},
            {"ph": "E", "name": "mu/iter",
             "args": {"collectives": 82}},
            {"ph": "E", "name": "sched/execute", "args": {"uid": "u"}}]
    ctx = types.SimpleNamespace(timeline=types.SimpleNamespace(spans=recs))
    assert read(ctx) == 82
    # a program without the counter (an earlier commit): nothing to read
    ctx.timeline.spans = recs[3:]
    assert read(ctx) is None
