"""fused_xa_xtb — (X_t @ B1, X_t^T @ B2_t) on a dense tensor in one pass
over X, as a CUDA kernel for Hopper.

Replaces ``src/repro/kernels/fused_bilinear.py:fused_xa_xtb``, the Pallas
kernel behind the distributed engine's fused MU iterations
(``dist/engine.py:100``: B1 = A^(j), B2_t = A^(i) for every slice).
Source: ``csrc/fused_bilinear.cu``.

Bound on an H100: memory.  Each value of X is read once for both
products; the floor is bytes(X) plus the factor reads and the two output
writes over 3.35 TB/s.  The products run on the tensor cores in split
TF32 (each value x as hi = tf32(x) plus lo = x - hi, three mma.sync
products per pair, each k-step's added to an fp32 sum), which keeps
fp32-level accuracy at a few instructions per value of X.  Design:
persistent CTAs walk work items (slice, panel of ``panel_rows(k)`` rows,
chunk of columns) in a fixed order; a producer warp streams each item's
64 x 128 tiles into a shared-memory ring by TMA (a tensor map over X's
strides, mbarriers; 4-byte cp.async when X's rows are not 16-byte
aligned, ``Call.vec`` 0); four warps sum XA over the chunk's columns
and four sum XTB over the panel's rows, each in its own registers.  The
chunk partials of XA and the panel partials of XTB go to
a workspace and a second kernel sums them in order (a single chunk or
panel writes the output itself), so both outputs are bit-identical from
call to call.  ``plan`` sizes the items and the workspace
(``workspace_floats``); ragged n1/n2 tails are masked in the kernel.

The member axis is written out: X ([r,] m, n1, n2), B1 ([r,] n2, k),
B2 ([r,] m, n1, k); an operand without the member axis is shared by all
members.  Operands are passed by strides: X and B2 need contiguous rows
only, so a slice view of X (the sliced schedule) and a B2 broadcast over
m (stride 0) cost no copy.

On a CPU tensor the wrapper runs the plain version
(``kernels/ref.py:ref_fused_xa_xtb``); on a CUDA tensor it launches the
kernel or raises; on meta tensors it runs up to the launch and returns
outputs of the right shapes (``launch.step_costs``: each of the three
counts the launch's ``cost`` and the wrapper's own aten work).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.launch import step_costs

from . import _build
from ._launch import (MAX_K, address, member_stride, members,
                      rows_contiguous)
from .ref import ref_fused_xa_xtb

BAND_ROWS = 64          # rows of a staged tile (csrc BAND)
STRIP_COLS = 128        # columns of a staged tile (csrc STRIP)
MAX_CHUNK_COLS = 4096   # columns of a work item, at most
# SMs the work items are balanced over: an H100's.  A constant, so that
# the summation order, and with it the result, does not depend on the card.
PLAN_SMS = 132
# how far from the best balance a wider chunk may leave the busiest SM:
# narrower chunks balance better but add XA partials to the workspace
BALANCE_SLACK = 1.04

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def panel_rows(k: int) -> int:
    """Rows of a work item at rank k: the kernel keeps 16 / ceil(k / 8)
    bands' XA sums in registers (csrc ``Cfg<NT>::PANEL``)."""
    return BAND_ROWS * max(1, 16 // _cdiv(k, 8))


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's work items and workspace, in floats.  Items are (slice
    t, panel, chunk), t slowest and chunk fastest; CTA c of ``grid`` takes
    items c, c + grid, ...  The workspace holds, in order, B1's and B2's
    split fragments (``b1_groups`` and ``b2_groups`` of them, rows padded
    to whole strips and bands), the chunk partials of XA (T, chunks, n1,
    k) when chunks > 1 and the panel partials of XTB (T, panels, n2, k)
    when panels > 1."""
    T: int
    n1: int
    n2: int
    k: int
    b1_groups: int
    b2_groups: int
    panel_rows: int
    chunk_cols: int
    panels: int
    chunks: int

    @property
    def items(self) -> int:
        return self.T * self.panels * self.chunks

    def grid(self, sms: int) -> int:
        """Persistent CTAs on a card of ``sms`` SMs (one per SM)."""
        return min(self.items, sms)

    def cta_items(self, cta: int, sms: int) -> list[tuple[int, int, int]]:
        """The (t, panel, chunk) items CTA ``cta`` walks, in its order."""
        per_t = self.panels * self.chunks
        return [(i // per_t, i % per_t // self.chunks, i % self.chunks)
                for i in range(cta, self.items, self.grid(sms))]

    def sections(self) -> dict[str, int]:
        """Floats of each workspace section, in order."""
        k8 = 8 * _cdiv(self.k, 8)
        n2p = _cdiv(self.n2, STRIP_COLS) * STRIP_COLS
        n1p = _cdiv(self.n1, BAND_ROWS) * BAND_ROWS
        return {
            "B1 fragments": self.b1_groups * n2p * k8 * 2,
            "B2 fragments": self.b2_groups * n1p * k8 * 2,
            "XA chunk partials": (self.T * self.chunks * self.n1 * self.k
                                  if self.chunks > 1 else 0),
            "XTB panel partials": (self.T * self.panels * self.n2 * self.k
                                   if self.panels > 1 else 0),
        }

    @property
    def workspace_floats(self) -> int:
        return sum(self.sections().values())


def plan(T: int, n1: int, n2: int, k: int, b1_groups: int = 1,
         b2_groups: int = 1) -> Plan:
    """Work items and workspace for T slices of an (n1, n2) X at rank k.
    Panels are ``panel_rows(k)`` rows; chunks are whole 128-column strips,
    at most MAX_CHUNK_COLS: the widest that leaves the busiest of PLAN_SMS
    SMs within BALANCE_SLACK of the fewest strips any width gives it
    (``busiest_strips``)."""
    rows = panel_rows(k)
    panels = _cdiv(n1, rows)
    strips = _cdiv(n2, STRIP_COLS)
    load = {w: busiest_strips(T * panels * _cdiv(strips, w), w)
            for w in range(1, min(strips, MAX_CHUNK_COLS // STRIP_COLS) + 1)}
    least = min(load.values())
    chunk_cols = STRIP_COLS * max(w for w, b in load.items()
                                  if b <= BALANCE_SLACK * least)
    return Plan(T, n1, n2, k, b1_groups, b2_groups, rows, chunk_cols,
                panels, _cdiv(n2, chunk_cols))


def busiest_strips(items: int, width: int) -> int:
    """Strips the busiest SM streams when ``items`` items of ``width``
    strips are dealt round-robin to PLAN_SMS SMs."""
    return _cdiv(items, PLAN_SMS) * width


def workspace_floats(T: int, n1: int, n2: int, k: int, b1_groups: int = 1,
                     b2_groups: int = 1) -> int:
    """Floats of workspace one call allocates: B1's groups (1, or one per
    member), B2's (1, or one per member, times m when it is not shared by
    the slices), and the partials (``Plan``)."""
    return plan(T, n1, n2, k, b1_groups, b2_groups).workspace_floats


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class Call:
    """A checked fused_xa_xtb call: shapes, dtype, strides and rank
    validated for the kernel, with its launch shape.  ``require_cuda`` is
    the device check, apart, so the CPU tests reach the others."""

    def __init__(self, X: torch.Tensor, B1: torch.Tensor, B2: torch.Tensor):
        if any(x.dtype != torch.float32 for x in (X, B1, B2)):
            raise TypeError("fused_xa_xtb: X, B1 and B2 must be float32")
        if X.dim() not in (3, 4) or B1.dim() not in (2, 3) \
                or B2.dim() not in (3, 4):
            raise ValueError(
                f"fused_xa_xtb: want X ([r,] m, n1, n2), B1 ([r,] n2, k), "
                f"B2 ([r,] m, n1, k); got {tuple(X.shape)}, "
                f"{tuple(B1.shape)}, {tuple(B2.shape)}")
        m, n1, n2 = X.shape[-3:]
        k = B1.shape[-1]
        if tuple(B1.shape[-2:]) != (n2, k) \
                or tuple(B2.shape[-3:]) != (m, n1, k):
            raise ValueError(
                f"fused_xa_xtb: X {tuple(X.shape)} wants B1 ([r,] {n2}, k) "
                f"and B2 ([r,] {m}, {n1}, k); got {tuple(B1.shape)}, "
                f"{tuple(B2.shape)}")
        if not 1 <= k <= MAX_K:
            raise ValueError(f"fused_xa_xtb: rank k={k} not supported "
                             f"(1 <= k <= {MAX_K})")
        leads = {x.shape[0] for x, d in ((X, 4), (B1, 3), (B2, 4))
                 if x.dim() == d}
        if len(leads) > 1:
            raise ValueError(f"fused_xa_xtb: member axes disagree: "
                             f"{sorted(leads)}")
        for name, x in (("X", X), ("B1", B1), ("B2", B2)):
            if not rows_contiguous(x):
                raise ValueError(f"fused_xa_xtb: {name}'s last two axes "
                                 f"must be row-major")
        self.members = leads.pop() if leads else None
        self.m, self.n1, self.n2, self.k = m, n1, n2, k
        self.T = (self.members or 1) * m
        self.strides = (member_stride(X, 3), X.stride(-3),
                        member_stride(B1, 2), member_stride(B2, 3),
                        B2.stride(-3))
        self.vec = int(n2 % 4 == 0 and address(X) % 16 == 0
                       and all(s % 4 == 0 for s in self.strides[:2]))
        members = self.members or 1
        # the kernel's groups of split fragments, from the strides as the
        # kernel reads them
        self.b1_groups = members if self.strides[2] else 1
        self.b2_groups = ((members if self.strides[3] else 1)
                          * (m if self.strides[4] else 1))
        self.device = X.device

    def require_cuda(self, *tensors: torch.Tensor) -> None:
        """Raise unless every tensor is on one CUDA device (or all on
        meta: shapes only, counted up to the launch)."""
        if self.device.type not in ("cuda", "meta") or any(
                x.device != self.device for x in tensors):
            raise ValueError(
                f"fused_xa_xtb: every tensor must be on one CUDA device, "
                f"got {sorted({str(x.device) for x in tensors})}")

    def shape_out(self, n: int) -> tuple[int, ...]:
        lead = (self.members,) if self.members is not None else ()
        return lead + (self.m, n, self.k)

    def plan(self) -> Plan:
        return plan(self.T, self.n1, self.n2, self.k, self.b1_groups,
                    self.b2_groups)


def cost(X: torch.Tensor, B1: torch.Tensor, B2: torch.Tensor
         ) -> tuple[int, int]:
    """(flops, bytes) of one call's own work: each value of X read once
    for both products, 4k flop per value and slice of each member; B1 and
    B2's own values (a dim of stride 0 once) read once, XA and XTB
    written once."""
    m, n1, n2 = X.shape[-3:]
    k = B1.shape[-1]
    T = members(X.shape[:-3], B1.shape[:-2], B2.shape[:-3]) * m
    nbytes = (step_costs.nbytes(X) + step_costs.nbytes(B1)
              + step_costs.nbytes(B2) + 4 * T * (n1 + n2) * k)
    return 4 * T * n1 * n2 * k, nbytes


def fused_xa_xtb(X: torch.Tensor, B1: torch.Tensor, B2: torch.Tensor):
    """X ([r,] m, n1, n2), B1 ([r,] n2, k), B2 ([r,] m, n1, k) ->
    (XA ([r,] m, n1, k), XTB ([r,] m, n2, k)), reading X once.  An empty
    side returns zeros without a launch."""
    global _launches
    if all(x.device.type == "cpu" for x in (X, B1, B2)):
        return step_costs.as_card(fused_xa_xtb, ref_fused_xa_xtb, X, B1, B2)
    call = Call(X, B1, B2)
    call.require_cuda(X, B1, B2)
    empty = call.n1 == 0 or call.n2 == 0 or call.T == 0
    alloc = torch.zeros if empty else torch.empty
    xa = alloc(call.shape_out(call.n1), dtype=torch.float32,
               device=call.device)
    xtb = alloc(call.shape_out(call.n2), dtype=torch.float32,
                device=call.device)
    if empty:
        return xa, xtb
    p = call.plan()
    ws = torch.empty(p.workspace_floats, dtype=torch.float32,
                     device=call.device)
    if call.device.type == "meta":
        step_costs.launched("fused_xa_xtb", cost, X, B1, B2)
        return xa, xtb
    ptrs, at = [], 0
    for floats in p.sections().values():
        ptrs.append(ws.data_ptr() + 4 * at if floats else None)
        at += floats
    with torch.cuda.device(call.device):
        rc = _build.library().repro_fused_xa_xtb(
            X.data_ptr(), B1.data_ptr(), B2.data_ptr(), xa.data_ptr(),
            xtb.data_ptr(), *ptrs, call.T, call.m, call.n1, call.n2, call.k,
            *call.strides, call.vec, p.panel_rows, p.chunk_cols,
            p.grid(_sms(call.device.index)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_xa_xtb")
    _launches += 1
    step_costs.launched("fused_xa_xtb", cost, X, B1, B2)
    return xa, xtb
