"""fused_xa_xtb — (X_t @ B1, X_t^T @ B2_t) on a dense tensor in one pass
over X, as a CUDA kernel for Hopper.

Replaces ``src/repro/kernels/fused_bilinear.py:fused_xa_xtb``, the Pallas
kernel behind the distributed engine's fused MU iterations
(``dist/engine.py:100``: B1 = A^(j), B2_t = A^(i) for every slice).
Source: ``csrc/fused_bilinear.cu``.

Bound on an H100: memory.  Each value of X is read once for both products
at 2k FMAs, k flop per byte, under the fp32 ridge for every k the sweep
uses; the floor is bytes(X) plus the factor reads and the two output
writes over 3.35 TB/s.  Design: one CTA per (slice, 256-row panel) walks
the columns in 32-wide strips staged once in shared memory; XA
accumulates in registers and is written once; each strip's X^T @ B2
partial is reduced across the CTA's warps and stored to the panel's slot
of a workspace (T, panels, n2, k), and a second kernel sums the panels in
order into XTB (with one panel the first kernel writes XTB itself).  Both
outputs are bit-identical from call to call.  Ragged n1/n2 tails are
masked in the kernel.

The member axis is written out: X ([r,] m, n1, n2), B1 ([r,] n2, k),
B2 ([r,] m, n1, k); an operand without the member axis is shared by all
members.  Operands are passed by strides: X and B2 need contiguous rows
only, so a slice view of X (the sliced schedule) and a B2 broadcast over
m (stride 0) cost no copy.

On a CPU tensor the wrapper runs the plain version
(``kernels/ref.py:ref_fused_xa_xtb``); on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import MAX_K, MAX_SLICES, member_stride, rows_contiguous
from .ref import ref_fused_xa_xtb

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


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
        if self.T > MAX_SLICES:
            raise ValueError(f"fused_xa_xtb: {self.T} slices exceed "
                             f"{MAX_SLICES}")
        self.strides = (member_stride(X, 3), X.stride(-3),
                        member_stride(B1, 2), member_stride(B2, 3),
                        B2.stride(-3))
        self.vec = int(n2 % 4 == 0 and X.data_ptr() % 16 == 0
                       and all(s % 4 == 0 for s in self.strides[:2]))
        self.device = X.device

    def require_cuda(self, *tensors: torch.Tensor) -> None:
        if self.device.type != "cuda" or any(x.device != self.device
                                             for x in tensors):
            raise ValueError(
                f"fused_xa_xtb: every tensor must be on one CUDA device, "
                f"got {sorted({str(x.device) for x in tensors})}")

    def shape_out(self, n: int) -> tuple[int, ...]:
        lead = (self.members,) if self.members is not None else ()
        return lead + (self.m, n, self.k)


def fused_xa_xtb(X: torch.Tensor, B1: torch.Tensor, B2: torch.Tensor):
    """X ([r,] m, n1, n2), B1 ([r,] n2, k), B2 ([r,] m, n1, k) ->
    (XA ([r,] m, n1, k), XTB ([r,] m, n2, k)), reading X once.  An empty
    side returns zeros without a launch."""
    global _launches
    if all(x.device.type == "cpu" for x in (X, B1, B2)):
        return ref_fused_xa_xtb(X, B1, B2)
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
    lib = _build.library()
    floats = ctypes.c_longlong()
    lib.repro_fused_xa_xtb_workspace(call.T, call.n1, call.n2, call.k,
                                     ctypes.addressof(floats))
    ws = torch.empty(floats.value, dtype=torch.float32, device=call.device)
    with torch.cuda.device(call.device):
        rc = lib.repro_fused_xa_xtb(
            X.data_ptr(), B1.data_ptr(), B2.data_ptr(), xa.data_ptr(),
            xtb.data_ptr(), ws.data_ptr() if floats.value else None,
            call.T, call.m, call.n1,
            call.n2, call.k, *call.strides, call.vec,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_xa_xtb")
    _launches += 1
    return xa, xtb
