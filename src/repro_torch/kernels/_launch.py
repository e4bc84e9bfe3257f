"""Argument checks and shapes shared by the kernel wrappers."""
from __future__ import annotations

import math

import torch

from repro_torch.core.sparse import BCSR, pad_rows

MAX_BS = 128
MAX_K = 64
MAX_SLICES = 65535     # gridDim.y


def block_size_ok(bs: int) -> bool:
    """The BCSR kernels take blocks of a multiple of 32, up to MAX_BS."""
    return bs % 32 == 0 and 32 <= bs <= MAX_BS


def stream_handle(device_index: int) -> int:
    """The device's current stream as a cudaStream_t integer: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object (~8 us per launch on the H100's host)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def address(x: torch.Tensor) -> int:
    """x's address for the alignment checks; 0 (aligned) on meta, which
    has none."""
    return 0 if x.is_meta else x.data_ptr()


def rows_contiguous(x: torch.Tensor) -> bool:
    """The last two axes are row-major (strides of size-1 axes do not
    matter)."""
    return ((x.shape[-1] <= 1 or x.stride(-1) == 1)
            and (x.shape[-2] <= 1 or x.stride(-2) == x.shape[-1]))


def members(*leads) -> int:
    """Members of a call whose operands have these leading shapes, () or
    (r,) each (the wrappers refuse members that disagree)."""
    return max(math.prod(lead) for lead in leads)


def member_stride(x: torch.Tensor, dims: int) -> int:
    """Floats between members, 0 when ``x`` has no member axis."""
    return x.stride(0) if x.dim() == dims + 1 else 0


class Launch:
    """A checked BCSR kernel call: the operand and its ([r,] n, k) factor
    operands, validated for the kernels, with the derived launch shape.
    The device check comes last, so the CPU tests reach the others."""

    def __init__(self, kernel: str, sp: BCSR, *operands: torch.Tensor):
        self.kernel = kernel
        self.sp = sp
        if sp.data.dtype != torch.float32 or any(
                B.dtype != torch.float32 for B in operands):
            raise TypeError(f"{kernel}: data and operands must be float32")
        # each member's (m, nnzb, bs, bs) contiguous; the member axis may
        # be strided (one relation slice of a member stack)
        inner = sp.data[0] if sp.batch_shape else sp.data
        if not inner.is_contiguous() or address(sp.data) % 16 or (
                sp.batch_shape and sp.data.stride(0) % 4):
            raise ValueError(f"{kernel}: data must be contiguous per member "
                             f"and 16-byte aligned")
        if not (sp.row_ptr.is_contiguous()
                and sp.block_cols.is_contiguous()):
            raise ValueError(f"{kernel}: row_ptr and block_cols must be "
                             f"contiguous")
        bs = sp.bs
        if not block_size_ok(bs):
            raise ValueError(f"{kernel}: block size {bs} not supported "
                             f"(a multiple of 32, at most {MAX_BS})")
        B0 = operands[0]
        k = B0.shape[-1]
        if not 1 <= k <= MAX_K:
            raise ValueError(f"{kernel}: rank k={k} not supported "
                             f"(1 <= k <= {MAX_K})")
        for B in operands:
            if B.shape != B0.shape or B.dim() not in (2, 3) \
                    or B.shape[-2] != sp.n:
                raise ValueError(
                    f"{kernel}: operands must be ([r,] n={sp.n}, k), got "
                    f"{[tuple(x.shape) for x in operands]}")
            if not B.is_contiguous():
                raise ValueError(f"{kernel}: operands must be contiguous")
        d_r = sp.batch_shape[0] if sp.batch_shape else None
        b_r = B0.shape[0] if B0.dim() == 3 else None
        if d_r is not None and b_r is not None and d_r != b_r:
            raise ValueError(f"{kernel}: data has {d_r} members, operands "
                             f"{b_r}")
        self.members = d_r or b_r or 1
        self.batched = d_r is not None or b_r is not None
        self.k = k
        self.T = self.members * sp.m
        if self.T > MAX_SLICES:
            raise ValueError(f"{kernel}: {self.T} slices exceed {MAX_SLICES}")
        self.data_member_stride = sp.data.stride(0) if d_r is not None \
            else 0
        self.b_member_stride = sp.n_pad * k if b_r is not None else 0
        tensors = (sp.data, sp.row_ptr, sp.block_cols) + operands
        dev = sp.data.device
        if dev.type not in ("cuda", "meta") or any(x.device != dev
                                                   for x in tensors):
            raise ValueError(f"{kernel}: every tensor must be on one CUDA "
                             f"device, got "
                             f"{sorted({str(x.device) for x in tensors})}")
        # meta: shapes only, counted up to the launch (launch.step_costs)
        self.meta = dev.type == "meta"

    def padded(self, B: torch.Tensor) -> torch.Tensor:
        """B zero-padded to n_pad rows (a copy only when bs does not
        divide n)."""
        return pad_rows(B, self.sp.n, self.sp.n_pad)

    def empty(self, zero: bool = False, cols: int | None = None
              ) -> torch.Tensor:
        """A (T, n_pad, cols or k) float32 output."""
        shape = (self.T, self.sp.n_pad, cols or self.k)
        dev = self.sp.data.device
        return (torch.zeros if zero else torch.empty)(
            shape, dtype=torch.float32, device=dev)

    def shape_out(self, out: torch.Tensor) -> torch.Tensor:
        """(T, n_pad, k) -> ([r,] m, n, k)."""
        lead = (self.members,) if self.batched else ()
        out = out.reshape(lead + (self.sp.m, self.sp.n_pad, self.k))
        return out[..., :self.sp.n, :]

    @staticmethod
    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream
