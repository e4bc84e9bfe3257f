"""Argument checks and shapes shared by the kernel wrappers."""
from __future__ import annotations

import torch

from repro_torch.core.sparse import BCSR, pad_rows

MAX_BS = 128
MAX_K = 64
MAX_SLICES = 65535     # gridDim.y


def rows_contiguous(x: torch.Tensor) -> bool:
    """The last two axes are row-major (strides of size-1 axes do not
    matter)."""
    return ((x.shape[-1] <= 1 or x.stride(-1) == 1)
            and (x.shape[-2] <= 1 or x.stride(-2) == x.shape[-1]))


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
        if not sp.data.is_contiguous() or sp.data.data_ptr() % 16:
            raise ValueError(f"{kernel}: data must be contiguous and "
                             f"16-byte aligned")
        if not (sp.row_ptr.is_contiguous()
                and sp.block_cols.is_contiguous()):
            raise ValueError(f"{kernel}: row_ptr and block_cols must be "
                             f"contiguous")
        bs = sp.bs
        if bs % 32 or not 32 <= bs <= MAX_BS:
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
        blk = sp.nnzb * bs * bs
        self.data_member_stride = sp.m * blk if d_r is not None else 0
        self.b_member_stride = sp.n_pad * k if b_r is not None else 0
        tensors = (sp.data, sp.row_ptr, sp.block_cols) + operands
        dev = sp.data.device
        if dev.type != "cuda" or any(x.device != dev for x in tensors):
            raise ValueError(f"{kernel}: every tensor must be on one CUDA "
                             f"device, got "
                             f"{sorted({str(x.device) for x in tensors})}")

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
