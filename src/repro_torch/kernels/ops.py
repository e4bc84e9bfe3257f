"""Dispatch of the BCSR products by ``impl`` and device (port of
``repro/kernels/ops.py:151,161``).

impl:
  "auto" — the kernel wrapper: the CUDA kernel for CUDA tensors, its plain
           version for CPU tensors
  "cuda" — the CUDA kernel; a CPU tensor raises
  "ref"  — the plain PyTorch version, on any device

There is no budget fallback and no ``try`` that falls back to the plain
version: a CUDA tensor either runs its kernel or raises.  ``repro``'s
``kernel_fallbacks()`` has no counterpart (it would always be 0); the
launch counters below take its place.
"""
from __future__ import annotations

from repro_torch.core.sparse import BCSR

from . import bcsr_fused
from . import bcsr_spmm as _spmm_mod
from . import ref as _ref
from .policy import IMPLS

__all__ = ["bcsr_spmm", "bcsr_xa_xta", "launch_counts",
           "reset_launch_counts"]


def _require(impl: str, kernel: str, *tensors) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and any(x.device.type != "cuda" for x in tensors):
        raise ValueError(f"{kernel}: impl='cuda' needs CUDA tensors, got "
                         f"{sorted({str(x.device) for x in tensors})}")
    return impl


def bcsr_spmm(sp: BCSR, B, *, impl: str = "auto"):
    """X @ B on a BCSR tensor (kernels/bcsr_spmm.py)."""
    if _require(impl, "bcsr_spmm", sp.data, B) == "ref":
        return _ref.ref_bcsr_spmm(sp, B)
    return _spmm_mod.bcsr_spmm(sp, B)


def bcsr_xa_xta(sp: BCSR, B1, B2, *, impl: str = "auto"):
    """One-pass (X @ B1, X^T @ B2) on a BCSR tensor
    (kernels/bcsr_fused.py)."""
    if _require(impl, "bcsr_xa_xta", sp.data, B1, B2) == "ref":
        return _ref.ref_bcsr_xa_xta(sp, B1, B2)
    return bcsr_fused.bcsr_xa_xta(sp, B1, B2)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {"bcsr_xa_xta": bcsr_fused.launch_count(),
            "bcsr_spmm": _spmm_mod.launch_count()}


def reset_launch_counts() -> None:
    bcsr_fused.reset_launch_count()
    _spmm_mod.reset_launch_count()
