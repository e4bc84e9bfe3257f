"""Dispatch of the kernels by ``impl`` and device (port of
``repro/kernels/ops.py:87,151,161,181``).

impl:
  "auto" — the kernel wrapper: the CUDA kernel for CUDA tensors, its plain
           version for CPU tensors
  "cuda" — the CUDA kernel; a CPU tensor raises
  "ref"  — the plain PyTorch version, on any device

There is no budget fallback and no ``try`` that falls back to the plain
version: a CUDA tensor either runs its kernel or raises.  (``repro``'s
VMEM window gates are TPU artifacts.)  ``repro``'s
``kernel_fallbacks()`` has no counterpart (it would always be 0); the
launch counters below take its place.
"""
from __future__ import annotations

from repro_torch.core.sparse import BCSR

from . import bcsr_fused
from . import bcsr_spmm as _spmm_mod
from . import fused_bilinear
from . import ref as _ref
from . import score_topk as _topk_mod
from .policy import IMPLS

__all__ = ["bcsr_spmm", "bcsr_xa_xta", "fused_xa_xtb", "launch_counts",
           "reset_launch_counts", "score_topk"]


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


def fused_xa_xtb(X, B1, B2, *, impl: str = "auto"):
    """One-pass (X_t @ B1, X_t^T @ B2_t) on a dense X ([r,] m, n1, n2)
    (kernels/fused_bilinear.py)."""
    if _require(impl, "fused_xa_xtb", X, B1, B2) == "ref":
        return _ref.ref_fused_xa_xtb(X, B1, B2)
    return fused_bilinear.fused_xa_xtb(X, B1, B2)


def score_topk(V, A, *, topk: int, impl: str = "auto",
               pn: int | None = None):
    """Top-k of V @ A^T without the (b, n) scores (kernels/score_topk.py):
    (scores (b, topk) f32, indices (b, topk) int32).  ``pn`` is the plain
    version's panel length (``ref.DEFAULT_PN`` when None)."""
    if _require(impl, "score_topk", V, A) == "ref":
        return _ref.ref_score_topk_stream(
            V, A, topk, _ref.DEFAULT_PN if pn is None else pn)
    return _topk_mod.score_topk(V, A, topk=topk, pn=pn)


_KERNELS = {"bcsr_xa_xta": bcsr_fused, "bcsr_spmm": _spmm_mod,
            "fused_xa_xtb": fused_bilinear, "score_topk": _topk_mod}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launch_count() for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.reset_launch_count()
