"""Dispatch of the kernels by ``impl`` and device (port of
``repro/kernels/ops.py:87,130,151,161,181,208``).

impl:
  "auto" — the kernel wrapper: the CUDA kernel for CUDA tensors, its plain
           version for CPU tensors (on meta tensors, the card's path up to
           the launch: ``launch.step_costs``)
  "cuda" — the CUDA kernel; a CPU tensor raises
  "ref"  — the plain PyTorch version, on any device

There is no budget gate and no ``try`` that falls back to the plain
version: a CUDA tensor runs its kernel or raises.  (``repro``'s VMEM
window gates are TPU artifacts.)  Every call probes the
``kernel/dispatch`` seam (``resilience.faults``) at impl resolution.  A
fired ``budget-overflow`` is counted (``kernel_fallbacks()``, which the
scheduler diffs per unit) and traced as a ``kernel/fallback`` instant
with ``repro``'s argument names (``requested_bytes`` is the bytes of the
call's operands; the port has no budget, so ``budget_bytes`` is 0).
Where the call would launch a CUDA kernel it then raises
``TransientError`` (``chosen="retry"``) and runs nothing, so the sweep's
unit retries on the kernel; a plain version never runs on a CUDA tensor
unless ``impl="ref"`` asks for it.  Elsewhere the call runs its plain
version (``chosen="ref"``).  ``repro`` dispatches once per compile and
the port once per call, so a plan's hit index on this seam counts calls.
The launch counters below count the kernel launches.
"""
from __future__ import annotations

from repro_torch.core.sparse import BCSR
from repro_torch.obs import trace as _obs
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.faults import TransientError

from . import bcsr_fused
from . import bcsr_spmm as _spmm_mod
from . import flash_attention as _flash_mod
from . import fused_bilinear
from . import mu_update_a as _mu_mod
from . import ref as _ref
from . import score_topk as _topk_mod
from .policy import IMPLS

__all__ = ["bcsr_spmm", "bcsr_xa_xta", "flash_attention", "fused_xa_xtb",
           "kernel_fallbacks", "launch_counts", "mu_update_a",
           "reset_launch_counts", "score_topk"]

_n_fallbacks = 0


def kernel_fallbacks() -> int:
    """Process-lifetime count of calls refused by an injected
    ``budget-overflow`` (each ran its plain version or raised
    ``TransientError``)."""
    return _n_fallbacks


def _note_fallback(kernel: str, requested_bytes: int, *,
                   chosen: str = "ref") -> None:
    global _n_fallbacks
    _n_fallbacks += 1
    _obs.event("kernel/fallback", kernel=kernel,
               requested_bytes=int(requested_bytes), budget_bytes=0,
               chosen=chosen)


def _on_card(tensors) -> bool:
    """CUDA tensors, or meta tensors standing in for them (shapes only:
    the wrapper runs up to its launch, ``launch.step_costs``)."""
    return all(x.device.type in ("cuda", "meta") for x in tensors)


def _dispatch(impl: str, kernel: str, *tensors) -> str:
    """Check ``impl`` against the tensors' device and probe the
    ``kernel/dispatch`` seam: "ref" when the plain version runs (asked
    for, or on the CPU), else the CUDA kernel's impl.  A fired
    ``budget-overflow`` on a call bound for the CUDA kernel raises
    ``TransientError``; on any other call it runs the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    on_card = _on_card(tensors)
    if impl == "cuda" and not on_card:
        raise ValueError(f"{kernel}: impl='cuda' needs CUDA tensors, got "
                         f"{sorted({str(x.device) for x in tensors})}")
    resolved = impl if impl != "auto" else ("cuda" if on_card else "ref")
    if _faults.probe("kernel/dispatch", kernel=kernel,
                     impl=resolved) == "budget-overflow":
        nbytes = sum(x.numel() * x.element_size() for x in tensors)
        if resolved == "cuda":
            _note_fallback(kernel, nbytes, chosen="retry")
            raise TransientError(f"{kernel}: injected budget-overflow; "
                                 f"the kernel call is refused")
        _note_fallback(kernel, nbytes)
        return "ref"
    return impl


def bcsr_spmm(sp: BCSR, B, *, impl: str = "auto"):
    """X @ B on a BCSR tensor (kernels/bcsr_spmm.py)."""
    if _dispatch(impl, "bcsr_spmm", sp.data, B) == "ref":
        return _ref.ref_bcsr_spmm(sp, B)
    return _spmm_mod.bcsr_spmm(sp, B)


def bcsr_xa_xta(sp: BCSR, B1, B2, *, impl: str = "auto", operands=None):
    """One-pass (X @ B1, X^T @ B2) on a BCSR tensor
    (kernels/bcsr_fused.py); ``operands``, B1 and B2 already tiled
    (``bcsr_fused.prepare``), go to the kernel's wrapper."""
    if _dispatch(impl, "bcsr_xa_xta", sp.data, B1, B2) == "ref":
        return _ref.ref_bcsr_xa_xta(sp, B1, B2)
    return bcsr_fused.bcsr_xa_xta(sp, B1, B2, operands=operands)


def fused_xa_xtb(X, B1, B2, *, impl: str = "auto"):
    """One-pass (X_t @ B1, X_t^T @ B2_t) on a dense X ([r,] m, n1, n2)
    (kernels/fused_bilinear.py)."""
    if _dispatch(impl, "fused_xa_xtb", X, B1, B2) == "ref":
        return _ref.ref_fused_xa_xtb(X, B1, B2)
    return fused_bilinear.fused_xa_xtb(X, B1, B2)


def mu_update_a(A, Num, S, eps: float, *, impl: str = "auto"):
    """A * Num / (A @ S + eps) without forming A @ S: A, Num ([r,] n, k),
    S ([r,] k, k) (kernels/mu_update_a.py)."""
    if _dispatch(impl, "mu_update_a", A, Num, S) == "ref":
        return _ref.ref_mu_update_a(A, Num, S, eps)
    return _mu_mod.mu_update_a(A, Num, S, eps)


def score_topk(V, A, *, topk: int, impl: str = "auto",
               pn: int | None = None):
    """Top-k of V @ A^T without the (b, n) scores (kernels/score_topk.py):
    (scores (b, topk) f32, indices (b, topk) int32).  ``pn`` is the plain
    version's panel length (``ref.DEFAULT_PN`` when None)."""
    if _dispatch(impl, "score_topk", V, A) == "ref":
        return _ref.ref_score_topk_stream(
            V, A, topk, _ref.DEFAULT_PN if pn is None else pn)
    return _topk_mod.score_topk(V, A, topk=topk, pn=pn)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    sm_scale: float | None = None, impl: str = "auto"):
    """Online-softmax GQA attention: q (b, hq, sq, d), k and v (b, hkv,
    skv, d) -> (b, hq, sq, d) (kernels/flash_attention.py).  ``impl="ref"``
    is the materializing softmax (``ref.ref_attention``).  A call bound
    for the kernel raises ``RuntimeError`` when grad is enabled and q, k
    or v requires it (the kernel has no backward), before any device
    check."""
    if impl == "cuda" or (impl == "auto" and _on_card((q, k, v))):
        _flash_mod.refuse_grad(q, k, v)
    if _dispatch(impl, "flash_attention", q, k, v) == "ref":
        return _ref.ref_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  sm_scale=sm_scale)
    return _flash_mod.flash_attention(q, k, v, causal=causal,
                                      q_offset=q_offset, sm_scale=sm_scale)


_KERNELS = {"bcsr_xa_xta": bcsr_fused, "bcsr_spmm": _spmm_mod,
            "fused_xa_xtb": fused_bilinear, "mu_update_a": _mu_mod,
            "score_topk": _topk_mod, "flash_attention": _flash_mod}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launch_count() for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.reset_launch_count()
