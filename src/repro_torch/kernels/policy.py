"""KernelPolicy — how the sparse ops pick an implementation (port of
``repro/kernels/policy.py``).

There is no panel budget here: ``repro``'s VMEM panel budget is a TPU
artifact, and the CUDA kernels keep no resident output panel, so nothing
falls back.  Stdlib only, so the numpy-only modules can name it.
"""
from __future__ import annotations

import dataclasses

IMPLS = ("auto", "cuda", "ref")


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """use_fused  route the X-sided MU products through the kernels
               (bcsr_xa_xta / bcsr_spmm on BCSR, fused_xa_xtb on dense)
               and every MU step's A update through mu_update_a
    impl       auto — the CUDA kernel for CUDA tensors, the plain PyTorch
                      version for CPU tensors
               cuda — the CUDA kernel; a CPU tensor raises
               ref  — the plain PyTorch version, on any device (only when
                      asked for explicitly)
    """
    use_fused: bool = False
    impl: str = "auto"

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, "
                             f"got {self.impl!r}")
