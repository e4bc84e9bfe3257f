"""mu_update_a — the multiplicative A update A * Num / (A @ S + eps) in
one pass, as a CUDA kernel for Hopper.

Replaces ``src/repro/kernels/mu_ratio.py:mu_update_a``, the Pallas
kernel that fuses the (n, k) x (k, k) denominator product with the
elementwise ratio, so A @ S never goes to memory.  Every MU step of the
port ends with this update under a fused policy (``core.rescal.a_ratio``:
the dense and BCSR steps, the masked steps and the grid engine).
Source: ``csrc/mu_update_a.cu``.

Bound on an H100: memory.  Each output reads one value of A and of Num
and writes one value, at 2k + 2 flop per 12 bytes; the floor is 12 bytes
per element over 3.35 TB/s (S is k*k floats per member besides).  Design
(the source's header has it in full): one thread per row of A; a warp
copies its 32 rows of A and Num, 32 k contiguous floats each, into
shared memory by ``cp.async`` (16-byte chunks where aligned), the next
tile's copies in flight while it computes this one; each member's S is
staged once per CTA and read as float4 broadcasts; the thread keeps its
row's k denominators in registers, each the k-term dot in ascending j
with ``fmaf``, then IEEE ``A * Num / (den + eps)`` in that order, as the
Pallas kernel; the results leave by coalesced stores.  A grid-stride
grid sized to the card; any n, tails included.

The host path is short, since a call costs its host work more than the
card's (microseconds at the sweeps' shapes): ``checked`` validates
shapes, strides and dtype once per signature (a refusal raises on every
call), and the device context is entered only when the tensors are not
on the current device.

The member axis is written out: A and Num ([r,] n, k), S ([r,] k, k); an
S without the member axis (or with member stride 0) is shared by all
members.  k <= 64 (S lives in shared memory); above it a CUDA call raises
``ValueError``.

On a CPU tensor the wrapper runs the plain version
(``kernels/ref.py:ref_mu_update_a``); on a CUDA tensor it launches the
kernel or raises; on meta tensors it runs up to the launch and returns an
output of the right shape (``launch.step_costs``: each of the three
counts the launch's ``cost`` and the wrapper's own aten work).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.launch import step_costs

from . import _build
from ._launch import (MAX_K, MAX_SLICES, member_stride, rows_contiguous,
                      stream_handle)
from .ref import ref_mu_update_a

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


class Call:
    """A checked mu_update_a call: shapes, dtype and strides validated for
    the kernel.  ``require_cuda`` is the device check, apart, so the CPU
    tests reach the others."""

    def __init__(self, A: torch.Tensor, Num: torch.Tensor, S: torch.Tensor):
        if any(x.dtype != torch.float32 for x in (A, Num, S)):
            raise TypeError("mu_update_a: A, Num and S must be float32")
        if A.dim() not in (2, 3) or S.dim() not in (2, 3):
            raise ValueError(f"mu_update_a: want A, Num ([r,] n, k) and S "
                             f"([r,] k, k); got {tuple(A.shape)}, "
                             f"{tuple(Num.shape)}, {tuple(S.shape)}")
        n, k = A.shape[-2:]
        if Num.shape != A.shape or tuple(S.shape[-2:]) != (k, k):
            raise ValueError(f"mu_update_a: A {tuple(A.shape)} wants Num of "
                             f"the same shape and S ([r,] {k}, {k}); got "
                             f"{tuple(Num.shape)}, {tuple(S.shape)}")
        if S.dim() == 3 and (A.dim() != 3 or S.shape[0] != A.shape[0]):
            raise ValueError(f"mu_update_a: S {tuple(S.shape)} has a member "
                             f"axis that A {tuple(A.shape)} lacks or "
                             f"disagrees with")
        if not 1 <= k <= MAX_K:
            raise ValueError(f"mu_update_a: rank k={k} not supported "
                             f"(1 <= k <= {MAX_K})")
        for name, x in (("A", A), ("Num", Num), ("S", S)):
            if not rows_contiguous(x):
                raise ValueError(f"mu_update_a: {name}'s last two axes "
                                 f"must be row-major")
        self.members = A.shape[0] if A.dim() == 3 else 1
        if self.members > MAX_SLICES:
            raise ValueError(f"mu_update_a: {self.members} members exceed "
                             f"{MAX_SLICES}")
        self.n, self.k = n, k
        self.strides = (member_stride(A, 2), member_stride(Num, 2),
                        member_stride(S, 2))
        self.shape = tuple(A.shape)

    @staticmethod
    def require_cuda(A: torch.Tensor, *tensors: torch.Tensor) -> None:
        """Raise unless every tensor is on one CUDA device (or all on
        meta: shapes only, counted up to the launch)."""
        dev = A.device
        if dev.type not in ("cuda", "meta") or any(x.device != dev
                                                   for x in tensors):
            raise ValueError(
                f"mu_update_a: every tensor must be on one CUDA device, "
                f"got {sorted({str(x.device) for x in (A,) + tensors})}")


@functools.lru_cache(maxsize=64)
def _checked(*sigs) -> Call:
    with step_costs.uncounted():         # built once per signature
        return Call(*(torch.empty_strided(shape, stride, dtype=dtype,
                                          device="meta")
                      for shape, stride, dtype in sigs))


def checked(A: torch.Tensor, Num: torch.Tensor, S: torch.Tensor) -> Call:
    """``Call(A, Num, S)``, built once per (shape, stride, dtype)
    signature of the three; a signature the kernel refuses is not cached,
    so it raises on every call."""
    return _checked((A.shape, A.stride(), A.dtype),
                    (Num.shape, Num.stride(), Num.dtype),
                    (S.shape, S.stride(), S.dtype))


def cost(A: torch.Tensor, Num: torch.Tensor, S: torch.Tensor
         ) -> tuple[int, int]:
    """(flops, bytes) of one call's own work: 2k + 2 flop per output (the
    k-term denominator, the product and the ratio); A, Num and S read
    once, the output written once."""
    k = A.shape[-1]
    return ((2 * k + 2) * A.numel(),
            4 * (A.numel() + Num.numel() + A.numel() + S.numel()))


def mu_update_a(A: torch.Tensor, Num: torch.Tensor, S: torch.Tensor,
                eps: float) -> torch.Tensor:
    """A ([r,] n, k), Num ([r,] n, k), S ([r,] k, k) -> A * Num / (A @ S +
    eps) ([r,] n, k), without forming A @ S.  An empty A returns an empty
    result without a launch."""
    global _launches
    dev = A.device
    if dev.type == "cpu" and Num.device.type == "cpu" \
            and S.device.type == "cpu":
        return step_costs.as_card(mu_update_a, ref_mu_update_a, A, Num, S,
                                  eps)
    call = checked(A, Num, S)
    if dev.type != "cuda" or Num.device != dev or S.device != dev:
        Call.require_cuda(A, Num, S)
    out = torch.empty(call.shape, dtype=torch.float32, device=dev)
    if call.n == 0 or call.members == 0:
        return out
    if dev.type == "meta":
        step_costs.launched("mu_update_a", cost, A, Num, S)
        return out
    args = (A.data_ptr(), Num.data_ptr(), S.data_ptr(), out.data_ptr(),
            call.members, call.n, call.k, *call.strides, float(eps))
    launch = _build.library().repro_mu_update_a
    if dev.index == torch.cuda.current_device():
        rc = launch(*args, stream_handle(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = launch(*args, stream_handle(dev.index))
    _build.check(rc, "mu_update_a")
    _launches += 1
    step_costs.launched("mu_update_a", cost, A, Num, S)
    return out
