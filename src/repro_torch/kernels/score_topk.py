"""score_topk — the top-k of V @ A^T without the (b, n) score matrix, as a
CUDA kernel for Hopper.

Replaces ``src/repro/kernels/score_topk.py:score_topk``, the Pallas kernel
behind every serve batch (``serve/engine.py``).  Source:
``csrc/score_topk.cu``.

Contract, as ``repro``'s: V (b, k) and A (n, k) float32 give f32 scores
and int32 indices, both (b, topk), in descending score; equal scores put
the lowest index first; slots past n (topk > n) are (-inf, -1).

Bound on an H100: fp32 operations (2bnk) once b exceeds ~10 queries at the
serve path's ranks, the reads of A (4nk bytes) below that.  Design: stage
1 splits n into chunks and the batch into groups of Q queries; each CTA
scores its rows once per query from registers and keeps each query's best
topk of the chunk, filtering by the current topk-th score; stage 2 merges
the chunks' lists per query.  ``plan`` asks the library for Q and the
chunking; the kernel's limits are k <= 64 and topk <= 1024 (``repro`` has
neither).

On CPU tensors the wrapper runs the plain version
(``kernels/ref.py:ref_score_topk_stream``); on CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from .ref import DEFAULT_PN, ref_score_topk_stream

MAX_K = 64               # the kernel's limits (csrc/score_topk.cu refuses
MAX_TOPK = 1024          # the same), checked here to raise ValueError

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    q: int               # queries per CTA
    chunk_rows: int      # rows of A per stage-1 CTA (whole tiles)
    n_chunks: int


@functools.lru_cache(maxsize=256)
def plan(b: int, n: int, k: int, topk: int, sms: int) -> Plan:
    """The kernel's launch plan for this shape on a card with ``sms`` SMs,
    from the launcher library, which owns the shared-memory layout it
    depends on (``repro_score_topk_plan``)."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().repro_score_topk_plan(b, n, k, topk, sms,
                                                         out),
                 "score_topk plan")
    return Plan(q=out[0], chunk_rows=out[1], n_chunks=out[2])


def check(V: torch.Tensor, A: torch.Tensor, topk: int) -> None:
    """Raise on what the kernel does not take.  The device check comes
    last, so the CPU tests reach the others."""
    if V.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("score_topk: V and A must be float32")
    if V.dim() != 2 or A.dim() != 2 or V.shape[1] != A.shape[1]:
        raise ValueError(f"score_topk: V (b, k) and A (n, k) expected, got "
                         f"{tuple(V.shape)} and {tuple(A.shape)}")
    k = A.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"score_topk: rank k={k} not supported "
                         f"(1 <= k <= {MAX_K})")
    if not 1 <= topk <= MAX_TOPK:
        raise ValueError(f"score_topk: topk={topk} not supported "
                         f"(1 <= topk <= {MAX_TOPK})")
    if A.shape[0] >= 2**31 - 1:
        raise ValueError(f"score_topk: n={A.shape[0]} does not fit the "
                         f"int32 indices")
    if not (V.is_contiguous() and A.is_contiguous()):
        raise ValueError("score_topk: V and A must be contiguous")
    if V.device.type != "cuda" or A.device != V.device:
        raise ValueError(f"score_topk: V and A must be on one CUDA device, "
                         f"got {V.device} and {A.device}")


def score_topk(V: torch.Tensor, A: torch.Tensor, *, topk: int,
               pn: int | None = None):
    """(scores (b, topk) f32, indices (b, topk) int32), the top-k of
    V @ A^T.  ``pn`` sets the panel of the plain version on CPU tensors
    and is not used by the kernel.  Empty V or A give the padded result
    without a launch."""
    global _launches
    if V.device.type == "cpu" and A.device.type == "cpu":
        return ref_score_topk_stream(V, A, topk,
                                     DEFAULT_PN if pn is None else pn)
    check(V, A, topk)
    b, n = V.shape[0], A.shape[0]
    if b == 0 or n == 0:
        return (torch.full((b, topk), -torch.inf, device=V.device),
                torch.full((b, topk), -1, dtype=torch.int32, device=V.device))
    p = plan(b, n, A.shape[1], topk,
             torch.cuda.get_device_properties(V.device).multi_processor_count)
    part_s = torch.empty((b, p.n_chunks, topk), device=V.device)
    part_i = torch.empty((b, p.n_chunks, topk), dtype=torch.int32,
                         device=V.device)
    out_s = torch.empty((b, topk), device=V.device)
    out_i = torch.empty((b, topk), dtype=torch.int32, device=V.device)
    with torch.cuda.device(V.device):
        rc = _build.library().repro_score_topk(
            V.data_ptr(), A.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), b, n, A.shape[1], topk, p.q,
            p.chunk_rows, p.n_chunks,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "score_topk")
    _launches += 1
    return out_s, out_i
