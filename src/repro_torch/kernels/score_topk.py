"""score_topk — the top-k of V @ A^T without the (b, n) score matrix, as a
CUDA kernel for Hopper.

Replaces ``src/repro/kernels/score_topk.py:score_topk``, the Pallas kernel
behind every serve batch (``serve/engine.py``).  Source:
``csrc/score_topk.cu``.

Contract, as ``repro``'s: V (b, k) and A (n, k) float32 give f32 scores
and int32 indices, both (b, topk), in descending score; equal scores put
the lowest index first; slots past n (topk > n) are (-inf, -1).

Bound on an H100: fp32 operations (2bnk) once b exceeds ~10 queries at the
serve path's ranks, the reads of A (4nk bytes) below that.  Design (the
source's header has it in full): stage 1 runs one CTA per SM over a chunk
of A, a producer warp streaming 256-row tiles into a shared-memory ring by
cp.async; each consumer warp scores 8 rows per lane against up to 8
queries from registers and keeps, per query, a sorted list of 32 E
entries in registers (a warp selection), dropping rows that do not reach
its topk-th entry; stage 2 merges each query's partial lists.  ``plan``
cuts the work; from SEED_ROWS rows on a first pass over a prefix of A
seeds the thresholds.  The kernel's limits are k <= 64 and topk <= 1024
(``repro`` has neither).

On CPU tensors the wrapper runs the plain version
(``kernels/ref.py:ref_score_topk_stream``); on CUDA tensors it launches the
kernel or raises; on meta tensors it runs up to each launch and returns
outputs of the right shapes (``launch.step_costs``: each of the three
counts every launch's ``cost`` and the wrapper's own aten work).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.launch import step_costs

from . import _build
from ._launch import address, stream_handle
from .ref import DEFAULT_PN, ref_score_topk_stream

MAX_K = 64               # the kernel's limits (csrc/score_topk.cu refuses
MAX_TOPK = 1024          # the same), checked here to raise ValueError
TILE = 256               # rows of A per ring tile (csrc: TILE)
WARPS = 8                # consumer warps per CTA (csrc: WARPS)
STAGES = 2               # ring slots, the most row warps (csrc: STAGES)
MIN_TILES = 2            # tiles each row warp walks at least: its fill
                         # (the first topk entries) is paid per chunk
SEED_ROWS = 1 << 20      # from this n on, a first pass over A's first
SEED_SHARE = 16          # n / SEED_SHARE rows seeds the thresholds

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def list_regs(topk: int) -> int:
    """E, the list registers per lane: the least power of two with
    32 E >= topk."""
    e = 1
    while 32 * e < topk:
        e *= 2
    return e


def warp_queries(e: int) -> int:
    """Queries per consumer warp for lists of ``e`` registers per lane
    (csrc: queries)."""
    return 1 if e >= 8 else 8 // e


@dataclasses.dataclass(frozen=True)
class Plan:
    lists_e: int         # E, list registers per lane
    groups: int          # query groups per CTA, a power of two <= WARPS
    row_warps: int       # warps per query group, each on every
                         # row_warps-th tile of the chunk (<= STAGES: a
                         # warp's tiles keep to its own ring slots)
    chunk_rows: int      # rows of A per stage-1 CTA, whole tiles
    n_chunks: int
    b: int

    @property
    def queries(self) -> int:
        """Queries per consumer warp."""
        return warp_queries(self.lists_e)

    @property
    def q_blocks(self) -> int:
        """CTAs along the batch: groups x queries queries each."""
        per = self.groups * self.queries
        return -(-self.b // per)

    @property
    def lists(self) -> int:
        """Partial lists per query, the input of stage 2."""
        return self.n_chunks * self.row_warps


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


@functools.lru_cache(maxsize=256)
def plan(b: int, n: int, k: int, topk: int, sms: int) -> Plan:
    """The launch plan for this shape on a card with ``sms`` SMs.  The
    batch splits into groups of ``warp_queries`` queries, up to 8 groups
    per CTA (fewer groups leave the CTA's 8 warps to share a group's rows
    as row warps); n splits into chunks of whole tiles so that stage 1 has
    about one CTA per SM, each row warp walking at least MIN_TILES
    tiles."""
    if b < 1 or n < 1 or not 1 <= k <= MAX_K or not 1 <= topk <= MAX_TOPK \
            or sms < 1:
        raise ValueError(f"score_topk plan: b={b} n={n} k={k} topk={topk} "
                         f"sms={sms} outside the kernel's limits")
    e = list_regs(topk)
    groups_total = -(-b // warp_queries(e))
    groups = min(WARPS, _pow2_at_least(groups_total))
    q_blocks = -(-groups_total // groups)
    row_warps = min(WARPS // groups, STAGES)
    tiles = -(-n // TILE)
    want = max(1, sms // q_blocks)
    most = max(1, tiles // (row_warps * MIN_TILES))
    per = -(-tiles // max(1, min(want, most)))
    return Plan(lists_e=e, groups=groups, row_warps=row_warps,
                chunk_rows=per * TILE, n_chunks=-(-tiles // per), b=b)


@functools.lru_cache(maxsize=16)
def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if V.device.type not in ("cuda", "meta") or A.device != V.device:
        raise ValueError(f"score_topk: V and A must be on one CUDA device, "
                         f"got {V.device} and {A.device}")


def cost(V: torch.Tensor, A: torch.Tensor, topk: int) -> tuple[int, int]:
    """(flops, bytes) of one pass's own work: the 2bnk flop of the scores;
    V and A read once, the (b, topk) scores and int32 indices written
    once."""
    b, (n, k) = V.shape[0], A.shape
    return 2 * b * n * k, 4 * (n * k + b * k) + 8 * b * topk


def _launch(V: torch.Tensor, A: torch.Tensor, topk: int, seed=None):
    """One stage 1 + stage 2 pass over all of A, its lists' thresholds
    started from the topk-th entries of ``seed`` (scores, indices) when
    given."""
    global _launches
    b, n, k = V.shape[0], A.shape[0], A.shape[1]
    dev = V.device
    if dev.type == "meta":
        step_costs.launched("score_topk", cost, V, A, topk)
        return (torch.empty((b, topk), device=dev),
                torch.empty((b, topk), dtype=torch.int32, device=dev))
    p = plan(b, n, k, topk, sm_count(dev))
    part = torch.empty((2, b, p.lists, topk), device=dev)
    out_s = torch.empty((b, topk), device=dev)
    out_i = torch.empty((b, topk), dtype=torch.int32, device=dev)
    seed_s, seed_i = (0, 0) if seed is None else (x.data_ptr() for x in seed)
    args = (V.data_ptr(), A.data_ptr(), seed_s, seed_i, part[0].data_ptr(),
            part[1].data_ptr(), out_s.data_ptr(), out_i.data_ptr(), b, n, k,
            topk, p.lists_e, p.groups, p.row_warps, p.chunk_rows, p.n_chunks)
    launch = _build.library().repro_score_topk
    if dev.index == torch.cuda.current_device():
        rc = launch(*args, stream_handle(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = launch(*args, stream_handle(dev.index))
    _build.check(rc, "score_topk")
    _launches += 1
    step_costs.launched("score_topk", cost, V, A, topk)
    return out_s, out_i


def score_topk(V: torch.Tensor, A: torch.Tensor, *, topk: int,
               pn: int | None = None):
    """(scores (b, topk) f32, indices (b, topk) int32), the top-k of
    V @ A^T.  ``pn`` sets the panel of the plain version on CPU tensors
    and is not used by the kernel.  Empty V or A give the padded result
    without a launch.  From SEED_ROWS rows on, a first launch over A's
    first n / SEED_SHARE rows gives every query a threshold to start from
    (the result's topk-th entry precedes or equals a subset's), so the
    full pass keeps few candidates: two launches."""
    if V.device.type == "cpu" and A.device.type == "cpu":
        return step_costs.as_card(
            score_topk, lambda V, A, topk: ref_score_topk_stream(
                V, A, topk, DEFAULT_PN if pn is None else pn), V, A,
            topk=topk)
    check(V, A, topk)
    b, n = V.shape[0], A.shape[0]
    if b == 0 or n == 0:
        return (torch.full((b, topk), -torch.inf, device=V.device),
                torch.full((b, topk), -1, dtype=torch.int32, device=V.device))
    if address(A) % 16:
        A = A.clone()        # the ring copies A in 16-byte chunks
    seed = _launch(V, A[:n // SEED_SHARE], topk) if n >= SEED_ROWS else None
    return _launch(V, A, topk, seed)
