"""flash_attention — causal or non-causal GQA attention with online softmax,
as CUDA kernels for Hopper.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention``, the
Pallas kernel that ``repro`` calls the TPU execution path of
``models/attention.py:chunked_attention``.  In the port every layer's
full-sequence attention on a CUDA tensor (``models.attention.
chunked_attention``, hence ``prefill`` and ``forward``) launches it.

Two kernels, chosen by dtype (``variant``), each counted apart
(``launch_count_by_variant``; ``launch_count`` is their sum):

  ``sm90_bf16`` (``csrc/flash_attention_sm90.cu``): bfloat16 on the
      tensor cores: wgmma for q @ k^T and for p @ v with p kept in
      registers, K and V tiles loaded by TMA into a shared-memory ring by
      a producer warpgroup.
  ``fma_fp32`` (``csrc/flash_attention.cu``): float32 on the FMA pipes
      (the repo keeps TF32 off, so fp32 keeps its full precision).

Contract, as ``repro``'s: q (b, hq, sq, d), k and v (b, hkv, skv, d),
hq % hkv == 0 -> (b, hq, sq, d) in q's dtype; s = (q @ k^T) * sm_scale
in fp32 (sm_scale defaults to 1 / sqrt(d)), masked to -1e30 where
q_offset + qi < kj when causal, the running (m, l, acc) in fp32, p cast
to v's dtype for p @ v, out = acc / max(l, 1e-30).  The bf16 kernel
folds sm_scale * log2(e) into one fp32 product and takes exp2.

Bound on an H100: operations, 4 * b * hq * d flop per visible (query,
key) pair, about half of sq * skv when causal (the masked key tiles are
skipped).  K and V of a query head's KV group are read through strides
(no repeat, no transpose); any sq and skv.

Limits of the kernels (``repro``'s plain and Pallas paths have none of
them, apart from Pallas's tile multiples): float32 or bfloat16, all three
alike; d in {16, 32, 64, 128}; a unit stride on d; q_offset >= 0; b * hq
<= 65535.  bfloat16 also: q, k and v 16-byte aligned, and their b, h and
s strides (on axes longer than 1) multiples of 16 bytes (TMA), sq <=
65535 * 128.  Outside them a CUDA call raises ``ValueError``.

On CPU tensors the wrapper runs the plain version
(``kernels/ref.py:ref_attention``); on CUDA tensors it launches the
kernel of its dtype or raises; on meta tensors it runs up to the launch
and returns an output of the right shape (``launch.step_costs``: each of
the three counts the launch's ``cost`` and the wrapper's own aten
work).  The kernels have no backward (nor has
``repro``'s Pallas kernel, which has no ``custom_vjp``): a call on CUDA
tensors of which one requires grad, with grad enabled, raises
``RuntimeError`` (``refuse_grad``) rather than return an output without
a ``grad_fn``.  Training differentiates the plain chunked path
(``impl="ref"``), as ``repro``'s training forward does.
"""
from __future__ import annotations

import torch

from repro_torch.launch import step_costs

from . import _build
from ._launch import MAX_SLICES, address
from .ref import ref_attention

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = {torch.bfloat16: "sm90_bf16", torch.float32: "fma_fp32"}
BQ_SM90 = 128          # query rows per CTA of the bf16 kernel (grid.y)

_launches = dict.fromkeys(VARIANTS.values(), 0)


def launch_count() -> int:
    """Kernel launches, both variants, since the last
    ``reset_launch_count``."""
    return sum(_launches.values())


def launch_count_by_variant() -> dict[str, int]:
    """Kernel launches per variant since the last ``reset_launch_count``."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


class Call:
    """A checked flash_attention call: shapes, dtypes, strides and the
    query offset validated for the kernel.  ``require_cuda`` is the device
    check, apart, so the CPU tests reach the others."""

    def __init__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_offset: int):
        if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
            raise ValueError(f"flash_attention: want q (b, hq, sq, d) and "
                             f"k, v (b, hkv, skv, d); got {tuple(q.shape)}, "
                             f"{tuple(k.shape)}, {tuple(v.shape)}")
        b, hq, sq, d = q.shape
        _, hkv, skv, dk = k.shape
        if k.shape[0] != b or dk != d or hkv < 1 or hq % hkv:
            raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                             f"{tuple(k.shape)} disagree (same b and d, "
                             f"hq a multiple of hkv)")
        if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
            raise ValueError(f"flash_attention: q, k and v must all be "
                             f"float32 or all bfloat16, got {q.dtype}, "
                             f"{k.dtype}, {v.dtype}")
        if d not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head dim {d} not supported "
                             f"(one of {HEAD_DIMS})")
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.stride(-1) != 1:
                raise ValueError(f"flash_attention: {name}'s last axis must "
                                 f"have unit stride")
        if q_offset < 0:
            raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
        if skv < 1:
            raise ValueError("flash_attention: no keys (skv = 0)")
        if b * hq > MAX_SLICES:
            raise ValueError(f"flash_attention: b * hq = {b * hq} exceeds "
                             f"{MAX_SLICES}")
        self.variant = VARIANTS[q.dtype]
        if self.variant == "sm90_bf16":
            self._check_tma(q, k, v)
        self.b, self.hq, self.sq, self.d = b, hq, sq, d
        self.hkv, self.skv = hkv, skv
        self.device = q.device

    @staticmethod
    def _check_tma(q, k, v) -> None:
        """The bf16 kernel reads q, k and v by TMA: a 16-byte aligned base
        and b, h, s strides of whole 16 bytes (axes of length 1 aside)."""
        for name, x in (("q", q), ("k", k), ("v", v)):
            if address(x) % 16:
                raise ValueError(f"flash_attention: {name}'s base address is "
                                 f"not 16-byte aligned (bf16 reads by TMA)")
            for axis, size, stride in zip("bhs", x.shape, x.stride()):
                if size > 1 and stride * x.element_size() % 16:
                    raise ValueError(
                        f"flash_attention: {name}'s {axis} stride {stride} "
                        f"is not a multiple of 16 bytes (bf16 reads by TMA)")
        if -(-q.shape[2] // BQ_SM90) > MAX_SLICES:
            raise ValueError(f"flash_attention: sq = {q.shape[2]} exceeds "
                             f"{MAX_SLICES * BQ_SM90}")

    def require_cuda(self, *tensors: torch.Tensor) -> None:
        """Raise unless every tensor is on one CUDA device (or all on
        meta: shapes only, counted up to the launch)."""
        if self.device.type not in ("cuda", "meta") or any(
                x.device != self.device for x in tensors):
            raise ValueError(
                f"flash_attention: every tensor must be on one CUDA device, "
                f"got {sorted({str(x.device) for x in tensors})}")


def visible_pairs(sq: int, skv: int, causal: bool = True,
                  q_offset: int = 0) -> int:
    """(query, key) pairs a head attends: all sq * skv, or, causal, the
    keys at or before each query's position q_offset + i."""
    if not causal:
        return sq * skv
    # sum over i < sq of min(skv, q_offset + i + 1), the first terms
    # below skv
    below = max(0, min(sq, skv - q_offset))
    lo = q_offset + 1
    return (below * (2 * lo + below - 1)) // 2 + (sq - below) * skv


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, q_offset: int = 0, dqk: int | None = None,
         dv: int | None = None) -> tuple[int, int]:
    """(flops, bytes) of one call's own work: 2 (dqk + dv) flop per
    visible (query, key) pair and query head; q, k and v read once and
    the output written once.  ``dqk`` and ``dv`` are the function's own
    head widths where the call pads them (MLA), else q's and v's."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dqk = dqk or d
    dv = dv or v.shape[-1]
    pairs = visible_pairs(sq, skv, causal, q_offset)
    nbytes = q.element_size() * (b * hq * sq * (dqk + dv)
                                 + b * hkv * skv * (dqk + dv))
    return 2 * b * hq * pairs * (dqk + dv), nbytes


def refuse_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``RuntimeError`` when grad is enabled and q, k or v requires
    it: the kernel's output would carry no ``grad_fn``, so a loss through
    it would leave the projections before it without gradients."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the CUDA kernel has no backward and q, k or v "
            "requires grad; differentiate the plain chunked path "
            "(impl=\"ref\") or call under torch.no_grad()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    sm_scale: float | None = None) -> torch.Tensor:
    """q (b, hq, sq, d), k and v (b, hkv, skv, d) -> (b, hq, sq, d) in q's
    dtype, laid out in memory as q is (a permuted (B, S, H, D) view gives
    a (B, S, H, D) buffer)."""
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return step_costs.as_card(flash_attention, ref_attention, q, k, v,
                                  causal=causal, q_offset=q_offset,
                                  sm_scale=sm_scale)
    refuse_grad(q, k, v)
    call = Call(q, k, v, q_offset)
    call.require_cuda(q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if call.device.type == "meta":
        step_costs.launched("flash_attention", cost, q, k, v,
                            causal=causal, q_offset=q_offset)
        return out
    if sm_scale is None:
        sm_scale = 1.0 / (call.d ** 0.5)
    strides = [x.stride(i) for x in (q, k, v, out) for i in range(3)]
    with torch.cuda.device(call.device):
        lib = _build.library()
        launcher = (lib.repro_flash_attention_sm90
                    if call.variant == "sm90_bf16"
                    else lib.repro_flash_attention)
        rc = launcher(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            call.b, call.hq, call.hkv, call.sq, call.skv, call.d, *strides,
            int(causal), int(q_offset), float(sm_scale),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"flash_attention ({call.variant})")
    _launches[call.variant] += 1
    step_costs.launched("flash_attention", cost, q, k, v, causal=causal,
                        q_offset=q_offset)
    return out
