"""Attention variants (port of ``repro/models/attention.py``): the
full-sequence ``chunked_attention`` (prefill and forward), the
single-token ``decode_attention`` against a cache, the ``GQAAttention``
block, the banded ``sliding_window_attention`` and its ring-buffer decode
``ring_decode_attention`` (the hybrid family), the non-causal
``cross_attention`` (enc-dec), and MLA, multi-head latent attention
(``MLAAttention``: ``mla_latents``, ``mla_prefill``, ``mla_decode``).

``repro`` keeps two routes to one function: the Pallas kernel
``kernels/flash_attention.py`` on the TPU and the chunked online softmax
in XLA elsewhere, its oracle.  So here: on a CUDA tensor
``chunked_attention`` launches the hand-written CUDA kernel
(``kernels.ops.flash_attention``); on the CPU, or with ``impl="ref"``,
it runs ``repro``'s chunked algorithm in PyTorch.  Under a
``launch.step_costs`` counter, meta tensors take the kernel's route, and
the CPU's "auto" route (the kernel's plain version) is counted as that
route, as a kernel wrapper's CPU path is.  ``cross_attention``
and ``mla_prefill`` go through it.  MLA's q/k head dim (d_nope + d_rope)
and v head dim (d_v) differ and need not be one the kernel builds: on
the kernel's route q, k and v are written into zero-padded buffers of
the smallest head dim it builds that holds both, which adds exactly 0 to
every dot product, with the scale of the unpadded q/k dim.

``repro`` runs the sliding-window, ring, MLA decode and single-token
decode attention in XLA, outside its kernel (whose contract has no
window), so their ports are plain PyTorch on every device: no kernel is
bypassed.

On an LM grid (``gqa_plan``, ``gqa_grid_full``, ``gqa_grid_decode``,
``decode_attention(group=)``) GQA runs tensor parallel over "model" as
``repro``'s ``constrain_heads`` places it, its collectives derived from
the parameter specs; a grid prefill still attends through the CUDA
kernel, on each rank's heads.  MLA's prefill and decode take an
``MLAPlan`` the same way; one device is their plan-less case.

Layouts: activations (B, S, H, D); caches (B, S, Hkv, D).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels.policy import IMPLS
from repro_torch.launch import step_costs

from .layers import apply_rope, dense_init, param, rmsnorm

NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_offset: int = 0,
                      chunk: int = 1024, q_chunk: int = 256,
                      sm_scale: float | None = None,
                      impl: str = "auto") -> torch.Tensor:
    """Flash-structured attention: q (B, Sq, Hq, D), k and v (B, Skv, Hkv,
    D), Hq % Hkv == 0 -> (B, Sq, Hq, D).

    impl: auto — the CUDA kernel for CUDA tensors, the plain chunked path
                 for CPU tensors
          cuda — the CUDA kernel; a CPU tensor raises
          ref  — the plain chunked path on any device

    The kernel reads q, k and v through permuted views and writes a
    (B, Sq, Hq, D) buffer: no copies.  Its arithmetic is the Pallas
    body's (the scale multiplies s in fp32); the plain path keeps
    ``repro``'s chunked-attention order (q times the scale in q's dtype,
    the KV heads repeated to Hq, (q_chunk x chunk) score tiles).  For a
    power-of-two scale (d = 16, 64) the two scale placements agree
    exactly; for d = 128 they differ by a rounding in bf16.

    The kernel has no backward: on the kernel's route, q, k or v that
    requires grad with grad enabled raises ``RuntimeError``
    (``ops.flash_attention``); training passes ``impl="ref"`` and
    autograd differentiates the chunked path.
    """
    if on_kernel(impl, q):
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, q_offset=q_offset, sm_scale=sm_scale,
            impl="cuda")
        return out.transpose(1, 2)
    kw = dict(causal=causal, q_offset=q_offset, chunk=chunk,
              q_chunk=q_chunk, sm_scale=sm_scale)
    if impl == "auto":       # the kernel's route, its plain version here
        return step_costs.as_card(
            lambda q, k, v: chunked_attention(q, k, v, impl=impl, **kw),
            lambda q, k, v: _chunked(q, k, v, **kw), q, k, v)
    return _chunked(q, k, v, **kw)


def on_kernel(impl: str, x: torch.Tensor) -> bool:
    """Whether a full-sequence attention call on ``x`` with ``impl`` takes
    the CUDA kernel's route (``chunked_attention``'s rule); meta tensors
    take it as CUDA tensors do (``launch.step_costs``)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "cuda" or (impl == "auto"
                              and x.device.type in ("cuda", "meta"))


def _chunked(q, k, v, *, causal, q_offset, chunk, q_chunk, sm_scale):
    """``repro``'s chunked online softmax: query tiles of q_chunk rows,
    each scanning KV tiles of ``chunk`` keys with running (m, l, acc) in
    fp32.  Tail tiles are ragged (``repro`` asserts whole tiles), and a
    causal query tile stops at its last visible key: the tiles after it
    are wholly masked, and in ``repro``'s scan they leave (m, l, acc)
    exactly as they were."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    if Hkv != Hq:
        rep = Hq // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    q = q * torch.tensor(scale, dtype=q.dtype)
    chunk = min(chunk, Skv)
    q_chunk = min(q_chunk, Sq)
    dev = q.device
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=dev)
    for q0 in range(0, Sq, q_chunk):
        qi = q[:, q0:q0 + q_chunk].float()
        nq = qi.shape[1]
        q_ids = q_offset + torch.arange(q0, q0 + nq, device=dev)
        m = torch.full((B, Hq, nq), NEG_INF, device=dev)
        l = torch.zeros((B, Hq, nq), device=dev)
        acc = torch.zeros((B, Hq, nq, Dv), device=dev)
        for k0 in range(0, Skv, chunk):
            if causal and k0 > q_offset + q0 + nq - 1:
                break
            kj = k[:, k0:k0 + chunk]
            vj = v[:, k0:k0 + chunk]
            s = torch.einsum("bqhd,bkhd->bhqk", qi, kj.float())
            if causal:
                k_ids = torch.arange(k0, k0 + kj.shape[1], device=dev)
                s = torch.where(q_ids[:, None] >= k_ids[None, :], s,
                                NEG_INF)
            m_cur = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_cur)
            p = torch.exp(s - m_cur[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vj.dtype).float(),
                              vj.float())
            acc = acc * alpha[..., None] + pv
            m = m_cur
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q0:q0 + nq] = o.transpose(1, 2).to(q.dtype)
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     group=None) -> torch.Tensor:
    """q (B, 1, Hq, D) against caches (B, S, Hkv, D) whose first ``pos``
    positions are filled (pos >= 1) -> (B, 1, Hq, D).

    ``repro`` scores the whole cache and masks positions >= pos to -1e30;
    their p is exp(-1e30 - m) = 0, so scoring only the first ``pos``
    positions gives the same result.  Plain PyTorch: ``repro`` computes
    this outside any Pallas kernel too.

    With ``group`` (a grid axis, ``dist.sharding.AxisGroup``; ``repro``'s
    ``axis_name``) the cache's S axis is sharded over that axis: this
    rank holds positions index * S .. index * S + S - 1, attends to them
    with ``repro``'s finite mask (a rank whose chunk starts at or past
    ``pos`` has no live key; its m is -1e30 and its weight exp(m - m_g)
    is 0, where an empty slice would give -inf - -inf = NaN), and the
    partial (m, l, acc) are combined over the group: an all-reduce MAX of
    m, then SUMs of l and acc rescaled by exp(m - m_g)."""
    if group is None:
        return _attend_one(q, k_cache[:, :pos], v_cache[:, :pos])
    S = k_cache.shape[1]
    valid = group.index * S + torch.arange(S, device=q.device) < pos
    return _attend_group(q, k_cache, v_cache, valid, group)


def _attend_group(q, k, v, valid, group) -> torch.Tensor:
    """``_attend_one`` over keys sharded along ``group``: each rank's
    partial (m, l, acc) over its keys, combined (an all-reduce MAX of m,
    then SUMs of l and acc rescaled by exp(m - m_g))."""
    m, l, acc = _attend_partial(q, k, v, valid)
    m_g = group.pmax(m)
    w = torch.exp(m - m_g)
    l = group.psum(l * w)
    acc = group.psum(acc * w)
    return _finish(q, acc, l)


def _attend_partial(q, k, v, valid=None):
    """The softmax statistics of one query position q (B, 1, Hq, D)
    against k and v (B, S, Hkv, D), keys where ``valid`` (S,) is false
    masked to -1e30: (m, l, acc) in fp32, per (B, Hkv, group) query;
    scores and p @ v accumulate in fp32, p is cast to v's dtype first."""
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = (q * torch.tensor(D ** -0.5, dtype=q.dtype)).reshape(
        B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float())
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(), v.float())
    return m, l, acc


def _finish(q, acc, l) -> torch.Tensor:
    B, _, Hq, D = q.shape
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def _attend_one(q, k, v, valid=None) -> torch.Tensor:
    """One query position q (B, 1, Hq, D) against k and v (B, S, Hkv, D)
    (``_attend_partial``'s mask and precision) -> (B, 1, Hq, D)."""
    _, l, acc = _attend_partial(q, k, v, valid)
    return _finish(q, acc, l)


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int,
                             chunk: int = 256) -> torch.Tensor:
    """Banded causal attention: q, k, v (B, S, H*, D) -> (B, S, Hq, D);
    each query sees the keys j with i - window < j <= i.  As ``repro``:
    query chunks of ``chunk`` rows (which must divide S), each scoring a
    static band of keys before it, zero-padded at the front and masked;
    q times the scale in its dtype, scores and p @ v in fp32, p cast to
    v's dtype first."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    q = q * torch.tensor(D ** -0.5, dtype=q.dtype)
    chunk = min(chunk, Sq)
    if Sq % chunk:
        raise ValueError(f"sliding_window_attention: chunk {chunk} does "
                         f"not divide the sequence ({Sq})")
    band = ((window + chunk - 1) // chunk + 1) * chunk
    pad = band - chunk
    kp = nn.functional.pad(k, (0, 0, 0, 0, pad, 0))
    vp = nn.functional.pad(v, (0, 0, 0, 0, pad, 0))
    dev = q.device
    q_ids = torch.arange(chunk, device=dev)[:, None]
    k_ids = torch.arange(band, device=dev)[None, :] - pad
    mask = (q_ids >= k_ids) & (q_ids - k_ids < window)
    out = torch.empty_like(q)
    for i in range(Sq // chunk):
        q0 = i * chunk
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q0 + chunk].float(),
                         kp[:, q0:q0 + band].float())
        s = torch.where(mask & (q0 + k_ids >= 0), s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                         vp[:, q0:q0 + band].float())
        out[:, q0:q0 + chunk] = o.transpose(1, 2).to(q.dtype)
    return out


def ring_decode_attention(q: torch.Tensor, k_ring: torch.Tensor,
                          v_ring: torch.Tensor, pos: int,
                          window: int, *, group=None) -> torch.Tensor:
    """Decode against a ring-buffer sliding-window cache: q (B, 1, Hq, D),
    k_ring and v_ring (B, W, Hkv, D), W = window, slot j holding the most
    recent position p with p % W == j (keys rotated at their own
    positions).  Slot j's position is pos - ((pos - j) mod W); a slot
    whose position is negative (warm-up) is masked.  With ``group`` the
    ring's slots are sharded along it (this rank holds slots index * W_l
    .. index * W_l + W_l - 1) and the partials are combined as
    ``decode_attention(group=)`` combines them."""
    W_l = k_ring.shape[1]
    first = group.index * W_l if group is not None else 0
    slots = first + torch.arange(W_l, device=q.device)
    valid = pos - torch.remainder(pos - slots, window) >= 0
    if group is None:
        return _attend_one(q, k_ring, v_ring, valid)
    return _attend_group(q, k_ring, v_ring, valid, group)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    impl: str = "auto") -> torch.Tensor:
    """Non-causal attention of decoder queries q (B, Sq, H, D) over the
    encoder's k and v (B, Se, Hkv, D): ``chunked_attention`` with
    causal=False, so the CUDA kernel on a CUDA tensor."""
    return chunked_attention(q, k, v, causal=False,
                             chunk=min(1024, k.shape[1]), impl=impl)


class GQAAttention(nn.Module):
    """Grouped-query attention with rotary positions: wq (d, Hq*D), wk and
    wv (d, Hkv*D), wo (Hq*D, d)."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 rope_theta: float, dtype, device):
        super().__init__()
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        self.rope_theta = rope_theta
        self.wq = param((d_model, n_heads * head_dim), dtype, device)
        self.wk = param((d_model, n_kv * head_dim), dtype, device)
        self.wv = param((d_model, n_kv * head_dim), dtype, device)
        self.wo = param((n_heads * head_dim, d_model), dtype, device)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.copy_(dense_init(gen, *w.shape, w.dtype, w.device))

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, S, d) -> q (B, S, Hq, D), k and v (B, S, Hkv, D), q and k
        rotated."""
        B, S, _ = x.shape
        q = (x @ self.wq).reshape(B, S, self.n_heads, self.head_dim)
        k = (x @ self.wk).reshape(B, S, self.n_kv, self.head_dim)
        v = (x @ self.wv).reshape(B, S, self.n_kv, self.head_dim)
        q = apply_rope(q, positions, self.rope_theta)
        k = apply_rope(k, positions, self.rope_theta)
        return q, k, v

    def full(self, x: torch.Tensor, positions: torch.Tensor, *,
             q_chunk: int, impl: str = "auto", causal: bool = True):
        """Attention over the whole sequence (causal unless the encoder
        asks): (out (B, S, d), k, v), k and v as the cache holds them."""
        B, S, _ = x.shape
        q, k, v = self.qkv(x, positions)
        o = chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                              impl=impl)
        return o.reshape(B, S, -1) @ self.wo, k, v

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, pos: int) -> torch.Tensor:
        """One token x (B, 1, d) at position ``pos``: writes its k and v
        into the caches (B, S, Hkv, D) at ``pos``, in place, and attends
        to positions 0..pos."""
        B = x.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
        q, k, v = self.qkv(x, positions)
        k_cache[:, pos] = k[:, 0]
        v_cache[:, pos] = v[:, 0]
        o = decode_attention(q, k_cache, v_cache, pos + 1)
        return o.reshape(B, 1, -1) @ self.wo


# ---------------------------------------------------------------------------
# GQA on an LM grid (tensor parallel over "model")
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GQAPlan:
    """How one GQA layer splits over the "model" axis, derived from the
    parameter specs (``dist.sharding.param_specs``): which of wq, wk (and
    wv) and wo are sharded, and, when the heads divide the axis
    (``repro``'s ``constrain_heads``), this rank's query heads
    [q0, q0 + nq) and the KV heads [kv0, kv0 + nkv) they read.
    ``kv_local``: wk's column block on this rank is exactly those KV
    heads, so no gather is needed; ``kv_index``: the local KV head of each
    local query head where they do not group evenly (else None)."""
    n_heads: int
    n_kv: int
    head_dim: int
    wq: bool
    wk: bool
    wo: bool
    heads_local: bool
    q0: int
    nq: int
    kv0: int
    nkv: int
    kv_local: bool
    kv_index: tuple | None


def gqa_plan(n_heads: int, n_kv: int, head_dim: int, tp, *, wq: bool,
             wk: bool, wo: bool) -> GQAPlan:
    """The plan of a GQA layer on ``tp``'s model axis (``GQAPlan``).  A
    sharded wk need not hold whole heads: at model = 16 llama3.2-1b's wk
    (2048 x 512) gives each rank 32 columns, half a 64-wide KV head, so
    its KV heads are gathered before use.  ``tp`` None: one device, where
    nothing is split."""
    M, m = (tp.size, tp.index) if tp is not None else (1, 0)
    heads_local = M > 1 and n_heads % M == 0
    if not heads_local:
        return GQAPlan(n_heads, n_kv, head_dim, wq, wk, wo, False, 0,
                       n_heads, 0, n_kv, False, None)
    g = n_heads // n_kv
    nq = n_heads // M
    q0 = m * nq
    kv0 = q0 // g
    nkv = (q0 + nq - 1) // g + 1 - kv0
    kv_local = (wk and n_kv % M == 0 and nkv == n_kv // M
                and kv0 == m * nkv)
    index = tuple((q0 + t) // g - kv0 for t in range(nq))
    even = nq % nkv == 0 and index == tuple(t // (nq // nkv)
                                            for t in range(nq))
    return GQAPlan(n_heads, n_kv, head_dim, wq, wk, wo, True, q0, nq, kv0,
                   nkv, kv_local, None if even else index)


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    B, S = x.shape[:2]
    return x.reshape(B, S, n, -1)


def gqa_grid_full(attn: GQAAttention, h: torch.Tensor,
                  positions: torch.Tensor | None, plan: GQAPlan, tp, *,
                  q_chunk: int, impl: str = "auto", causal: bool = True,
                  need_kv: bool = False, kv_in: torch.Tensor | None = None,
                  rope: bool = True, attend=None):
    """GQA over the whole sequence on the grid: h (B, S, d), whole on
    every model rank -> (out (B, S, d), whole on every rank, and, with
    ``need_kv``, k and v (B, Skv, Hkv, D) with every KV head, as the
    cache holds them; else None, None).  ``attn`` holds this rank's
    blocks of wq, wk, wv (columns) and wo (rows).  ``kv_in`` (B, Skv,
    d): what k and v project from (cross attention: the encoder's
    output; default h); ``rope``: rotate q and k at ``positions`` (cross
    attention does not); ``attend(q, k, v)`` takes the place of
    ``chunked_attention`` (the hybrid's sliding window), and then the
    fallback attends every query on every rank.

    Heads divide the axis: each rank attends its query heads against
    their KV heads (its own column block of wk/wv when that is exactly
    those heads, else the gathered K/V's), through ``chunked_attention``
    (the CUDA kernel on a CUDA tensor), and the row-parallel wo's partial
    products are all-reduced.  Else (``constrain_heads``'s fallback):
    q, k and v are gathered whole; with S a multiple of the axis each
    rank attends its own block of S / model queries (``q_offset``)
    against the whole K/V and the outputs are gathered over the
    sequence; otherwise every rank attends every query."""
    B, S, _ = h.shape
    D = plan.head_dim
    src = h if kv_in is None else kv_in
    if kv_in is None:
        hs = ks = tp.split_use(h) if plan.wq or plan.wk else h
    else:
        hs = tp.split_use(h) if plan.wq else h
        ks = tp.split_use(kv_in) if plan.wk else kv_in
    q = hs @ attn.wq if plan.wq else h @ attn.wq
    k, v = ((ks @ attn.wk, ks @ attn.wv) if plan.wk else
            (src @ attn.wk, src @ attn.wv))
    def rot(t):
        return apply_rope(t, positions, attn.rope_theta) if rope else t

    attend_given = attend is not None
    if not attend_given:
        def attend(qa, ka, va):
            return chunked_attention(qa, ka, va, causal=causal,
                                     q_chunk=q_chunk, impl=impl)
    k_all = v_all = None
    if plan.heads_local:
        if plan.wq:
            ql = _heads(q, plan.nq)
        else:
            ql = _heads(tp.split_use(q)[..., plan.q0 * D:
                                        (plan.q0 + plan.nq) * D], plan.nq)
        ql = rot(ql)
        if plan.kv_local:
            kl, vl = rot(_heads(k, plan.nkv)), _heads(v, plan.nkv)
            if need_kv:
                k_all, v_all = tp.gather(kl, 2), tp.gather(vl, 2)
        else:
            kf = rot(_heads(tp.gather(k, -1) if plan.wk else k, plan.n_kv))
            vf = _heads(tp.gather(v, -1) if plan.wk else v, plan.n_kv)
            if need_kv:
                k_all, v_all = kf, vf
            sl = slice(plan.kv0, plan.kv0 + plan.nkv)
            kl, vl = tp.split_use(kf)[:, :, sl], tp.split_use(vf)[:, :, sl]
        if plan.kv_index is not None:
            idx = torch.tensor(plan.kv_index, device=h.device)
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        o = attend(ql, kl, vl).reshape(B, S, plan.nq * D)
        if plan.wo:
            out = tp.reduce(o @ attn.wo)
        else:
            out = tp.gather(o, -1) @ attn.wo
        return out, k_all, v_all
    qf = rot(_heads(tp.gather(q, -1) if plan.wq else q, plan.n_heads))
    kf = rot(_heads(tp.gather(k, -1) if plan.wk else k, plan.n_kv))
    vf = _heads(tp.gather(v, -1) if plan.wk else v, plan.n_kv)
    if not attend_given and tp.size > 1 and S > 1 and S % tp.size == 0:
        r0, n = tp.block(S)
        o = chunked_attention(tp.split_use(qf)[:, r0:r0 + n],
                              tp.split_use(kf), tp.split_use(vf),
                              causal=causal, q_offset=r0, q_chunk=q_chunk,
                              impl=impl)
        of = tp.gather(o.reshape(B, n, -1), 1)
    else:
        of = attend(qf, kf, vf).reshape(B, S, -1)
    if plan.wo:
        c0, nc = tp.block(of.shape[-1])
        out = tp.reduce(tp.split_use(of)[..., c0:c0 + nc] @ attn.wo)
    else:
        out = of @ attn.wo
    return out, (kf if need_kv else None), (vf if need_kv else None)


def gqa_grid_decode(attn: GQAAttention, h: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
                    plan: GQAPlan, tp, seq=None) -> torch.Tensor:
    """One token h (B, 1, d) at ``pos`` on the grid: q, k and v gathered
    whole over "model" (every head), the new K/V written into the
    caches (B, S_local, Hkv, D) on the rank that holds position ``pos``
    (``seq``: the axis the caches' S is sharded over, else None: each
    holds every position), ``decode_attention`` combined over ``seq``,
    then this rank's heads through the row-parallel wo and an
    all-reduce.  No autograd: serving only."""
    B = h.shape[0]
    q, k, v = gqa_grid_qkv1(attn, h, pos, plan, tp)
    S = k_cache.shape[1]
    owner, at = divmod(pos, S) if seq is not None else (None, pos)
    if seq is None or seq.index == owner:
        k_cache[:, at] = k[:, 0]
        v_cache[:, at] = v[:, 0]
    o = decode_attention(q, k_cache, v_cache, pos + 1, group=seq)
    return grid_out(o.reshape(B, 1, -1), attn.wo, plan.wo, tp)


def grid_heads(h: torch.Tensor, w: torch.Tensor, sharded: bool, n: int,
               tp) -> torch.Tensor:
    """A column-parallel projection h @ w gathered whole over "model",
    as n heads (B, S, n, D); no autograd (decode)."""
    x = h @ w
    return _heads(tp.gather(x, -1) if sharded else x, n)


def gqa_grid_qkv1(attn: GQAAttention, h: torch.Tensor, pos: int,
                  plan: GQAPlan, tp):
    """One token's q (B, 1, Hq, D), k and v (B, 1, Hkv, D), every head,
    gathered whole over "model"; q and k rotated at ``pos``."""
    positions = torch.full((h.shape[0], 1), pos, dtype=torch.int64,
                           device=h.device)
    q = apply_rope(grid_heads(h, attn.wq, plan.wq, plan.n_heads, tp),
                   positions, attn.rope_theta)
    k = apply_rope(grid_heads(h, attn.wk, plan.wk, plan.n_kv, tp),
                   positions, attn.rope_theta)
    return q, k, grid_heads(h, attn.wv, plan.wk, plan.n_kv, tp)


def grid_out(o: torch.Tensor, wo: torch.Tensor, sharded: bool, tp
             ) -> torch.Tensor:
    """The row-parallel output projection of o (..., H * D), whole on
    every model rank: this rank's block of o's columns through its rows
    of wo, all-reduced (or o @ wo where wo is whole)."""
    if sharded:
        c0, nc = tp.block(o.shape[-1])
        return tp.reduce(o[..., c0:c0 + nc] @ wo)
    return o @ wo


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention), MiniCPM3 / DeepSeek-V2 style
# ---------------------------------------------------------------------------

class MLAAttention(nn.Module):
    """Multi-head latent attention: queries through a rank-``q_lora``
    bottleneck, keys and values decompressed from a ``kv_lora`` latent,
    plus a ``d_rope`` rotary key shared by the heads.  The cache holds
    the latents {"c" (B, S, kv_lora), "r" (B, S, d_rope)}.  Weights as
    ``repro``'s ``mla_init``: wq_down (d, q_lora), q_norm, wq_up (q_lora,
    H*(d_nope+d_rope)), wkv_down (d, kv_lora+d_rope), kv_norm, wkv_up
    (kv_lora, H*(d_nope+d_v)), wo (H*d_v, d)."""

    def __init__(self, d_model: int, n_heads: int, *, q_lora: int,
                 kv_lora: int, d_nope: int, d_rope: int, d_v: int,
                 rope_theta: float, dtype, device):
        super().__init__()
        self.n_heads, self.kv_lora = n_heads, kv_lora
        self.d_nope, self.d_rope, self.d_v = d_nope, d_rope, d_v
        self.rope_theta = rope_theta
        self.wq_down = param((d_model, q_lora), dtype, device)
        self.q_norm = nn.Parameter(torch.ones(q_lora, dtype=dtype,
                                              device=device))
        self.wq_up = param((q_lora, n_heads * (d_nope + d_rope)), dtype,
                           device)
        self.wkv_down = param((d_model, kv_lora + d_rope), dtype, device)
        self.kv_norm = nn.Parameter(torch.ones(kv_lora, dtype=dtype,
                                               device=device))
        self.wkv_up = param((kv_lora, n_heads * (d_nope + d_v)), dtype,
                            device)
        self.wo = param((n_heads * d_v, d_model), dtype, device)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq_down, self.wq_up, self.wkv_down, self.wkv_up,
                  self.wo):
            w.copy_(dense_init(gen, *w.shape, w.dtype, w.device))

    def prefill(self, x, positions, *, q_chunk: int, impl: str = "auto"):
        return mla_prefill(self, x, positions, q_chunk=q_chunk, impl=impl)

    def decode(self, x, c_cache, r_cache, pos: int):
        return mla_decode(self, x, pos, c_cache, r_cache)


@dataclasses.dataclass(frozen=True)
class MLAPlan:
    """How an MLA layer splits over "model", from the parameter specs:
    which of wq_down, wq_up, wkv_down, wkv_up (columns) and wo (rows) are
    sharded, and ``heads_local``: H divides the axis, so this rank's
    column blocks of wq_up and wkv_up and its row block of wo are exactly
    its H / M heads (else a block may hold part of a head: minicpm3-4b's
    40 heads at model 16 are 2.5 per rank).  ``WHOLE``: nothing split,
    as on one device."""
    wq_down: bool = False
    wq_up: bool = False
    wkv_down: bool = False
    wkv_up: bool = False
    wo: bool = False
    heads_local: bool = False


WHOLE = MLAPlan()


def mla_plan(n_heads: int, tp, **sharded: bool) -> MLAPlan:
    """The plan of an MLA layer on ``tp``'s model axis (``MLAPlan``)."""
    local = (tp.size > 1 and n_heads % tp.size == 0 and sharded["wq_up"]
             and sharded["wkv_up"] and sharded["wo"])
    return MLAPlan(heads_local=local, **sharded)


def _whole_cols(tp, x: torch.Tensor, w: torch.Tensor, sharded: bool,
                xs: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w whole on every model rank: this rank's columns gathered
    where w is column-split (``xs``: x already marked ``split_use``)."""
    if not sharded:
        return x @ w
    return tp.gather((tp.split_use(x) if xs is None else xs) @ w, -1)


def mla_latents(p: MLAAttention, x: torch.Tensor, positions: torch.Tensor,
                plan: MLAPlan = WHOLE, tp=None, xs=None):
    """The compressed cache payload, whole on every model rank: (c_kv (B,
    S, kv_lora), k_rope (B, S, d_rope)), k_rope rotated.  The norm and
    the rotation need whole rows, so on a grid wkv_down's column blocks
    (latent and rope columns mixed) are gathered first."""
    B, S, _ = x.shape
    down = _whole_cols(tp, x, p.wkv_down, plan.wkv_down, xs)
    c_kv = rmsnorm(down[..., :p.kv_lora], p.kv_norm)
    k_rope = apply_rope(down[..., p.kv_lora:].reshape(B, S, 1, p.d_rope),
                        positions, p.rope_theta)
    return c_kv, k_rope.reshape(B, S, p.d_rope)


def mla_prefill(p: MLAAttention, x: torch.Tensor, positions: torch.Tensor,
                *, q_chunk: int = 256, impl: str = "auto",
                plan: MLAPlan = WHOLE, tp=None):
    """Training/prefill MLA: K and V decompressed, causal attention with
    the scale 1 / sqrt(d_nope + d_rope).  x (B, S, d) -> (out (B, S, d),
    (c_kv, k_rope)), the latents for the cache.  On the kernel's route
    q, k and v are written into zero buffers of one head dim the kernel
    builds (module docstring); ``ValueError`` when none holds them.

    On an LM grid (``plan`` on ``tp``'s "model" axis; x and the outputs
    whole on every model rank) the latents and q's latent (wq_down's
    gathered columns) are whole, normalized and rotated on every rank.
    Heads local: each rank decompresses and attends its H / M heads and
    its wo rows' partial products are all-reduced.  Else (a head split
    between ranks): q and K/V are gathered whole, each rank attends its
    block of S / model queries when S divides (else every query), and
    its block of the output's columns goes through its rows of wo."""
    B, S, _ = x.shape
    H, dn, dr, dv = p.n_heads, p.d_nope, p.d_rope, p.d_v
    xs = tp.split_use(x) if plan.wq_down or plan.wkv_down else None
    c_kv, k_rope = mla_latents(p, x, positions, plan, tp, xs)
    cq = rmsnorm(_whole_cols(tp, x, p.wq_down, plan.wq_down, xs), p.q_norm)
    rope = functools.partial(apply_rope, positions=positions,
                             theta=p.rope_theta)
    if plan.heads_local:
        Hl = H // tp.size
        q = (tp.split_use(cq) @ p.wq_up).reshape(B, S, Hl, dn + dr)
        kv = (tp.split_use(c_kv) @ p.wkv_up).reshape(B, S, Hl, dn + dv)
        o = mla_attend(q[..., :dn], rope(q[..., dn:]), kv[..., :dn],
                       tp.split_use(k_rope), kv[..., dn:], q_chunk=q_chunk,
                       impl=impl)
        return tp.reduce(o.reshape(B, S, Hl * dv) @ p.wo), (c_kv, k_rope)
    q = _whole_cols(tp, cq, p.wq_up, plan.wq_up).reshape(B, S, H, dn + dr)
    kv = _whole_cols(tp, c_kv, p.wkv_up, plan.wkv_up).reshape(B, S, H,
                                                               dn + dv)
    parts = (q[..., :dn], rope(q[..., dn:]), kv[..., :dn], k_rope,
             kv[..., dn:])
    if tp is not None and tp.size > 1 and S > 1 and S % tp.size == 0:
        r0, n = tp.block(S)
        qn, qr, kn, kr, vv = (tp.split_use(t) for t in parts)
        o = mla_attend(qn[:, r0:r0 + n], qr[:, r0:r0 + n], kn, kr, vv,
                       q_chunk=q_chunk, impl=impl, q_offset=r0)
        of = tp.gather(o.reshape(B, n, H * dv), 1)
    else:
        of = mla_attend(*parts, q_chunk=q_chunk, impl=impl).reshape(
            B, S, H * dv)
    if plan.wo:
        c0, nc = tp.block(H * dv)
        return tp.reduce(tp.split_use(of)[..., c0:c0 + nc] @ p.wo), \
            (c_kv, k_rope)
    return of @ p.wo, (c_kv, k_rope)


def mla_attend(q_nope, q_rope, k_nope, k_rope, v, *, q_chunk: int,
               impl: str, q_offset: int = 0) -> torch.Tensor:
    """MLA's causal attention: q_nope (B, Sq, H, d_nope), q_rope (B, Sq,
    H, d_rope), k_nope (B, Skv, H, d_nope), the shared k_rope (B, Skv,
    d_rope), v (B, Skv, H, d_v) -> (B, Sq, H, d_v), scale 1 / sqrt(d_nope
    + d_rope); the queries at positions q_offset.. (``mla_prefill``'s
    docstring has the kernel route)."""
    B, Sq, H, dn = q_nope.shape
    Skv, dr, dv = k_nope.shape[1], q_rope.shape[-1], v.shape[-1]
    scale = (dn + dr) ** -0.5
    if on_kernel(impl, q_nope):
        d = next((d for d in HEAD_DIMS if d >= max(dn + dr, dv)), None)
        if d is None:
            raise ValueError(f"mla_prefill: head dims {dn + dr} (q, k) and "
                             f"{dv} (v) exceed flash_attention's "
                             f"{HEAD_DIMS[-1]}")
        q = q_nope.new_zeros((B, Sq, H, d))
        k, vp = (k_nope.new_zeros((B, Skv, H, d)) for _ in range(2))
        q[..., :dn] = q_nope
        q[..., dn:dn + dr] = q_rope
        k[..., :dn] = k_nope
        k[..., dn:dn + dr] = k_rope[:, :, None]
        vp[..., :dv] = v
        return chunked_attention(q, k, vp, causal=True, q_offset=q_offset,
                                 sm_scale=scale, impl=impl)[..., :dv]
    def plain(q_nope, q_rope, k_nope, k_rope, v):
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(B, Skv, H, dr)],
                      dim=-1)
        return chunked_attention(q, k, v, causal=True, q_offset=q_offset,
                                 q_chunk=q_chunk, sm_scale=scale, impl="ref")

    parts = (q_nope, q_rope, k_nope, k_rope, v)
    if impl == "auto":       # the kernel's route, its plain version here
        return step_costs.as_card(
            lambda *p: mla_attend(*p, q_chunk=q_chunk, impl=impl,
                                  q_offset=q_offset), plain, *parts)
    return plain(*parts)


def _touched_heads(w: torch.Tensor, sharded: bool, tp, width: int):
    """A column block of a weight laid out as H heads of ``width``
    columns, as (h0, the block at its place among the heads h0 .. h1 - 1
    it touches, zero elsewhere: (rows, h1 - h0, width)); w whole: (0, w
    as (rows, H, width))."""
    if not sharded:
        return 0, w.reshape(w.shape[0], -1, width)
    c0, nc = tp.index * w.shape[1], w.shape[1]
    h0, h1 = c0 // width, -(-(c0 + nc) // width)
    pad = nn.functional.pad(w, (c0 - h0 * width, h1 * width - c0 - nc))
    return h0, pad.reshape(w.shape[0], h1 - h0, width)


def mla_decode(p: MLAAttention, x: torch.Tensor, pos: int,
               c_cache: torch.Tensor, r_cache: torch.Tensor,
               plan: MLAPlan = WHOLE, tp=None, seq=None) -> torch.Tensor:
    """Absorbed-matmul MLA decode of one token x (B, 1, d) at ``pos``:
    writes its latents into the caches (B, S, kv_lora) and (B, S,
    d_rope) at ``pos``, in place, maps the query into the latent space
    and attends to positions 0..pos of the compressed cache, in fp32 as
    ``repro``.  Returns the block's output (B, 1, d).  No autograd:
    serving only.

    On an LM grid (``plan`` on ``tp``'s "model" axis; x and the output
    whole on every model rank) the latents are whole and written on the
    rank that holds ``pos`` (``seq``: the axis the caches' positions
    are sharded over, else None: each holds every position); each rank
    scores its positions and the partials are combined as
    ``decode_attention(group=)`` combines them, every head on every
    rank.  Heads local: each rank maps its H / M heads' queries into the
    latent space through its own columns of wq_up and wkv_up (one
    all-gather), and decompresses its heads' values through its wkv_up
    columns and its rows of wo (one all-reduce).  Else q is gathered
    whole and q's latent goes through this rank's columns of wkv_up (on
    the heads they touch; a head split between ranks gets each rank's
    part of the sum), all-reduced; so does the value, then its block
    through this rank's rows of wo."""
    B = x.shape[0]
    H, dn, dr, dv, L = p.n_heads, p.d_nope, p.d_rope, p.d_v, p.kv_lora
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    c_new, r_new = mla_latents(p, x, positions, plan, tp)
    S = c_cache.shape[1]
    owner, at = divmod(pos, S) if seq is not None else (None, pos)
    if seq is None or seq.index == owner:
        c_cache[:, at] = c_new[:, 0]
        r_cache[:, at] = r_new[:, 0]
    cq = rmsnorm(_whole_cols(tp, x, p.wq_down, plan.wq_down), p.q_norm)
    partial = plan.wkv_up and not plan.heads_local
    if plan.heads_local:
        # this rank's heads' q latents and rotary parts, gathered: every
        # rank scores every head on its block of positions
        Hl = H // tp.size
        h0, w_up = tp.index * Hl, p.wkv_up.reshape(L, Hl, dn + dv)
        q = (cq @ p.wq_up).reshape(B, 1, Hl, dn + dr)
        q_lat = torch.einsum("bohd,lhd->bohl", q[..., :dn], w_up[..., :dn])
        q_rope = apply_rope(q[..., dn:], positions, p.rope_theta)
        both = tp.gather(torch.cat([q_lat, q_rope], dim=-1), 2)
        q_lat, q_rope = both[:, 0, :, :L], both[..., L:]
    else:
        q = _whole_cols(tp, cq, p.wq_up, plan.wq_up).reshape(B, 1, H,
                                                             dn + dr)
        h0, w_up = _touched_heads(p.wkv_up, plan.wkv_up, tp, dn + dv)
        q_lat = torch.einsum("bohd,lhd->bohl",
                             q[:, :, h0:h0 + w_up.shape[1], :dn],
                             w_up[..., :dn])[:, 0]
        if partial:
            q_lat = tp.reduce(nn.functional.pad(
                q_lat, (0, 0, h0, H - h0 - w_up.shape[1])))
        q_rope = apply_rope(q[..., dn:], positions, p.rope_theta)
    if seq is None:
        cc = c_cache[:, :pos + 1].float()
        rc = r_cache[:, :pos + 1].float()
    else:
        cc, rc = c_cache.float(), r_cache.float()
    s = (torch.einsum("bhl,bsl->bhs", q_lat.float(), cc)
         + torch.einsum("bohr,bsr->bhs", q_rope.float(), rc)) \
        * (dn + dr) ** -0.5
    if seq is None:
        o_lat = torch.einsum("bhs,bsl->bhl", torch.softmax(s, dim=-1), cc)
    else:
        s = torch.where(seq.index * S + torch.arange(S, device=x.device)
                        <= pos, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        pe = torch.exp(s - m)
        m_g = seq.pmax(m)
        w = torch.exp(m - m_g)
        l = seq.psum(pe.sum(dim=-1, keepdim=True) * w)
        acc = seq.psum(torch.einsum("bhs,bsl->bhl", pe, cc) * w)
        o_lat = acc / torch.clamp_min(l, 1e-30)
    nh = w_up.shape[1]
    out = torch.einsum("bhl,lhd->bhd", o_lat[:, h0:h0 + nh],
                       w_up[..., dn:].float())
    if partial:
        out = tp.reduce(nn.functional.pad(out, (0, 0, h0, H - h0 - nh)))
    out = out.reshape(B, 1, -1).to(x.dtype)
    if plan.heads_local:
        return tp.reduce(out @ p.wo)
    return grid_out(out, p.wo, plan.wo, tp)
