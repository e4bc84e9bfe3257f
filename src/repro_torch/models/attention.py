"""GQA attention (port of ``repro/models/attention.py:27,159,212,223``):
the full-sequence ``chunked_attention`` (prefill and forward), the
single-token ``decode_attention`` against a cache, and the
``GQAAttention`` block.  Sliding-window, MLA, ring and cross attention
are not ported yet (ROADMAP.md §1).

``repro`` keeps two routes to one function: the Pallas kernel
``kernels/flash_attention.py`` on the TPU and the chunked online softmax
in XLA elsewhere, its oracle.  So here: on a CUDA tensor
``chunked_attention`` launches the hand-written CUDA kernel
(``kernels.ops.flash_attention``); on the CPU, or with ``impl="ref"``,
it runs ``repro``'s chunked algorithm in PyTorch.

Layouts: activations (B, S, H, D); caches (B, S, Hkv, D).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.policy import IMPLS

from .layers import apply_rope, dense_init, param

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
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" or (impl == "auto" and q.device.type == "cuda"):
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, q_offset=q_offset, sm_scale=sm_scale,
            impl="cuda")
        return out.transpose(1, 2)
    return _chunked(q, k, v, causal=causal, q_offset=q_offset, chunk=chunk,
                    q_chunk=q_chunk, sm_scale=sm_scale)


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
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """q (B, 1, Hq, D) against caches (B, S, Hkv, D) whose first ``pos``
    positions are filled (pos >= 1) -> (B, 1, Hq, D).

    ``repro`` scores the whole cache and masks positions >= pos to -1e30;
    their p is exp(-1e30 - m) = 0, so scoring only the first ``pos``
    positions gives the same result.  Scores and p @ v accumulate in fp32,
    p is cast to the cache's dtype first.  Plain PyTorch: ``repro``
    computes this outside any Pallas kernel too."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    g = Hq // Hkv
    scale = D ** -0.5
    qg = (q * torch.tensor(scale, dtype=q.dtype)).reshape(B, Hkv, g, D)
    kc = k_cache[:, :pos]
    vc = v_cache[:, :pos]
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), kc.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       vc.float())
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


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
             q_chunk: int, impl: str = "auto"):
        """Causal attention over the whole sequence: (out (B, S, d), k,
        v), k and v as the cache holds them."""
        B, S, _ = x.shape
        q, k, v = self.qkv(x, positions)
        o = chunked_attention(q, k, v, causal=True, q_chunk=q_chunk,
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
