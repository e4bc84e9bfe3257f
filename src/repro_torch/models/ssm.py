"""Mamba2 SSD (state-space duality) mixer (port of
``repro/models/ssm.py``; arXiv:2405.21060).

Chunked SSD for training and prefill (linear in the sequence length) and
an O(1) recurrent step for decode.  Layout: x (B, L, H, P), H heads of
headdim P; state (B, H, P, N), state size N; the B and C projections
shared across G groups of heads.

The chunk scan, as ``repro``'s: the within-chunk (diagonal) term through
the masked decay matrix L[i, j] = exp(sum_{t in (j, i]} dA_t), i >= j,
and the cross-chunk term through the carried state, chunk after chunk,
so that one chunk's (Q, Q) blocks live at a time.  The scan runs in
fp32; the decode cache keeps the state in fp32 and the convolution's
window in the model's dtype.  All of it is plain PyTorch on every
device: ``repro`` runs it in XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init, param, rmsnorm


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA (..., Q) -> (..., Q, Q): out[i, j] = sum_{t=j+1..i} dA_t for
    i >= j, -inf otherwise."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int = 256, h0=None):
    """SSD scan: x (B, L, H, P), dt (B, L, H), A (H,) negative, Bm and Cm
    (B, L, G, N) -> (y (B, L, H, P) in x's dtype, h_last (B, H, P, N)
    fp32).  ``chunk`` must divide L (``repro`` asserts it)."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    chunk = min(chunk, L)
    if L % chunk:
        raise ValueError(f"ssd_chunked: chunk {chunk} does not divide the "
                         f"sequence ({L})")
    xd = (x * dt[..., None]).float()                      # dt-scaled input
    dA = (dt * A).float()                                 # (B, L, H)
    Bf, Cf = Bm.float(), Cm.float()
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    y = torch.empty((Bsz, L, H, P), dtype=x.dtype, device=x.device)
    for c0 in range(0, L, chunk):
        sl = slice(c0, c0 + chunk)
        xq, dAq, Bq, Cq = xd[:, sl], dA[:, sl], Bf[:, sl], Cf[:, sl]
        # intra-chunk (diagonal)
        Lmat = torch.exp(_segsum(dAq.transpose(1, 2)))    # (B, H, Q, Q)
        CB = torch.einsum("bqgn,bkgn->bgqk", Cq, Bq)      # (B, G, Q, Q)
        scores = CB.repeat_interleave(rep, dim=1) * Lmat
        y_diag = torch.einsum("bhqk,bkhp->bqhp", scores, xq)
        # cross-chunk: the carried state's contribution
        dA_cum = torch.cumsum(dAq, dim=1)                 # (B, Q, H)
        Ch = Cq.repeat_interleave(rep, dim=2)             # (B, Q, H, N)
        y_off = torch.einsum("bqhn,bqh,bhpn->bqhp", Ch, torch.exp(dA_cum),
                             h)
        # state update
        decay_in = torch.exp(dA_cum[:, -1:, :] - dA_cum)  # (B, Q, H)
        Bh = Bq.repeat_interleave(rep, dim=2)
        states = torch.einsum("bqhn,bqh,bqhp->bhpn", Bh, decay_in, xq)
        h = h * torch.exp(dA_cum[:, -1, :])[..., None, None] + states
        y[:, sl] = (y_diag + y_off).to(x.dtype)
    return y, h


def ssd_decode_step(h, x, dt, A, Bm, Cm):
    """One recurrent step: h (B, H, P, N), x (B, H, P), dt (B, H), Bm and
    Cm (B, G, N) -> (y (B, H, P), h_new)."""
    rep = x.shape[1] // Bm.shape[1]
    dA = torch.exp((dt * A).float())                      # (B, H)
    Bh = Bm.float().repeat_interleave(rep, dim=1)         # (B, H, N)
    Ch = Cm.float().repeat_interleave(rep, dim=1)
    xd = (x * dt[..., None]).float()
    h_new = h * dA[..., None, None] + torch.einsum("bhp,bhn->bhpn", xd, Bh)
    y = torch.einsum("bhpn,bhn->bhp", h_new, Ch)
    return y.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# The Mamba2 mixer block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def mamba2_dims(d_model: int, expand: int, headdim: int, groups: int,
                state: int):
    """(d_inner, n_heads, conv_dim)."""
    d_inner = expand * d_model
    return d_inner, d_inner // headdim, d_inner + 2 * groups * state


class Mamba2(nn.Module):
    """The Mamba2 mixer: in_proj (d, 2 d_inner + 2 G N + H), a depthwise
    causal conv (conv_w (K, conv_dim), conv_b), A_log, D and dt_bias (H,)
    in fp32, the gated norm's weight (d_inner,) and out_proj (d_inner,
    d); initialized as ``repro``'s ``mamba2_init``."""

    def __init__(self, d_model: int, *, state: int, expand: int = 2,
                 headdim: int = 64, groups: int = 1, conv: int = 4,
                 dtype=torch.float32, device=None):
        super().__init__()
        d_inner, H, conv_dim = mamba2_dims(d_model, expand, headdim, groups,
                                           state)
        self.state, self.headdim, self.groups = state, headdim, groups
        self.d_inner, self.n_heads = d_inner, H
        f32 = torch.float32
        self.in_proj = param((d_model, 2 * d_inner + 2 * groups * state + H),
                             dtype, device)
        self.conv_w = param((conv, conv_dim), dtype, device)
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, dtype=dtype,
                                               device=device))
        self.A_log = nn.Parameter(torch.zeros(H, dtype=f32, device=device))
        self.D = nn.Parameter(torch.ones(H, dtype=f32, device=device))
        self.dt_bias = nn.Parameter(torch.zeros(H, dtype=f32, device=device))
        self.norm = nn.Parameter(torch.ones(d_inner, dtype=dtype,
                                            device=device))
        self.out_proj = param((d_inner, d_model), dtype, device)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        for w in (self.in_proj, self.out_proj):
            w.copy_(dense_init(gen, *w.shape, w.dtype, w.device))
        self.conv_w.copy_(torch.randn(self.conv_w.shape, generator=gen,
                                      dtype=self.conv_w.dtype,
                                      device=self.conv_w.device) * 0.2)

    def forward(self, x, *, chunk: int = 256, return_state: bool = False):
        return mamba2_apply(self, x, chunk=chunk, return_state=return_state)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv: x (B, L, C), w (K, C); the taps summed in
    ``repro``'s order."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + xp[:, i:i + L] * w[i]
    return out + b


def _split_proj(proj, d_inner: int, groups: int, state: int, H: int):
    """in_proj's output -> (z, xBC, dt)."""
    return (proj[..., :d_inner],
            proj[..., d_inner:2 * d_inner + 2 * groups * state],
            proj[..., -H:])


def _ssd_inputs(p: Mamba2, xBC: torch.Tensor, lead: tuple):
    """The conv's activated output -> (xs (*lead, H, P), Bm and Cm (*lead,
    G, N))."""
    d_in, gn = p.d_inner, p.groups * p.state
    return (xBC[..., :d_in].reshape(*lead, p.n_heads, p.headdim),
            xBC[..., d_in:d_in + gn].reshape(*lead, p.groups, p.state),
            xBC[..., d_in + gn:].reshape(*lead, p.groups, p.state))


def _gated_out(p: Mamba2, y, xs, z, lead: tuple) -> torch.Tensor:
    """y + D x, the norm gated by silu(z), then out_proj."""
    y = y + (p.D[:, None] * xs.float()).to(y.dtype)
    y = y.reshape(*lead, p.d_inner)
    return rmsnorm(y * F.silu(z), p.norm) @ p.out_proj


def mamba2_apply(p: Mamba2, x: torch.Tensor, *, chunk: int = 256,
                 h0=None, return_state: bool = False):
    """The full-sequence (train, prefill) mixer: x (B, L, d) -> out (B, L,
    d); with ``return_state`` also (h_last (B, H, P, N) fp32, the last
    K - 1 pre-conv inputs (B, K - 1, conv_dim)), the decode cache."""
    Bsz, L, _ = x.shape
    proj = x @ p.in_proj
    z, xBC_raw, dt = _split_proj(proj, p.d_inner, p.groups, p.state,
                                 p.n_heads)
    xBC = F.silu(_causal_conv(xBC_raw, p.conv_w, p.conv_b))
    xs, Bm, Cm = _ssd_inputs(p, xBC, (Bsz, L))
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, h_last = ssd_chunked(xs, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    out = _gated_out(p, y, xs, z, (Bsz, L))
    if return_state:
        K = p.conv_w.shape[0]
        return out, (h_last, xBC_raw[:, -(K - 1):, :])
    return out


def mamba2_step(p: Mamba2, x: torch.Tensor, ssm_state: torch.Tensor,
                conv_state: torch.Tensor):
    """One token x (B, 1, d) against ssm_state (B, H, P, N) and
    conv_state (B, K - 1, conv_dim) -> (out (B, 1, d), new ssm_state,
    new conv_state)."""
    Bsz = x.shape[0]
    proj = x @ p.in_proj
    z, xBC, dt = _split_proj(proj, p.d_inner, p.groups, p.state, p.n_heads)
    window = torch.cat([conv_state, xBC], dim=1)          # (B, K, conv_dim)
    conv_out = torch.einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b
    xs, Bm, Cm = _ssd_inputs(p, F.silu(conv_out), (Bsz,))
    dtv = F.softplus(dt[:, 0].float() + p.dt_bias)
    y, h_new = ssd_decode_step(ssm_state, xs, dtv, -torch.exp(p.A_log),
                               Bm, Cm)
    out = _gated_out(p, y, xs, z, (Bsz, 1))
    return out, h_new, window[:, 1:]
