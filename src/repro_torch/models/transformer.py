"""The dense decoder of the LM zoo (port of the dense family of
``repro/models/transformer.py``): llama3.2-1b, yi-9b and granite-20b, GQA
or MQA, SwiGLU or GELU MLP, tied embeddings.

  Transformer(cfg, device=, gen=)            parameters (drawn from gen)
  model.forward(tokens)          -> (logits (B, S, Vpad), aux); training
                                    passes impl="ref" (models/model.py
                                    ``loss_fn``)
  model.prefill(tokens)          -> (logits (B, 1, Vpad) of the last
                                     position, cache)
  model.decode_step(cache, tokens, pos) -> (logits (B, 1, Vpad), cache)

The cache is ``repro``'s: {"k", "v"}, each (L, B, S, Hkv, D).  On a CUDA
tensor every layer's full-sequence attention launches the CUDA
flash_attention kernel (``impl="auto"``); ``impl="ref"`` keeps the plain
chunked path, which a training forward takes: the kernel has no backward
(nor has ``repro``'s Pallas kernel), and a forward under grad on its
route raises.  The other families (moe, ssm, hybrid, encdec, vlm) and
MLA attention are not ported yet (ROADMAP.md §1) and raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device

from .attention import GQAAttention
from .layers import MLP, MLP2, embed, embed_init, param, rmsnorm, unembed

# prefill's query tile: flash-structured attention re-streams K/V once per
# q tile, so prefill (no backward) takes 2048-row tiles and a training
# forward keeps 256 (``repro``'s _attn_full)
PREFILL_Q_CHUNK = 2048
TRAIN_Q_CHUNK = 256


def head_dim(cfg) -> int:
    return cfg.head_dim or cfg.d_model // cfg.n_heads


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for an architecture the port does not
    run yet."""
    if cfg.family != "dense" or cfg.attn_impl != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with attention "
            f"{cfg.attn_impl!r} is not ported yet; repro_torch runs the "
            f"dense GQA decoders (ROADMAP.md §1 lists the rest in order)")


class DenseBlock(nn.Module):
    """rmsnorm -> GQA attention -> residual -> rmsnorm -> MLP -> residual."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.ln2 = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.attn = GQAAttention(d, cfg.n_heads, cfg.n_kv, head_dim(cfg),
                                 cfg.rope_theta, dtype, device)
        ffn = MLP2 if cfg.mlp == "gelu" else MLP
        self.mlp = ffn(d, cfg.d_ff, dtype, device)

    def forward(self, x, positions, *, q_chunk: int, impl: str = "auto"):
        """Returns (x, k, v)."""
        a, k, v = self.attn.full(rmsnorm(x, self.ln1), positions,
                                 q_chunk=q_chunk, impl=impl)
        x = x + a
        return x + self.mlp(rmsnorm(x, self.ln2)), k, v

    def decode(self, x, k_cache, v_cache, pos: int):
        x = x + self.attn.decode(rmsnorm(x, self.ln1), k_cache, v_cache, pos)
        return x + self.mlp(rmsnorm(x, self.ln2))


def _block_out(blk: DenseBlock, x, positions, impl: str):
    """A training forward's block: its output alone (the cache's k and v
    are prefill's)."""
    return blk(x, positions, q_chunk=TRAIN_Q_CHUNK, impl=impl)[0]


class Transformer(nn.Module):
    """A dense decoder at ``cfg``'s widths and dtype on ``device`` (CUDA
    unless the caller asks for the CPU).  With ``gen`` the weights are
    drawn as ``repro``'s ``init_params`` draws them (N(0, 1) / sqrt(d_in)
    for dense weights, N(0, 0.02^2) for the embedding, ones for the
    norms); without it they are left for a state dict to fill."""

    def __init__(self, cfg, *, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        dev = _device.resolve(device)
        dtype = dtype_of(cfg)
        self.cfg = cfg
        self.embed = param((cfg.padded_vocab, cfg.d_model), dtype, dev)
        self.layers = nn.ModuleList(DenseBlock(cfg, dtype, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                                  device=dev))
        if gen is not None:
            self.init_parameters(gen)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        self.embed.copy_(embed_init(gen, *self.embed.shape, self.embed.dtype,
                                    self.device))
        for blk in self.layers:
            blk.attn.init_parameters(gen)
            blk.mlp.init_parameters(gen)

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        return torch.arange(S, device=tokens.device).expand(B, S)

    def forward(self, tokens: torch.Tensor, *, impl: str = "auto",
                remat: bool = False):
        """tokens (B, S) -> (logits (B, S, Vpad), aux); aux is 0 (the
        dense family has no auxiliary loss).  Under grad, ``impl`` must be
        "ref" on a CUDA tensor (the kernel has no backward; the training
        loss passes it).  ``remat`` recomputes each decoder block in the
        backward instead of keeping its activations
        (``torch.utils.checkpoint``, non-reentrant), as ``repro`` wraps
        its scan body in ``jax.checkpoint``."""
        x = embed(self.embed, tokens)
        positions = self._positions(tokens)
        for blk in self.layers:
            if remat and torch.is_grad_enabled():
                x = checkpoint(_block_out, blk, x, positions, impl,
                               use_reentrant=False)
            else:
                x, _, _ = blk(x, positions, q_chunk=TRAIN_Q_CHUNK, impl=impl)
        logits = unembed(self.embed, rmsnorm(x, self.final_norm))
        return logits, torch.zeros((), device=x.device)

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """Zero-filled decode cache {"k", "v"}, each (L, B, S, Hkv, D)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv, head_dim(cfg))
        return {name: torch.zeros(shape, dtype=self.embed.dtype,
                                  device=self.device) for name in ("k", "v")}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, impl: str = "auto"):
        """Serving prefill: one full-sequence pass that also fills the
        decode cache.  tokens (B, S) -> (logits (B, 1, Vpad) of the last
        position, cache with S positions)."""
        B, S = tokens.shape
        cache = self.init_cache(B, S)
        x = embed(self.embed, tokens)
        positions = self._positions(tokens)
        for i, blk in enumerate(self.layers):
            x, k, v = blk(x, positions, q_chunk=PREFILL_Q_CHUNK, impl=impl)
            cache["k"][i] = k
            cache["v"][i] = v
        last = rmsnorm(x[:, S - 1:], self.final_norm)
        return unembed(self.embed, last), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int):
        """One token for every sequence: tokens (B, 1) at position ``pos``
        (the number of cached positions) -> (logits (B, 1, Vpad), cache).
        The cache is updated in place at ``pos`` (``repro`` carries it
        through a fori_loop with donated buffers to the same effect) and
        returned."""
        x = embed(self.embed, tokens)
        for i, blk in enumerate(self.layers):
            x = blk.decode(x, cache["k"][i], cache["v"][i], pos)
        return unembed(self.embed, rmsnorm(x, self.final_norm)), cache
