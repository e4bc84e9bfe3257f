"""The architecture zoo: one transformer substrate, six families (port of
``repro/models/transformer.py``).

  dense   GQA/MQA/MHA decoder (llama3.2-1b, yi-9b, granite-20b) and the
          MLA variant (minicpm3-4b), chosen by cfg.attn_impl
  moe     top-k routed experts (+ shared experts): granite-moe-3b-a800m,
          deepseek-moe-16b
  ssm     attention-free Mamba2/SSD stack (mamba2-1.3b)
  hybrid  parallel sliding-window attention + SSM heads per layer
          (hymba-1.5b)
  encdec  encoder-decoder with cross attention (whisper-large-v3; the
          audio frontend stubbed: the batch carries frame embeddings)
  vlm     decoder with prepended patch embeddings (internvl2-26b; the ViT
          stubbed: the batch carries patch embeddings)

  Transformer(cfg, device=, gen=)            parameters (drawn from gen)
  model.forward(tokens, frames=, patches=)   -> (logits (B, S, Vpad),
                                                aux); training passes
                                                impl="ref" (``loss_fn``)
  model.prefill(tokens, frames=, patches=)   -> (logits (B, 1, Vpad) of
                                                the last position, cache)
  model.decode_step(cache, tokens, pos)      -> (logits (B, 1, Vpad),
                                                cache)

``frames`` (B, Se, d_model) is enc-dec's encoder input and ``patches``
(B, n_patches, d_model) go before VLM's token embeddings, as in
``repro``'s batch.  ``moe_impl`` ("einsum" by default, as ``repro``)
picks the MoE path; aux is the layers' summed load-balance loss (0
without experts).

The cache is ``repro``'s, each leaf stacked over the layers (L, ...):
{"k", "v"} (L, B, S, Hkv, D) for GQA, plus the read-only cross-attention
{"xk", "xv"} (L, B, Se, Hkv, D) for enc-dec; {"c", "r"} (L, B, S,
kv_lora / d_rope) for MLA; {"ssm" (L, B, H, P, N) fp32, "conv" (L, B,
K-1, conv_dim)} for the SSM; the hybrid's ring {"k", "v"} (L, B, window,
Hkv, D) beside the SSM leaves.  On a CUDA tensor every full-sequence
GQA, MLA and cross attention launches the CUDA flash_attention kernel
(``impl="auto"``); ``impl="ref"`` keeps the plain chunked path, which a
training forward takes: the kernel has no backward (nor has ``repro``'s
Pallas kernel), and a forward under grad on its route raises.  The SSM
and the hybrid's sliding window run no kernel, as in ``repro``.

On an LM grid a model placed there (``train.serve_step.
params_shardings``) runs through ``GridTransformer``, ``repro``'s
forward/prefill/decode_step under a mesh; ``param_shapes`` is
``repro``'s parameter tree's shapes, what the placement rules read.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.dist.sharding import (BATCH_AXIS, MODEL_AXIS, Grid,
                                       LMPlacement, cache_specs, local_block,
                                       shard_batch, stacked_shapes)
from repro_torch.dist.tp import TensorParallel

from .attention import (GQAAttention, GQAPlan, MLAAttention,
                        cross_attention, decode_attention, gqa_grid_decode,
                        gqa_grid_full, gqa_grid_qkv1, gqa_plan, grid_heads,
                        grid_out, mla_decode, mla_plan, mla_prefill,
                        ring_decode_attention)
from .hybrid import Hymba, hymba_apply, hymba_step
from .layers import (MLP, MLP2, embed, embed_grid, embed_init, mlp_grid,
                     param, rmsnorm, unembed, unembed_grid)
from .moe import MoE, MoEGridPlan, moe_apply
from .ssm import Mamba2, mamba2_dims, mamba2_step

# prefill's query tile: flash-structured attention re-streams K/V once per
# q tile, so prefill (no backward) takes 2048-row tiles and a training
# forward (and the encoder) keeps 256 (``repro``'s _attn_full)
PREFILL_Q_CHUNK = 2048
TRAIN_Q_CHUNK = 256
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
ATTN_IMPLS = ("gqa", "mla")
# cache leaves that decode only reads
READONLY = ("xk", "xv")


def head_dim(cfg) -> int:
    return cfg.head_dim or cfg.d_model // cfg.n_heads


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _norm(d: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(d, dtype=dtype, device=device))


def _ffn(cfg, dtype, device):
    """(name, module): the routed experts "moe" or the MLP "mlp"."""
    if cfg.n_experts:
        return "moe", MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k,
                          cfg.n_shared, dtype, device)
    ffn = MLP2 if cfg.mlp == "gelu" else MLP
    return "mlp", ffn(cfg.d_model, cfg.d_ff, dtype, device)


def _mamba(cfg, dtype, device) -> Mamba2:
    return Mamba2(cfg.d_model, state=cfg.ssm_state, expand=cfg.ssm_expand,
                  headdim=cfg.ssm_headdim, groups=cfg.ssm_groups,
                  conv=cfg.ssm_conv, dtype=dtype, device=device)


class _Block(nn.Module):
    """What the blocks share: the FFN ("mlp" or "moe") and its apply,
    (y, aux) with aux 0 for an MLP."""

    def _add_ffn(self, cfg, dtype, device) -> None:
        self.ffn_name, ffn = _ffn(cfg, dtype, device)
        setattr(self, self.ffn_name, ffn)

    def ffn(self, h: torch.Tensor, moe_impl: str):
        if self.ffn_name == "moe":
            return self.moe(h, impl=moe_impl)
        return self.mlp(h), torch.zeros((), device=h.device)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        for child in self.children():
            child.init_parameters(gen)


class DecoderBlock(_Block):
    """dense / moe / vlm block, and enc-dec's decoder block: rmsnorm ->
    GQA or MLA attention -> residual -> [rmsnorm -> cross attention ->
    residual] -> rmsnorm -> MLP or MoE -> residual."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.mla = cfg.attn_impl == "mla"
        self.ln1 = _norm(d, dtype, device)
        self.ln2 = _norm(d, dtype, device)
        if self.mla:
            self.attn = MLAAttention(
                d, cfg.n_heads, q_lora=cfg.q_lora, kv_lora=cfg.kv_lora,
                d_nope=cfg.d_nope, d_rope=cfg.d_rope, d_v=cfg.d_v,
                rope_theta=cfg.rope_theta, dtype=dtype, device=device)
        else:
            self.attn = GQAAttention(d, cfg.n_heads, cfg.n_kv, head_dim(cfg),
                                     cfg.rope_theta, dtype, device)
        self.cross = cfg.family == "encdec"
        if self.cross:
            self.ln_x = _norm(d, dtype, device)
            self.xattn = GQAAttention(d, cfg.n_heads, cfg.n_kv,
                                      head_dim(cfg), cfg.rope_theta, dtype,
                                      device)
        self._add_ffn(cfg, dtype, device)

    def forward(self, x, positions, *, q_chunk: int, impl: str = "auto",
                moe_impl: str = "einsum", enc_out=None):
        """Returns (x, aux, this layer's cache leaves)."""
        h = rmsnorm(x, self.ln1)
        if self.mla:
            a, (c, r) = self.attn.prefill(h, positions, q_chunk=q_chunk,
                                          impl=impl)
            cache = {"c": c, "r": r}
        else:
            a, k, v = self.attn.full(h, positions, q_chunk=q_chunk,
                                     impl=impl)
            cache = {"k": k, "v": v}
        x = x + a
        if self.cross:
            o, xk, xv = self._cross(rmsnorm(x, self.ln_x), enc_out, impl)
            x = x + o
            cache.update(xk=xk, xv=xv)
        y, aux = self.ffn(rmsnorm(x, self.ln2), moe_impl)
        return x + y, aux, cache

    def _cross(self, h, enc_out, impl: str):
        """Cross attention of h (B, S, d) over the encoder's output (no
        rotary positions): (out, xk, xv)."""
        xa = self.xattn
        B, S, _ = h.shape
        Se = enc_out.shape[1]
        q = (h @ xa.wq).reshape(B, S, xa.n_heads, xa.head_dim)
        xk = (enc_out @ xa.wk).reshape(B, Se, xa.n_kv, xa.head_dim)
        xv = (enc_out @ xa.wv).reshape(B, Se, xa.n_kv, xa.head_dim)
        o = cross_attention(q, xk, xv, impl=impl)
        return o.reshape(B, S, -1) @ xa.wo, xk, xv

    def decode(self, x, c: dict, pos: int, moe_impl: str = "einsum"):
        h = rmsnorm(x, self.ln1)
        if self.mla:
            x = x + self.attn.decode(h, c["c"], c["r"], pos)
        else:
            x = x + self.attn.decode(h, c["k"], c["v"], pos)
        if self.cross:
            xa = self.xattn
            B = x.shape[0]
            q = (rmsnorm(x, self.ln_x) @ xa.wq).reshape(B, 1, xa.n_heads,
                                                         xa.head_dim)
            o = decode_attention(q, c["xk"], c["xv"], c["xk"].shape[1])
            x = x + o.reshape(B, 1, -1) @ xa.wo
        y, _ = self.ffn(rmsnorm(x, self.ln2), moe_impl)
        return x + y


class SSMBlock(_Block):
    """rmsnorm -> Mamba2 -> residual (no FFN)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.ln1 = _norm(cfg.d_model, dtype, device)
        self.mamba = _mamba(cfg, dtype, device)

    def forward(self, x, positions, *, q_chunk: int, impl: str = "auto",
                moe_impl: str = "einsum", enc_out=None):
        h = rmsnorm(x, self.ln1)
        y, (h_last, conv_tail) = self.mamba(h, chunk=min(256, h.shape[1]),
                                            return_state=True)
        return (x + y, torch.zeros((), device=x.device),
                {"ssm": h_last, "conv": conv_tail})

    def decode(self, x, c: dict, pos: int, moe_impl: str = "einsum"):
        y, s_new, conv_new = mamba2_step(self.mamba, rmsnorm(x, self.ln1),
                                         c["ssm"], c["conv"])
        c["ssm"].copy_(s_new)
        c["conv"].copy_(conv_new)
        return x + y


class HybridBlock(_Block):
    """rmsnorm -> Hymba mixer -> residual -> rmsnorm -> MLP or MoE ->
    residual."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _norm(d, dtype, device)
        self.ln2 = _norm(d, dtype, device)
        self.mixer = Hymba(d, cfg.n_heads, cfg.n_kv, head_dim(cfg),
                           window=cfg.window, rope_theta=cfg.rope_theta,
                           ssm_state=cfg.ssm_state,
                           ssm_headdim=cfg.ssm_headdim,
                           ssm_expand=cfg.ssm_expand,
                           ssm_groups=cfg.ssm_groups, dtype=dtype,
                           device=device)
        self._add_ffn(cfg, dtype, device)

    def forward(self, x, positions, *, q_chunk: int, impl: str = "auto",
                moe_impl: str = "einsum", enc_out=None):
        mix, cache = hymba_apply(self.mixer, rmsnorm(x, self.ln1), positions,
                                 return_state=True)
        x = x + mix
        y, aux = self.ffn(rmsnorm(x, self.ln2), moe_impl)
        return x + y, aux, cache

    def decode(self, x, c: dict, pos: int, moe_impl: str = "einsum"):
        x = x + hymba_step(self.mixer, rmsnorm(x, self.ln1), c, pos)
        y, _ = self.ffn(rmsnorm(x, self.ln2), moe_impl)
        return x + y


class EncoderLayer(_Block):
    """Enc-dec's encoder layer: rmsnorm -> non-causal GQA attention ->
    residual -> rmsnorm -> MLP -> residual."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _norm(d, dtype, device)
        self.attn = GQAAttention(d, cfg.n_heads, cfg.n_kv, head_dim(cfg),
                                 cfg.rope_theta, dtype, device)
        self.ln2 = _norm(d, dtype, device)
        self.mlp = (MLP2 if cfg.mlp == "gelu" else MLP)(d, cfg.d_ff, dtype,
                                                        device)

    def forward(self, x, positions, impl: str):
        o, _, _ = self.attn.full(rmsnorm(x, self.ln1), positions,
                                 q_chunk=TRAIN_Q_CHUNK, impl=impl,
                                 causal=False)
        x = x + o
        return x + self.mlp(rmsnorm(x, self.ln2))


def block_type(cfg) -> type:
    """The decoder block of ``cfg``'s family; ``ValueError`` for a family
    or attention outside the zoo."""
    if cfg.family not in FAMILIES or cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with attention "
                         f"{cfg.attn_impl!r} is not in the zoo (families "
                         f"{FAMILIES}, attention {ATTN_IMPLS})")
    return {"ssm": SSMBlock, "hybrid": HybridBlock}.get(cfg.family,
                                                        DecoderBlock)


def _block_out(blk, x, positions, impl: str, moe_impl: str, enc_out):
    """A training forward's block: (x, aux); the cache leaves are
    prefill's."""
    x, aux, _ = blk(x, positions, q_chunk=TRAIN_Q_CHUNK, impl=impl,
                    moe_impl=moe_impl, enc_out=enc_out)
    return x, aux


class Transformer(nn.Module):
    """A model of ``cfg``'s family at its widths and dtype on ``device``
    (CUDA unless the caller asks for the CPU).  With ``gen`` the weights
    are drawn as ``repro``'s ``init_params`` draws them (N(0, 1) /
    sqrt(d_in) for dense weights, N(0, 0.02^2) for the embedding, ones
    for the norms, and ``repro``'s own laws for the router, the experts
    and the SSM); without it they are left for a state dict to fill."""

    def __init__(self, cfg, *, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        block = block_type(cfg)
        dev = _device.resolve(device)
        dtype = dtype_of(cfg)
        self.cfg = cfg
        self.embed = param((cfg.padded_vocab, cfg.d_model), dtype, dev)
        self.layers = nn.ModuleList(block(cfg, dtype, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _norm(cfg.d_model, dtype, dev)
        if cfg.family == "encdec":
            self.enc_layers = nn.ModuleList(
                EncoderLayer(cfg, dtype, dev)
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = _norm(cfg.d_model, dtype, dev)
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
            blk.init_parameters(gen)
        for blk in getattr(self, "enc_layers", ()):
            blk.init_parameters(gen)

    @staticmethod
    def _positions(x: torch.Tensor) -> torch.Tensor:
        B, S = x.shape[:2]
        return torch.arange(S, device=x.device).expand(B, S)

    def _inputs(self, tokens, frames, patches, impl: str,
                remat: bool = False):
        """The decoder's input x (B, S, d) (VLM: the patches first) and
        enc-dec's encoder output (else None)."""
        fam = self.cfg.family
        x = embed(self.embed, tokens)
        if fam == "vlm":
            if patches is None:
                raise ValueError(f"{self.cfg.name}: the vlm family needs "
                                 f"patches (B, n_patches, d_model)")
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        enc_out = None
        if fam == "encdec":
            if frames is None:
                raise ValueError(f"{self.cfg.name}: the encdec family needs "
                                 f"frames (B, Se, d_model)")
            enc_out = self._encode(frames, impl, remat)
        return x, enc_out

    def _encode(self, frames, impl: str, remat: bool):
        """The encoder stack over the frame embeddings (non-causal)."""
        x = frames.to(self.embed.dtype)
        positions = self._positions(x)
        for blk in self.enc_layers:
            if remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, positions, impl, use_reentrant=False)
            else:
                x = blk(x, positions, impl)
        return rmsnorm(x, self.enc_norm)

    def forward(self, tokens: torch.Tensor, *,
                frames: torch.Tensor | None = None,
                patches: torch.Tensor | None = None, impl: str = "auto",
                moe_impl: str = "einsum", remat: bool = False):
        """tokens (B, S) -> (logits (B, S', Vpad), aux), S' = S plus the
        VLM's patches; aux the summed MoE load-balance loss (fp32, 0
        without experts).  Under grad, ``impl`` must be "ref" on a CUDA
        tensor (the kernel has no backward; the training loss passes it).
        ``remat`` recomputes each block in the backward instead of
        keeping its activations (``torch.utils.checkpoint``,
        non-reentrant), as ``repro`` wraps its scan bodies in
        ``jax.checkpoint``."""
        x, enc_out = self._inputs(tokens, frames, patches, impl, remat)
        positions = self._positions(x)
        aux = torch.zeros((), device=x.device)
        for blk in self.layers:
            if remat and torch.is_grad_enabled():
                x, a = checkpoint(_block_out, blk, x, positions, impl,
                                  moe_impl, enc_out, use_reentrant=False)
            else:
                x, a = _block_out(blk, x, positions, impl, moe_impl, enc_out)
            aux = aux + a
        logits = unembed(self.embed, rmsnorm(x, self.final_norm))
        return logits, aux

    def init_cache(self, batch_size: int, max_len: int, *,
                   device=None) -> dict:
        """The zero-filled decode cache of ``repro``'s ``init_cache`` (the
        module docstring lists its leaves); enc-dec's xk and xv take
        max_len positions, as ``repro``'s.  ``device`` (default the
        model's): "meta" gives the shapes and dtypes alone."""
        cfg = self.cfg
        L, B, S = cfg.n_layers, batch_size, max_len
        dtype, dev = self.embed.dtype, device or self.device

        def zeros(*shape, dt=dtype):
            return torch.zeros((L, B, *shape), dtype=dt, device=dev)

        cache = {}
        if cfg.family in ("ssm", "hybrid"):
            _, H, conv_dim = mamba2_dims(cfg.d_model, cfg.ssm_expand,
                                         cfg.ssm_headdim, cfg.ssm_groups,
                                         cfg.ssm_state)
            cache = {"ssm": zeros(H, cfg.ssm_headdim, cfg.ssm_state,
                                  dt=torch.float32),
                     "conv": zeros(cfg.ssm_conv - 1, conv_dim)}
        if cfg.family == "ssm":
            return cache
        if cfg.family == "hybrid":
            kv = (cfg.window, cfg.n_kv, head_dim(cfg))
            return {"k": zeros(*kv), "v": zeros(*kv), **cache}
        if cfg.attn_impl == "mla":
            return {"c": zeros(S, cfg.kv_lora), "r": zeros(S, cfg.d_rope)}
        kv = (S, cfg.n_kv, head_dim(cfg))
        cache = {"k": zeros(*kv), "v": zeros(*kv)}
        if cfg.family == "encdec":
            cache.update(xk=zeros(*kv), xv=zeros(*kv))
        return cache

    @torch.no_grad()
    def extend_cache(self, filled: dict, max_len: int) -> dict:
        """A cache of ``max_len`` positions that continues ``filled`` (a
        prefill's): the per-position leaves (k and v but the hybrid's
        ring, c and r) hold filled's positions first; the fixed-size
        leaves (ring, SSM state, conv window) are copies of filled's, and
        enc-dec's read-only xk and xv are filled's own."""
        B = next(iter(filled.values())).shape[1]
        cache = self.init_cache(B, max_len)
        for name, leaf in filled.items():
            if name in READONLY:
                cache[name] = leaf
            elif leaf.shape == cache[name].shape:
                cache[name].copy_(leaf)
            else:
                cache[name][:, :, :leaf.shape[2]] = leaf
        return cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *,
                frames: torch.Tensor | None = None,
                patches: torch.Tensor | None = None, impl: str = "auto",
                moe_impl: str = "einsum"):
        """Serving prefill: one full-sequence pass that also fills the
        decode cache.  tokens (B, S) -> (logits (B, 1, Vpad) of the last
        position, cache with the sequence's positions)."""
        x, enc_out = self._inputs(tokens, frames, patches, impl)
        positions = self._positions(x)
        L = len(self.layers)
        cache = {}
        for i, blk in enumerate(self.layers):
            x, _, leaves = blk(x, positions, q_chunk=PREFILL_Q_CHUNK,
                               impl=impl, moe_impl=moe_impl, enc_out=enc_out)
            for name, leaf in leaves.items():
                if name not in cache:
                    cache[name] = leaf.new_empty((L, *leaf.shape))
                cache[name][i] = leaf
        last = rmsnorm(x[:, -1:], self.final_norm)
        return unembed(self.embed, last), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int, *,
                    moe_impl: str = "einsum"):
        """One token for every sequence: tokens (B, 1) at position ``pos``
        (the number of positions before it, patches included) -> (logits
        (B, 1, Vpad), cache).  The cache is updated in place (``repro``
        carries it through a fori_loop with donated buffers to the same
        effect; enc-dec's xk and xv are only read) and returned."""
        x = embed(self.embed, tokens)
        for i, blk in enumerate(self.layers):
            x = blk.decode(x, {name: leaf[i] for name, leaf in cache.items()},
                           pos, moe_impl=moe_impl)
        return unembed(self.embed, rmsnorm(x, self.final_norm)), cache


# ---------------------------------------------------------------------------
# Shapes, and the model on an LM grid
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _named_shapes(cfg) -> tuple:
    return tuple((n, tuple(p.shape))
                 for n, p in meta_model(cfg).named_parameters())


def named_shapes(cfg) -> dict[str, tuple]:
    """The global shape of each of the port's parameters ({name: shape};
    built on the meta device, no storage)."""
    return dict(_named_shapes(cfg))


@functools.lru_cache(maxsize=None)
def meta_model(cfg) -> "Transformer":
    """``cfg``'s model on the meta device: every parameter's shape and
    dtype, no storage."""
    return Transformer(cfg, device="meta")


def cache_shapes(cfg, batch_size: int, max_len: int) -> dict:
    """The decode cache ``init_cache`` builds (``repro``'s
    ``cache_shapes``), as meta-device tensors: shapes and dtypes from the
    port's own model, no allocation."""
    return meta_model(cfg).init_cache(batch_size, max_len)


def param_shapes(cfg) -> dict[str, tuple]:
    """``repro``'s parameter tree's shapes ({"/"-path: shape}, layer
    stacks with their leading L axis; ``repro``'s ``param_shapes``),
    from the port's model without allocating it: what the placement
    rules (``dist.sharding.param_specs``) read."""
    return stacked_shapes(named_shapes(cfg))


def lm_placement(grid: Grid, cfg) -> LMPlacement:
    """Where each of ``cfg``'s parameters lives on ``grid`` (any family,
    any LM grid)."""
    if not grid.lm:
        raise ValueError("the LM runs on an LM grid (Grid(lm=True), "
                         "launch.mesh.make_lm_grid)")
    return LMPlacement(grid, named_shapes(cfg))


class GridRefusal(ValueError):
    """A batch or cache the grid cannot run (``check_rows``,
    ``init_cache``): what the dry run records as a cell's refusal."""


class GridTransformer:
    """A ``Transformer`` whose parameters are placed on an LM grid
    (``train.serve_step.params_shardings``), run as ``repro`` runs it on
    its mesh: tensor parallel over "model" (Megatron column / row
    parallel projections, vocab-parallel embedding and logits, heads
    split as ``constrain_heads`` splits them, the experts
    EXPERT-else-ff), data parallel over ("pod", "data"), the decode
    cache's blocks as ``cache_specs`` places them.  The residual stream
    between blocks is whole on every model rank (an all-reduce after
    each row-parallel product); ``repro`` keeps it sequence-sharded,
    which gives the same values.  Every family of the zoo:

      GQA (dense, MoE, VLM, enc-dec)  ``gqa_grid_full`` / ``_decode``
      MLA (minicpm3-4b)               ``mla_prefill`` / ``mla_decode``
      MoE                             ``moe.moe_apply`` (global groups and
                                      balance loss)
      SSM (mamba2)                    whole on every model rank (its
                                      in_proj and out_proj replicate)
      hybrid (hymba)                  ``hybrid.hymba_apply``; its
                                      Mamba2 branch whole
      enc-dec                         the encoder stack and cross
                                      attention tensor parallel
      VLM                             the patches after the
                                      vocab-parallel lookup

      forward(tokens, frames=, patches=)   -> (logits (B_l, S, V_l), aux)
      prefill(tokens, max_len, frames=, patches=)
                                           -> (logits (B_l, 1, Vpad),
                                               cache)
      decode_step(cache, tokens, pos)      -> (logits (B_l, 1, Vpad),
                                               cache)
      init_cache(batch, max_len)           -> cache (this cell's blocks)

    ``forward`` takes this cell's rows (and of ``frames`` / ``patches``)
    and gives its vocab block of the logits (the training loss reads
    them sharded); ``prefill`` takes the global batch and keeps this
    cell's rows (``batch_shardings``); ``decode_step`` takes and gives
    this cell's rows, with every vocab id.

    The cache: each cell holds its ``cache_specs`` block of every leaf.
    The per-position leaves (GQA's k and v, MLA's c and r) and enc-dec's
    read-only xk and xv are sequence-sharded, and a decode step combines
    the ranks' partial attention over them (``decode_attention(group=)``
    and its MLA counterpart); the hybrid's ring is sharded over its
    window's slots and combined alike.  The SSM state and the conv
    window (sharded over heads and channels where they divide) are
    gathered whole for the step, which runs the single-device
    ``mamba2_step`` on every model rank, and each rank keeps its block
    of the result: one all-gather per leaf and layer, the state's
    (B, H, P, N) fp32 the larger.

    With an MoE and more than one data cell the batch's rows must split
    evenly over the data axes (``GridRefusal``): its groups and balance
    loss are the global batch's."""

    def __init__(self, model: Transformer, grid: Grid,
                 placement: LMPlacement | None = None):
        cfg = model.cfg
        self.model, self.grid, self.cfg = model, grid, cfg
        self.placement = pl = placement or lm_placement(grid, cfg)
        for name, p in model.named_parameters():
            if tuple(p.shape) != pl.local_shape(name):
                raise ValueError(
                    f"{name} {tuple(p.shape)} is not this cell's block "
                    f"{pl.local_shape(name)}: place the model "
                    f"first (train.serve_step.params_shardings(grid, "
                    f"model))")
        self.tp = TensorParallel(grid)
        self.batch = grid.axis(BATCH_AXIS)
        self.rows = self.batch if self.batch.size > 1 else None
        self._fixed: dict[str, int | None] = {}
        self.vocab_sharded = pl.model_sharded("embed")
        fam = cfg.family
        self.plan = self.mla_plan = self.xplan = self.enc_plan = None
        self.moe_plan = None
        self.mlp_sharded = self.enc_mlp = False
        if fam == "hybrid":
            self.plan = self._gqa("layers.0.mixer.attn")
        elif fam != "ssm" and cfg.attn_impl == "mla":
            self.mla_plan = mla_plan(cfg.n_heads, self.tp, **{
                w: pl.model_sharded(f"layers.0.attn.{w}")
                for w in ("wq_down", "wq_up", "wkv_down", "wkv_up", "wo")})
        elif fam != "ssm":
            self.plan = self._gqa("layers.0.attn")
        if fam == "encdec":
            self.xplan = self._gqa("layers.0.xattn")
            self.enc_plan = self._gqa("enc_layers.0.attn")
            self.enc_mlp = self._mlp("enc_layers.0.mlp")
        if fam != "ssm":
            if cfg.n_experts:
                self.moe_plan = self._moe("layers.0.moe")
            else:
                self.mlp_sharded = self._mlp("layers.0.mlp")

    def _gqa(self, prefix: str) -> GQAPlan:
        sh = self.placement.model_sharded
        cfg = self.cfg
        return gqa_plan(cfg.n_heads, cfg.n_kv, head_dim(cfg), self.tp,
                        wq=sh(f"{prefix}.wq"), wk=sh(f"{prefix}.wk"),
                        wo=sh(f"{prefix}.wo"))

    def _mlp(self, prefix: str) -> bool:
        sh = self.placement.model_sharded
        if sh(f"{prefix}.wi") != sh(f"{prefix}.wo"):
            raise ValueError(f"{self.cfg.name}: the MLP's wi and wo must be "
                             f"split alike ({prefix})")
        return sh(f"{prefix}.wo")

    def _moe(self, prefix: str) -> MoEGridPlan:
        spec = self.placement[f"{prefix}.wgi"].spec
        experts = ("expert" if spec[0] == MODEL_AXIS else
                   "ff" if MODEL_AXIS in spec else "whole")
        return MoEGridPlan(
            router=self.placement.model_sharded(f"{prefix}.router"),
            experts=experts,
            shared=self._mlp(f"{prefix}.shared") if self.cfg.n_shared
            else False,
            n_experts=self.cfg.n_experts)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def check_rows(self, batch_size: int) -> None:
        if (self.cfg.n_experts and self.rows is not None
                and batch_size % self.rows.size):
            raise GridRefusal(
                f"{self.cfg.name}: the MoE on a grid of {self.rows.size} "
                f"data cells needs the batch's rows to split evenly over "
                f"them (its groups and balance loss are the global "
                f"batch's); got {batch_size} rows")

    # -- the blocks ---------------------------------------------------------

    def _ffn(self, blk, h, moe_impl: str):
        if blk.ffn_name == "moe":
            return moe_apply(blk.moe, h, self.cfg.top_k, impl=moe_impl,
                             plan=self.moe_plan, tp=self.tp, batch=self.rows)
        return (mlp_grid(blk.mlp, h, self.tp, self.mlp_sharded),
                torch.zeros((), device=h.device))

    def _block(self, i: int, x, positions, impl: str, q_chunk: int,
               moe_impl: str, enc_out, need: bool = False):
        """(x, aux, this layer's cache leaves, whole over "model")."""
        blk = self.model.layers[i]
        fam = self.cfg.family
        if fam == "ssm":
            y, (h_last, conv) = blk.mamba(rmsnorm(x, blk.ln1),
                                          chunk=min(256, x.shape[1]),
                                          return_state=True)
            return (x + y, torch.zeros((), device=x.device),
                    {"ssm": h_last, "conv": conv})
        h = rmsnorm(x, blk.ln1)
        if fam == "hybrid":
            mix = hymba_apply(blk.mixer, h, positions, plan=self.plan,
                              tp=self.tp, return_state=need)
            mix, cache = mix if need else (mix, {})
        elif self.mla_plan is not None:
            mix, (c, r) = mla_prefill(blk.attn, h, positions,
                                      q_chunk=q_chunk, impl=impl,
                                      plan=self.mla_plan, tp=self.tp)
            cache = {"c": c, "r": r}
        else:
            mix, k, v = gqa_grid_full(blk.attn, h, positions, self.plan,
                                      self.tp, q_chunk=q_chunk, impl=impl,
                                      need_kv=need)
            cache = {"k": k, "v": v}
        x = x + mix
        if fam == "encdec":
            o, xk, xv = gqa_grid_full(
                blk.xattn, rmsnorm(x, blk.ln_x), None, self.xplan, self.tp,
                q_chunk=q_chunk, need_kv=need, kv_in=enc_out, rope=False,
                attend=functools.partial(cross_attention, impl=impl))
            x = x + o
            cache.update(xk=xk, xv=xv)
        y, aux = self._ffn(blk, rmsnorm(x, blk.ln2), moe_impl)
        return x + y, aux, cache

    def _train_block(self, i: int, x, positions, impl: str, moe_impl: str,
                     enc_out):
        x, aux, _ = self._block(i, x, positions, impl, TRAIN_Q_CHUNK,
                                moe_impl, enc_out)
        return x, aux

    def _enc_layer(self, blk, x, positions, impl: str):
        o, _, _ = gqa_grid_full(blk.attn, rmsnorm(x, blk.ln1), positions,
                                self.enc_plan, self.tp,
                                q_chunk=TRAIN_Q_CHUNK, impl=impl,
                                causal=False)
        x = x + o
        return x + mlp_grid(blk.mlp, rmsnorm(x, blk.ln2), self.tp,
                            self.enc_mlp)

    def _inputs(self, tokens, frames, patches, impl: str,
                remat: bool = False):
        """``Transformer._inputs`` on the grid: the vocab-parallel lookup
        (VLM: the patches first, on every model rank) and enc-dec's
        encoder stack over this cell's frames."""
        m, fam = self.model, self.cfg.family
        x = embed_grid(m.embed, tokens, self.tp, self.vocab_sharded)
        if fam == "vlm":
            if patches is None:
                raise ValueError(f"{self.cfg.name}: the vlm family needs "
                                 f"patches (B, n_patches, d_model)")
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        if fam != "encdec":
            return x, None
        if frames is None:
            raise ValueError(f"{self.cfg.name}: the encdec family needs "
                             f"frames (B, Se, d_model)")
        e = frames.to(m.embed.dtype)
        positions = m._positions(e)
        for blk in m.enc_layers:
            if remat and torch.is_grad_enabled():
                e = checkpoint(self._enc_layer, blk, e, positions, impl,
                               use_reentrant=False)
            else:
                e = self._enc_layer(blk, e, positions, impl)
        return x, rmsnorm(e, m.enc_norm)

    def forward(self, tokens: torch.Tensor, *,
                frames: torch.Tensor | None = None,
                patches: torch.Tensor | None = None, impl: str = "ref",
                remat: bool = False, moe_impl: str = "einsum"):
        """tokens (B_l, S), this cell's rows (and of frames / patches) ->
        (logits (B_l, S', V_l), this rank's vocab block, and aux, the MoE
        balance loss of the global batch).  Training's forward: ``impl``
        "ref" (the plain chunked attention, which autograd
        differentiates)."""
        m = self.model
        x, enc_out = self._inputs(tokens, frames, patches, impl, remat)
        positions = m._positions(x)
        aux = torch.zeros((), device=x.device)
        for i in range(len(m.layers)):
            if remat and torch.is_grad_enabled():
                x, a = checkpoint(self._train_block, i, x, positions, impl,
                                  moe_impl, enc_out, use_reentrant=False)
            else:
                x, a = self._train_block(i, x, positions, impl, moe_impl,
                                         enc_out)
            aux = aux + a
        logits = unembed_grid(m.embed, rmsnorm(x, m.final_norm), self.tp,
                              self.vocab_sharded)
        return logits, aux

    def _whole_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        if self.vocab_sharded:
            return self.tp.gather(logits, -1)
        return logits

    # -- the cache ----------------------------------------------------------

    def _positional(self, name: str) -> bool:
        """Whether a leaf holds one entry per position (and is
        sequence-sharded on a model axis of several ranks)."""
        return self.cfg.family != "hybrid" and name in ("k", "v", "c", "r")

    def _model_dim(self, name: str, shape: tuple) -> int | None:
        """The dim of one layer's leaf (B, ...) that "model" splits, from
        ``cache_specs``: the positions of a per-position leaf; for the
        fixed-size leaves (SSM state, conv window, ring) their specs at
        their whole shapes.  For xk and xv, whose positions are the
        frames' (known to the prefill that placed them, not to a decode
        step's own ``GridTransformer``), the block's shape says it:
        ``cache_specs`` takes the first of positions, heads and head dim
        that the axis divides, and only the split one is below the
        config's, so it is the heads or the head dim where that one is
        smaller, else the positions."""
        if self.tp.size == 1:
            return None
        if self._positional(name):
            return 1
        if name in READONLY:
            whole = (self.cfg.n_kv, head_dim(self.cfg))
            return next((d for d, n in zip((2, 3), whole)
                         if shape[d] != n), 1)
        if name not in self._fixed:
            fixed = self.model.init_cache(1, 1, device="meta")[name]
            spec = cache_specs(self.grid, {name: fixed})[name]
            self._fixed[name] = next((d - 1 for d, e in enumerate(spec)
                                      if e == MODEL_AXIS), None)
        return self._fixed[name]

    def _whole(self, leaf: torch.Tensor, d: int | None) -> torch.Tensor:
        return leaf if d is None else self.grid.all_gather(leaf, MODEL_AXIS,
                                                           d)

    def _own(self, whole: torch.Tensor, d: int | None) -> torch.Tensor:
        if d is None:
            return whole
        n = whole.shape[d] // self.tp.size
        return whole.narrow(d, self.tp.index * n, n)

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """This cell's blocks of the zero decode cache of a global batch
        of ``batch_size`` sequences and ``max_len`` positions
        (``cache_specs``; ``GridRefusal`` when a per-position leaf's
        max_len is not a multiple of the model axis, which would put
        "model" on its heads)."""
        self.check_rows(batch_size)
        glob = self.model.init_cache(batch_size, max_len, device="meta")
        specs = cache_specs(self.grid, glob)
        out = {}
        for name, leaf in glob.items():
            if (self.tp.size > 1 and self._positional(name)
                    and specs[name][2] != MODEL_AXIS):
                raise GridRefusal(
                    f"the decode cache's {max_len} positions are not a "
                    f"multiple of the model axis ({self.tp.size}); the "
                    f"grid decode needs them sharded over it "
                    f"(cache_specs)")
            shape = local_block(self.grid, leaf, specs[name]).shape
            out[name] = torch.zeros(shape, dtype=leaf.dtype,
                                    device=self.device)
        return out

    def _store(self, cache: dict, name: str, i: int, leaf: torch.Tensor,
               B: int) -> None:
        """Layer i's whole leaf (this cell's rows) into this cell's block
        of the cache: a per-position leaf's block of positions, a fixed
        leaf's block by its spec; enc-dec's read-only xk and xv, the
        frames' positions, are made here (``cache_specs`` at their
        shape)."""
        if name in READONLY:
            if name not in cache:
                L = len(self.model.layers)
                spec = cache_specs(self.grid, {name: (L, B,
                                                      *leaf.shape[1:])})
                d = next((k - 1 for k, e in enumerate(spec[name])
                          if e == MODEL_AXIS), None)
                if self.tp.size > 1 and d is None:
                    raise ValueError(f"{name}: no dim of {tuple(leaf.shape)}"
                                     f" divides the model axis")
                self._fixed[name] = d
                cache[name] = leaf.new_empty((L, *self._own(leaf, d).shape))
            cache[name][i] = self._own(leaf, self._fixed[name])
            return
        if self._positional(name):
            s_l = cache[name].shape[2]
            p0 = self.tp.index * s_l if self.tp.size > 1 else 0
            n = max(0, min(leaf.shape[1], p0 + s_l) - p0)
            cache[name][i, :, :n] = leaf[:, p0:p0 + n]
            return
        cache[name][i] = self._own(leaf, self._model_dim(
            name, cache[name].shape[1:]))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int | None = None, *,
                frames: torch.Tensor | None = None,
                patches: torch.Tensor | None = None, impl: str = "auto",
                moe_impl: str = "einsum"):
        """Serving prefill of the global batch ``tokens`` (B, S) (and its
        ``frames`` or ``patches``): this cell's rows go through the
        layers (attention through the CUDA kernel on a CUDA tensor, on
        this rank's heads), each layer's cache leaves kept as this
        cell's blocks.  Returns (logits (B_l, 1, Vpad) of the last
        position, the cache of ``max_len`` (default S plus the
        patches) positions rounded up to a multiple of the model axis,
        this cell's blocks)."""
        B = tokens.shape[0]
        M = self.tp.size
        P = tokens.shape[1] + (patches.shape[1] if patches is not None
                               else 0)
        max_len = -(-(max_len or P) // M) * M
        cache = {n: x for n, x in self.init_cache(B, max_len).items()
                 if n not in READONLY}
        inputs = {"tokens": tokens, "frames": frames, "patches": patches}
        rows = shard_batch(self.grid, {k: v for k, v in inputs.items()
                                       if v is not None})
        m = self.model
        x, enc_out = self._inputs(rows["tokens"], rows.get("frames"),
                                  rows.get("patches"), impl)
        positions = m._positions(x)
        for i in range(len(m.layers)):
            x, _, leaves = self._block(i, x, positions, impl,
                                       PREFILL_Q_CHUNK, moe_impl, enc_out,
                                       need=True)
            for name, leaf in leaves.items():
                self._store(cache, name, i, leaf, B)
        last = unembed_grid(m.embed, rmsnorm(x[:, -1:], m.final_norm),
                            self.tp, self.vocab_sharded)
        return self._whole_vocab(last), cache

    # -- decode -------------------------------------------------------------

    def _mamba_step(self, mamba, h, c: dict) -> torch.Tensor:
        """``mamba2_step`` on the state and conv window gathered whole;
        this rank keeps its blocks of the new ones."""
        dims = {n: self._model_dim(n, c[n].shape) for n in ("ssm", "conv")}
        y, s_new, conv_new = mamba2_step(
            mamba, h, self._whole(c["ssm"], dims["ssm"]),
            self._whole(c["conv"], dims["conv"]))
        c["ssm"].copy_(self._own(s_new, dims["ssm"]))
        c["conv"].copy_(self._own(conv_new, dims["conv"]))
        return y

    def _hymba_step(self, p, h, c: dict, pos: int, seq) -> torch.Tensor:
        """``hymba_step`` on the grid: q, k and v whole, the new k and v
        into ring slot pos % W on the rank that holds it, the ring's
        partial attention combined over "model" (or the ring gathered
        whole where "model" splits its heads), this rank's block
        through its rows of wo; the Mamba2 branch as ``_mamba_step``."""
        B = h.shape[0]
        q, k, v = gqa_grid_qkv1(p.attn, h, pos, self.plan, self.tp)
        d = self._model_dim("k", c["k"].shape)
        slot = pos % p.window
        if d == 1:
            owner, at = divmod(slot, c["k"].shape[1])
            if seq.index == owner:
                c["k"][:, at] = k[:, 0]
                c["v"][:, at] = v[:, 0]
            o = ring_decode_attention(q, c["k"], c["v"], pos, p.window,
                                      group=seq)
        else:
            kr, vr = self._whole(c["k"], d), self._whole(c["v"], d)
            kr[:, slot] = k[:, 0]
            vr[:, slot] = v[:, 0]
            c["k"].copy_(self._own(kr, d))
            c["v"].copy_(self._own(vr, d))
            o = ring_decode_attention(q, kr, vr, pos, p.window)
        attn_out = grid_out(o.reshape(B, 1, -1), p.attn.wo, self.plan.wo,
                            self.tp)
        m_out = self._mamba_step(p.mamba, h, c)
        return 0.5 * (rmsnorm(attn_out, p.ln_a) + rmsnorm(m_out, p.ln_m))

    def _cross_step(self, xa, h, c: dict, seq) -> torch.Tensor:
        """Cross attention of one token over the read-only xk and xv,
        sequence-sharded (combined over "model") or gathered whole."""
        B = h.shape[0]
        q = grid_heads(h, xa.wq, self.xplan.wq, xa.n_heads, self.tp)
        d = self._model_dim("xk", c["xk"].shape)
        if d == 1:
            Se = c["xk"].shape[1] * self.tp.size
            o = decode_attention(q, c["xk"], c["xv"], Se, group=seq)
        else:
            xk, xv = self._whole(c["xk"], d), self._whole(c["xv"], d)
            o = decode_attention(q, xk, xv, xk.shape[1])
        return grid_out(o.reshape(B, 1, -1), xa.wo, self.xplan.wo, self.tp)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int, *,
                    moe_impl: str = "einsum"):
        """One token for this cell's rows: tokens (B_l, 1) at position
        ``pos`` -> (logits (B_l, 1, Vpad), cache updated in place).  Each
        layer's attention gathers its q (and new k, v or latents) whole
        over "model", writes the new entry on the rank that holds
        ``pos``, combines the ranks' partial attention over their blocks
        of positions, and runs its heads through wo; the class docstring
        has the SSM's and the ring's steps."""
        m, tp = self.model, self.tp
        seq = self.grid.axis(MODEL_AXIS) if tp.size > 1 else None
        fam = self.cfg.family
        x = embed_grid(m.embed, tokens, tp, self.vocab_sharded)
        for i, blk in enumerate(m.layers):
            c = {name: leaf[i] for name, leaf in cache.items()}
            h = rmsnorm(x, blk.ln1)
            if fam == "ssm":
                x = x + self._mamba_step(blk.mamba, h, c)
                continue
            if fam == "hybrid":
                x = x + self._hymba_step(blk.mixer, h, c, pos, seq)
            elif self.mla_plan is not None:
                x = x + mla_decode(blk.attn, h, pos, c["c"], c["r"],
                                   self.mla_plan, tp, seq)
            else:
                x = x + gqa_grid_decode(blk.attn, h, c["k"], c["v"], pos,
                                        self.plan, tp, seq)
            if fam == "encdec":
                x = x + self._cross_step(blk.xattn, rmsnorm(x, blk.ln_x), c,
                                         seq)
            y, _ = self._ffn(blk, rmsnorm(x, blk.ln2), moe_impl)
            x = x + y
        logits = unembed_grid(m.embed, rmsnorm(x, m.final_norm), tp,
                              self.vocab_sharded)
        return self._whole_vocab(logits), cache
