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

from .attention import (GQAAttention, MLAAttention, cross_attention,
                        decode_attention, gqa_grid_decode, gqa_grid_full,
                        gqa_plan)
from .hybrid import Hymba, hymba_apply, hymba_step
from .layers import (MLP, MLP2, embed, embed_grid, embed_init, mlp_grid,
                     param, rmsnorm, unembed, unembed_grid)
from .moe import MoE
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

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """The zero-filled decode cache of ``repro``'s ``init_cache`` (the
        module docstring lists its leaves); enc-dec's xk and xv take
        max_len positions, as ``repro``'s."""
        cfg = self.cfg
        L, B, S = cfg.n_layers, batch_size, max_len
        dtype, dev = self.embed.dtype, self.device

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
    model = Transformer(cfg, device="meta")
    return tuple((n, tuple(p.shape)) for n, p in model.named_parameters())


def named_shapes(cfg) -> dict[str, tuple]:
    """The global shape of each of the port's parameters ({name: shape};
    built on the meta device, no storage)."""
    return dict(_named_shapes(cfg))


def param_shapes(cfg) -> dict[str, tuple]:
    """``repro``'s parameter tree's shapes ({"/"-path: shape}, layer
    stacks with their leading L axis; ``repro``'s ``param_shapes``),
    from the port's model without allocating it: what the placement
    rules (``dist.sharding.param_specs``) read."""
    return stacked_shapes(named_shapes(cfg))


def grid_supported(cfg) -> bool:
    """Whether the grid forward takes ``cfg`` on a grid of more than one
    cell: the dense GQA decoders (llama3.2-1b, yi-9b, granite-20b)."""
    return cfg.family == "dense" and cfg.attn_impl == "gqa"


def lm_placement(grid: Grid, cfg) -> LMPlacement:
    """Where each of ``cfg``'s parameters lives on ``grid``; refuses a
    family the grid forward does not take on a grid of several cells."""
    if grid.size > 1 and not grid_supported(cfg):
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family ({cfg.attn_impl} "
            f"attention) runs on a 1 x 1 grid only; its grid forward is "
            f"not ported yet (ROADMAP.md §1 item 5(d)); the dense GQA "
            f"decoders run on any LM grid")
    if not grid.lm:
        raise ValueError("the LM runs on an LM grid (Grid(lm=True), "
                         "launch.mesh.make_lm_grid)")
    return LMPlacement(grid, named_shapes(cfg))


class GridTransformer:
    """A ``Transformer`` whose parameters are placed on an LM grid
    (``train.serve_step.params_shardings``), run as ``repro`` runs it on
    its mesh: tensor parallel over "model" (Megatron column / row
    parallel projections, vocab-parallel embedding and logits, heads
    split as ``constrain_heads`` splits them), data parallel over ("pod",
    "data"), the decode cache's sequence over "model" (``cache_specs``).
    The residual stream between blocks is whole on every model rank (an
    all-reduce after each row-parallel product); ``repro`` keeps it
    sequence-sharded, which gives the same values.

      forward(tokens)                   -> (logits (B_l, S, V_l), aux)
      prefill(tokens, max_len)          -> (logits (B_l, 1, Vpad), cache)
      decode_step(cache, tokens, pos)   -> (logits (B_l, 1, Vpad), cache)
      init_cache(batch, max_len)        -> cache (this cell's blocks)

    ``forward`` takes this cell's rows and gives its vocab block of the
    logits (the training loss reads them sharded); ``prefill`` takes the
    global batch and keeps this cell's rows (``batch_shardings``);
    ``decode_step`` takes and gives this cell's rows, with every vocab
    id.  The MoE, MLA, SSM, hybrid, enc-dec and VLM families run on a
    1 x 1 grid only, through the model's own methods."""

    def __init__(self, model: Transformer, grid: Grid,
                 placement: LMPlacement | None = None):
        cfg = model.cfg
        self.model, self.grid, self.cfg = model, grid, cfg
        self.placement = placement or lm_placement(grid, cfg)
        for name, p in model.named_parameters():
            if tuple(p.shape) != self.placement.local_shape(name):
                raise ValueError(
                    f"{name} {tuple(p.shape)} is not this cell's block "
                    f"{self.placement.local_shape(name)}: place the model "
                    f"first (train.serve_step.params_shardings(grid, "
                    f"model))")
        self.tp = TensorParallel(grid)
        self.batch = grid.axis(BATCH_AXIS)
        self.dense = grid_supported(cfg)
        if self.dense:
            pl = self.placement
            sh = pl.model_sharded
            self.plan = gqa_plan(cfg.n_heads, cfg.n_kv, head_dim(cfg),
                                 self.tp, wq=sh("layers.0.attn.wq"),
                                 wk=sh("layers.0.attn.wk"),
                                 wo=sh("layers.0.attn.wo"))
            self.mlp_sharded = sh("layers.0.mlp.wo")
            if sh("layers.0.mlp.wi") != self.mlp_sharded:
                raise ValueError(f"{cfg.name}: the MLP's wi and wo must be "
                                 f"split alike")
            self.vocab_sharded = sh("embed")

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _block(self, i: int, x, positions, impl: str, q_chunk: int,
               need_kv: bool = False):
        blk = self.model.layers[i]
        a, k, v = gqa_grid_full(blk.attn, rmsnorm(x, blk.ln1), positions,
                                self.plan, self.tp, q_chunk=q_chunk,
                                impl=impl, need_kv=need_kv)
        x = x + a
        x = x + mlp_grid(blk.mlp, rmsnorm(x, blk.ln2), self.tp,
                         self.mlp_sharded)
        return x, k, v

    def _train_block(self, i: int, x, positions, impl: str):
        return self._block(i, x, positions, impl, TRAIN_Q_CHUNK)[0]

    def forward(self, tokens: torch.Tensor, *, impl: str = "ref",
                remat: bool = False, moe_impl: str = "einsum"):
        """tokens (B_l, S), this cell's rows -> (logits (B_l, S, V_l), this
        rank's vocab block, and aux).  Training's forward: ``impl`` "ref"
        (the plain chunked attention, which autograd differentiates)."""
        if not self.dense:
            return self.model(tokens, impl=impl, remat=remat,
                              moe_impl=moe_impl)
        m = self.model
        x = embed_grid(m.embed, tokens, self.tp, self.vocab_sharded)
        positions = m._positions(x)
        for i in range(len(m.layers)):
            if remat and torch.is_grad_enabled():
                x = checkpoint(self._train_block, i, x, positions, impl,
                               use_reentrant=False)
            else:
                x = self._train_block(i, x, positions, impl)
        logits = unembed_grid(m.embed, rmsnorm(x, m.final_norm), self.tp,
                              self.vocab_sharded)
        return logits, torch.zeros((), device=x.device)

    def _whole_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        if self.vocab_sharded:
            return self.tp.gather(logits, -1)
        return logits

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """This cell's blocks of the zero decode cache of a global batch
        of ``batch_size`` sequences and ``max_len`` positions
        (``cache_specs``: batch over the data axes, positions over
        "model"; ``ValueError`` when max_len is not a multiple of the
        model axis, which would put "model" on the heads)."""
        if not self.dense:
            return self.model.init_cache(batch_size, max_len)
        cfg = self.cfg
        kv = (cfg.n_layers, batch_size, max_len, cfg.n_kv, head_dim(cfg))
        spec = cache_specs(self.grid, {"k": kv})["k"]
        if self.tp.size > 1 and spec[2] != MODEL_AXIS:
            raise ValueError(
                f"the decode cache's {max_len} positions are not a "
                f"multiple of the model axis ({self.tp.size}); the grid "
                f"decode needs them sharded over it (cache_specs)")
        shape = local_block(self.grid, torch.empty(kv, device="meta"),
                            spec).shape
        return {n: torch.zeros(shape, dtype=self.model.embed.dtype,
                               device=self.device) for n in ("k", "v")}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int | None = None, *,
                impl: str = "auto", moe_impl: str = "einsum"):
        """Serving prefill of the global batch ``tokens`` (B, S): this
        cell's rows go through the layers (attention through the CUDA
        kernel on a CUDA tensor, on this rank's heads), each layer's K/V
        gathered whole over "model" and this cell's block of positions
        kept.  Returns (logits (B_l, 1, Vpad) of the last position, the
        cache of ``max_len`` (default S) positions rounded up to a
        multiple of the model axis, this cell's blocks)."""
        B, S = tokens.shape
        M = self.tp.size
        max_len = -(-(max_len or S) // M) * M
        if not self.dense:
            logits, filled = self.model.prefill(tokens, impl=impl,
                                                moe_impl=moe_impl)
            return logits, self.model.extend_cache(filled, max_len)
        cache = self.init_cache(B, max_len)
        m = self.model
        x = embed_grid(m.embed, shard_batch(self.grid, {"t": tokens})["t"],
                       self.tp, self.vocab_sharded)
        positions = m._positions(x)
        s_l = cache["k"].shape[2]
        p0 = self.tp.index * s_l if self.tp.size > 1 else 0
        n = max(0, min(S, p0 + s_l) - p0)
        for i in range(len(m.layers)):
            x, k, v = self._block(i, x, positions, impl, PREFILL_Q_CHUNK,
                                  need_kv=True)
            cache["k"][i, :, :n] = k[:, p0:p0 + n]
            cache["v"][i, :, :n] = v[:, p0:p0 + n]
        last = unembed_grid(m.embed, rmsnorm(x[:, -1:], m.final_norm),
                            self.tp, self.vocab_sharded)
        return self._whole_vocab(last), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos: int, *,
                    moe_impl: str = "einsum"):
        """One token for this cell's rows: tokens (B_l, 1) at position
        ``pos`` -> (logits (B_l, 1, Vpad), cache updated in place).  Each
        layer gathers q, k and v whole over "model", writes k and v on the
        rank that holds ``pos``, combines the sequence-sharded attention
        (``decode_attention(group=)``), and runs its heads through wo."""
        if not self.dense:
            return self.model.decode_step(cache, tokens, pos,
                                          moe_impl=moe_impl)
        m = self.model
        seq = self.grid.axis(MODEL_AXIS) if self.tp.size > 1 else None
        x = embed_grid(m.embed, tokens, self.tp, self.vocab_sharded)
        for i, blk in enumerate(m.layers):
            x = x + gqa_grid_decode(blk.attn, rmsnorm(x, blk.ln1),
                                    cache["k"][i], cache["v"][i], pos,
                                    self.plan, self.tp, seq)
            x = x + mlp_grid(blk.mlp, rmsnorm(x, blk.ln2), self.tp,
                             self.mlp_sharded)
        logits = unembed_grid(m.embed, rmsnorm(x, m.final_norm), self.tp,
                              self.vocab_sharded)
        return self._whole_vocab(logits), cache
