"""Config schema of the LM zoo (port of ``repro/configs/base.py``):
architectures (``ArchConfig``), benchmark shapes (``ShapeSpec``) and the
same-family miniatures (``reduced``).

Every architecture ships as a ``configs/<id>.py`` exporting CONFIG (the
published numbers) and REDUCED (a miniature for CPU tests), with the same
values as ``repro``'s.  ``repro``'s ``input_specs`` (JAX stand-ins for
the XLA dry-run) has no counterpart here.

Shape semantics: train_4k / prefill_32k process seq_len tokens per
sequence; decode_* / long_* run ONE new token against a cache of seq_len.
long_500k needs a sub-quadratic arch (``sub_quadratic``).
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv: int = 0
    d_ff: int = 0
    head_dim: int = 0          # 0 -> d_model // n_heads
    mlp: str = "swiglu"        # swiglu | gelu
    rope_theta: float = 10000.0
    # --- MLA (attn_impl == "mla") ---
    attn_impl: str = "gqa"
    q_lora: int = 0
    kv_lora: int = 0
    d_nope: int = 0
    d_rope: int = 0
    d_v: int = 0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    window: int = 0            # hybrid sliding-window size
    # --- enc-dec / vlm ---
    n_enc_layers: int = 0
    dec_ratio: int = 1         # decoder_len = seq_len // dec_ratio
    n_patches: int = 0
    # --- misc ---
    sub_quadratic: bool = False
    dtype: str = "bfloat16"
    train_microbatches: int = 1   # grad-accum splits for train_4k memory
    source: str = ""           # [source; verified-tier]

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 (Megatron-style padding; the pad
        logits are masked before sampling)."""
        return -(-self.vocab // 256) * 256

    def supports(self, shape: ShapeSpec) -> tuple[bool, str]:
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False, ("full-attention arch: O(S) KV decode at 500k is "
                           "quadratic-history — skipped per assignment")
        return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, Any]:
    """Meta-device stand-ins for every model input of this cell, with
    ``repro``'s shapes and dtypes (int32 token ids; frames and patches in
    the model's dtype):

    train   -> {"batch": {tokens, labels, [frames|patches]}}
    prefill -> {"batch": {tokens, [frames|patches]}}
    decode  -> {"tokens", "pos", "cache"}

    Enc-dec's decoder takes seq_len // dec_ratio tokens beside seq_len
    frames; a VLM's tokens are seq_len less its patches; decode is one
    token against a cache of seq_len (``models.transformer.
    cache_shapes``)."""
    import torch

    B, S = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)

    def meta(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            St = max(S // cfg.dec_ratio, 1)
            batch = {"frames": meta(B, S, cfg.d_model, dtype=act),
                     "tokens": meta(B, St)}
        elif cfg.family == "vlm":
            St = S - cfg.n_patches
            batch = {"patches": meta(B, cfg.n_patches, cfg.d_model,
                                     dtype=act),
                     "tokens": meta(B, St)}
        else:
            St = S
            batch = {"tokens": meta(B, S)}
        if shape.kind == "train":
            batch["labels"] = meta(B, St)
        return {"batch": batch}

    from repro_torch.models.transformer import cache_shapes
    return {"tokens": meta(B, 1), "pos": meta(),
            "cache": cache_shapes(cfg, B, S)}


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Same-family miniature for CPU tests."""
    small: dict[str, Any] = dict(
        name=cfg.name + "-reduced", n_layers=2, d_model=64, vocab=512,
        dtype="float32", train_microbatches=1)
    if cfg.n_heads:
        small.update(n_heads=4, n_kv=max(1, min(cfg.n_kv, 2)), head_dim=16)
    if cfg.d_ff:
        small.update(d_ff=128)
    if cfg.attn_impl == "mla":
        small.update(q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16)
    if cfg.n_experts:
        small.update(n_experts=4, top_k=2,
                     n_shared=min(cfg.n_shared, 1))
    if cfg.ssm_state:
        small.update(ssm_state=8, ssm_headdim=16)
    if cfg.window:
        small.update(window=16)
    if cfg.n_enc_layers:
        small.update(n_enc_layers=2)
    if cfg.n_patches:
        small.update(n_patches=4)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
