"""whisper-large-v3 — enc-dec audio; conv frontend stubbed (precomputed
frame embeddings) [arXiv:2212.04356; unverified].

Adaptations (DESIGN.md): GELU MLP kept; sinusoidal+conv frontend replaced
by the embedding stub per assignment; RoPE replaces learned positions
(positional scheme is not the benchmarked subsystem).  Decoder length is
seq_len // 4 for train/prefill."""
from .base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv=20,
    head_dim=64, d_ff=5120, vocab=51866, mlp="gelu", dec_ratio=4,
    source="[arXiv:2212.04356; unverified]",
)
REDUCED = reduced(CONFIG)
