"""minicpm3-4b — MLA (multi-head latent attention)
[hf:openbmb/MiniCPM3-4B; hf]."""
from .base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense", attn_impl="mla",
    n_layers=62, d_model=2560, n_heads=40, n_kv=40, head_dim=64,
    d_ff=6400, vocab=73448,
    q_lora=768, kv_lora=256, d_nope=64, d_rope=32, d_v=64,
    train_microbatches=2,   # SEQ-fallback attention (40 MHA heads) memory
    source="[hf:openbmb/MiniCPM3-4B; hf]",
)
REDUCED = reduced(CONFIG)
