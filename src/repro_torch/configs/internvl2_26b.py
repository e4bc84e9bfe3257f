"""internvl2-26b — InternViT + InternLM2 backbone; ViT frontend stubbed
(precomputed patch embeddings) [arXiv:2404.16821; hf]."""
from .base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
    d_ff=16384, vocab=92553, n_patches=256,
    train_microbatches=8,
    source="[arXiv:2404.16821; hf]",
)
REDUCED = reduced(CONFIG)
