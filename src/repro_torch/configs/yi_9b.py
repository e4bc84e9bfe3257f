"""yi-9b — llama-arch GQA [arXiv:2403.04652; hf]."""
from .base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv=4, head_dim=128,
    d_ff=11008, vocab=64000, train_microbatches=2,
    source="[arXiv:2403.04652; hf]",
)
REDUCED = reduced(CONFIG)
