"""deepseek-moe-16b — 2 shared + 64 routed top-6, fine-grained experts
[arXiv:2401.06066; hf]."""
from .base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
    d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, n_shared=2,
    source="[arXiv:2401.06066; hf]",
)
REDUCED = reduced(CONFIG)
