"""granite-moe-3b-a800m — 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, head_dim=64,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
)
REDUCED = reduced(CONFIG)
