"""granite-20b — llama-arch MQA (kv=1), code [arXiv:2405.04324; hf]."""
from .base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv=1, head_dim=128,
    d_ff=24576, vocab=49152, mlp="gelu",  # GPT-BigCode: 2-matrix GELU MLP
    train_microbatches=4,
    source="[arXiv:2405.04324; hf]",
)
REDUCED = reduced(CONFIG)
