"""llama3.2-1b — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified]."""
from .base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv=8, head_dim=64,
    d_ff=8192, vocab=128256, rope_theta=500000.0,
    source="[hf:meta-llama/Llama-3.2-1B; unverified]",
)
REDUCED = reduced(CONFIG)
