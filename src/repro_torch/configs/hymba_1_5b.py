"""hymba-1.5b — hybrid parallel attn+mamba heads [arXiv:2411.13676; hf]."""
from .base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5, head_dim=64,
    d_ff=5504, vocab=32001,
    ssm_state=16, ssm_headdim=64, ssm_expand=2, ssm_groups=1,
    window=1024, sub_quadratic=True,
    source="[arXiv:2411.13676; hf]",
)
REDUCED = reduced(CONFIG)
