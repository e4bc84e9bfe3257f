"""mamba2-1.3b — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""
from .base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, vocab=50280, d_ff=0,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_groups=1,
    sub_quadratic=True,
    source="[arXiv:2405.21060; unverified]",
)
REDUCED = reduced(CONFIG)
