"""Config registry (port of ``repro/configs/__init__.py``): ``--arch <id>``
resolves to the same LM architectures, with the same numbers, as in
``repro``, and to the paper's own RESCAL workloads
(``rescal_paper.py``: rescal-small, rescal-dense-3tb,
rescal-sparse-eb)."""
from __future__ import annotations

from . import (deepseek_moe_16b, granite_20b, granite_moe_3b_a800m,
               hymba_1_5b, internvl2_26b, llama3_2_1b, mamba2_1_3b,
               minicpm3_4b, whisper_large_v3, yi_9b)
from .base import SHAPES, ArchConfig, ShapeSpec, input_specs, reduced
from .rescal_paper import RESCAL_CONFIGS, RescalConfig

_MODULES = (hymba_1_5b, granite_moe_3b_a800m, deepseek_moe_16b,
            whisper_large_v3, llama3_2_1b, yi_9b, granite_20b, minicpm3_4b,
            mamba2_1_3b, internvl2_26b)

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
REDUCED_ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.REDUCED
                                        for m in _MODULES}


def get_config(name: str) -> ArchConfig | RescalConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in RESCAL_CONFIGS:
        return RESCAL_CONFIGS[name]
    raise KeyError(
        f"unknown arch {name!r}; available: "
        f"{sorted(ARCHS) + sorted(RESCAL_CONFIGS)}")


__all__ = ["ARCHS", "REDUCED_ARCHS", "RESCAL_CONFIGS", "SHAPES",
           "ArchConfig", "RescalConfig", "ShapeSpec", "get_config",
           "input_specs", "reduced"]
