"""Config registry of the LM zoo (port of ``repro/configs/__init__.py``):
``--arch <id>`` resolves to the same architectures, with the same
numbers, as in ``repro``.  The paper's RESCAL workloads
(``repro/configs/rescal_paper.py``) are not ported yet."""
from __future__ import annotations

from . import (deepseek_moe_16b, granite_20b, granite_moe_3b_a800m,
               hymba_1_5b, internvl2_26b, llama3_2_1b, mamba2_1_3b,
               minicpm3_4b, whisper_large_v3, yi_9b)
from .base import SHAPES, ArchConfig, ShapeSpec, reduced

_MODULES = (hymba_1_5b, granite_moe_3b_a800m, deepseek_moe_16b,
            whisper_large_v3, llama3_2_1b, yi_9b, granite_20b, minicpm3_4b,
            mamba2_1_3b, internvl2_26b)

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
REDUCED_ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.REDUCED
                                        for m in _MODULES}


def get_config(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")


__all__ = ["ARCHS", "REDUCED_ARCHS", "SHAPES", "ArchConfig", "ShapeSpec",
           "get_config", "reduced"]
