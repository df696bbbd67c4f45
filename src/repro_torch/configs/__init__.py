"""Config registry: ``get_config(arch_id)`` / ``ARCHS`` list (the port's copy
of ``repro.configs``).

Arch ids follow the assignment table (``--arch <id>`` in launchers).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    ArchConfig,
    MoEConfig,
    SSMConfig,
    ShapeSpec,
    SHAPES_BY_NAME,
    XLSTMConfig,
    TRAIN_4K,
    PREFILL_32K,
    DECODE_32K,
    LONG_500K,
)

_MODULES: Dict[str, str] = {
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "minicpm-2b": "minicpm_2b",
    "smollm-135m": "smollm_135m",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen1.5-32b": "qwen15_32b",
    "zamba2-1.2b": "zamba2_1_2b",
    "dbrx-132b": "dbrx_132b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "xlstm-350m": "xlstm_350m",
    "musicgen-large": "musicgen_large",
}

ARCHS: List[str] = list(_MODULES)


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCHS}
