"""Architecture registry: ``get(name)`` / ``reduced(name)`` / ``names()``.

Each assigned architecture lives in ``configs/<id>.py`` exposing
``CONFIG`` (the exact published shape) and ``reduced()`` (a small
same-family variant for CPU smoke tests).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ModelConfig, ShapeSpec, SHAPES

_ARCHS = [
    "granite_moe_3b_a800m",
    "deepseek_moe_16b",
    "seamless_m4t_large_v2",
    "gemma3_12b",
    "qwen1_5_0_5b",
    "nemotron_4_340b",
    "command_r_35b",
    "recurrentgemma_9b",
    "mamba2_1_3b",
    "paligemma_3b",
]

# public ids use dashes/dots; module names use underscores
_ID_TO_MOD = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "gemma3-12b": "gemma3_12b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "nemotron-4-340b": "nemotron_4_340b",
    "command-r-35b": "command_r_35b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-1.3b": "mamba2_1_3b",
    "paligemma-3b": "paligemma_3b",
}
_MOD_TO_ID = {v: k for k, v in _ID_TO_MOD.items()}


def names() -> List[str]:
    return list(_ID_TO_MOD)


def _module(arch: str):
    mod = _ID_TO_MOD.get(arch, arch.replace("-", "_").replace(".", "_"))
    return importlib.import_module(f"{__package__}.{mod}")


def get(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def shapes_for(arch: str) -> Dict[str, ShapeSpec]:
    """Applicable shape cells for an arch (per assignment rules):
    ``long_500k`` only for sub-quadratic archs; all archs have decode
    (seamless decodes with its enc-dec decoder)."""
    cfg = get(arch)
    out = dict(SHAPES)
    if not cfg.supports_long_context:
        out.pop("long_500k")
    return out


def all_cells() -> List[tuple]:
    return [(a, s) for a in names() for s in shapes_for(a)]
