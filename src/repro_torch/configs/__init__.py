"""Architecture registry: ``--arch <id>`` resolves through here."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import (SHAPES, SHAPES_BY_NAME, ModelConfig,
                                 ShapeSpec, shape_applicable)

ARCH_IDS: List[str] = [
    "mixtral-8x22b",
    "qwen3-moe-30b-a3b",
    "hymba-1.5b",
    "yi-6b",
    "olmo-1b",
    "qwen2-7b",
    "starcoder2-15b",
    "falcon-mamba-7b",
    "hubert-xlarge",
    "paligemma-3b",
]

_MODULES: Dict[str, str] = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def input_specs(arch_id: str, shape_name: str):
    from repro_torch.configs.common import input_specs as mk
    return mk(get_config(arch_id), SHAPES_BY_NAME[shape_name])


def cells(include_skipped: bool = False):
    """All (arch_id, shape, runnable, why) cells of the assignment matrix."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES:
            ok, why = shape_applicable(cfg, s)
            if ok or include_skipped:
                out.append((a, s, ok, why))
    return out
