"""Architecture registry: ``--arch <id>`` resolves through here.

Copy of ``repro/configs/__init__.py`` without ``input_specs``/``cells``,
which belong to the XLA dry-run tooling."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

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
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
