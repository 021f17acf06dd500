"""Config registry: ``get_config(name)`` / ``get_reduced(name)``.

The port serves the dense transformer family; its registry holds the archs
whose configs it carries.  Other archs join with their family's port.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import MLAConfig, ModelConfig  # noqa: F401

_ARCH_MODULES: Dict[str, str] = {
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
}

ARCH_NAMES: List[str] = list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def get_reduced(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(_ARCH_MODULES[name]).reduced()
