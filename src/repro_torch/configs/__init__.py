"""Config registry: ``get_config(name)`` / ``get_reduced(name)``.

The registry holds the archs of the families the port serves, copied from
the JAX package field for field: the dense ones, the MoE family's
olmoe-1b-7b and deepseek-v3-671b (MLA + MTP), whisper-small
(encoder-decoder), and the recurrent families' xlstm-350m (sLSTM + mLSTM)
and zamba2-2.7b (Mamba2 + shared attention), and the VLM backbone
phi-3-vision-4.2b (patch embeddings before the text tokens).  The paper's
CNNs are in ``paper_cnns``; the dry run's input-shape cells in ``shapes``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (MeshConfig, MLAConfig, ModelConfig,  # noqa: F401
                                      ShapeConfig, TrainConfig)
from repro_torch.configs.shapes import SHAPES, shapes_for  # noqa: F401

_ARCH_MODULES: Dict[str, str] = {
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
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
