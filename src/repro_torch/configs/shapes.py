"""The four assigned input-shape cells (LM-family shapes) of the dry run."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ModelConfig, ShapeConfig

SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}


def shapes_for(config: ModelConfig) -> List[ShapeConfig]:
    """Applicable shapes for an architecture: ``long_500k`` needs
    sub-quadratic (recurrent-state) decode, so only the SSM/hybrid families
    run it."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if config.subquadratic:
        out.append(SHAPES["long_500k"])
    return out
