"""h2o-danube-1.8b: llama+mistral mix with sliding-window attention [arXiv:2401.16818; hf]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=32000, head_dim=80,
    sliding_window=4096, rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="h2o-danube-1.8b-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        sliding_window=32)
