"""yi-9b: llama-arch dense GQA [arXiv:2403.04652; hf]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, head_dim=128, rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    """Same family, smoke-test size: one forward/train step on CPU."""
    return dataclasses.replace(
        CONFIG, name="yi-9b-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
