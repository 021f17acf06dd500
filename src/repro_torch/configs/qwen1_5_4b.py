"""qwen1.5-4b: dense attention (kv=heads=20) with QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    d_ff=6912, vocab_size=151936, head_dim=128, qkv_bias=True,
    rope_theta=5000000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen1.5-4b-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)
