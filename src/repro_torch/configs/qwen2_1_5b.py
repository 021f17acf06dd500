"""qwen2-1.5b: dense GQA with QKV bias [arXiv:2407.10671; hf]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128, qkv_bias=True,
    rope_theta=1000000.0, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-1.5b-reduced", num_layers=2, d_model=48,
        num_heads=4, num_kv_heads=2, head_dim=12, d_ff=96, vocab_size=256)
