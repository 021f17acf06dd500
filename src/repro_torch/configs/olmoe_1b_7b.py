"""olmoe-1b-7b: MoE, 64 experts top-8 [arXiv:2409.02060; hf]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    num_experts=64, experts_per_token=8, moe_d_ff=1024,
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="olmoe-1b-7b-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=64, vocab_size=256,
        num_experts=8, experts_per_token=2, moe_d_ff=64)
