"""zamba2-2.7b: Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="zamba",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    shared_attn_every=6,  # shared attn block applied after every 6 mamba blocks
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-2.7b-reduced", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        ssm_state=16, ssm_head_dim=16, shared_attn_every=2)
