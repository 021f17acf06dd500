"""deepseek-v3-671b: MLA + 1 shared + 256 routed top-8 experts + MTP
[arXiv:2412.19437; hf].

Per the assignment's config line: 61L, d_model=7168, 128H, d_ff=2048 (routed
expert hidden dim), vocab=129280, 256 experts top-8.
"""
import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=2048, vocab_size=129280, head_dim=128,
    num_experts=256, experts_per_token=8, moe_d_ff=2048,
    num_shared_experts=1, mla=MLAConfig(), mtp=True,
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-v3-671b-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=64, vocab_size=256,
        num_experts=8, experts_per_token=2, moe_d_ff=64, num_shared_experts=1,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16))
