"""whisper-small: encoder-decoder, conv frontend STUB per assignment
[arXiv:2212.04356; unverified].

The encoder takes precomputed frame embeddings ``(B, S, d_model)``.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="whisper",
    num_layers=12, encoder_layers=12, d_model=768, num_heads=12,
    num_kv_heads=12, d_ff=3072, vocab_size=51865, head_dim=64,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-small-reduced", num_layers=2, encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=256)
