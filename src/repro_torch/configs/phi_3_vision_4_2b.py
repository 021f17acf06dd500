"""phi-3-vision-4.2b: phi3-mini backbone + CLIP frontend (a stub, as in the
reference) [hf:microsoft/Phi-3-vision-128k-instruct; hf].

The transformer backbone only; precomputed patch embeddings fill the image
positions before the text tokens (``Model.make_inputs``).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    rope_theta=10000.0, num_image_tokens=1024,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="phi-3-vision-4.2b-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        num_image_tokens=8)
