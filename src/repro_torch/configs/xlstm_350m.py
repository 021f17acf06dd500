"""xlstm-350m: sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM) [arXiv:2405.04517; unverified]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="xlstm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=256,
    slstm_every=8,  # blocks 0, 8, 16 are sLSTM -> 3 sLSTM + 21 mLSTM
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-350m-reduced", num_layers=4, d_model=64,
        num_heads=2, num_kv_heads=2, head_dim=32, vocab_size=256,
        slstm_every=2)
