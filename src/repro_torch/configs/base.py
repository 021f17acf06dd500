"""Config dataclasses: the model architecture description.

A copy of the JAX package's ``ModelConfig`` (same fields, same defaults), so
the port and the reference describe one architecture with one record.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description for every family in the zoo."""

    name: str
    family: str                    # dense | moe | whisper | xlstm | zamba
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // num_heads
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA window (h2o-danube)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_dispatch_int8: bool = False   # DeepSeek-style quantized all_to_all
    mla: Optional[MLAConfig] = None
    mtp: bool = False               # DeepSeek multi-token-prediction module

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0         # if > 0, num_layers = decoder layers

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    slstm_every: int = 0            # xlstm: every k-th block is sLSTM
    shared_attn_every: int = 0      # zamba2: shared attn after every k mamba blocks

    # --- VLM ---
    num_image_tokens: int = 0       # phi-3-vision patch tokens (stub frontend)

    # --- FORMS integration ---
    forms_fragment: int = 8
    forms_bits: int = 8

    # --- activation sparsity (zero-skipping, DESIGN.md §6g) ---
    mlp_act: str = "silu"           # swiglu gate nonlinearity (silu/gelu/relu)
    act_sparsity: float = 0.0       # fragment drop fraction (0 = dense)
    act_fragment: int = 8           # sparsification granularity; align with
                                    # the serving FormsSpec.m to skip work

    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "xlstm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM/hybrid recurrent decode)."""
        return self.family in ("xlstm", "zamba")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d, L = self.d_model, self.num_layers
        hd = self.hd()
        if self.family == "xlstm":
            per = 4 * d * d  # qkv/gate/out projections, approximate
            return L * per + 2 * self.vocab_size * d
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.num_heads * m.v_head_dim * d)
        if self.family == "zamba":
            d_in = self.ssm_expand * d
            per = (d * (2 * d_in + 2 * self.ssm_state) + d_in * d)  # mamba2 in/out
            shared = 4 * attn + 3 * d * self.d_ff
            return L * per + shared + 2 * self.vocab_size * d
        ff = 3 * d * self.d_ff if self.d_ff else 0
        if self.num_experts:
            ff = 3 * d * self.moe_d_ff * (self.num_experts + self.num_shared_experts) + d * self.num_experts
        per = attn + ff
        enc = self.encoder_layers * per
        emb = (1 if self.tie_embeddings else 2) * self.vocab_size * d
        return (L + self.encoder_layers) * per + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-in experts)."""
        if not self.num_experts:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        total = self.param_count()
        all_experts = L * 3 * d * self.moe_d_ff * self.num_experts
        active_experts = L * 3 * d * self.moe_d_ff * self.experts_per_token
        return total - all_experts + active_experts

