"""The benchmark's yardstick: the card's published peaks and the work
(operations and bytes) of each measured layer, computed from shapes.

One yardstick for every route: the least time of a piece of work is the
larger of its operations at the dense bf16 tensor-core peak and its bytes
at the HBM peak, whatever kernel or precision the program chooses.  Each
input byte is counted once and each output byte once; where the work
depends on the data (causal attention, the decode context, the experts
that received tokens), what these inputs need is counted.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

#: NVIDIA H100 SXM, dense rates without sparsity (the data sheet), at the
#: full 700 W power limit
PEAK_FLOPS = 989e12          # bf16 / fp16 tensor cores
PEAK_BYTES = 3.35e12         # HBM3


def ideal_s(flops: float, nbytes: float) -> float:
    """The least time of one piece of work on the card."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def roofline_share(work: Iterable[Tuple[float, float]], device_s: float):
    """Sum of the ideal times of ``work`` ((flops, bytes) per call) over the
    device time the calls took, in percent; None without device time."""
    if device_s <= 0:
        return None
    total = sum(ideal_s(f, b) for f, b in work)
    if total <= 0:
        return None
    return 100.0 * total / device_s


# ---------------------------------------------------------------------------
# the FORMS matmul: y (M, N) f32 = x (M, Kp) @ (signs * mags) (Kp, N) * scale
# ---------------------------------------------------------------------------

def forms_mm_work(m_rows: int, kp: int, n: int, x_bytes: int, mag_bytes: int,
                  frag: int) -> Tuple[float, float]:
    """One polarized matmul: 2·M·K·N operations; x, the codes, the fragment
    signs (int8), the column scale (f32) read once, y (f32) written once."""
    flops = 2.0 * m_rows * kp * n
    nbytes = (m_rows * kp * x_bytes + kp * n * mag_bytes + (kp // frag) * n
              + 4 * n + 4 * m_rows * n)
    return flops, nbytes


# ---------------------------------------------------------------------------
# attention (bf16 q/k/v/out; scores and softmax are the kernels' own)
# ---------------------------------------------------------------------------

def causal_attention_work(batch: int, seq: int, heads: int, kv_heads: int,
                          hd: int, elem: int = 2) -> Tuple[float, float]:
    """Causal self-attention over ``seq`` positions: QK^T and PV over the
    causal half (seq (seq + 1) / 2 pairs per head), q/k/v read and the
    output written once."""
    pairs = seq * (seq + 1) / 2.0
    flops = 4.0 * batch * heads * hd * pairs
    nbytes = elem * batch * seq * hd * (2 * heads + 2 * kv_heads)
    return flops, nbytes


def decode_attention_work(ctx_sum: float, ctx_rows: float, queries: int, heads: int,
                          kv_heads: int, hd: int, elem: int = 2) -> Tuple[float, float]:
    """Decode attention: ``ctx_sum`` is the sum over queries of the
    positions each attends to, ``ctx_rows`` the cache rows the call needs
    (each slot's longest context), ``queries`` the query rows; the cached
    K and V rows, q and the output read or written once."""
    flops = 4.0 * heads * hd * ctx_sum
    nbytes = elem * (2 * kv_heads * hd * ctx_rows + 2 * heads * hd * queries)
    return flops, nbytes


# ---------------------------------------------------------------------------
# the routed experts of a MoE FFN (SwiGLU experts, FORMS codes)
# ---------------------------------------------------------------------------

def moe_work(tokens: int, d: int, f: int, n_experts: int, top_k: int, hit: float,
             frag: int, act_bytes: int = 2) -> Tuple[float, float]:
    """One MoE FFN call on ``tokens`` tokens: the router (dense f32 weight)
    and ``top_k`` SwiGLU experts per token (three d x f products); bytes:
    x and y once, the router once, and the codes, signs and scales of the
    ``hit`` experts that received a token."""
    flops = 2.0 * tokens * d * n_experts + 2.0 * 3 * tokens * top_k * d * f
    per_expert = 2 * (d * f + (d // frag) * f + 4 * f) + (f * d + (f // frag) * d + 4 * d)
    nbytes = 2 * act_bytes * tokens * d + 4 * d * n_experts + hit * per_expert
    return flops, nbytes


# ---------------------------------------------------------------------------
# model FLOPs (the numerator of an mfu)
# ---------------------------------------------------------------------------

def layer_params(cfg: Dict) -> int:
    """Active parameters of one decoder layer's products per token
    (projections; for a MoE layer the router and ``top_k`` experts)."""
    d, h, kv, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    if cfg.get("num_experts"):
        ffn = d * cfg["num_experts"] + 3 * d * cfg["moe_d_ff"] * cfg["experts_per_token"]
    else:
        ffn = 3 * d * cfg["d_ff"]
    return attn + ffn


def serve_model_flops(cfg: Dict, requests: Iterable[Tuple[int, int]]) -> float:
    """Model FLOPs of served requests ((prompt tokens, generated tokens)
    each): every prompt token and every generated token but the last
    through the layers, one head row per generated token, and causal
    attention over each position's context."""
    n_layers, d, vocab = cfg["num_layers"], cfg["d_model"], cfg["vocab_size"]
    h, hd = cfg["num_heads"], cfg["head_dim"]
    per_tok = 2.0 * n_layers * layer_params(cfg)
    total = 0.0
    for n_prompt, n_out in requests:
        fed = n_prompt + max(n_out - 1, 0)
        total += per_tok * fed + 2.0 * d * vocab * n_out
        # position p attends to p + 1 positions: sum over p < fed
        total += 4.0 * n_layers * h * hd * fed * (fed + 1) / 2.0
    return total


def train_model_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x (layer params + head) per
    token, plus forward and backward causal attention (3 x the forward's
    4·H·hd per pair); recomputation is not counted."""
    n_layers, d, vocab = cfg["num_layers"], cfg["d_model"], cfg["vocab_size"]
    h, hd = cfg["num_heads"], cfg["head_dim"]
    tokens = batch * seq
    dense = 6.0 * tokens * (n_layers * layer_params(cfg) + d * vocab)
    attn = 3.0 * 4.0 * n_layers * h * hd * batch * seq * (seq + 1) / 2.0
    return dense + attn
