"""The chunked linear recurrence: the shared engine of mLSTM (xLSTM) and
Mamba2 (Zamba2), in plain PyTorch.

Both are instances of the gated outer-product recurrence

    S_t = a_t * S_{t-1} + g_t * k_t v_t^T          S: (dk, dv) per head
    y_t = q_t^T S_t

with 0 < a_t <= 1 (log_a <= 0).  The chunkwise-parallel form processes W
timesteps per step of a loop over chunks:

  within-chunk:  y[t] += sum_{s<=t} exp(cum[t]-cum[s]) g[s] (q_t.k_s) v_s
  cross-chunk:   y[t] += exp(cum[t]) q_t^T S_prev
  state update:  S' = exp(cum[W-1]) S_prev
                   + sum_s exp(cum[W-1]-cum[s]) g[s] k_s v_s^T

As in the reference (``repro/models/ssm_common.py``, plain ``jnp``: there is
no TPU kernel here), the state and every product run in float32, and each
chunk's output is cast to ``v.dtype``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

DEFAULT_CHUNK = 128
# the masked-out decay exponent: exp of it is exactly 0 in f32
_MASKED = -1e30


def chunk_width(s: int, chunk: int) -> int:
    """The reference's chunk rule, copied as it is: ``min(chunk, s)``, and
    the whole sequence as one chunk when that does not divide ``s``.  So a
    prompt of 19-60 tokens is one chunk, and a run has several chunks only
    where ``s`` is a multiple of ``chunk``."""
    w = min(chunk, s)
    return s if s % w else w


def chunked_linear_recurrence(
    q: torch.Tensor,        # (B, S, H, dk)
    k: torch.Tensor,        # (B, S, H, dk)
    v: torch.Tensor,        # (B, S, H, dv)
    log_a: torch.Tensor,    # (B, S, H) decay logs, <= 0
    gate: torch.Tensor,     # (B, S, H) input gates, >= 0
    init_state: Optional[torch.Tensor] = None,   # (B, H, dk, dv) f32
    chunk: int = DEFAULT_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, dv) in v's dtype, final_state (B, H, dk, dv) f32)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    w = chunk_width(s, chunk)
    state = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
             if init_state is None else init_state)
    tri = torch.tril(torch.ones((w, w), dtype=torch.bool, device=q.device))
    ys = []
    for c0 in range(0, s, w):
        qc = q[:, c0:c0 + w].float()
        kc = k[:, c0:c0 + w].float()
        vc = v[:, c0:c0 + w].float()
        gc = gate[:, c0:c0 + w].float()
        cum = torch.cumsum(log_a[:, c0:c0 + w].float(), dim=1)      # (B, W, H)
        total = cum[:, -1]                                            # (B, H)
        # cross-chunk contribution
        y_inter = torch.einsum("bwhk,bhkv->bwhv", qc * torch.exp(cum)[..., None], state)
        # within-chunk: decay-weighted causal attention.  Mask BEFORE exp:
        # where s > t the ratio is positive and exp of it overflows; a 0/1
        # mask multiplied after exp gives inf * 0 = NaN forward, and a
        # where() after exp is right forward but NaN in the gradient
        ratio = cum[:, :, None, :] - cum[:, None, :, :]               # (B, Wq, Ws, H)
        decay = torch.exp(torch.where(tri[None, :, :, None], ratio, _MASKED))
        scores = torch.einsum("bthk,bshk->btsh", qc, kc)
        weighted = scores * decay * gc[:, None, :, :]
        y_intra = torch.einsum("btsh,bshv->bthv", weighted, vc)
        # state update
        carry_decay = torch.exp(total[:, None, :] - cum) * gc
        kv = torch.einsum("bshk,bshv->bhkv", kc * carry_decay[..., None], vc)
        state = state * torch.exp(total)[..., None, None] + kv
        # each chunk's output is rounded to v's dtype (bf16 when served)
        ys.append((y_inter + y_intra).to(v.dtype))
    return torch.cat(ys, dim=1), state


def recurrence_decode_step(
    q: torch.Tensor,        # (B, H, dk)
    k: torch.Tensor,        # (B, H, dk)
    v: torch.Tensor,        # (B, H, dv)
    log_a: torch.Tensor,    # (B, H)
    gate: torch.Tensor,     # (B, H)
    state: torch.Tensor,    # (B, H, dk, dv) float32
    out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent decode step, O(1) in the sequence length.  Returns (y
    (B, H, dv) in v's dtype, new_state).  ``out`` (it may be ``state``
    itself) receives the new state in place: the serving caches advance
    without a copy of the state."""
    a = torch.exp(log_a.float())[..., None, None]
    kv = torch.einsum("bhk,bhv->bhkv", k.float() * gate.float()[..., None], v.float())
    if out is None:
        new_state = state * a + kv
    else:
        new_state = torch.mul(state, a, out=out).add_(kv)
    y = torch.einsum("bhk,bhkv->bhv", q.float(), new_state)
    return y.to(v.dtype), new_state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv (the Mamba frontend).

    x: (B, S, D); w: (K, D); state: (B, K-1, D), the last K-1 inputs carried
    for decode.  Returns (y (B, S, D), new_state (B, K-1, D)), both in x's
    dtype; the taps are summed in order, as the reference sums them.
    """
    kk, d = w.shape
    if state is None:
        state = torch.zeros((x.shape[0], kk - 1, d), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)            # (B, S+K-1, D)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, kk):
        y = y + xp[:, i:i + s] * w[i]
    if b is not None:
        y = y + b
    new_state = xp[:, -(kk - 1):] if kk > 1 else state
    return y, new_state
