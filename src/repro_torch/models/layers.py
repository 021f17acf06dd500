"""Shared model building blocks, in plain PyTorch.

Conventions follow the JAX package exactly, so the same weights give the
same numbers:

* params are nested dicts of float32 tensors; compute casts to the config
  dtype (bf16 by default);
* attention takes bf16 (or f32) operands and sums in float32 — here the
  operands are upcast to f32, which gives the same products and sums;
* RoPE rotates *interleaved* pairs (``x[..., 0::2]``, ``x[..., 1::2]``);
* the decode path keeps the KV cache in bf16 and attends with the query
  cast to the cache dtype, as the reference does.

The reference's sharding annotations (``constrain``/``grad_boundary``) have
no counterpart on one card and are dropped.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.forms.linear import DTYPES, FormsLinearParams  # noqa: F401
from repro_torch.forms.linear import apply as forms_apply
from repro_torch.forms.linear import to_dense as forms_to_dense

Params = Dict[str, torch.Tensor]

DEFAULT_Q_CHUNK = 1024
MASK_VALUE = -1e30


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with jnp's type promotion (bf16 @ f32 computes in f32)."""
    rt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(rt), b.to(rt))


def wload(p: Params, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Weight read with decompression of FORMS leaves on the CPU.

    On the card a FORMS leaf is consumed by the polarized-matmul kernel
    through :func:`linear`; rebuilding it densely there would serve around
    the kernel, so that raises.
    """
    v = p[name]
    if isinstance(v, FormsLinearParams):
        if v.mags.device.type != "cpu":
            raise NotImplementedError(
                f"{name}: a FORMS leaf on {v.mags.device} is consumed by the "
                "polarized-matmul kernel via linear(), not decompressed")
        return forms_to_dense(v).to(dtype)
    return v.to(dtype)


def linear(p: Params, name: str, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ W`` where ``W = p[name]`` is dense or FORMS-compressed; every
    compressed weight goes through the polarized matmul, which takes 2-D
    weights only (a stacked or conv leaf raises)."""
    v = p[name]
    if isinstance(v, FormsLinearParams):
        return forms_apply(v, x, tag=name).to(dtype)
    return matmul(x, wload(p, name, dtype))


def _f32_scalar(v: float, device) -> torch.Tensor:
    # a fill on the device, not a host-to-device copy: no host sync
    return torch.full((), v, dtype=torch.float32, device=device)


def attn_scale(hd: int, device) -> torch.Tensor:
    """``1 / sqrt(hd)`` computed in f32, as the reference computes it."""
    return 1.0 / torch.sqrt(_f32_scalar(float(hd), device))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(_f32_scalar(theta, device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd) or (B, S, hd); positions: (S,) or (B, S) int.

    Rotates interleaved pairs and restacks them, exactly as the reference.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions.float()[..., None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    if positions.ndim == 1:
        if x.ndim == 4:
            cos, sin = cos[None, :, None, :], sin[None, :, None, :]
        else:
            cos, sin = cos[None], sin[None]
    elif x.ndim == 4:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def gqa_scores_softmax_out(qr, k, v, qpos, kpos, window, scale, causal=True):
    """One chunk of grouped-query attention.

    qr: (B, qc, KV, G, hd); k/v: (B, S, KV, hd); positions (qc,), (S,).
    Returns (B, qc, KV, G, hd) in v's dtype.
    """
    b, qc, kv, g, hd = qr.shape
    hdv = v.shape[-1]
    q_full = qr.reshape(b, qc, kv * g, hd).float()
    k_full = k.repeat_interleave(g, dim=2).float()
    v_full = v.repeat_interleave(g, dim=2).float()
    scores = torch.einsum("bqhd,bshd->bhqs", q_full, k_full) * scale
    if causal:
        mask = qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        scores = torch.where(mask[None, None], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype).float(), v_full)
    return out.to(v.dtype).reshape(b, qc, kv, g, hdv)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: Optional[int] = None,
                     q_chunk: int = DEFAULT_Q_CHUNK,
                     positions: Optional[torch.Tensor] = None,
                     causal: bool = True) -> torch.Tensor:
    """Chunked (optionally causal) GQA for prefill.  q: (B, S, H, hd);
    k/v: (B, S, KV, hd).  Query chunks of ``q_chunk`` keep the score peak at
    (B, H, q_chunk, S)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    hdv = v.shape[-1]
    g = h // kv
    scale = attn_scale(hd, q.device)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=q.device)
    qr = q.reshape(b, s, kv, g, hd)
    qc = min(q_chunk, s)
    if s % qc != 0:
        qc = s
    outs = [gqa_scores_softmax_out(qr[:, i:i + qc], k, v, positions[i:i + qc],
                                   positions, window, scale, causal)
            for i in range(0, s, qc)]
    return torch.cat(outs, dim=1).reshape(b, s, h, hdv)


def position_grid(pos: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """Normalize decode positions (scalar, (B,) or (B, T)) to a (B, T) grid."""
    pos = torch.as_tensor(pos).to(torch.int32)
    if pos.ndim <= 1:
        pos = pos.reshape(-1, 1)
    return pos.expand(b, t)


def position_span(pos: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) first-token positions -> the (B, T) grid ``pos[b] + t``."""
    pos = pos.to(torch.int32)
    return pos[:, None] + torch.arange(t, dtype=torch.int32, device=pos.device)[None, :]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, window: Optional[int] = None) -> torch.Tensor:
    """Bounded-token GQA against a cache view.

    q: (B, T, H, hd); caches: (B, Smax, KV, hd) (dense leaves or paged
    gathers); query ``(b, t)`` attends to cache positions <= pos[b, t].  The
    query is cast to the cache dtype first and the output comes back in it,
    as in the reference.
    """
    b, t, h, hd = q.shape
    smax, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = attn_scale(hd, q.device)
    qr = q.reshape(b, t, kv, g, hd).to(k_cache.dtype)
    pos2 = position_grid(pos, b, t)
    scores = torch.einsum("btkgh,bskh->bkgts", qr.float(), k_cache.float()) * scale
    kpos = torch.arange(smax, dtype=torch.int32, device=q.device)
    mask = kpos[None, None, :] <= pos2[:, :, None]
    if window is not None:
        mask = mask & (kpos[None, None, :] > pos2[:, :, None] - window)
    scores = torch.where(mask[:, None, None], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, t, h, hd).to(v_cache.dtype)


def write_view(view: torch.Tensor, rows: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Write ``rows`` (B, T, ...) into a (B, S, ...) cache view at the (B, T)
    position grid, in place; positions past S are dropped (JAX's scatter
    semantics)."""
    b = view.shape[0]
    s = view.shape[1]
    bidx = torch.arange(b, device=view.device)[:, None].expand_as(grid)
    live = grid < s
    idx = grid.clamp(max=s - 1).long()
    keep = view[bidx, idx]
    sel = live.reshape(*live.shape, *([1] * (rows.ndim - 2)))
    view[bidx, idx] = torch.where(sel, rows, keep)
    return view


def attention_block(p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
                    hd: int, rope_theta: float, positions: torch.Tensor,
                    window: Optional[int] = None,
                    q_chunk: int = DEFAULT_Q_CHUNK,
                    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    cache_pos: Optional[torch.Tensor] = None,
                    return_kv: bool = False, dtype=torch.bfloat16):
    """Full attention sub-layer.  Returns (out, new_kv_or_None).

    Prefill (``cache=None``): causal self-attention over x; with
    ``return_kv`` also the post-rope (k, v) for the one-shot page write.
    Decode (``cache=(k, v)`` gathered views of shape (B, Smax, KV, hd)):
    writes the new K/V into the views — a transient copy, not the pool —
    attends, and returns the new-token K/V for the caller's commit.
    """
    b, s, _ = x.shape
    q = linear(p, "wq", x, dtype)
    k = linear(p, "wk", x, dtype)
    v = linear(p, "wv", x, dtype)
    if "bq" in p:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    q = q.reshape(b, s, n_heads, hd)
    k = k.reshape(b, s, n_kv, hd)
    v = v.reshape(b, s, n_kv, hd)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if cache is None:
        out = causal_attention(q, k, v, window=window, q_chunk=q_chunk,
                               positions=positions)
        new_kv = (k, v) if return_kv else None
    else:
        k_cache, v_cache = cache
        k_t, v_t = k.to(k_cache.dtype), v.to(v_cache.dtype)
        posgrid = position_grid(cache_pos, b, s)
        write_view(k_cache, k_t, posgrid)
        write_view(v_cache, v_t, posgrid)
        out = decode_attention(q, k_cache, v_cache, posgrid, window=window)
        new_kv = (k_t, v_t)
    out = out.reshape(b, s, n_heads * hd)
    return linear(p, "wo", out, dtype), new_kv


# ---------------------------------------------------------------------------
# MLP, embedding, head
# ---------------------------------------------------------------------------

_MLP_ACTS = {"silu": F.silu, "gelu": lambda t: F.gelu(t, approximate="tanh"),
             "relu": F.relu}


def sparsify_fragments(x: torch.Tensor, m: int, drop_frac: float) -> torch.Tensor:
    """Zero all but the top-``(1 - drop_frac)`` fragments of each row.

    Ranks the m-wide input groups of each row by max |x| and zeroes the
    weakest ``drop_frac`` of them, so the sparsity the zero-skipping
    matmuls see is aligned with the fragments they can skip.  Ties at the
    threshold may keep more than the budget, as in the reference.
    """
    if drop_frac <= 0.0:
        return x
    if not 0.0 < drop_frac < 1.0:
        raise ValueError(f"drop_frac must be in [0, 1), got {drop_frac}")
    K = x.shape[-1]
    if K % m:
        raise ValueError(
            f"feature dim {K} does not tile into fragments of m={m}; "
            f"align act_fragment with the layer width (or pad the model)")
    F = K // m
    keep = max(1, int(round(F * (1.0 - drop_frac))))
    xf = x.reshape(*x.shape[:-1], F, m)
    strength = xf.float().abs().amax(dim=-1)                           # (..., F)
    kth = torch.sort(strength, dim=-1, descending=True).values[..., keep - 1:keep]
    mask = strength >= kth
    return (xf * mask[..., None].to(xf.dtype)).reshape(x.shape)


def swiglu(p: Params, x: torch.Tensor, dtype=torch.bfloat16, act: str = "silu",
           frag_drop: float = 0.0, frag_m: int = 8) -> torch.Tensor:
    """Gated MLP; ``act`` picks the gate nonlinearity.  ``frag_drop > 0``
    sparsifies the hidden activations in whole fragments before ``down``,
    so the zero-skipping matmuls have dead fragments to skip."""
    h = _MLP_ACTS[act](linear(p, "gate", x, dtype)) * linear(p, "up", x, dtype)
    if frag_drop > 0.0:
        h = sparsify_fragments(h, frag_m, frag_drop)
    return linear(p, "down", h, dtype)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of the table, cast to ``dtype`` (gather first: same numbers as
    the reference's cast-then-gather, without casting the whole table).
    ``index_select``, whose gradient is an ``index_add_`` into the table,
    keeps the backward pass free of host syncs."""
    rows = embed.index_select(0, tokens.reshape(-1).long())
    return rows.reshape(*tokens.shape, embed.shape[-1]).to(dtype)


def lm_logits(x: torch.Tensor, head, dtype=torch.bfloat16) -> torch.Tensor:
    if isinstance(head, FormsLinearParams):
        return forms_apply(head, x, tag="head").to(dtype)
    return matmul(x, head.to(dtype))
