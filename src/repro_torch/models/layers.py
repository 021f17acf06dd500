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

On a mesh (an ambient ``distributed.context.parallel_context`` whose model
axis has more than one member) every rank holds its local shards and the
layers make the collectives the layouts imply (explicit SPMD):
:func:`linear` runs an N-sharded weight on the rank's columns and gathers
them unless the caller keeps them local, and a K-sharded weight on the
rank's whole-fragment K slice of the input followed by a sum over
``model``; attention runs on the rank's heads when q/k/v split at whole
heads, else on all heads (gathered), and a dense slot cache whose sequence
is sharded (context-parallel decode) merges the ranks' partial softmaxes
by log-sum-exp; the vocab-sharded embedding is a masked lookup plus a sum,
and the logits are gathered before sampling.  The collectives are
differentiable, with the conjugates of ``distributed/context``, so the same
code trains on a mesh: a dense leaf split over the batch axes (FSDP) is
gathered where it is used (:func:`gathered`, inside each block so a remat
recompute gathers it again), and :func:`model_entry` at the entry of
attention and the MLP sums the input's partial cotangent over ``model``
once, in the primal dtype: the reference's ``grad_boundary``.  The
reference's ``constrain`` annotates GSPMD layouts and has no counterpart.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.distributed.context import gather_fsdp, model_ctx, set_shard, shard_of
from repro_torch.distributed.sharding import SCANNED_PREFIXES
from repro_torch.forms.linear import DTYPES, FormsLinearParams  # noqa: F401
from repro_torch.forms.linear import apply as forms_apply
from repro_torch.forms.linear import to_dense as forms_to_dense
from repro_torch.forms.tree import EXPERT_WEIGHT_NAMES
from repro_torch.serving.quant_weights import dequantize_leaf

Params = Dict[str, torch.Tensor]

DEFAULT_Q_CHUNK = 1024
MASK_VALUE = -1e30


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with jnp's type promotion (bf16 @ f32 computes in f32)."""
    rt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(rt), b.to(rt))


def wload(p: Params, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Weight read with decompression (:func:`load_leaf` of ``p[name]``)."""
    return load_leaf(p[name], name, dtype)


def load_leaf(v, name: str, dtype: torch.dtype) -> torch.Tensor:
    """One weight leaf read with decompression.

    An int-grid leaf ``{"q": int8, "s": f32}`` (``serving/quant_weights``)
    is dequantized, on any device, as in the reference.  A FORMS leaf is
    rebuilt densely on the CPU only: on the card it is consumed by the
    polarized-matmul kernel through :func:`linear`, and rebuilding it there
    would serve around the kernel, so that raises.  Two exceptions, each
    rebuilt as the reference rebuilds it (no kernel of the reference
    serves them either): a layer's stacked experts (``w_gate``/``w_up``/
    ``w_down``, mags ``(E, Kp, N)``), which the MoE family's expert FFN
    multiplies with ``torch.einsum``, and a layer's MLA ``kv_up``, which
    the absorbed decode folds into the query and the output.  On a mesh a
    leaf split along N comes back as this rank's columns (``kv_up``: the
    rank's heads); one split along K raises (``forms.to_dense``).  The
    experts' rebuild is the span ``rt.moe.rebuild``; ``moe.rebuild_bytes``
    counts the bytes of the dense tensors it returns.
    """
    if isinstance(v, dict) and "q" in v:
        return dequantize_leaf(v, dtype)
    if isinstance(v, FormsLinearParams):
        experts = name in EXPERT_WEIGHT_NAMES and v.mags.ndim == 3
        rebuilt = experts or (name == "kv_up" and v.mags.ndim == 2)
        if v.mags.device.type != "cpu" and not rebuilt:
            raise NotImplementedError(
                f"{name}: a FORMS leaf on {v.mags.device} is consumed by the "
                "polarized-matmul kernel via linear(), not decompressed")
        if experts:
            with obs.span("rt.moe.rebuild", leaf=name):
                out = forms_to_dense(v).to(dtype)
            obs.count("moe.rebuild_bytes", out.numel() * out.element_size())
            return out
        return forms_to_dense(v).to(dtype)
    return v.to(dtype)


def linear(p: Params, name: str, x: torch.Tensor, dtype: torch.dtype, *,
           x_local: bool = False, out_local: bool = False,
           x_entry: bool = False) -> torch.Tensor:
    """``x @ W`` where ``W = p[name]`` is dense, int-grid or FORMS-compressed;
    every compressed weight goes through the polarized matmul, which takes
    2-D weights only (a stacked or conv leaf raises).  Dense and int-grid
    weights are a ``torch.matmul`` (the reference's int path runs outside
    any Pallas kernel too).  On a mesh ``x_local`` says ``x`` holds this
    rank's columns (a split at the model axis), ``out_local`` asks for
    this rank's output columns back and ``x_entry`` says ``x`` came
    through :func:`model_entry` (:func:`apply_weight`)."""
    return apply_weight(p[name], x, dtype, name, x_local=x_local, out_local=out_local,
                        x_entry=x_entry)


def _matrix_split(v) -> Tuple[bool, bool]:
    """Whether a leaf's K and N are split over the model axis."""
    if isinstance(v, dict):      # an int-grid leaf: its codes carry the layout
        v = v["q"]
    if isinstance(v, FormsLinearParams):
        return v.matrix_split()
    sh = shard_of(v)
    if sh is None:
        return False, False
    return sh.on_model(-2), sh.on_model(-1)


def _cols(t: torch.Tensor, ctx) -> torch.Tensor:
    """This rank's equal share of ``t``'s last dim (``t`` alike on every
    rank of the model axis; the backward gathers the shares)."""
    return ctx.split(t, "model", -1)


def model_entry(x: torch.Tensor) -> torch.Tensor:
    """The sublayer entry on a mesh (the reference's ``grad_boundary``):
    the identity, whose backward sums the cotangent of ``x`` over ``model``
    once, in ``x``'s dtype (bf16 in a bf16 model), for every consumer
    behind it that holds only some of its weight's columns or rows.  The
    consumers take ``x_entry=True``; off a mesh it is ``x`` itself."""
    ctx = model_ctx()
    return x if ctx is None else ctx.copy_to(x, "model")


def all_split(p: Params, names) -> bool:
    """Whether every one of ``p``'s named weights is split over ``model``
    (each then makes a partial cotangent, and one :func:`model_entry` in
    front of them all sums it)."""
    return model_ctx() is not None and all(any(_matrix_split(p[n])) for n in names)


def apply_weight(v, x: torch.Tensor, dtype: torch.dtype, tag: str, *,
                 x_local: bool = False, out_local: bool = False,
                 x_entry: bool = False) -> torch.Tensor:
    """``x @ v`` for one weight leaf in any layout (see :func:`linear`).

    Off a mesh: the polarized matmul of a FORMS leaf, else a matmul.  On a
    mesh with model size tp: a K-sharded leaf multiplies the rank's K slice
    of x (padded to Kp; an ``x_local`` activation is that slice already when
    its width is the leaf's local K) in f32 and sums over ``model`` before
    the cast; any other leaf takes the whole x (gathered if ``x_local``).
    An N-sharded result is gathered unless ``out_local``; a replicated one
    is cut to the rank's columns when ``out_local``.

    The backward keeps every cotangent of a replicated activation whole and
    alike on every model rank: a whole x entering an N-sharded leaf goes
    through ``copy_to`` (its cotangent summed over ``model``) and its K
    slice through ``split``, except behind :func:`model_entry`
    (``x_entry``), which sums the partial cotangents of all its consumers at
    once; there the leaf must be split.  An FSDP leaf comes gathered
    (:func:`gathered`).
    """
    ctx = model_ctx()
    forms = isinstance(v, FormsLinearParams)
    if ctx is None:
        if forms:
            return forms_apply(v, x, tag=tag).to(dtype)
        return matmul(x, load_leaf(v, tag, dtype))
    k_split, n_split = _matrix_split(v)
    if x_entry and not (k_split or n_split):
        raise ValueError(f"{tag}: a replicated weight behind model_entry would count its "
                         "whole cotangent once per model rank")
    whole = x_entry and not x_local     # x is whole, its cotangent summed at the entry
    if x_local and not (k_split and x.shape[-1] == _local_k(v)
                        and (not forms or v.k == _local_k(v) * ctx.axis_size("model"))):
        x = ctx.all_gather(x, "model", -1)
        x_local = False
    if k_split:
        tp, kl = ctx.axis_size("model"), _local_k(v)
        if x_local:
            xs = x
        else:
            if x.shape[-1] < kl * tp:
                x = torch.nn.functional.pad(x, (0, kl * tp - x.shape[-1]))
            r = ctx.coord("model")
            xs = x[..., r * kl:(r + 1) * kl] if whole else ctx.split(x, "model", -1)
        if forms:
            y = forms_apply(v, xs, tag=tag)
        else:
            y = torch.matmul(xs.float(), load_leaf(v, tag, dtype).float())
        y = ctx.all_reduce(y, "model").to(dtype)
    else:
        if n_split and not whole:
            x = ctx.copy_to(x, "model")
        if forms:
            y = forms_apply(v, x, tag=tag).to(dtype)
        else:
            y = matmul(x, load_leaf(v, tag, dtype))
    if n_split and not out_local:
        return ctx.all_gather(y, "model", -1)
    if out_local and not n_split:
        return _cols(y, ctx)
    return y


def _local_k(v) -> int:
    if isinstance(v, dict):
        v = v["q"]
    return v.mags.shape[-2] if isinstance(v, FormsLinearParams) else v.shape[-2]


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


def layernorm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with ``p["scale"]`` and ``p["bias"]`` (whisper)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


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


@obs.spanned("rt.attn.prefill")
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


@obs.spanned("rt.attn.decode")
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


def decode_attention_seq_shard(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, pos: torch.Tensor, offset: int,
                               window: Optional[int] = None) -> torch.Tensor:
    """:func:`decode_attention` on a cache whose sequence is sharded over
    ``model`` (context-parallel decode): this rank holds cache positions
    ``offset .. offset + S_local - 1``.  The ranks' partial softmaxes merge
    by log-sum-exp over ``model`` (the flash-decoding merge): the global
    max, the global sum of exponentials, then each rank's probabilities
    (cast to the cache dtype, as the one-device path casts them) times its
    values, summed."""
    ctx = model_ctx()
    b, t, h, hd = q.shape
    s_loc, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = attn_scale(hd, q.device)
    qr = q.reshape(b, t, kv, g, hd).to(k_cache.dtype)
    pos2 = position_grid(pos, b, t)
    scores = torch.einsum("btkgh,bskh->bkgts", qr.float(), k_cache.float()) * scale
    kpos = offset + torch.arange(s_loc, dtype=torch.int32, device=q.device)
    mask = kpos[None, None, :] <= pos2[:, :, None]
    if window is not None:
        mask = mask & (kpos[None, None, :] > pos2[:, :, None] - window)
    scores = torch.where(mask[:, None, None], scores, MASK_VALUE)
    top = ctx.all_reduce(scores.amax(dim=-1, keepdim=True), "model", "max")
    e = torch.exp(scores - top)
    probs = e / ctx.all_reduce(e.sum(dim=-1, keepdim=True), "model")
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    out = ctx.all_reduce(out, "model")
    return out.reshape(b, t, h, hd).to(v_cache.dtype)


def write_view(view: torch.Tensor, rows: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Write ``rows`` (B, T, ...) into a (B, S, ...) cache view at the (B, T)
    position grid, in place; positions past S are dropped (JAX's scatter
    semantics).  A dropped write lands on row S-1 carrying that row's final
    value, so the duplicate writes there agree whatever their order."""
    b, s = view.shape[:2]
    bidx = torch.arange(b, device=view.device)[:, None].expand_as(grid)
    tail = (-1,) + (1,) * (rows.ndim - 2)
    live = (grid < s).reshape(*grid.shape, *tail[1:])
    last = view[:, s - 1]
    if grid.shape[1] > 1:
        # a row of several tokens may write S-1 and drop others onto it
        hit = grid == s - 1                               # at most one t per row
        t_hit = hit.to(torch.int8).argmax(dim=1)
        last = torch.where(hit.any(dim=1).reshape(tail), rows[bidx[:, 0], t_hit], last)
    view[bidx, grid.clamp(max=s - 1).long()] = torch.where(live, rows, last[:, None])
    return view


def write_view_range(view: torch.Tensor, rows: torch.Tensor, grid: torch.Tensor,
                     offset: int) -> torch.Tensor:
    """:func:`write_view` into a rank's slice of a sequence-sharded cache
    (positions ``offset .. offset + S_local - 1``): rows at positions this
    rank does not hold are dropped, so each row lands on its owner only.
    Shapes stay static (no host sync): a dropped row lands on the slice's
    first or last position carrying that position's final value, as in
    :func:`write_view`, so the duplicate writes there agree."""
    b, s = view.shape[:2]
    loc = grid - offset
    live = (loc >= 0) & (loc < s)
    bidx = torch.arange(b, device=view.device)[:, None].expand_as(grid)
    tail = (-1,) + (1,) * (rows.ndim - 2)
    rows_b = bidx[:, 0]

    def final(hit: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
        t_hit = hit.to(torch.int8).argmax(dim=1)          # at most one t per row
        return torch.where(hit.any(dim=1).reshape(tail), rows[rows_b, t_hit], cur)

    first = final(live & (loc == 0), view[:, 0])
    last = final(live & (loc == s - 1), view[:, s - 1])
    shape = (*grid.shape, *tail[1:])
    fill = torch.where((loc < 0).reshape(shape), first[:, None], last[:, None])
    view[bidx, loc.clamp(0, s - 1).long()] = torch.where(live.reshape(shape), rows, fill)
    return view


def _vec_like(b: torch.Tensor, width: int) -> torch.Tensor:
    """A bias in the layout of a ``width``-wide activation: gathered, cut to
    this rank's share, or as it is."""
    if b.shape[-1] == width:
        return b
    ctx = model_ctx()
    if b.shape[-1] < width:
        return ctx.all_gather(b, "model", -1)
    return _cols(b, ctx)


def attention_block(p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
                    hd: int, rope_theta: float, positions: torch.Tensor,
                    window: Optional[int] = None,
                    q_chunk: int = DEFAULT_Q_CHUNK,
                    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    cache_pos: Optional[torch.Tensor] = None,
                    use_rope: bool = True, causal: bool = True,
                    return_kv: bool = False, dtype=torch.bfloat16,
                    seq_offset: Optional[int] = None):
    """Full attention sub-layer.  Returns (out, new_kv_or_None).

    Prefill (``cache=None``): self-attention over x, causal unless
    ``causal=False`` (whisper's encoder); with ``return_kv`` also the
    post-rope (k, v) for the one-shot page write.  ``use_rope=False``
    leaves q and k unrotated (whisper's absolute positions).
    Decode (``cache=(k, v)`` gathered views of shape (B, Smax, KV, hd)):
    writes the new K/V into the views — a transient copy, not the pool —
    attends, and returns the new-token K/V for the caller's commit.
    On a mesh whose model size divides both head counts the block runs on
    this rank's heads (its q/k/v columns, its cache heads, its rows of
    ``wo``) and returns its heads' K/V; otherwise on all heads.
    ``seq_offset`` marks a decode cache that holds this rank's sequence
    slice from that position (context-parallel decode).
    """
    b, s, _ = x.shape
    ctx = model_ctx()
    tp = ctx.axis_size("model") if ctx is not None else 1
    local = tp > 1 and n_heads % tp == 0 and n_kv % tp == 0
    if local:
        n_heads, n_kv = n_heads // tp, n_kv // tp
    entry = all_split(p, ("wq", "wk", "wv"))
    if entry:
        x = model_entry(x)
    q = linear(p, "wq", x, dtype, out_local=local, x_entry=entry)
    k = linear(p, "wk", x, dtype, out_local=local, x_entry=entry)
    v = linear(p, "wv", x, dtype, out_local=local, x_entry=entry)
    if "bq" in p:
        q = q + _vec_like(p["bq"], q.shape[-1]).to(dtype)
        k = k + _vec_like(p["bk"], k.shape[-1]).to(dtype)
        v = v + _vec_like(p["bv"], v.shape[-1]).to(dtype)
    q = q.reshape(b, s, n_heads, hd)
    k = k.reshape(b, s, n_kv, hd)
    v = v.reshape(b, s, n_kv, hd)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    if cache is None:
        out = causal_attention(q, k, v, window=window, q_chunk=q_chunk,
                               positions=positions, causal=causal)
        new_kv = (k, v) if return_kv else None
    else:
        k_cache, v_cache = cache
        k_t, v_t = k.to(k_cache.dtype), v.to(v_cache.dtype)
        posgrid = position_grid(cache_pos, b, s)
        if seq_offset is None:
            write_view(k_cache, k_t, posgrid)
            write_view(v_cache, v_t, posgrid)
            out = decode_attention(q, k_cache, v_cache, posgrid, window=window)
        else:
            write_view_range(k_cache, k_t, posgrid, seq_offset)
            write_view_range(v_cache, v_t, posgrid, seq_offset)
            out = decode_attention_seq_shard(q, k_cache, v_cache, posgrid, seq_offset,
                                             window=window)
        new_kv = (k_t, v_t)
    out = out.reshape(b, s, n_heads * hd)
    return linear(p, "wo", out, dtype, x_local=local), new_kv


def cross_attention_block(p: Params, x: torch.Tensor, enc: torch.Tensor, *,
                          n_heads: int, hd: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper's decoder): MHA over the
    whole encoder output, no mask, f32 scores.  ``enc`` is whole on every
    rank.  On a mesh whose model size divides the heads the block runs on
    this rank's heads, as :func:`attention_block` does (its q/k/v columns,
    its rows of ``wo``, then a sum over ``model``); otherwise on all heads
    (the N-split projections gathered)."""
    b, s, _ = x.shape
    se = enc.shape[1]
    ctx = model_ctx()
    tp = ctx.axis_size("model") if ctx is not None else 1
    local = tp > 1 and n_heads % tp == 0
    if local:
        n_heads //= tp
    entry = all_split(p, ("wk", "wv"))
    if entry:
        enc = model_entry(enc)
    q = linear(p, "wq", x, dtype, out_local=local).reshape(b, s, n_heads, hd)
    k = linear(p, "wk", enc, dtype, out_local=local, x_entry=entry).reshape(b, se, n_heads, hd)
    v = linear(p, "wv", enc, dtype, out_local=local, x_entry=entry).reshape(b, se, n_heads, hd)
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * attn_scale(hd, x.device)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v.float()).to(dtype)
    return linear(p, "wo", out.reshape(b, s, n_heads * hd), dtype, x_local=local)


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
    ctx = model_ctx()
    # on a mesh the hidden columns stay on their rank unless the fragment
    # ranking needs whole rows
    local = (ctx is not None and frag_drop == 0.0
             and _hidden_width(p) % ctx.axis_size("model") == 0)
    entry = all_split(p, ("gate", "up"))
    if entry:
        x = model_entry(x)
    h = (_MLP_ACTS[act](linear(p, "gate", x, dtype, out_local=local, x_entry=entry))
         * linear(p, "up", x, dtype, out_local=local, x_entry=entry))
    if frag_drop > 0.0:
        h = sparsify_fragments(h, frag_m, frag_drop)
    return linear(p, "down", h, dtype, x_local=local)


def _hidden_width(p: Params) -> int:
    """The global output width of ``p["gate"]``."""
    v = p["gate"]
    if isinstance(v, dict):
        v = v["q"]
    sh = v.shard[0] if isinstance(v, FormsLinearParams) and v.shard else shard_of(v)
    if sh is not None:
        return sh.shape[-1]
    return v.mags.shape[-1] if isinstance(v, FormsLinearParams) else v.shape[-1]


def gelu_mlp(p: Params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Biased two-layer MLP with the tanh-approximate GELU, which is
    ``jax.nn.gelu``'s default (whisper).  On a mesh the hidden columns stay
    on their rank (``up``'s columns plus the bias's share, ``down``'s K
    rows, then a sum over ``model``)."""
    ctx = model_ctx()
    local = ctx is not None and p["b_up"].shape[-1] % ctx.axis_size("model") == 0
    h = linear(p, "up", x, dtype, out_local=local)
    h = F.gelu(h + _vec_like(wload(p, "b_up", dtype), h.shape[-1]), approximate="tanh")
    return linear(p, "down", h, dtype, x_local=local) + wload(p, "b_down", dtype)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of the table, cast to ``dtype`` (gather first: same numbers as
    the reference's cast-then-gather, without casting the whole table).
    ``index_select``, whose gradient is an ``index_add_`` into the table,
    keeps the backward pass free of host syncs.  A vocab-sharded table (a
    mesh) looks up the tokens in this rank's rows, zeroes the others and
    sums over ``model``: exactly one rank holds each row."""
    sh = shard_of(embed)
    ctx = model_ctx()
    if sh is not None and ctx is not None and sh.on_model(0):
        v_loc = embed.shape[0]
        idx = tokens.reshape(-1).long() - ctx.coord("model") * v_loc
        live = (idx >= 0) & (idx < v_loc)
        rows = embed.index_select(0, idx.clamp(0, v_loc - 1))
        rows = ctx.all_reduce(torch.where(live[:, None], rows, 0.0), "model")
        return rows.reshape(*tokens.shape, embed.shape[-1]).to(dtype)
    rows = embed.index_select(0, tokens.reshape(-1).long())
    return rows.reshape(*tokens.shape, embed.shape[-1]).to(dtype)


def lm_logits(x: torch.Tensor, head, dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ head``; on a mesh the vocab-sharded logits are gathered, so
    sampling sees every column as on one device."""
    return apply_weight(head, x, dtype, "head")


def take_layer(t: torch.Tensor, i: int) -> torch.Tensor:
    """Layer ``i`` of a stacked dense tensor, keeping its layout on a mesh."""
    sh = shard_of(t)
    return set_shard(t[i], sh.layer() if sh is not None else None)


def gathered(tree):
    """A params subtree with every FSDP leaf gathered (:func:`gather_fsdp`),
    e.g. one layer's slice inside its block, where a recompute (remat)
    gathers it again."""
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gathered(v) for v in tree]
    return gather_fsdp(tree)


def gathered_top(params):
    """The params with every FSDP leaf outside the stacked layer trees
    gathered once (the embedding, the tied or untied head, the final norm),
    so the forward and the loss share one gather of each; the stacked
    leaves are gathered per layer slice inside the blocks."""
    return {k: (v if k in SCANNED_PREFIXES else gathered(v)) for k, v in params.items()}
