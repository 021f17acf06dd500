"""Expert-parallel MoE dispatch/combine with ``all_to_all`` over ``model``.

The JAX package's ``distributed/moe_dispatch.py`` in explicit SPMD: each
rank holds ``E / tp`` experts (``moe/w_*`` sharded ``("model", None,
None)``) and a token slice of its data shard, sorts its (token, expert)
assignments by destination expert, packs a ``(tp, E_loc, C2, d)`` send
buffer, exchanges it with ``all_to_all`` over ``model``, and hands its
experts an ``(E_loc, tp * C2, d)`` block; :func:`combine` sends the expert
outputs back the same way and gathers each token's K outputs by its
recorded slot.

Capacity is per (source rank, expert): ``C2 = max(1, int(cf * T_loc * K /
E))`` with ``T_loc`` the tokens of one rank, as the reference; pairs past
it drop.  The ranks of the port's engine hold their data shard's tokens
already (the runner splits the slots over ``data``), so :func:`can_use`
splits a data rank's ``t`` tokens over ``model``: ``t // tp`` is the
reference's ``t // n_dev``.

``quantized=True`` sends an int8 payload (:func:`int8_all_to_all`):
per-row symmetric int8 with scale ``amax / 127``, the scales sent beside
it.  Its backward is the reference's straight-through estimator: the
cotangent takes the reverse ``all_to_all`` at full precision (the
quantization noise is not differentiated).  Every exchange here is
differentiable (``ParallelContext.all_to_all``: its backward is the reverse
exchange), so the expert-parallel path trains on a mesh.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed.context import ParallelContext


def int8_all_to_all(x: torch.Tensor, ctx: ParallelContext) -> torch.Tensor:
    """``all_to_all`` over ``model`` with an int8-quantized payload: per-row
    symmetric int8 (scale over the last dim), then (q, scale) transported
    and dequantized.  x: (tp, ..., d), split over dim 0.  Backward: the
    reverse ``all_to_all`` of the cotangent at full precision."""
    if ctx.axis_size("model") == 1:
        return x
    return _Int8AllToAll.apply(x, ctx)


class _Int8AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, pc):
        fctx.pc = pc
        amax = x.float().abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp(amax, min=1e-20) / 127.0
        q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
        q2 = pc.all_to_all(q, "model")
        s2 = pc.all_to_all(scale, "model")
        return (q2.float() * s2).to(x.dtype)

    @staticmethod
    def backward(fctx, g):
        return fctx.pc.all_to_all(g, "model"), None


def _a2a(x: torch.Tensor, ctx: ParallelContext, quantized: bool) -> torch.Tensor:
    if quantized:
        return int8_all_to_all(x, ctx)
    return ctx.all_to_all(x, "model")


def can_use(ctx: Optional[ParallelContext], t: int, e: int) -> bool:
    """Whether ``t`` tokens of one data shard take the expert-parallel path:
    a model axis of more than one rank, tokens and experts that split over
    it evenly, at least one token per rank."""
    if ctx is None or not ctx.model_axes:
        return False
    tp = ctx.axis_size("model")
    return tp > 1 and t % tp == 0 and e % tp == 0 and (t // tp) > 0


def dispatch(xt: torch.Tensor, idx: torch.Tensor, e: int, c2: int,
             ctx: ParallelContext, quantized: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token dispatch of this rank's tokens.  xt: (T_loc, d); idx: (T_loc,
    K) expert ids.  Returns (buf (E_loc, tp * C2, d) for this rank's
    experts, slots (T_loc, K) int: the slot within (this rank, expert), -1
    where dropped)."""
    tp = ctx.axis_size("model")
    e_loc = e // tp
    t_loc, d = xt.shape
    k = idx.shape[1]
    dev = xt.device
    flat = idx.reshape(-1).long()                                   # (T_loc*K,)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    pos_sorted = torch.arange(t_loc * k, device=dev) - seg_start[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    valid = pos < c2
    send_idx = (flat // e_loc) * (e_loc * c2) + (flat % e_loc) * c2 + pos
    send_idx = torch.where(valid, send_idx, tp * e_loc * c2)        # dump slot
    x_rep = xt.repeat_interleave(k, dim=0)
    send = torch.zeros((tp * e_loc * c2 + 1, d), dtype=xt.dtype, device=dev)
    send = send.index_add_(0, send_idx, x_rep)[:-1]
    recv = _a2a(send.reshape(tp, e_loc, c2, d), ctx, quantized)
    buf = recv.transpose(0, 1).reshape(e_loc, tp * c2, d)
    slots = torch.where(valid, pos, -1).reshape(t_loc, k)
    return buf, slots


def combine(out_buf: torch.Tensor, idx: torch.Tensor, slots: torch.Tensor,
            gates: torch.Tensor, e: int, c2: int, ctx: ParallelContext,
            quantized: bool = False) -> torch.Tensor:
    """Inverse of :func:`dispatch` with gate weighting: out_buf (E_loc, tp *
    C2, d) expert outputs; returns y (T_loc, d) for this rank's tokens."""
    tp = ctx.axis_size("model")
    e_loc = e // tp
    t_loc, k = idx.shape
    d = out_buf.shape[-1]
    back = _a2a(out_buf.reshape(e_loc, tp, c2, d).transpose(0, 1).contiguous(), ctx,
                quantized)                                          # (tp, e_loc, c2, d)
    flatbuf = back.reshape(tp * e_loc * c2, d)
    flat = idx.reshape(-1).long()
    slot = slots.reshape(-1)
    gidx = (flat // e_loc) * (e_loc * c2) + (flat % e_loc) * c2 + slot
    gidx = torch.where(slot >= 0, gidx, 0)
    y_tk = flatbuf[gidx]
    y_tk = torch.where((slot >= 0)[:, None], y_tk, torch.zeros_like(y_tk))
    y_tk = y_tk * gates.reshape(-1, 1).to(y_tk.dtype)
    return y_tk.reshape(t_loc, k, d).sum(dim=1)
