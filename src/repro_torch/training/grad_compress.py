"""Gradient compression with error feedback.

The compressors change what a gradient all-reduce would carry: a bf16 cast
(half the bytes) or stochastic-rounding int8 with a per-tensor scale (a
quarter), with the rounding residual carried into the next step (error
feedback keeps the scheme unbiased in the long run).  As in the
reference, compression applies to the gradients after their reduction; on
one card the step sees the same rounded gradients as on many.

``none``, ``bf16`` and ``bf16_ef`` equal the reference's exactly.
``int8_ef`` draws its rounding noise from a ``torch.Generator`` (on the
gradients' device), so its draws are not ``jax.random``'s; it keeps the
same invariants (the residual is exactly what rounding lost, the rounding is
unbiased).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.paths import tree_map
from repro_torch.distributed.context import current_context, local_slice, set_shard, shard_of

Params = Any
MODES = ("none", "bf16", "bf16_ef", "int8_ef")


def init_error_state(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compress_bf16(grads: Params) -> Params:
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def decompress(grads: Params) -> Params:
    return tree_map(lambda g: g.float(), grads)


def compress_bf16_ef(grads: Params, err: Params) -> Tuple[Params, Params]:
    """bf16 with error feedback: g' = bf16(g + e); e' = (g + e) - g'."""
    corrected = tree_map(lambda g, e: g.float() + e, grads, err)
    q = compress_bf16(corrected)
    return q, tree_map(lambda c, qq: c - qq.float(), corrected, q)


def compress_int8_ef(grads: Params, err: Params, generator: torch.Generator,
                     like: Optional[Params] = None) -> Tuple[Params, Params, Params]:
    """Stochastic-rounding int8 with a per-tensor scale and error feedback.

    Returns (int8 grads, scales, new_err).  The noise is uniform in
    [-0.5, 0.5), drawn leaf by leaf in the tree's order.  On a mesh
    ``like`` (the params) gives each leaf's layout: the tensor's max is
    max-reduced over its shard axes, and every rank draws the whole leaf's
    noise (the generators of all ranks stay in step) and keeps its own
    slice, so the codes are the one-device step's.
    """
    ctx = current_context()

    def one(g, e, p=None):
        sh = shard_of(p) if p is not None and ctx is not None else None
        corrected = g.float() + e
        amax = corrected.abs().amax()
        if sh is not None:
            amax = ctx.reduce_over(amax, sh.axes(), "max")
        scale = torch.clamp(amax, min=1e-12) / 127.0
        scaled = corrected / scale
        shape = sh.shape if sh is not None else scaled.shape
        noise = torch.rand(shape, generator=generator, device=scaled.device) - 0.5
        if sh is not None:
            noise = local_slice(noise, sh.spec, ctx)
        q = (scaled + noise).round_().clamp_(-127, 127).to(torch.int8)
        deq = q.float() * scale
        return q, scale, corrected - deq

    triples = tree_map(one, grads, err) if like is None else tree_map(one, grads, err, like)
    return tuple(tree_map(lambda t: t[i], triples) for i in range(3))


def decompress_int8(q: Params, scales: Params) -> Params:
    return tree_map(lambda g, s: g.float() * s, q, scales)


def apply_compression(grads: Params, mode: str, err: Optional[Params],
                      generator: Optional[torch.Generator] = None,
                      like: Optional[Params] = None) -> Tuple[Params, Optional[Params]]:
    """Dispatch on TrainConfig.grad_compression; returns (grads_f32, new_err).
    On a mesh it takes the reduced gradients' shards (``like``: the params,
    which carry the layouts)."""
    if mode == "none":
        return grads, err
    if mode == "bf16":
        return decompress(compress_bf16(grads)), err
    if mode == "bf16_ef":
        q, new_err = compress_bf16_ef(grads, err)
        return decompress(q), _marked(new_err, like)
    if mode == "int8_ef":
        q, scales, new_err = compress_int8_ef(grads, err, generator, like)
        return decompress_int8(q, scales), _marked(new_err, like)
    raise ValueError(f"unknown grad compression {mode!r}; one of {MODES}")


def _marked(err: Params, like: Optional[Params]) -> Params:
    """The error buffer's shards marked with their params' layouts."""
    if like is None:
        return err
    return tree_map(lambda e, p: set_shard(e, shard_of(p)), err, like)
