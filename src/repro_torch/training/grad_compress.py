"""Gradient compression with error feedback.

The compressors change what a gradient all-reduce would carry: a bf16 cast
(half the bytes) or stochastic-rounding int8 with a per-tensor scale (a
quarter), with the rounding residual carried into the next step (error
feedback keeps the scheme unbiased in the long run).  On one card there is
no all-reduce; the step sees the same rounded gradients as on many.

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


def compress_int8_ef(grads: Params, err: Params, generator: torch.Generator
                     ) -> Tuple[Params, Params, Params]:
    """Stochastic-rounding int8 with a per-tensor scale and error feedback.

    Returns (int8 grads, scales, new_err).  The noise is uniform in
    [-0.5, 0.5), drawn leaf by leaf in the tree's order.
    """
    def one(g, e):
        corrected = g.float() + e
        scale = torch.clamp(corrected.abs().amax(), min=1e-12) / 127.0
        scaled = corrected / scale
        noise = torch.rand(scaled.shape, generator=generator, device=scaled.device) - 0.5
        q = (scaled + noise).round_().clamp_(-127, 127).to(torch.int8)
        deq = q.float() * scale
        return q, scale, corrected - deq

    triples = tree_map(one, grads, err)
    return tuple(tree_map(lambda t: t[i], triples) for i in range(3))


def decompress_int8(q: Params, scales: Params) -> Params:
    return tree_map(lambda g, s: g.float() * s, q, scales)


def apply_compression(grads: Params, mode: str, err: Optional[Params],
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[Params, Optional[Params]]:
    """Dispatch on TrainConfig.grad_compression; returns (grads_f32, new_err)."""
    if mode == "none":
        return grads, err
    if mode == "bf16":
        return decompress(compress_bf16(grads)), err
    if mode == "bf16_ef":
        q, new_err = compress_bf16_ef(grads, err)
        return decompress(q), new_err
    if mode == "int8_ef":
        q, scales, new_err = compress_int8_ef(grads, err, generator)
        return decompress_int8(q, scales), new_err
    raise ValueError(f"unknown grad compression {mode!r}; one of {MODES}")
