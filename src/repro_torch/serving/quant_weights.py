"""Low-bit int-grid weight storage for serving: ``{"q": int8, "s": f32}``.

Each weight becomes a signed per-output-column symmetric grid of ``bits``
(2 to 8) in an int8 container times a per-column f32 scale.  The
speculative draft's ``mode="int"`` (``serving/speculate.py``) is built
here; ``models.layers.wload`` dequantizes such a leaf on read, and the
product is a plain ``torch.matmul``, as in the reference, whose int path
runs outside any Pallas kernel.  ``torch.round`` rounds half to even like
``jnp.round``, so ``q`` and ``s`` are the reference's bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.paths import map_in_order

QUANT_SUFFIXES = ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                  "mlp/gate", "mlp/up", "mlp/down",
                  # MLA projections (deepseek) — scan-stacked (L, in, out)
                  "mla/q_down", "mla/q_up", "mla/kv_down", "mla/kv_up",
                  "mla/wo",
                  # shared experts — scan-stacked (L, in, out)
                  "moe/shared_gate", "moe/shared_up", "moe/shared_down")

# stacked per-expert weights (L, E, in, out): one scale row per (layer,
# expert) column; the router stays full precision
EXPERT_SUFFIXES = ("moe/w_gate", "moe/w_up", "moe/w_down")


def quantize_leaf(w: torch.Tensor, bits: int = 8,
                  batch_dims: Optional[int] = None) -> dict:
    """Per-output-column symmetric signed quantization at ``bits``.

    The grid is ``[-(2^(bits-1)-1), 2^(bits-1)-1]`` in an int8 container;
    the last axis is the output-column axis.  ``batch_dims`` counts the
    leading axes that index independent matrices (the amax runs over every
    axis between them and the column axis); by default 1 for a
    scan-stacked (L, K, N) leaf, ``ndim - 4`` for conv-shaped
    ``(..., kh, kw, cin, cout)`` kernels and 0 for a (K, N) matrix.
    Stacked-expert ``(L, E, din, dout)`` leaves need ``batch_dims=2``.
    """
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    if batch_dims is None:
        batch_dims = 1 if w.ndim == 3 else max(0, w.ndim - 4)
    if not 0 <= batch_dims <= w.ndim - 2:
        raise ValueError(f"batch_dims={batch_dims} out of range for a "
                         f"rank-{w.ndim} leaf")
    qmax = float(2 ** (bits - 1) - 1)
    wf = w.float()
    axes = tuple(range(batch_dims, w.ndim - 1))
    amax = torch.amax(torch.abs(wf), dim=axes, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / qmax
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    return {"q": q, "s": scale.float()}


def dequantize_leaf(v: dict, dtype: torch.dtype) -> torch.Tensor:
    return v["q"].to(dtype) * v["s"].to(dtype)


def quantize_tree(params: Any, bits: int = 8, *,
                  load: Optional[Callable[[Tuple, Any], Any]] = None,
                  store: Optional[Callable[[Tuple, Any], Any]] = None
                  ) -> Tuple[Any, int, int]:
    """Quantize the matching weights of a tree of dicts and lists, as the
    reference's ``tree_flatten`` walks it; returns ``(tree,
    bytes_before, bytes_after)``.  ``bytes_after`` counts the int8
    container as stored: a 4-bit grid does not halve it.  ``load`` and
    ``store`` wrap each leaf in turn (:func:`~repro_torch.core.paths.
    map_in_order`)."""
    acc = [0, 0]

    def one(pstr, tree):
        if not (isinstance(tree, torch.Tensor) and tree.ndim >= 2):
            return tree
        if any(pstr.endswith(sfx) for sfx in EXPERT_SUFFIXES):
            batch_dims = tree.ndim - 2
        elif any(pstr.endswith(sfx) for sfx in QUANT_SUFFIXES):
            batch_dims = None
        else:
            return tree
        v = quantize_leaf(tree, bits=bits, batch_dims=batch_dims)
        acc[0] += tree.numel() * tree.element_size()
        acc[1] += v["q"].numel() + v["s"].numel() * 4
        return v

    return map_in_order(one, params, load=load, store=store), acc[0], acc[1]
