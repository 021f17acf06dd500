"""Activation-sparsity helpers of the zero-skipping paths, in plain PyTorch.

Input zero-skipping (paper §IV-B, figs 7-9) needs the same few reductions
in both of its served forms:

* **block skip** — :func:`block_mask`, one occupancy bit per (row tile,
  K slice) of the input, computed before the launch; the polarized-matmul
  kernel skips the loads and MACs of every dead tile (``zero_skip="block"``);
* **fragment compaction** — :func:`fragment_occupancy` and
  :func:`compact_order` pick the live whole fragments of a batch, and the
  matmul runs on the gathered, smaller operands (``zero_skip="compact"``).

:func:`fragment_live` is the per-fragment NOR gate the bit-serial simulator
also uses, and :class:`SparsityMeter` is the accumulator behind
``engine.stats()["sparsity"]``.  The names mirror
``repro.kernels.sparsity``.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = [
    "block_mask",
    "fragment_live",
    "fragment_occupancy",
    "compact_order",
    "sparsity_counts",
    "SparsityMeter",
]


def block_mask(x: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """int32 ``(M // bm, K // bk)`` mask: 1 where tile (i, k) of ``x`` holds
    any nonzero.  ``x`` must already be padded to whole tiles."""
    M, K = x.shape
    if M % bm or K % bk:
        raise ValueError(
            f"block_mask needs tiled input: got x {tuple(x.shape)} with tiles "
            f"({bm}, {bk}); pad x to multiples first")
    tiles = (x != 0).reshape(M // bm, bm, K // bk, bk)
    return tiles.any(dim=(1, 3)).to(torch.int32)


def fragment_live(xf: torch.Tensor) -> torch.Tensor:
    """Live mask over the fragment axis of an ``(..., F, m)`` view: a
    fragment is live when any of its m inputs is nonzero."""
    return (xf != 0).any(dim=-1)


def fragment_occupancy(x: torch.Tensor, m: int) -> torch.Tensor:
    """bool ``(K // m,)``: True where any row of the (M, K) batch uses the
    fragment (the union the shared weight matrix forces on compaction)."""
    M, K = x.shape
    if K % m:
        raise ValueError(f"K={K} not divisible by fragment size m={m}")
    return (x.reshape(M, K // m, m) != 0).any(dim=(0, 2))


def compact_order(live: torch.Tensor) -> torch.Tensor:
    """Fragment gather order with the live fragments first, in their own
    order (a stable sort of ``~live``); dead fragments pad the tail."""
    return torch.sort((~live).to(torch.uint8), stable=True).indices


def sparsity_counts(x: torch.Tensor, m: int) -> torch.Tensor:
    """int64 ``[zero_elems, elems, dead_frags, frags]`` of one call's input.

    Counted in int64 on the input's device: the reference's float32
    counters stop being exact past 2^24 elements, and nothing here leaves
    the device (the sizes are filled in by device ops, not copied over).
    """
    x2 = x.reshape(-1, x.shape[-1])
    K = x2.shape[-1]
    zero = (x2 == 0).sum()
    elems = torch.full_like(zero, x2.numel())
    if K % m == 0:
        live = fragment_live(x2.reshape(x2.shape[0], K // m, m))
        dead = (~live).sum()
        frags = torch.full_like(zero, live.numel())
    else:  # odd geometry: no fragment view, element stats only
        dead = frags = torch.zeros_like(zero)
    return torch.stack([zero, elems, dead, frags])


class SparsityMeter:
    """Per-tag accumulator of :func:`sparsity_counts` vectors.

    The reference ships each call's counters to the host through a debug
    callback.  Here each tag owns an int64 counters vector on the device
    that every call adds into, and the call count is kept on the host, so
    recording adds one device op per matmul and no host round trip; only
    :meth:`summary` reads the device.
    """

    def __init__(self) -> None:
        self._acc: Dict[str, torch.Tensor] = {}
        self._calls: Dict[str, int] = {}

    def record(self, tag: str, counts: torch.Tensor) -> None:
        """Add one call's ``[zero, elems, dead, frags]`` counters."""
        prev = self._acc.get(tag)
        counts = counts.to(torch.int64)
        self._acc[tag] = counts.clone() if prev is None else prev.add_(counts)
        self._calls[tag] = self._calls.get(tag, 0) + 1

    def reset(self) -> None:
        self._acc.clear()
        self._calls.clear()

    def summary(self) -> dict:
        """``{"layers": {tag: {...}}, "overall": {...}}`` with
        ``elem_sparsity`` (zero input elements), ``fragment_sparsity``
        (dead m-fragments, the skippable share) and ``calls``."""
        def entry(zero, elems, dead, frags, calls):
            return {"elem_sparsity": zero / elems if elems else 0.0,
                    "fragment_sparsity": dead / frags if frags else 0.0,
                    "calls": int(calls)}

        layers = {}
        tot = [0, 0, 0, 0, 0]
        for tag in sorted(self._acc):
            c = [int(v) for v in self._acc[tag].cpu().tolist()] + [self._calls[tag]]
            layers[tag] = entry(*c)
            tot = [a + b for a, b in zip(tot, c)]
        return {"layers": layers, "overall": entry(*tot)}
