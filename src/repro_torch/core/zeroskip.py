"""Input zero-skipping: Effective Input Cycles (paper §IV-B, figs 7-9).

* **effective bits** of one input = ``input_bits`` less its run of most
  significant zero bits — the bits that reach the output;
* **EIC of a fragment** = the most effective bits over its ``m`` inputs =
  the bit-serial cycles the fragment needs before its remaining planes are
  all zero (the skip circuit of fig 9 stops there).

This module is the analytic side: exact EIC statistics of real activation
codes, the cycle counts they give, and the speedup model.  The bit-serial
crossbar kernel (``kernels/bitserial_crossbar``) reports the same EIC per
(row, fragment).  The names mirror ``repro.core.zeroskip``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def effective_bits(codes: torch.Tensor, input_bits: int) -> torch.Tensor:
    """Effective bit count per input code (0 for code 0), int32.

    The code's two's-complement bits are masked to the ``input_bits``
    streamed planes, the highest set bit is smeared into every lower plane
    and the bits are counted — ``floor(log2(x)) + 1`` for a code in range,
    and the reference's value for bits at or above ``input_bits`` and for
    negative codes.  Computed in int64, where the 32-bit patterns fit.
    """
    if not 1 <= input_bits <= 32:
        raise ValueError(f"input_bits={input_bits} must be in [1, 32]")
    mask = 0xFFFFFFFF if input_bits == 32 else (1 << input_bits) - 1
    c = codes.to(torch.int64) & mask
    for s in (1, 2, 4, 8, 16):
        c = c | (c >> s)
    c = c - ((c >> 1) & _M1)                       # popcount of 32 bits
    c = (c & _M2) + ((c >> 2) & _M2)
    c = (c + (c >> 4)) & _M4
    c = (c * 0x01010101) & 0xFFFFFFFF
    return (c >> 24).to(torch.int32)


def fragment_eic(codes: torch.Tensor, m: int, input_bits: int) -> torch.Tensor:
    """``(..., F)`` int32 EIC per fragment of ``(..., K)`` activation codes;
    K is padded to a multiple of m with zeros (a zero never extends EIC)."""
    eb = effective_bits(codes, input_bits)
    k = eb.shape[-1]
    pad = (-k) % m
    if pad:
        eb = torch.nn.functional.pad(eb, (0, pad))
    return eb.reshape(*eb.shape[:-1], (k + pad) // m, m).amax(dim=-1)


@dataclasses.dataclass
class EICStats:
    """Aggregate EIC statistics for one layer / activation population."""

    mean_eic: float          # average cycles per fragment (paper fig 8b)
    input_bits: int
    histogram: np.ndarray    # (input_bits + 1,) fraction of fragments per EIC value

    @property
    def cycle_fraction(self) -> float:
        """Share of the worst-case cycles actually needed (= mean / bits)."""
        return self.mean_eic / self.input_bits

    @property
    def savings(self) -> float:
        """Share of cycles skipped (paper: 33% at m=4, 6% at m=128)."""
        return 1.0 - self.cycle_fraction


def eic_stats(codes: torch.Tensor, m: int, input_bits: int) -> EICStats:
    """:class:`EICStats` over all fragments of a code tensor."""
    eic = fragment_eic(codes, m, input_bits).reshape(-1).cpu().numpy()
    hist = np.bincount(eic, minlength=input_bits + 1).astype(np.float64)
    hist /= max(hist.sum(), 1.0)
    return EICStats(mean_eic=float(eic.mean()), input_bits=input_bits, histogram=hist)


def layer_cycles(codes: torch.Tensor, m: int, input_bits: int,
                 zero_skip: bool = True) -> np.int64:
    """Total bit-serial input cycles to stream a batch of inputs: each
    fragment pays its EIC with zero-skipping, ``input_bits`` without.
    Summed in int64 on the host, which no layer overflows."""
    eic = fragment_eic(codes, m, input_bits)
    if not zero_skip:
        eic = torch.full_like(eic, input_bits)
    return np.sum(eic.cpu().numpy(), dtype=np.int64)


def speedup_from_skipping(stats: EICStats) -> float:
    """Cycle-limited speedup of zero-skipping over streaming every bit."""
    return stats.input_bits / max(stats.mean_eic, 1e-9)
