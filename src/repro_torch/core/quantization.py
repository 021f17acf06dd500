"""ReRAM-customized weight quantization (paper §III-C).

Only magnitude bits live on the crossbar (signs are in the fragment sign
indicator), so the grid is a symmetric magnitude grid ``w = s * delta * q``
with integer ``q in [0, 2^bits - 1]``.  ``torch.round`` rounds half to even,
as ``jnp.round`` does, so codes agree bit for bit with the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Quantization grid description.

    Attributes:
      bits: magnitude bits per weight (paper default 8).
      cell_bits: bits per ReRAM cell (paper default 2).
      per_channel: if True scale per output column (axis=1), else per-tensor.
    """

    bits: int = 8
    cell_bits: int = 2
    per_channel: bool = True

    def __post_init__(self):
        if self.cell_bits < 1:
            raise ValueError(f"cell_bits must be >= 1, got {self.cell_bits}")
        if self.bits < 1 or self.bits > 16:
            raise ValueError(
                f"magnitude bits must be in [1, 16], got {self.bits} — the "
                f"crossbar stores uint8 codes up to 8 bits and int32 codes "
                f"above (16 is the serving ceiling; the paper uses 8)")
        if self.bits % self.cell_bits != 0:
            valid = [b for b in range(self.cell_bits, 17, self.cell_bits)]
            raise ValueError(
                f"bits ({self.bits}) must be a multiple of cell_bits "
                f"({self.cell_bits}) to fully utilize ReRAM cell resolution "
                f"(paper §III-C); valid bit-widths at cell_bits="
                f"{self.cell_bits}: {valid}")

    @property
    def levels(self) -> int:
        return (1 << self.bits) - 1  # max magnitude code


def scale_for(mat: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Max-abs calibration scale: largest code maps to the largest magnitude."""
    if spec.per_channel:
        amax = mat.abs().amax(dim=0, keepdim=True)  # (1, N)
    else:
        amax = mat.abs().amax()
    return torch.clamp(amax, min=1e-12) / spec.levels


def quantize_codes(mat: torch.Tensor, spec: QuantSpec,
                   scale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed integer codes in [-levels, levels] and the scale used."""
    if scale is None:
        scale = scale_for(mat, spec)
    q = torch.clamp(torch.round(mat / scale), -spec.levels, spec.levels)
    return q, scale
