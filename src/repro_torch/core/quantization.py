"""ReRAM-customized weight quantization (paper §III-C) and cell bit-slicing.

Only magnitude bits live on the crossbar (signs are in the fragment sign
indicator), so the grid is a symmetric magnitude grid ``w = s * delta * q``
with integer ``q in [0, 2^bits - 1]``.  ``torch.round`` rounds half to even,
as ``jnp.round`` does, so codes agree bit for bit with the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

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

    @property
    def cells_per_weight(self) -> int:
        return self.bits // self.cell_bits


def scale_for(mat: torch.Tensor, spec: QuantSpec,
              amax_reduce: Optional[Callable[[torch.Tensor, bool], torch.Tensor]] = None
              ) -> torch.Tensor:
    """Max-abs calibration scale: largest code maps to the largest magnitude.

    Per output column ``(1, N)`` or per tensor (a scalar); a stack of
    matrices ``(L, K, N)`` gets one scale per layer, ``(L, 1, N)`` or
    ``(L, 1, 1)``.  ``amax_reduce(amax, per_channel)`` completes the max
    of a matrix held in shards (a mesh: over the ranks that split K, and N
    too for a per-tensor scale) before the scale is formed.
    """
    if spec.per_channel:
        amax = mat.abs().amax(dim=-2, keepdim=True)  # (1, N)
    elif mat.ndim > 2:
        amax = mat.abs().amax(dim=(-2, -1), keepdim=True)
    else:
        amax = mat.abs().amax()
    if amax_reduce is not None:
        amax = amax_reduce(amax, spec.per_channel)
    return torch.clamp(amax, min=1e-12) / spec.levels


def quantize_codes(mat: torch.Tensor, spec: QuantSpec,
                   scale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed integer codes in [-levels, levels] and the scale used."""
    if scale is None:
        scale = scale_for(mat, spec)
    q = (mat / scale).round_().clamp_(-spec.levels, spec.levels)
    return q, scale


def project_quantize(mat: torch.Tensor, spec: QuantSpec,
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Euclidean projection onto the quantization grid Q (round to nearest).

    ``mat / scale`` stays a division, as in the reference: multiplying by a
    reciprocal rounds differently and moves codes sitting on a half step.
    """
    q, scale = quantize_codes(mat, spec, scale)
    return q * scale


def quantization_error(mat: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Relative L2 error of projecting onto Q."""
    pq = project_quantize(mat, spec)
    return torch.linalg.norm(mat - pq) / torch.clamp(torch.linalg.norm(mat), min=1e-12)


def is_on_grid(mat: torch.Tensor, spec: QuantSpec, scale: torch.Tensor,
               atol: float = 1e-5) -> torch.Tensor:
    """Boolean: every entry sits on the quantization grid (up to atol)."""
    q = torch.round(mat / scale)
    ok_range = torch.all(q.abs() <= spec.levels)
    ok_grid = torch.all((q * scale - mat).abs() <= atol * torch.clamp(mat.abs(), min=1.0))
    return ok_range & ok_grid


# ---------------------------------------------------------------------------
# Cell bit-slicing and bit-serial inputs (paper §III-C, §IV-A/B).
# ---------------------------------------------------------------------------

def slice_to_cells(mag_codes: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """``(cells, K, N)`` int32 planes of ``(K, N)`` magnitude codes, plane
    ``c`` holding bits ``[c*cell_bits, (c+1)*cell_bits)`` (least significant
    plane first): ``sum_c plane_c * 2**(c*cell_bits) == codes``."""
    codes = mag_codes.to(torch.int32)
    mask = (1 << spec.cell_bits) - 1
    return torch.stack([(codes >> (c * spec.cell_bits)) & mask
                        for c in range(spec.cells_per_weight)])


def cells_to_codes(planes: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Inverse of :func:`slice_to_cells`."""
    weights = [1 << (spec.cell_bits * c) for c in range(planes.shape[0])]
    return sum(w * p.to(torch.int32) for w, p in zip(weights, planes))


def input_bit_planes(x_codes: torch.Tensor, input_bits: int) -> torch.Tensor:
    """``(input_bits, ..., K)`` 0/1 int32 planes of unsigned activation
    codes, least significant first: the bit-serial DAC stream (§IV-B)."""
    x = x_codes.to(torch.int32)
    return torch.stack([(x >> b) & 1 for b in range(input_bits)])


def quantize_activations(x: torch.Tensor, input_bits: int = 16,
                         scale: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned activation codes (post-ReLU activations are >= 0), as f32
    values in [0, 2^input_bits - 1], and the scale; FORMS streams 16-bit
    activations bit-serially."""
    levels = (1 << input_bits) - 1
    if scale is None:
        scale = torch.clamp(x.abs().amax(), min=1e-12) / levels
    codes = torch.clamp(torch.round(torch.clamp(x, min=0.0) / scale), 0, levels)
    return codes, scale
