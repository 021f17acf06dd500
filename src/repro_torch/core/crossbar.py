"""Crossbar mapping scheme and crossbar-count accounting (paper §IV-A, Fig 5).

Physical crossbar arrays are ``(q*m) x (p*n)`` cells (e.g. 128 x 128),
partitioned into ``q x p`` logical sub-arrays of ``m x n``.  A weight matrix
``(K, N)`` quantized to ``bits`` magnitude bits with ``cell_bits`` per cell
occupies, per weight, ``cells_per_weight = bits / cell_bits`` adjacent cells
in a row, so a crossbar holds ``rows = q*m`` weights vertically and
``(p*n) / cells_per_weight`` weight-columns horizontally.

The port's copy of the JAX package's module, on the port's ``FragmentSpec``
and ``QuantSpec``: plain arithmetic, equal number for number.

Crossbar-reduction accounting mirrors the paper's Tables I/II: the baseline is
the *unpruned fp32* model mapped with the splitting scheme (two crossbars for
+/- weights, 16-bit weights); FORMS maps the pruned model, quantized, with a
single polarized crossbar (+ a 1R sign indicator per fragment, which is not a
crossbar).  Reduction multiplies three factors: pruning x quantization x 2
(polarization halves crossbar count vs +/- splitting).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.core.fragments import FragmentSpec
from repro_torch.core.quantization import QuantSpec


@dataclasses.dataclass(frozen=True)
class CrossbarSpec:
    """Physical crossbar geometry."""

    rows: int = 128
    cols: int = 128

    def subarrays(self, frag: FragmentSpec) -> Tuple[int, int]:
        """(q, p): logical sub-array grid per crossbar."""
        return self.rows // frag.m, max(1, self.cols // frag.n_sub_cols)


def crossbars_for_matrix(shape: Tuple[int, int], xbar: CrossbarSpec,
                         quant: QuantSpec, signed_split: bool = False,
                         weight_bits: int | None = None) -> int:
    """Number of physical crossbars needed to hold one weight matrix.

    ``signed_split=True`` models the PRIME-style baseline that doubles
    crossbars for +/- weights.  ``weight_bits`` overrides ``quant.bits``
    (e.g. 16-bit baseline before FORMS quantization).
    """
    k, n = shape
    bits = weight_bits if weight_bits is not None else quant.bits
    cells_per_weight = -(-bits // quant.cell_bits)
    cols_per_xbar = max(1, xbar.cols // cells_per_weight)
    vertical = -(-k // xbar.rows)
    horizontal = -(-n // cols_per_xbar)
    count = vertical * horizontal
    return count * (2 if signed_split else 1)


def model_crossbars(shapes: List[Tuple[int, int]], xbar: CrossbarSpec,
                    quant: QuantSpec, signed_split: bool = False,
                    weight_bits: int | None = None) -> int:
    return sum(crossbars_for_matrix(s, xbar, quant, signed_split, weight_bits)
               for s in shapes)


@dataclasses.dataclass
class ReductionReport:
    """Crossbar-reduction factorization as presented in Tables I/II."""

    baseline_crossbars: int
    pruned_crossbars: int
    final_crossbars: int
    prune_factor: float
    quant_factor: float
    polarization_factor: float

    @property
    def total(self) -> float:
        return self.baseline_crossbars / max(self.final_crossbars, 1)


def reduction_report(
    dense_shapes: List[Tuple[int, int]],
    pruned_shapes: List[Tuple[int, int]],
    xbar: CrossbarSpec,
    quant: QuantSpec,
    baseline_bits: int = 16,
) -> ReductionReport:
    """Crossbar reduction of FORMS vs the signed-splitting fp/16-bit baseline.

    * baseline: unpruned, ``baseline_bits``-bit weights, two crossbars for
      +/- (splitting scheme of the paper's baseline mapping [41]);
    * pruned:   pruned shapes, still baseline bits + splitting;
    * final:    pruned shapes, FORMS-quantized bits, single crossbar
      (polarized) — sign indicator is 1R-per-fragment, not a crossbar.
    """
    base = model_crossbars(dense_shapes, xbar, quant, signed_split=True,
                           weight_bits=baseline_bits)
    pruned = model_crossbars(pruned_shapes, xbar, quant, signed_split=True,
                             weight_bits=baseline_bits)
    final = model_crossbars(pruned_shapes, xbar, quant, signed_split=False)
    prune_factor = base / max(pruned, 1)
    # quantization shrinks cells per weight
    quant_factor = baseline_bits / quant.bits
    return ReductionReport(
        baseline_crossbars=base,
        pruned_crossbars=pruned,
        final_crossbars=final,
        prune_factor=prune_factor,
        quant_factor=quant_factor,
        polarization_factor=2.0,
    )


def sign_indicator_bits(shape: Tuple[int, int], frag: FragmentSpec) -> int:
    """Bits of 1R sign-indicator storage for a matrix (1 bit per fragment)."""
    k, n = shape
    return frag.num_fragments(k) * n
