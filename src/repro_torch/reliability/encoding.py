"""Cell-level encodings of the FORMS magnitude codes, host numpy.

A ``bits``-bit magnitude code occupies ``bits / cell_bits`` ReRAM cells,
one per bit-slice plane, each programmed to a conductance level in
``[0, 2^cell_bits)``.  This module slices codes into those levels and reads
(possibly analog) levels back, under the two readout disciplines the fault
injector (``reliability/faults.py``) simulates:

* ``binary``: the plain radix-``2^cell_bits`` readout: the periphery reads
  each cell's conductance, subtracts the nominal HRS floor and reassembles
  the code, so conductance variation and retention drift land directly in
  the read levels.
* ``vecom``: VECOM-style offset compensation (Jang et al.,
  arXiv:2312.11042): every physical bitline carries :data:`N_REF` extra
  reference cells programmed to the full-scale level, and the readout
  divides the bitline's common multiplicative error, estimated from them,
  out of every cell before reassembling codes.  At zero noise the estimate
  is exactly 1, so the round trip is exact.

The stored uint8 codes are the same under both encodings: ``encoding`` is
metadata on :class:`~repro_torch.forms.linear.FormsLinearParams` (set from
``FormsSpec.encoding``) that selects the periphery model.  This is the JAX
package's ``reliability/encoding.py`` (numpy there too), function for
function.
"""
from __future__ import annotations

import numpy as np

from repro_torch.forms.spec import VALID_ENCODINGS, FormsSpec

__all__ = ["N_REF", "VALID_ENCODINGS", "assemble_codes", "column_gain",
           "max_level", "num_planes", "radix_read", "slice_codes"]

# Reference cells per physical bitline (vecom encoding).  More references
# average down the estimate's own cell noise (variance ~ 1/N_REF).
N_REF = 4


def num_planes(spec: FormsSpec) -> int:
    """Cells per weight: one bit-slice plane per cell."""
    return spec.quant.cells_per_weight


def max_level(spec: FormsSpec) -> int:
    """Largest programmable conductance level of one cell."""
    return (1 << spec.cell_bits) - 1


def slice_codes(codes: np.ndarray, spec: FormsSpec) -> np.ndarray:
    """Magnitude codes ``(..., Kp, N)`` -> cell levels ``(C, ..., Kp, N)``,
    the least significant plane first."""
    codes = np.asarray(codes).astype(np.int64)
    mask = max_level(spec)
    return np.stack([(codes >> (c * spec.cell_bits)) & mask
                     for c in range(num_planes(spec))], axis=0)


def assemble_codes(levels: np.ndarray, spec: FormsSpec) -> np.ndarray:
    """Read (possibly analog) cell levels ``(C, ..., Kp, N)`` back into
    clipped integer codes: each plane clipped to its programmable range
    (the sense amplifier saturates), the radix sum, and the ADC's rounding
    onto the ``spec.bits`` code grid.  The exact inverse of
    :func:`slice_codes` on integer levels in range."""
    return radix_read(np.clip(levels, 0.0, float(max_level(spec))), spec)


def radix_read(clipped: np.ndarray, spec: FormsSpec) -> np.ndarray:
    """:func:`assemble_codes` on levels already clipped to their range: the
    radix sum and the ADC's rounding (the fault injector clips in place)."""
    weights = (1 << (spec.cell_bits
                     * np.arange(num_planes(spec), dtype=np.int64)))
    mag = np.tensordot(weights.astype(np.float64), clipped, axes=1)
    code = np.clip(np.rint(mag), 0, spec.quant.levels)
    return code.astype(np.uint8 if spec.bits <= 8 else np.int32)


def column_gain(g_ref: np.ndarray, g_nominal: float) -> np.ndarray:
    """VECOM's estimate of a bitline's common gain error: the geometric
    mean over the ``N_REF`` leading axis of ``g_ref / g_nominal`` (the
    errors are lognormal), exactly 1 for uncorrupted references."""
    ratio = np.maximum(np.asarray(g_ref, np.float64) / g_nominal, 1e-9)
    return np.exp(np.mean(np.log(ratio), axis=0))
