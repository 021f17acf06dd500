"""FormsSpec: the single compression descriptor of the FORMS pipeline.

The same fields and validation as the JAX package's ``FormsSpec``, less
``prefer_ref``: in the port the device of the tensors alone picks the CUDA
kernel (a CUDA tensor) or its plain PyTorch version (a CPU tensor).
``bm/bn/bk`` stay as fields so specs carry over one to one; the CUDA kernel
picks its own tiles.  :func:`spec_from_meta` rebuilds a spec from the
fields a checkpoint stores (``dataclasses.asdict(spec)`` of either
package's spec).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.fragments import FragmentSpec
from repro_torch.core.quantization import QuantSpec
from repro_torch.kernels.ops import VALID_ZERO_SKIP

VALID_RULES = ("sum", "energy")
VALID_ENCODINGS = ("binary", "vecom")


@dataclasses.dataclass(frozen=True)
class FormsSpec:
    """Static description of one FORMS compression configuration.

    Fragment geometry (paper §III-B): ``m``, ``policy``, ``n_sub_cols``.
    Quantization grid (paper §III-C): ``bits``, ``cell_bits``,
    ``per_channel``.  Polarization: ``rule`` ("sum" or "energy").
    Bit-serial simulation: ``input_bits``, ``adc_bits``.  Reliability:
    ``encoding``.  Zero-skipping: ``zero_skip``, ``zero_skip_keep``.
    Tiling hints: ``bm``, ``bn``, ``bk``, ``sim_bm``, ``sim_bn``.
    """

    m: int = 8
    policy: str = "W"
    n_sub_cols: int = 128

    bits: int = 8
    cell_bits: int = 2
    per_channel: bool = True

    rule: str = "energy"

    input_bits: int = 16
    adc_bits: Optional[int] = None

    encoding: str = "binary"

    zero_skip: str = "off"
    zero_skip_keep: float = 0.5

    bm: int = 128
    bn: int = 128
    bk: int = 512
    sim_bm: int = 32
    sim_bn: int = 128

    def __post_init__(self):
        try:
            _ = self.fragment
        except ValueError as e:
            raise ValueError(
                f"invalid fragment geometry m={self.m}, "
                f"policy={self.policy!r}, n_sub_cols={self.n_sub_cols}: {e}"
            ) from e
        try:
            _ = self.quant
        except ValueError as e:
            raise ValueError(
                f"unsupported bit-width bits={self.bits} at cell_bits="
                f"{self.cell_bits} (fragment m={self.m}): {e}. "
                f"Mixed-precision plans must pick per-leaf bits from the "
                f"cell-aligned ladder (e.g. 2/4/6/8 at 2-bit cells)."
            ) from e
        if self.rule not in VALID_RULES:
            raise ValueError(
                f"sign rule must be one of {VALID_RULES}, got {self.rule!r}")
        if self.encoding not in VALID_ENCODINGS:
            raise ValueError(
                f"cell encoding must be one of {VALID_ENCODINGS}, "
                f"got {self.encoding!r}")
        if self.zero_skip not in VALID_ZERO_SKIP:
            raise ValueError(
                f"zero_skip must be one of {VALID_ZERO_SKIP}, "
                f"got {self.zero_skip!r}")
        if not 0.0 < self.zero_skip_keep <= 1.0:
            raise ValueError(
                f"zero_skip_keep is a fragment-budget fraction in (0, 1], "
                f"got {self.zero_skip_keep}")
        if self.input_bits < 1:
            raise ValueError(f"input_bits must be >= 1, got {self.input_bits}")
        if self.adc_bits is not None and self.adc_bits < 1:
            raise ValueError(f"adc_bits must be >= 1 or None, got {self.adc_bits}")
        for name in ("bm", "bn", "bk", "sim_bm", "sim_bn"):
            if getattr(self, name) < 1:
                raise ValueError(f"tile size {name} must be >= 1, "
                                 f"got {getattr(self, name)}")

    @property
    def fragment(self) -> FragmentSpec:
        return FragmentSpec(m=self.m, policy=self.policy,
                            n_sub_cols=self.n_sub_cols)

    @property
    def quant(self) -> QuantSpec:
        return QuantSpec(bits=self.bits, cell_bits=self.cell_bits,
                         per_channel=self.per_channel)



def spec_from_meta(fields: dict) -> FormsSpec:
    """A :class:`FormsSpec` from ``dataclasses.asdict`` of a spec, as a
    checkpoint's ``extra`` meta holds it.  The reference's ``prefer_ref``
    is dropped when it is None or False (the route follows the tensors'
    device here); any other value is refused."""
    fields = dict(fields)
    prefer_ref = fields.pop("prefer_ref", None)
    if prefer_ref not in (None, False):
        raise ValueError(f"prefer_ref={prefer_ref!r}: the port has no switch to the plain "
                         f"version; a CUDA tensor runs its kernel, a CPU tensor the plain "
                         f"version")
    return FormsSpec(**fields)
