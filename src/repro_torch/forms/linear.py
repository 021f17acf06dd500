"""FormsLinear: the paper's compressed weight representation.

A FORMS-compressed linear layer stores, per weight matrix:

* ``mags``  (Kp, N) uint8  — magnitude codes (int32 when ``bits > 8``);
* ``signs`` (Kp/m, N) int8 — fragment signs (the 1R sign indicator);
* ``scale`` (1, N) f32     — dequantization scale.

``from_dense`` projects a float matrix onto the polarized set P and the
magnitude grid Q and returns the codes; ``apply`` runs the MVM through
``kernels/ops.polarized_matmul`` (the CUDA kernel on the card, its plain
version on the CPU).  Scan-stacked ``(L, K, N)`` weights keep their leading
layer axis on every tensor.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Tuple

import torch

from repro_torch.core import polarization as polmod
from repro_torch.core import quantization as quantmod
from repro_torch.core.fragments import matrix_to_conv, pad_rows
from repro_torch.forms.spec import FormsSpec
from repro_torch.kernels import ops as kops


@dataclasses.dataclass
class FormsLinearParams:
    """FORMS-compressed weights for one linear layer.

    ``mags``/``signs``/``scale`` may carry extra leading batch axes (scan-
    stacked layers); ``k``/``m`` always describe the trailing 2-D matrix.
    ``orig_shape``/``policy`` record the conv view for :func:`to_dense`;
    ``out_dtype`` is the dtype of the dense tensor the compression consumed.
    """

    mags: torch.Tensor    # (..., Kp, N) uint8 magnitude codes (K padded to m)
    signs: torch.Tensor   # (..., Kp/m, N) int8 in {+1, -1}
    scale: torch.Tensor   # (..., 1, N) float32
    k: int
    m: int
    orig_shape: Optional[Tuple[int, ...]] = None
    policy: str = "W"
    out_dtype: str = "float32"
    encoding: str = "binary"
    bits: int = 8

    @property
    def n(self) -> int:
        return self.mags.shape[-1]

    def layer(self, i: int) -> "FormsLinearParams":
        """Layer ``i`` of a scan-stacked leaf (the port's counterpart of the
        slice ``lax.scan`` hands each layer)."""
        return dataclasses.replace(self, mags=self.mags[i], signs=self.signs[i],
                                   scale=self.scale[i])


# Ambient spec for call sites that cannot thread one explicitly (the model
# layers); set by the serving engine around its model calls.
_DEFAULT_SPEC: Optional[FormsSpec] = None


@contextlib.contextmanager
def default_spec(spec: Optional[FormsSpec]) -> Iterator[None]:
    """Make ``spec`` the ambient spec for :func:`apply` calls without one;
    ``m`` and ``bits`` always come from the params being applied."""
    global _DEFAULT_SPEC
    prev, _DEFAULT_SPEC = _DEFAULT_SPEC, spec
    try:
        yield
    finally:
        _DEFAULT_SPEC = prev


def _resolve_spec(p: FormsLinearParams, spec: Optional[FormsSpec]) -> FormsSpec:
    if spec is not None:
        if spec.m != p.m:
            raise ValueError(f"spec.m={spec.m} does not match params m={p.m}")
        if spec.bits != p.bits:
            spec = dataclasses.replace(spec, bits=p.bits)
        return spec
    if _DEFAULT_SPEC is not None:
        return dataclasses.replace(_DEFAULT_SPEC, m=p.m, bits=p.bits)
    return FormsSpec(m=p.m, bits=p.bits)


def _flatten_pad(x: torch.Tensor, kp: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Flatten leading dims of ``(..., K)`` to 2-D f32 and zero-pad K to Kp."""
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).float()
    pad = kp - x2.shape[-1]
    if pad:
        x2 = torch.nn.functional.pad(x2, (0, pad))
    return x2, lead


def from_dense(w: torch.Tensor, spec: FormsSpec = FormsSpec()
               ) -> Tuple[FormsLinearParams, torch.Tensor]:
    """Convert a dense (K, N) matrix; returns (params, relative L2 error)."""
    w = w.float()
    wp = pad_rows(w, spec.m)
    polarized, signs = polmod.project_polarize(wp, spec.m, rule=spec.rule)
    quant = spec.quant
    scale = quantmod.scale_for(polarized, quant)
    codes, _ = quantmod.quantize_codes(polarized, quant, scale)
    mags = codes.abs().to(torch.uint8 if spec.bits <= 8 else torch.int32)
    recon = (mags.float() * signs.repeat_interleave(spec.m, dim=0)[: wp.shape[0]]
             * scale)
    err = torch.linalg.norm(recon[: w.shape[0]] - w) / torch.clamp(
        torch.linalg.norm(w), min=1e-12)
    params = FormsLinearParams(mags=mags, signs=signs.to(torch.int8),
                               scale=scale.reshape(1, -1).float(),
                               k=int(w.shape[0]), m=spec.m, policy=spec.policy,
                               encoding=spec.encoding, bits=spec.bits)
    return params, err


def _to_dense_2d(mags: torch.Tensor, signs: torch.Tensor, scale: torch.Tensor,
                 k: int, m: int) -> torch.Tensor:
    sign_grid = signs.float().repeat_interleave(m, dim=-2)
    return (mags.float() * sign_grid * scale)[..., :k, :]


#: the dtype names of configs and ``out_dtype`` fields, as torch dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def to_dense(p: FormsLinearParams) -> torch.Tensor:
    """Reconstruct the dense weight tensor — exact inverse of compression
    ((K, N), stacked (..., K, N), or the conv ``orig_shape`` view)."""
    dense = _to_dense_2d(p.mags, p.signs, p.scale, p.k, p.m)
    if p.orig_shape is not None and len(p.orig_shape) == 4:
        dense = matrix_to_conv(dense, p.orig_shape, p.policy)
    return dense.to(DTYPES[p.out_dtype])


def apply(p: FormsLinearParams, x: torch.Tensor,
          spec: Optional[FormsSpec] = None) -> torch.Tensor:
    """y = x @ W_forms (f32) for x of shape (..., K) via the polarized matmul.

    Requires an unstacked 2-D weight (take a layer with ``p.layer(i)``).
    """
    if p.mags.ndim != 2:
        raise ValueError(
            f"apply() needs a 2-D weight, got mags of rank {p.mags.ndim}; take "
            "one layer of a stacked leaf with p.layer(i) (expert and conv "
            "leaves are not ported yet)")
    spec = _resolve_spec(p, spec)
    x2, lead = _flatten_pad(x, p.mags.shape[0])
    y = kops.polarized_matmul(x2, p.mags, p.signs, p.scale, spec=spec)
    return y.reshape(*lead, p.n)
