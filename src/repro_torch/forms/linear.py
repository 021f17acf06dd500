"""FormsLinear: the paper's compressed weight representation.

A FORMS-compressed linear layer stores, per weight matrix:

* ``mags``  (Kp, N) uint8  — magnitude codes (int32 when ``bits > 8``);
* ``signs`` (Kp/m, N) int8 — fragment signs (the 1R sign indicator);
* ``scale`` (1, N) f32     — dequantization scale.

``from_dense`` projects a float matrix onto the polarized set P and the
magnitude grid Q and returns the codes; ``apply`` runs the MVM through
``kernels/ops.polarized_matmul`` (the CUDA kernel on the card, its plain
version on the CPU), and ``apply_simulated`` runs it through the bit-serial
crossbar simulator.  Scan-stacked ``(L, K, N)`` weights keep their leading
layer axis on every tensor.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, Optional, Tuple

import torch

from repro_torch.core import polarization as polmod
from repro_torch.core import quantization as quantmod
from repro_torch.core.fragments import matrix_to_conv, pad_rows
from repro_torch.forms.spec import FormsSpec
from repro_torch.kernels import ops as kops
from repro_torch.kernels.sparsity import SparsityMeter, sparsity_counts


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
    # on a mesh (distributed/sharding.reshard_state): the (mags, signs,
    # scale) layouts of this rank's local planes, with their global shapes
    shard: Optional[Tuple[Any, Any, Any]] = None

    @property
    def n(self) -> int:
        return self.mags.shape[-1]

    def layer(self, i: int) -> "FormsLinearParams":
        """Layer ``i`` of a scan-stacked leaf (the port's counterpart of the
        slice ``lax.scan`` hands each layer)."""
        shard = None if self.shard is None else tuple(s.layer() for s in self.shard)
        return dataclasses.replace(self, mags=self.mags[i], signs=self.signs[i],
                                   scale=self.scale[i], shard=shard)

    def matrix_split(self) -> Tuple[bool, bool]:
        """Whether this rank holds a K slice and an N slice of the matrix
        (the trailing two dims) rather than all of it."""
        if self.shard is None:
            return False, False
        mags = self.shard[0]
        return mags.spec[-2] is not None, mags.spec[-1] is not None


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


# Ambient sparsity meter, same lifecycle as the ambient spec: installed by
# the serving engine around its decode steps when zero_skip_stats is on.
# When set, every forms matmul adds its input's counters into the meter's
# device accumulator under the call site's tag.
_SPARSITY_METER: Optional[SparsityMeter] = None


@contextlib.contextmanager
def sparsity_stats(meter: Optional[SparsityMeter]) -> Iterator[None]:
    """Make ``meter`` the ambient sparsity meter for :func:`apply` calls
    (a few small device ops per matmul, so the engine installs it only
    when ``zero_skip_stats`` is asked for)."""
    global _SPARSITY_METER
    prev, _SPARSITY_METER = _SPARSITY_METER, meter
    try:
        yield
    finally:
        _SPARSITY_METER = prev


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
    """Flatten leading dims of ``(..., K)`` to 2-D and zero-pad K to Kp, in
    x's dtype (bf16 activations reach the tensor-core kernel as they are)."""
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1])
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
    ((K, N), stacked (..., K, N), or the conv ``orig_shape`` view).  A leaf
    that holds one rank's N slice of a matrix comes back as the rank's
    columns of the whole matrix: signs are per (fragment, column) and
    scales per column, so the columns are self-contained (MLA's absorbed
    decode rebuilds its rank's heads of ``kv_up`` so).  A K slice is
    refused: ``k`` and the fragment grid describe the whole matrix, so a
    slice would come back with the wrong rows; so is an N slice of a conv
    view.  (Slices along leading axes, a rank's experts, hold whole
    matrices.)"""
    k_split, n_split = p.matrix_split()
    if k_split or (n_split and p.orig_shape is not None and len(p.orig_shape) == 4):
        raise ValueError(
            f"to_dense of a sharded FORMS leaf (mags spec {p.shard[0].spec}, global "
            f"shape {p.shard[0].shape}, local {tuple(p.mags.shape)}): this rank holds "
            "a K slice of the matrix; gather it first")
    dense = _to_dense_2d(p.mags, p.signs, p.scale, p.k, p.m)
    if p.orig_shape is not None and len(p.orig_shape) == 4:
        dense = matrix_to_conv(dense, p.orig_shape, p.policy)
    return dense.to(DTYPES[p.out_dtype])


def apply(p: FormsLinearParams, x: torch.Tensor,
          spec: Optional[FormsSpec] = None, tag: str = "linear") -> torch.Tensor:
    """y = x @ W_forms (f32) for x of shape (..., K) via the polarized matmul.

    Requires an unstacked 2-D weight (take a layer with ``p.layer(i)``).
    ``tag`` names the call site in the sparsity counters
    (``engine.stats()["sparsity"]["layers"]``).
    """
    if p.mags.ndim != 2:
        raise ValueError(
            f"apply() needs a 2-D weight, got mags of rank {p.mags.ndim}; take "
            "one layer of a stacked leaf with p.layer(i) (expert and conv "
            "leaves are rebuilt with to_dense or sliced by their callers)")
    spec = _resolve_spec(p, spec)
    x2, lead = _flatten_pad(x, p.mags.shape[0])
    if _SPARSITY_METER is not None:
        _SPARSITY_METER.record(tag, sparsity_counts(x2, p.m))
    y = kops.polarized_matmul(x2, p.mags, p.signs, p.scale, spec=spec)
    return y.reshape(*lead, p.n)


def apply_simulated(p: FormsLinearParams, x: torch.Tensor,
                    spec: Optional[FormsSpec] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bit-serial crossbar simulation; returns (y, eic, x_scale).

    y is the dequantized f32 output; eic (rows, fragments) the effective
    input cycles consumed (the zero-skipping observable).  ``spec``
    provides ``input_bits``/``adc_bits``/``cell_bits``.
    """
    if p.mags.ndim != 2:
        raise ValueError(
            f"apply_simulated() needs a 2-D weight, got rank {p.mags.ndim}")
    spec = _resolve_spec(p, spec)
    x2, lead = _flatten_pad(x.float(), p.mags.shape[0])
    x_codes, x_scale = quantmod.quantize_activations(x2, spec.input_bits)
    cells = quantmod.slice_to_cells(p.mags, spec.quant)
    if spec.cell_bits <= 8:     # planes masked to cell_bits fit the kernel's uint8 cells
        cells = cells.to(torch.uint8)
    acc, eic = kops.bitserial_crossbar(x_codes, cells, p.signs, spec=spec)
    y = acc.float() * x_scale * p.scale
    return y.reshape(*lead, p.n), eic, x_scale
