"""Public kernel entry points: geometry validation and dispatch by device.

``polarized_matmul`` checks the fragment geometry with the JAX package's
messages, picks the zero-skip route, then hands the operands to the kernel
wrappers, which run the CUDA kernels on CUDA tensors (the tensor-core one
for bf16 x and uint8 codes at prefill M, the f32 one otherwise) and the
plain PyTorch versions on CPU tensors.  The CUDA kernels mask ragged M/N/K edges
themselves, so nothing is padded here.  ``bitserial_crossbar`` is the
entry of the bit-serial crossbar simulator, ``admm_polarize`` that of the
fragment-polarization projection (the ADMM Z-update), which pads K to
whole fragments.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import sparsity
from repro_torch.kernels.admm_polarize import admm_polarize as _polarize_kernel
from repro_torch.kernels.bitserial_crossbar import bitserial_crossbar as _bitserial_kernel
from repro_torch.kernels.polarized_matmul import polarized_matmul as _polarized_kernel
from repro_torch.kernels.polarized_matmul import polarized_matmul_skip as _skip_kernel

#: zero-skip modes of :func:`polarized_matmul`: ``off`` is the dense
#: kernel; ``block`` skips the all-zero (row tile, K slice) input tiles
#: (bit-identical to dense); ``compact`` gathers the live whole fragments
#: into a smaller product when they fit the ``zero_skip_keep`` budget, and
#: runs the full product when they do not.
VALID_ZERO_SKIP = ("off", "block", "compact")


def _validate_polarized_geometry(x: torch.Tensor, mags: torch.Tensor,
                                 signs: torch.Tensor, m: int) -> None:
    """Reject a K that does not tile into fragments, a sign plane that is not
    one row per fragment, and activations whose K disagrees with mags."""
    K, N = mags.shape
    if m < 1:
        raise ValueError(f"fragment size m must be >= 1, got {m}")
    if K % m != 0:
        raise ValueError(
            f"K={K} magnitude rows do not tile into fragments of m={m} "
            f"rows; pad K to {-(-K // m) * m} (core.fragments.pad_rows / "
            f"forms.from_dense do this) or choose an m dividing K")
    if tuple(signs.shape) != (K // m, N):
        raise ValueError(
            f"signs must hold one row per fragment: expected "
            f"{(K // m, N)} for mags {tuple(mags.shape)} with m={m}, got "
            f"{tuple(signs.shape)}")
    if x.ndim != 2 or x.shape[1] != K:
        raise ValueError(
            f"x and mags disagree on K: x is {tuple(x.shape)}, mags is "
            f"{tuple(mags.shape)}; pad activations to the magnitude rows "
            f"(forms.apply does this automatically)")


def gather_live_fragments(x: torch.Tensor, mags: torch.Tensor, signs: torch.Tensor,
                          m: int, keep_frac: float):
    """The operands of fragment compaction: the first ``keep`` fragments in
    live-first order (x columns, mags rows and the shared sign row move
    together, which keeps the gather sign-consistent), the live count
    (a device scalar: nothing is read back) and ``keep``.  None when the
    budget holds every fragment."""
    M, K = x.shape
    N = mags.shape[1]
    F = K // m
    keep = max(1, min(F, int(round(F * keep_frac))))
    if keep >= F:
        return None
    live = sparsity.fragment_occupancy(x, m)
    idx = sparsity.compact_order(live)[:keep]
    xg = x.reshape(M, F, m).index_select(1, idx).reshape(M, keep * m)
    mg = mags.reshape(F, m, N).index_select(0, idx).reshape(keep * m, N)
    return xg, mg, signs.index_select(0, idx), live.sum(), keep


def _compact_matmul(x: torch.Tensor, mags: torch.Tensor, signs: torch.Tensor,
                    scale: torch.Tensor, m: int, keep_frac: float,
                    dense_fn: Callable[..., torch.Tensor]) -> torch.Tensor:
    """Fragment compaction: a smaller product when the live fragments fit.

    Gathers the live whole fragments into a ``keep``-fragment budget
    (:func:`gather_live_fragments`) and runs ``dense_fn`` on them; with more
    live fragments than the budget it runs the full product.  Exact, because
    the fragments gathered away have all-zero input columns.

    The reference picks the branch with ``lax.cond``.  On the CPU a Python
    ``if`` does.  On the card the choice stays on the device: both products
    are launched into one output, gated by the flag ``n_live <= keep`` and
    its complement, and the kernel's blocks of the launch not chosen return
    at once — so the gather is always paid, the full product only when it
    is chosen, and the host never waits for the flag.
    """
    plan = gather_live_fragments(x, mags, signs, m, keep_frac)
    if plan is None:
        return dense_fn(x, mags, signs, scale)
    xg, mg, sg, n_live, keep = plan
    if x.device.type == "cpu":
        if int(n_live) <= keep:
            return dense_fn(xg, mg, sg, scale)
        return dense_fn(x, mags, signs, scale)
    use = (n_live <= keep).to(torch.int32).reshape(1)
    out = torch.empty((x.shape[0], mags.shape[1]), dtype=torch.float32, device=x.device)
    dense_fn(xg, mg, sg, scale, gate=use, out=out)
    dense_fn(x, mags, signs, scale, gate=1 - use, out=out)
    return out


@obs.spanned("rt.forms.mm")
def polarized_matmul(x: torch.Tensor, mags: torch.Tensor, signs: torch.Tensor,
                     scale: torch.Tensor, *, m: int = 8, zero_skip: str = "off",
                     zero_skip_keep: float = 0.5,
                     spec: Optional[Any] = None) -> torch.Tensor:
    """y[M,N] = x[M,K] @ (signs*mags)[K,N] * scale[1,N], float32.

    ``signs`` is int8 (the FORMS storage type) or +-1 floats.  ``spec`` (a
    FormsSpec) supplies ``m`` and the zero-skip knobs.  ``zero_skip`` (see
    :data:`VALID_ZERO_SKIP`) exploits input sparsity: ``block`` skips the
    kernel's all-zero input tiles, ``compact`` runs on the gathered live
    fragments when at most ``zero_skip_keep`` of them are live.
    """
    if spec is not None:
        m = spec.m
        zero_skip, zero_skip_keep = spec.zero_skip, spec.zero_skip_keep
    if zero_skip not in VALID_ZERO_SKIP:
        raise ValueError(
            f"zero_skip must be one of {VALID_ZERO_SKIP}, got "
            f"{zero_skip!r} (FormsSpec(zero_skip=...) / --zero-skip)")
    _validate_polarized_geometry(x, mags, signs, m)
    # bf16 x stays bf16, for the tensor-core kernel (the kernel wrappers
    # widen it for the f32 kernel and the CPU); other dtypes widen to f32
    x = (x if x.dtype == torch.bfloat16 else x.float()).contiguous()
    if zero_skip == "block":
        return _skip_kernel(x, mags, signs, scale, m)
    if zero_skip == "compact":
        return _compact_matmul(
            x, mags, signs, scale, m, zero_skip_keep,
            lambda x_, mg, sg, sc, **kw: _polarized_kernel(x_, mg, sg, sc, m, **kw))
    return _polarized_kernel(x, mags, signs, scale, m)


def bitserial_crossbar(
    x_codes: torch.Tensor, cell_planes: torch.Tensor, signs: torch.Tensor,
    *, m: int = 8, input_bits: int = 16, cell_bits: int = 2,
    adc_bits: Optional[int] = None, spec: Optional[Any] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (acc[M,N] int32, eic[M,K/m] int32) of the bit-serial crossbar.

    ``spec`` (a FormsSpec) overrides ``m``/``input_bits``/``cell_bits``/
    ``adc_bits``.  On CPU tensors this is the plain version plus
    ``core.zeroskip.fragment_eic``, as the reference's oracle route is; on
    CUDA tensors the kernel computes both.
    """
    if spec is not None:
        m, input_bits, cell_bits = spec.m, spec.input_bits, spec.cell_bits
        adc_bits = spec.adc_bits
    return _bitserial_kernel(x_codes, cell_planes, signs, m=m, input_bits=input_bits,
                             cell_bits=cell_bits, adc_bits=adc_bits)


def admm_polarize(v: torch.Tensor, *, m: int = 8, rule: str = "sum",
                  spec: Optional[Any] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (projected, signs) of ``v`` (K, N) or a stacked leaf (L, K, N).

    K is zero-padded to whole fragments (pad rows are sign-neutral) and the
    projection is cut back to K rows; ``signs`` keeps all ``ceil(K/m)``
    fragment rows.  ``spec`` (a FormsSpec) overrides ``m``/``rule``.  On
    CUDA tensors a stacked leaf is one kernel launch.
    """
    if spec is not None:
        m, rule = spec.m, spec.rule
    K = v.shape[-2]
    pad = (-K) % m if m >= 1 else 0
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad)) if pad else v.contiguous()
    out, signs = _polarize_kernel(vp, m=m, rule=rule)
    return (out[..., :K, :] if pad else out), signs
