"""Public kernel entry points: geometry validation and dispatch by device.

``polarized_matmul`` checks the fragment geometry with the JAX package's
messages, then hands the operands to the kernel wrapper, which runs the
CUDA kernel on CUDA tensors and the plain PyTorch version on CPU tensors.
The CUDA kernel masks ragged M/N/K edges itself, so nothing is padded here.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.kernels.polarized_matmul import polarized_matmul as _polarized_kernel


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


def polarized_matmul(x: torch.Tensor, mags: torch.Tensor, signs: torch.Tensor,
                     scale: torch.Tensor, *, m: int = 8,
                     spec: Optional[Any] = None) -> torch.Tensor:
    """y[M,N] = x[M,K] @ (signs*mags)[K,N] * scale[1,N], float32.

    ``signs`` is int8 (the FORMS storage type) or +-1 floats.  ``spec`` (a
    FormsSpec) supplies ``m``; its zero-skip modes are not ported yet and
    raise rather than silently serving the dense path.
    """
    if spec is not None:
        m = spec.m
        if spec.zero_skip != "off":
            raise NotImplementedError(
                f"zero_skip={spec.zero_skip!r} is not ported yet "
                f"(ROADMAP queue 1, item 5: zero-skip)")
    _validate_polarized_geometry(x, mags, signs, m)
    return _polarized_kernel(x.float().contiguous(), mags, signs, scale, m)
