"""Fragment-polarization projection of the ADMM Z-update: the hand-written
CUDA kernel and its wrapper.

For ``v`` (K, N), or a stack of layers (L, K, N), with K a multiple of the
fragment size m, it elects one sign per (fragment of m rows, column) — by
the fragment's sum (``sum``) or by the squared mass of its two signs
(``energy``) — and zeroes the entries that disagree.  It returns the
projected tensor and the (…, K/m, N) signs, both in v's dtype (float32 or
bfloat16).  The kernel (``csrc/admm_polarize.cu``) replaces the Pallas TPU
kernel ``repro/kernels/admm_polarize.py::_kernel``; its source says what
bounds it on the card and how the design answers that.

CPU tensors take the plain version (:func:`repro_torch.kernels.ref.
ref_admm_polarize`), CUDA tensors the kernel, which launches or raises.
A stacked leaf is projected in one launch.  ``admm_polarize.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_admm_polarize

_SOURCE = "admm_polarize"
_RULES = {"sum": 0, "energy": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# v, out, signs; L, K, N, m, rule, dtype; stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_THREADS = 256          # columns per block, as csrc/admm_polarize.cu fixes it
_MAX_GRID_X, _MAX_GRID_Y = 2 ** 31 - 1, 65535


def _entry():
    lib = build.load(_SOURCE)
    fn = lib.forms_admm_polarize
    if fn.argtypes is None:
        if lib.forms_admm_polarize_threads() != _THREADS:
            raise RuntimeError("csrc/admm_polarize.cu and its wrapper disagree on "
                               "the block size")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def admm_polarize(v: torch.Tensor, *, m: int, rule: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (projected, signs) of a (K, N) or (L, K, N) tensor."""
    if rule not in _RULES:
        raise ValueError(f"the polarization kernel takes rule 'sum' or 'energy', got "
                         f"{rule!r} (the frozen projection is plain torch)")
    if v.ndim not in (2, 3):
        raise ValueError(f"v must be (K, N) or (L, K, N), got {tuple(v.shape)}")
    K, N = v.shape[-2:]
    if m < 1 or K % m:
        raise ValueError(f"K={K} rows do not tile into fragments of m={m}; pad K to "
                         f"{-(-K // max(m, 1)) * max(m, 1)} (kernels.ops.admm_polarize does)")
    if v.device.type == "cpu":
        return ref_admm_polarize(v, m, rule)
    if v.device.type != "cuda":
        raise ValueError(f"admm_polarize runs on cpu or cuda tensors, got {v.device}")
    if v.dtype not in _DTYPES:
        raise TypeError(f"the polarization kernel takes float32 or bfloat16, got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError("the polarization kernel takes a contiguous v")
    L = v.shape[0] if v.ndim == 3 else 1
    col_blocks = -(-N // _THREADS)
    if (max(L, K, N) >= 2 ** 31 or col_blocks * (K // m) > _MAX_GRID_X
            or L > _MAX_GRID_Y):
        raise ValueError(f"shape {tuple(v.shape)} is outside the kernel's grid")
    out = torch.empty_like(v)
    signs = torch.empty((*v.shape[:-2], K // m, N), dtype=v.dtype, device=v.device)
    if v.numel() == 0:
        return out, signs
    stream = torch.cuda.current_stream(v.device).cuda_stream
    with torch.cuda.device(v.device):
        err = _entry()(v.data_ptr(), out.data_ptr(), signs.data_ptr(), L, K, N, m,
                       _RULES[rule], _DTYPES[v.dtype], stream)
    if err != 0:
        raise RuntimeError(f"admm_polarize kernel launch failed: CUDA error {err}")
    admm_polarize.launches += 1
    return out, signs


admm_polarize.launches = 0
