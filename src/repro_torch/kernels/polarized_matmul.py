"""Polarized-magnitude matmul: the hand-written CUDA kernel and its wrapper.

Computes ``y = x @ (repeat(signs, m) * mags) * scale`` for ``x`` (M, K) f32,
``mags`` (K, N) uint8 or int32 codes, ``signs`` (K/m, N) int8 and ``scale``
(1, N) f32.  The kernel (``csrc/polarized_matmul.cu``) replaces the Pallas
TPU kernel ``repro/kernels/polarized_matmul.py::_kernel``; its source says
what bounds it on the card and how the design answers that.

The tensors' device picks the route: CPU tensors go to the plain PyTorch
version (:func:`repro_torch.kernels.ref.ref_polarized_matmul_fast`), CUDA
tensors to the kernel.  A CUDA call either launches the kernel or raises —
there is no fallback.  ``polarized_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_polarized_matmul_fast

_SOURCE = "polarized_matmul"
_ENTRY = {torch.uint8: "forms_polarized_matmul_u8",
          torch.int32: "forms_polarized_matmul_i32"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# the kernel's tiling, as csrc/polarized_matmul.cu fixes it: 32 output
# columns by 4 (M <= 4) or 8 rows per block, K cut into slices of 256 rows
_BN, _KC = 32, 256

# per (device, stream): the kernel's per-tile ticket counters, all zero
# between launches (the kernel resets what it uses), grown on demand.  One
# buffer per stream, because launches on one stream run in order while
# launches on two streams may overlap and must not share tile counters.
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _tickets(key: Tuple[torch.device, int], n: int) -> torch.Tensor:
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=key[0])
        _TICKETS[key] = t
    return t


def _int8_signs(signs: torch.Tensor) -> torch.Tensor:
    """int8 signs as they are; +-1 floats converted; anything else raises."""
    if signs.dtype == torch.int8:
        return signs
    if signs.is_floating_point() and bool((signs.abs() == 1).all()):
        return signs.to(torch.int8)
    raise TypeError(f"signs must be int8 (or floats that are all +-1), got "
                    f"{signs.dtype}")


def _entry(mag_dtype: torch.dtype):
    lib = build.load(_SOURCE)
    fn = getattr(lib, _ENTRY[mag_dtype])
    if fn.argtypes is None:
        if lib.forms_polarized_matmul_kc() != _KC:
            raise RuntimeError("csrc/polarized_matmul.cu and its wrapper disagree "
                               "on the K slice")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def polarized_matmul(x: torch.Tensor, mags: torch.Tensor, signs: torch.Tensor,
                     scale: torch.Tensor, m: int) -> torch.Tensor:
    """y[M, N] = x[M, K] @ (repeat(signs, m) * mags)[K, N] * scale[1, N], f32."""
    devices = {t.device for t in (x, mags, signs, scale)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devices))}")
    dev = x.device
    if dev.type == "cpu":
        return ref_polarized_matmul_fast(x, mags, signs, scale, m)
    if dev.type != "cuda":
        raise ValueError(f"polarized_matmul runs on cpu or cuda tensors, got {dev}")

    if x.ndim != 2 or mags.ndim != 2:
        raise ValueError(f"x and mags must be 2-D, got {tuple(x.shape)} and {tuple(mags.shape)}")
    M, K = x.shape
    K2, N = mags.shape
    if K != K2:
        raise ValueError(f"x {tuple(x.shape)} and mags {tuple(mags.shape)} disagree on K")
    if K % m != 0 or tuple(signs.shape) != (K // m, N):
        raise ValueError(f"signs {tuple(signs.shape)} do not hold one row per "
                         f"fragment of m={m} for mags {tuple(mags.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if mags.dtype not in _ENTRY:
        raise TypeError(f"mags must be uint8 or int32, got {mags.dtype}")
    if scale.dtype != torch.float32 or scale.numel() != N:
        raise TypeError(f"scale must be float32 with N={N} entries, got "
                        f"{scale.dtype} {tuple(scale.shape)}")
    signs = _int8_signs(signs)
    for name, t in (("x", x), ("mags", mags), ("signs", signs), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(M, N, K) >= 2 ** 31:
        raise ValueError(f"shape ({M}, {K}, {N}) exceeds the kernel's int32 indices")

    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0 or K == 0:
        return y.zero_()
    # the vector-load instantiation needs whole 4-column and 8-row groups
    # and aligned rows; anything else takes the masked scalar one
    fast = int(N % 4 == 0 and K % 8 == 0
               and mags.data_ptr() % (4 * mags.element_size()) == 0
               and signs.data_ptr() % 4 == 0)
    fn = _entry(mags.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev, stream)
    slices = -(-K // _KC)
    work = tickets = None
    if slices > 1:
        bm = 4 if M <= 4 else 8
        work = torch.empty(slices * M * N, dtype=torch.float32, device=dev)
        tickets = _tickets(key, -(-N // _BN) * -(-M // bm))
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), mags.data_ptr(), signs.data_ptr(), scale.data_ptr(),
                 y.data_ptr(), work.data_ptr() if work is not None else None,
                 tickets.data_ptr() if tickets is not None else None,
                 M, N, K, m, fast, stream)
    if err != 0:
        # a launch that failed may leave tickets raised: the next launch on
        # this stream starts from fresh zeros
        _TICKETS.pop(key, None)
        raise RuntimeError(f"polarized_matmul kernel launch failed: CUDA error {err}")
    polarized_matmul.launches += 1
    return y


polarized_matmul.launches = 0
