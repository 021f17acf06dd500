"""Polarized-magnitude matmul: the hand-written CUDA kernel and its wrappers.

Computes ``y = x @ (repeat(signs, m) * mags) * scale`` for ``x`` (M, K) f32,
``mags`` (K, N) uint8 or int32 codes, ``signs`` (K/m, N) int8 and ``scale``
(1, N) f32.  The kernel (``csrc/polarized_matmul.cu``) replaces the Pallas
TPU kernels ``repro/kernels/polarized_matmul.py::_kernel`` (dense,
:func:`polarized_matmul`) and ``::_kernel_skip`` (input zero-skipping,
:func:`polarized_matmul_skip`); its source says what bounds it on the card
and how the design answers that.

The tensors' device picks the route: CPU tensors go to the plain PyTorch
versions (:func:`repro_torch.kernels.ref.ref_polarized_matmul_fast` and
``ref_polarized_matmul_skip``), CUDA tensors to the kernel.  A CUDA call
either launches the kernel or raises — there is no fallback.  Each wrapper
counts its kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_polarized_matmul_fast, ref_polarized_matmul_skip
from repro_torch.kernels.sparsity import block_mask

_SOURCE = "polarized_matmul"
_ENTRY = {torch.uint8: "forms_polarized_matmul_u8",
          torch.int32: "forms_polarized_matmul_i32"}
# x, mags, signs, scale, mask, gate, y, work, tickets; M, N, K, m, fast; stream
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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


def tile_rows(M: int) -> int:
    """Rows of x per block: the kernel takes 4 at decode (M <= 4), else 8."""
    return 4 if M <= 4 else 8


def tile_mask(x: torch.Tensor) -> torch.Tensor:
    """The kernel's int32 zero-skip mask of x: one entry per (row tile,
    K slice of ``KC`` rows), 1 where the tile holds a nonzero.  A plain
    torch reduction over x padded to whole tiles, made on x's device before
    the launch (as the reference makes its mask outside its kernel)."""
    M, K = x.shape
    bm = tile_rows(M)
    if M % bm or K % _KC:   # the served shapes tile already: no copy
        x = torch.nn.functional.pad(x, (0, (-K) % _KC, 0, (-M) % bm))
    return block_mask(x, bm, _KC)


def _device_of(*ts: torch.Tensor) -> torch.device:
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"polarized_matmul runs on cpu or cuda tensors, got {dev}")
    return dev


def polarized_matmul(x: torch.Tensor, mags: torch.Tensor, signs: torch.Tensor,
                     scale: torch.Tensor, m: int, *, gate: Optional[torch.Tensor] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[M, N] = x[M, K] @ (repeat(signs, m) * mags)[K, N] * scale[1, N], f32.

    ``gate`` (one int32 on the card, CUDA tensors only) lets the launch
    write ``out`` only where it reads nonzero, without the host reading it:
    the kernel's blocks return at once otherwise (fragment compaction
    launches two gated products into one ``out``).
    """
    dev = _device_of(x, mags, signs, scale)
    if dev.type == "cpu":
        if gate is not None or out is not None:
            raise ValueError("gate= and out= are for CUDA tensors; on the CPU choose "
                             "with a Python if")
        return ref_polarized_matmul_fast(x, mags, signs, scale, m)
    y = _launch(x, mags, signs, scale, m, None, gate, out)
    polarized_matmul.launches += 1
    return y


def polarized_matmul_skip(x: torch.Tensor, mags: torch.Tensor, signs: torch.Tensor,
                          scale: torch.Tensor, m: int,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same product with input zero-skipping: a (row tile, K slice) of
    x that is all zero moves no weight byte and does no MAC.  ``mask`` is
    :func:`tile_mask` of x (made here when None); the result equals
    :func:`polarized_matmul`'s bit for bit, for any x."""
    dev = _device_of(x, mags, signs, scale)
    if mask is None:
        mask = tile_mask(x.float())
    M, K = x.shape
    want = (-(-M // tile_rows(M)), -(-K // _KC))
    if tuple(mask.shape) != want:
        raise ValueError(f"mask {tuple(mask.shape)} is not the kernel's tiling of x "
                         f"{tuple(x.shape)}: expected {want} (tile_mask(x))")
    if m < 1 or _KC % m:
        raise ValueError(f"zero-skip masks cover K slices of {_KC} rows, which must be "
                         f"a whole number of fragments: m={m} does not divide "
                         f"{_KC}; use zero_skip='compact' for this m")
    if dev.type == "cpu":
        return ref_polarized_matmul_skip(x, mags, signs, scale, mask, m,
                                         tile_rows(M), _KC)
    if mask.device != dev or mask.dtype != torch.int32 or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous int32 tensor on x's device")
    y = _launch(x, mags, signs, scale, m, mask, None, None)
    polarized_matmul_skip.launches += 1
    return y


def _launch(x, mags, signs, scale, m, mask, gate, out) -> torch.Tensor:
    """Check the operands and launch the kernel on x's CUDA device."""
    dev = x.device
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

    if gate is not None and (gate.device != dev or gate.dtype != torch.int32
                             or gate.numel() != 1):
        raise ValueError("gate must be one int32 on x's device")
    if out is None:
        if gate is not None:
            raise ValueError("a gated call needs out=")
        y = torch.empty((M, N), dtype=torch.float32, device=dev)
    elif (out.shape != (M, N) or out.dtype != torch.float32 or out.device != dev
          or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 ({M}, {N}) tensor on {dev}")
    else:
        y = out
    if M == 0 or N == 0 or K == 0:
        if gate is None:
            return y.zero_()
        return y.masked_fill_(gate.reshape(1, 1) != 0, 0.0)  # no host read
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
        work = torch.empty(slices * M * N, dtype=torch.float32, device=dev)
        tickets = _tickets(key, -(-N // _BN) * -(-M // tile_rows(M)))
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), mags.data_ptr(), signs.data_ptr(), scale.data_ptr(),
                 ptr(mask), ptr(gate), y.data_ptr(), ptr(work), ptr(tickets),
                 M, N, K, m, fast, stream)
    if err != 0:
        # a launch that failed may leave tickets raised: the next launch on
        # this stream starts from fresh zeros
        _TICKETS.pop(key, None)
        raise RuntimeError(f"polarized_matmul kernel launch failed: CUDA error {err}")
    return y


polarized_matmul.launches = 0
polarized_matmul_skip.launches = 0
