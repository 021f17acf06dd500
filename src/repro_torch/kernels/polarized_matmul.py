"""Polarized-magnitude matmul: the hand-written CUDA kernels and their wrappers.

Computes ``y = x @ (repeat(signs, m) * mags) * scale`` for ``x`` (M, K)
f32 or bf16, ``mags`` (K, N) uint8 or int32 codes, ``signs`` (K/m, N) int8
and ``scale`` (1, N) f32, into f32.  Two kernels replace the Pallas TPU
kernels ``repro/kernels/polarized_matmul.py::_kernel`` (dense) and
``::_kernel_skip`` (input zero-skipping); each source says what bounds it on
the card and how its design answers that:

* ``csrc/polarized_matmul_tc.cu`` — bf16 x times uint8 codes on the tensor
  cores (:func:`polarized_matmul_tc`, :func:`polarized_matmul_tc_skip`), for
  M >= :data:`TC_MIN_ROWS` and N >= :data:`TC_MIN_COLS`: the prefill of a
  bf16 served model (``wgmma`` with the codes widened in registers, TMA
  loads, the K slices of an output tile summed inside a thread-block
  cluster; :func:`tc_group` picks the cluster);
* ``csrc/polarized_matmul.cu`` — f32 on the CUDA cores
  (:func:`polarized_matmul`, :func:`polarized_matmul_skip`), for everything
  else: decode, narrow N, int32 codes (bits > 8) and f32 activations.  It takes bf16 x
  as it is and widens it in the kernel (exactly), and its launch geometry is
  :func:`decode_split`'s plan.

:func:`polarized_matmul` and :func:`polarized_matmul_skip` are the entry
points: :func:`uses_tensor_cores` picks the kernel from x's dtype, the codes'
dtype, the device, M and N.  The tensors' device picks the route: CPU tensors
go to the plain PyTorch versions
(:func:`repro_torch.kernels.ref.ref_polarized_matmul_fast` and
``ref_polarized_matmul_skip``, on x widened to f32), CUDA tensors to a
kernel.  A CUDA call either launches its kernel or raises — there is no
fallback.  Each kernel wrapper counts its own launches in its ``launches``
attribute: ``polarized_matmul.launches`` counts the f32 kernel's dense
launches only, ``polarized_matmul_tc.launches`` the tensor-core kernel's.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_polarized_matmul_fast, ref_polarized_matmul_skip
from repro_torch.kernels.sparsity import block_mask

_SOURCE = "polarized_matmul"
# the f32 kernel's C entry per (x dtype, code dtype)
_ENTRY = {(torch.float32, torch.uint8): "forms_polarized_matmul_u8",
          (torch.float32, torch.int32): "forms_polarized_matmul_i32",
          (torch.bfloat16, torch.uint8): "forms_polarized_matmul_u8_bf16",
          (torch.bfloat16, torch.int32): "forms_polarized_matmul_i32_bf16"}
_MAG_DTYPES = (torch.uint8, torch.int32)
_TC_SOURCE, _TC_ENTRY = "polarized_matmul_tc", "forms_polarized_matmul_tc"
# x, mags, signs, scale, mask, gate, y, work, tickets; M, N, K, m, fast,
# group; stream (the f32 kernel's entries)
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# x, mags, signs, scale, mask, gate, y; M, N, K, m, fast, cluster; stream
# (the tensor-core entry: no scratch, the K slices meet inside a cluster)
_TC_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# the zero-skip mask's K slice, as both sources fix it
_KC = 256
# the f32 kernel's tiling, as csrc/polarized_matmul.cu fixes it: 128 output
# columns by 4 (M <= 4) or 8 rows per block, each block summing ``group``
# (at most 32) K slices
_BN, _MAX_GROUP = 128, 32
# the tensor-core kernel's, as csrc/polarized_matmul_tc.cu fixes it: the
# zero-skip mask in 64-row tiles of x (a block's tokens: 8, 16, 32 or 64 of
# them) and the same K slices of 256 rows, 128 columns per block, and the K
# range of an output tile cut over a cluster of at most 8 blocks
_TC_BM, _TC_BN, _TC_MAX_CLUSTER = 64, 128, 8

#: the least M that takes the tensor-core kernel (bf16 x, uint8 codes).
#: Measured on an H100 (PERF.md, the M crossover, per qwen2-1.5b layer on
#: bf16 x): the f32 kernel is faster up to M = 4 (0.1028 against 0.1087
#: ms), the tensor-core kernel from M = 8 (0.1087 against 0.1269 ms).
TC_MIN_ROWS = 8

#: the least N that takes the tensor-core kernel.  Measured on an H100 at
#: M = 64, K = 1024 (PERF.md, the narrow-N row): at N = 1, 2 and 4 (the
#: mLSTM's wi/wf and their shards) its plain loads of a 128-column tile take
#: 0.055-0.058 ms against the f32 kernel's 0.018; from N = 16 it wins
#: (0.0116 against 0.0129 ms).
TC_MIN_COLS = 16

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


def _entry(x_dtype: torch.dtype, mag_dtype: torch.dtype):
    lib = build.load(_SOURCE)
    fn = getattr(lib, _ENTRY[x_dtype, mag_dtype])
    if fn.argtypes is None:
        if lib.forms_polarized_matmul_kc() != _KC:
            raise RuntimeError("csrc/polarized_matmul.cu and its wrapper disagree "
                               "on the K slice")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _tc_entry():
    lib = build.load(_TC_SOURCE)
    fn = getattr(lib, _TC_ENTRY)
    if fn.argtypes is None:
        tile = tuple(lib.forms_polarized_matmul_tc_tile(i) for i in range(4))
        if tile != (_TC_BM, _TC_BN, _KC, _TC_MAX_CLUSTER):
            raise RuntimeError(f"csrc/polarized_matmul_tc.cu tiles by {tile}, its wrapper "
                               f"by {(_TC_BM, _TC_BN, _KC, _TC_MAX_CLUSTER)}")
        fn.argtypes = _TC_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def tc_tokens(M: int) -> int:
    """Rows of x per tensor-core block: the least ``wgmma`` N of 8, 16, 32
    and 64 that holds M, else 64 (the mask's row tile)."""
    return next(n for n in (8, 16, 32, _TC_BM) if M <= n or n == _TC_BM)


def tc_group(M: int, N: int, K: int, sms: int) -> int:
    """The tensor-core kernel's cluster: how many blocks split the K range
    of one output tile (their partial tiles are summed in the cluster's
    shared memory).  The largest power of two whose blocks fit one wave on
    the ``sms`` SMs (a block takes an SM), at most 8 (a portable cluster)
    and at most one 64-row stage of K per block: timed fastest at every
    qwen2-1.5b, whisper, MLA and Zamba2 shape on an H100 (PERF.md)."""
    tiles = -(-N // _TC_BN) * -(-M // tc_tokens(M))
    stages = -(-K // 64)
    cluster = 1
    while 2 * cluster * tiles <= sms and 2 * cluster <= min(_TC_MAX_CLUSTER, stages):
        cluster *= 2
    return cluster


def decode_split(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """The f32 kernel's plan on a card of ``sms`` SMs: ``(group, splits)``.
    A block covers :func:`tile_rows` rows, 128 columns and ``group`` K
    slices of 256 rows, so the grid is ceil(N / 128) x ceil(M / rows) x
    ``splits``.  The group is the one whose busiest SM (blocks spread
    evenly over the SMs) has the least to do, counting a slice of codes as
    4 and a split block's partial, written and summed again, as 1; of
    equals, the largest (timed on an H100, PERF.md)."""
    tiles = -(-N // _BN) * -(-M // tile_rows(M))
    S = -(-K // _KC)

    def busiest(g: int) -> int:
        splits = -(-S // g)
        return -(-tiles * splits // sms) * (4 * g + (splits > 1))

    group = min(range(1, min(S, _MAX_GROUP) + 1), key=lambda g: (busiest(g), -g))
    return group, -(-S // group)


def uses_tensor_cores(x_dtype: torch.dtype, mag_dtype: torch.dtype, device_type: str,
                      M: int, N: int) -> bool:
    """Whether a call takes the tensor-core kernel: CUDA, bf16 x, uint8
    codes (every operand exact in bf16), M >= :data:`TC_MIN_ROWS` and N >=
    :data:`TC_MIN_COLS`."""
    return (device_type == "cuda" and x_dtype == torch.bfloat16
            and mag_dtype == torch.uint8 and M >= TC_MIN_ROWS and N >= TC_MIN_COLS)


def tile_rows(M: int, tensor_cores: bool = False) -> int:
    """Rows of x per block: the f32 kernel takes 4 at decode (M <= 4), else
    8; the tensor-core kernel 64."""
    if tensor_cores:
        return _TC_BM
    return 4 if M <= 4 else 8


def tile_mask(x: torch.Tensor, mag_dtype: torch.dtype = torch.uint8,
              N: Optional[int] = None) -> torch.Tensor:
    """The int32 zero-skip mask of x at the tiling of the kernel that a call
    with x and codes of ``mag_dtype`` on ``N`` output columns (None: at
    least :data:`TC_MIN_COLS`) launches: one entry per (row tile, K slice of
    ``KC`` rows), 1 where the tile holds a nonzero."""
    M = x.shape[0]
    N = TC_MIN_COLS if N is None else N
    return _tile_mask(x, tile_rows(M, uses_tensor_cores(x.dtype, mag_dtype, x.device.type,
                                                        M, N)))


def _tile_mask(x: torch.Tensor, bm: int) -> torch.Tensor:
    """The mask at row tiles of ``bm``: a plain torch reduction over x
    padded to whole tiles, made on x's device before the launch (as the
    reference makes its mask outside its kernel)."""
    M, K = x.shape
    if M % bm or K % _KC:   # the served shapes tile already: no copy
        x = torch.nn.functional.pad(x, (0, (-K) % _KC, 0, (-M) % bm))
    return block_mask(x, bm, _KC)


def _device_of(*ts: torch.Tensor) -> torch.device:
    build.refuse_fake("polarized_matmul", *ts)
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"polarized_matmul runs on cpu or cuda tensors, got {dev}")
    return dev


def _tensor_cores(x: torch.Tensor, mags: torch.Tensor, dev: torch.device) -> bool:
    return (x.ndim == 2 and mags.ndim == 2
            and uses_tensor_cores(x.dtype, mags.dtype, dev.type, x.shape[0], mags.shape[1]))


def polarized_matmul(x: torch.Tensor, mags: torch.Tensor, signs: torch.Tensor,
                     scale: torch.Tensor, m: int, *, gate: Optional[torch.Tensor] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[M, N] = x[M, K] @ (repeat(signs, m) * mags)[K, N] * scale[1, N], f32.

    On CUDA tensors the call takes the tensor-core kernel where
    :func:`uses_tensor_cores` says so (:func:`polarized_matmul_tc`), else
    the f32 kernel.  ``gate`` (one int32 on the card, CUDA tensors only)
    lets the launch write ``out`` only where it reads nonzero, without the
    host reading it: the kernel's blocks return at once otherwise (fragment
    compaction launches two gated products into one ``out``).
    """
    dev = _device_of(x, mags, signs, scale)
    if dev.type == "cpu":
        if gate is not None or out is not None:
            raise ValueError("gate= and out= are for CUDA tensors; on the CPU choose "
                             "with a Python if")
        return ref_polarized_matmul_fast(x, mags, signs, scale, m)
    if _tensor_cores(x, mags, dev):
        return polarized_matmul_tc(x, mags, signs, scale, m, gate=gate, out=out)
    y = _launch(x, mags, signs, scale, m, None, gate, out, tc=False)
    polarized_matmul.launches += 1
    return y


def polarized_matmul_tc(x: torch.Tensor, mags: torch.Tensor, signs: torch.Tensor,
                        scale: torch.Tensor, m: int, *, gate: Optional[torch.Tensor] = None,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The product on the tensor-core kernel: bf16 x, uint8 codes, any M and
    N (:func:`polarized_matmul` sends it M >= :data:`TC_MIN_ROWS` and N >=
    :data:`TC_MIN_COLS`); ``gate`` and ``out`` as there."""
    dev = _device_of(x, mags, signs, scale)
    if dev.type == "cpu":
        if gate is not None or out is not None:
            raise ValueError("gate= and out= are for CUDA tensors; on the CPU choose "
                             "with a Python if")
        return ref_polarized_matmul_fast(x, mags, signs, scale, m)
    y = _launch(x, mags, signs, scale, m, None, gate, out, tc=True)
    polarized_matmul_tc.launches += 1
    return y


def _check_mask(mask: torch.Tensor, x: torch.Tensor, bm: int, m: int) -> None:
    M, K = x.shape
    want = (-(-M // bm), -(-K // _KC))
    if tuple(mask.shape) != want:
        raise ValueError(f"mask {tuple(mask.shape)} is not the kernel's tiling of x "
                         f"{tuple(x.shape)}: expected {want} (tile_mask(x))")
    if m < 1 or _KC % m:
        raise ValueError(f"zero-skip masks cover K slices of {_KC} rows, which must be "
                         f"a whole number of fragments: m={m} does not divide "
                         f"{_KC}; use zero_skip='compact' for this m")
    if x.device.type == "cuda" and (mask.device != x.device or mask.dtype != torch.int32
                                    or not mask.is_contiguous()):
        raise ValueError("mask must be a contiguous int32 tensor on x's device")


def polarized_matmul_skip(x: torch.Tensor, mags: torch.Tensor, signs: torch.Tensor,
                          scale: torch.Tensor, m: int,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same product with input zero-skipping: a (row tile, K slice) of
    x that is all zero moves no weight byte and does no MAC.  ``mask`` is
    :func:`tile_mask` of x (made here when None), at the tiling of the
    kernel the call takes (:func:`uses_tensor_cores`); the result equals
    :func:`polarized_matmul`'s bit for bit, for any x."""
    dev = _device_of(x, mags, signs, scale)
    if _tensor_cores(x, mags, dev):
        return polarized_matmul_tc_skip(x, mags, signs, scale, m, mask)
    bm = tile_rows(x.shape[0])
    if mask is None:
        mask = _tile_mask(x, bm)
    _check_mask(mask, x, bm, m)
    if dev.type == "cpu":
        return ref_polarized_matmul_skip(x, mags, signs, scale, mask, m, bm, _KC)
    y = _launch(x, mags, signs, scale, m, mask, None, None, tc=False)
    polarized_matmul_skip.launches += 1
    return y


def polarized_matmul_tc_skip(x: torch.Tensor, mags: torch.Tensor, signs: torch.Tensor,
                             scale: torch.Tensor, m: int,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Input zero-skipping on the tensor-core kernel, at its tiling of 64-row
    tiles (``mask`` made here when None); equal to
    :func:`polarized_matmul_tc` bit for bit, for any x."""
    dev = _device_of(x, mags, signs, scale)
    if mask is None:
        mask = _tile_mask(x, _TC_BM)
    _check_mask(mask, x, _TC_BM, m)
    if dev.type == "cpu":
        return ref_polarized_matmul_skip(x, mags, signs, scale, mask, m, _TC_BM, _KC)
    y = _launch(x, mags, signs, scale, m, mask, None, None, tc=True)
    polarized_matmul_tc_skip.launches += 1
    return y


def _launch(x, mags, signs, scale, m, mask, gate, out, *, tc: bool) -> torch.Tensor:
    """Check the operands and launch a kernel on x's CUDA device: the
    tensor-core one (``tc``) or the f32 one."""
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
    if tc and (x.dtype != torch.bfloat16 or mags.dtype != torch.uint8):
        raise TypeError(f"the tensor-core kernel takes bf16 x and uint8 mags, got "
                        f"{x.dtype} and {mags.dtype}")
    if not tc and x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if mags.dtype not in _MAG_DTYPES:
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
    # 16-byte cp.async and TMA need whole 8-element rows of x, 16-column rows
    # of codes and signs, and aligned bases; anything else stages element by
    # element
    fast = int(K % 8 == 0 and N % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in (x, mags, signs)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: t.data_ptr() if t is not None else None
    if tc:
        args = [x.data_ptr(), mags.data_ptr(), signs.data_ptr(), scale.data_ptr(),
                ptr(mask), ptr(gate), y.data_ptr(), M, N, K, m, fast,
                tc_group(M, N, K, sms), stream]
        with torch.cuda.device(dev):
            err = _tc_entry()(*args)
        if err != 0:
            raise RuntimeError(f"polarized_matmul_tc kernel launch failed: CUDA error {err}")
        return y
    fn = _entry(x.dtype, mags.dtype)
    group, slices = decode_split(M, N, K, sms)
    tiles = -(-N // _BN) * -(-M // tile_rows(M))
    key = (dev, stream)
    work = tickets = None
    if slices > 1:
        work = torch.empty(slices * M * N, dtype=torch.float32, device=dev)
        # one buffer per stream: launches on a stream run in order, and
        # each returns its counters to zero
        tickets = _tickets(key, tiles)
    args = [x.data_ptr(), mags.data_ptr(), signs.data_ptr(), scale.data_ptr(),
            ptr(mask), ptr(gate), y.data_ptr(), ptr(work), ptr(tickets), M, N, K, m, fast]
    with torch.cuda.device(dev):
        err = fn(*args, group, stream)
    if err != 0:
        # a launch that failed may leave tickets raised: the next launch on
        # this stream starts from fresh zeros
        _TICKETS.pop(key, None)
        raise RuntimeError(f"polarized_matmul kernel launch failed: CUDA error {err}")
    return y


polarized_matmul.launches = 0
polarized_matmul_skip.launches = 0
polarized_matmul_tc.launches = 0
polarized_matmul_tc_skip.launches = 0
