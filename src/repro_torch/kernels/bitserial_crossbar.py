"""Bit-serial FORMS crossbar simulator: the hand-written CUDA kernel and its
wrapper.

For activation codes ``x`` (M, K), cell planes (C, K, N) of the magnitude
codes and fragment signs (K/m, N) it returns the accelerator's integer
result ``acc`` (M, N) int32 — per input bit and cell plane the per-fragment
column sums, clipped at the ADC ceiling, signed and shift-added — and the
per-(row, fragment) EIC (M, K/m) int32, the zero-skip observable.  The
kernel (``csrc/bitserial_crossbar.cu``) replaces the Pallas TPU kernel
``repro/kernels/bitserial_crossbar.py::_kernel``; its source says what
bounds it on the card and how the design answers that.

CPU tensors take the plain version (``ref.ref_bitserial_crossbar`` plus
``core.zeroskip.fragment_eic``), CUDA tensors the kernel, which launches or
raises.  ``bitserial_crossbar.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.zeroskip import fragment_eic
from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_bitserial_crossbar

_SOURCE = "bitserial_crossbar"
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_uint, ctypes.c_void_p])
_PLAN_ARGTYPES = [ctypes.c_int] * 7 + [ctypes.c_uint, ctypes.POINTER(ctypes.c_longlong)]


def _entry():
    lib = build.load(_SOURCE)
    fn = lib.forms_bitserial_crossbar
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _adc_max(adc_bits: Optional[int]) -> int:
    return 0xFFFFFFFF if adc_bits is None else (1 << adc_bits) - 1


def plan(M: int, N: int, K: int, C: int, *, m: int = 8, input_bits: int = 16,
         cell_bits: int = 2, adc_bits: Optional[int] = None) -> Dict[str, object]:
    """The launch :func:`bitserial_crossbar` makes with these arguments on
    the current device: its grid, threads per block, dynamic shared memory,
    the m16n8k32 MMAs it issues, the padded fragment rows and whether it
    clips (builds the kernel; card only)."""
    fn = build.load(_SOURCE).forms_bitserial_plan
    fn.argtypes, fn.restype = _PLAN_ARGTYPES, ctypes.c_int
    out = (ctypes.c_longlong * 8)()
    if fn(M, N, K, C, m, input_bits, cell_bits, _adc_max(adc_bits), out) != 0:
        raise ValueError(f"no bit-serial launch for ({M}, {K}, {N}), C={C}, m={m}")
    return {"grid": list(out[:3]), "threads": out[3], "smem_bytes": out[4], "mmas": out[5],
            "padded_m": out[6], "clips": bool(out[7])}


def bitserial_crossbar(x_codes: torch.Tensor, cell_planes: torch.Tensor,
                       signs: torch.Tensor, *, m: int = 8, input_bits: int = 16,
                       cell_bits: int = 2, adc_bits: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (acc (M, N) int32, eic (M, K/m) int32).

    ``x_codes`` holds integer codes (floats, as ``quantize_activations``
    makes them, are truncated to int32).  Each cell is read whole, as the
    reference reads it, whatever ``cell_bits`` is.  The kernel reads uint8
    cells, so on the card ``cell_planes`` must be uint8 (another dtype is
    refused, not cut to its low byte); the plain version takes any integer
    planes.
    """
    devices = {t.device for t in (x_codes, cell_planes, signs)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devices))}")
    dev = x_codes.device
    if x_codes.ndim != 2 or cell_planes.ndim != 3:
        raise ValueError(f"x_codes must be (M, K) and cell_planes (C, K, N), got "
                         f"{tuple(x_codes.shape)} and {tuple(cell_planes.shape)}")
    M, K = x_codes.shape
    C, K2, N = cell_planes.shape
    if K != K2 or m < 1 or K % m or tuple(signs.shape) != (K // m, N):
        raise ValueError(f"x {tuple(x_codes.shape)}, cells {tuple(cell_planes.shape)} and "
                         f"signs {tuple(signs.shape)} do not tile into fragments of m={m}")
    if not 1 <= input_bits <= 32:
        raise ValueError(f"input_bits={input_bits} must be in [1, 32]")
    if adc_bits is not None and not 1 <= adc_bits <= 32:
        raise ValueError(f"adc_bits={adc_bits} must be in [1, 32] or None")
    if cell_bits < 1:
        raise ValueError(f"cell_bits={cell_bits} must be at least 1")
    if dev.type == "cpu":
        acc, _ = ref_bitserial_crossbar(x_codes, cell_planes, signs, m, input_bits,
                                        cell_bits, adc_bits=adc_bits)
        return acc, fragment_eic(x_codes, m, input_bits)
    if dev.type != "cuda":
        raise ValueError(f"bitserial_crossbar runs on cpu or cuda tensors, got {dev}")

    if max(M, N, K) >= 2 ** 31 or M * input_bits >= 2 ** 31 or (N == 0 or C == 0) and M * K:
        raise ValueError(f"shape ({M}, {K}, {N}) with {C} cell planes is outside the "
                         f"kernel's range")
    if cell_planes.dtype != torch.uint8:
        raise ValueError(f"the kernel reads uint8 cells, got {cell_planes.dtype} planes")
    x32 = x_codes.to(torch.int32).contiguous()
    cells8 = cell_planes.contiguous()
    signs8 = signs.to(torch.int8).contiguous()
    acc = torch.zeros((M, N), dtype=torch.int32, device=dev)
    eic = torch.empty((M, K // m), dtype=torch.int32, device=dev)
    if M == 0 or K == 0:
        return acc, eic
    adc_max = _adc_max(adc_bits)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _entry()(x32.data_ptr(), cells8.data_ptr(), signs8.data_ptr(), acc.data_ptr(),
                       eic.data_ptr(), M, N, K, C, m, input_bits, cell_bits, adc_max, stream)
    if err != 0:
        raise RuntimeError(f"bitserial_crossbar kernel launch failed: CUDA error {err}")
    bitserial_crossbar.launches += 1
    return acc, eic


bitserial_crossbar.launches = 0
