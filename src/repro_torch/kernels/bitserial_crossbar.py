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
from typing import Optional, Tuple

import torch

from repro_torch.core.zeroskip import fragment_eic
from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_bitserial_crossbar

_SOURCE = "bitserial_crossbar"
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_uint, ctypes.c_void_p])
# the kernel packs a fragment's m inputs, and a magnitude's weight bits, into
# 32-bit masks: m <= 32 and cells * cell_bits <= 16
_MAX_M, _MAX_WBITS = 32, 16


def _entry():
    lib = build.load(_SOURCE)
    fn = lib.forms_bitserial_crossbar
    if fn.argtypes is None:
        if lib.forms_bitserial_max_m() != _MAX_M:
            raise RuntimeError("csrc/bitserial_crossbar.cu and its wrapper disagree "
                               "on the largest fragment")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def bitserial_crossbar(x_codes: torch.Tensor, cell_planes: torch.Tensor,
                       signs: torch.Tensor, *, m: int = 8, input_bits: int = 16,
                       cell_bits: int = 2, adc_bits: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (acc (M, N) int32, eic (M, K/m) int32).

    ``x_codes`` holds integer codes (floats, as ``quantize_activations``
    makes them, are truncated to int32); ``cell_planes`` holds
    ``cell_bits``-bit values (as ``slice_to_cells`` makes them).
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
    if dev.type == "cpu":
        acc, _ = ref_bitserial_crossbar(x_codes, cell_planes, signs, m, input_bits,
                                        cell_bits, adc_bits=adc_bits)
        return acc, fragment_eic(x_codes, m, input_bits)
    if dev.type != "cuda":
        raise ValueError(f"bitserial_crossbar runs on cpu or cuda tensors, got {dev}")

    if m > _MAX_M:
        raise ValueError(f"the bit-serial kernel packs a fragment into one 32-bit "
                         f"mask: m={m} > {_MAX_M}")
    if not 1 <= cell_bits <= 8 or C * cell_bits > _MAX_WBITS:
        raise ValueError(f"{C} cells of {cell_bits} bits exceed the kernel's "
                         f"{_MAX_WBITS} weight bits")
    if max(M, N, K) >= 2 ** 31 or N == 0 and M * K > 0:
        raise ValueError(f"shape ({M}, {K}, {N}) is outside the kernel's range")
    x32 = x_codes.to(torch.int32).contiguous()
    cells8 = cell_planes.to(torch.uint8).contiguous()
    signs8 = signs.to(torch.int8).contiguous()
    acc = torch.zeros((M, N), dtype=torch.int32, device=dev)
    eic = torch.empty((M, K // m), dtype=torch.int32, device=dev)
    if M == 0 or K == 0:
        return acc, eic
    adc_max = 0xFFFFFFFF if adc_bits is None else (1 << adc_bits) - 1
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _entry()(x32.data_ptr(), cells8.data_ptr(), signs8.data_ptr(), acc.data_ptr(),
                       eic.data_ptr(), M, N, K, C, m, input_bits, cell_bits, adc_max, stream)
    if err != 0:
        raise RuntimeError(f"bitserial_crossbar kernel launch failed: CUDA error {err}")
    bitserial_crossbar.launches += 1
    return acc, eic


bitserial_crossbar.launches = 0
