"""The tensor-core polarized matmul (``csrc/polarized_matmul_tc.cu``) under
the host emulation of its PTX.

The source is compiled once with g++ against ``tests/cuda_host`` (mbarriers,
TMA tile loads in the 128-byte swizzle, ``wgmma`` as a warpgroup collective,
a cluster's blocks run together with distributed shared memory) and every
launch runs block by block on the CPU, against the plain version on the
bf16-rounded x.  The emulation writes and reads the swizzle by one formula,
so only the card shows that the layouts are the hardware's
(``chip_smoke.py``'s kernel_tc phase and ``tests/test_torch_gpu.py``).
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import polarized_matmul as pm
from repro_torch.kernels import ref
from test_torch_kernels import _bf16, _mk, _torch, host_library


@pytest.fixture(scope="module")
def tc_fn(tmp_path_factory):
    """The tensor-core entry of ``csrc/polarized_matmul_tc.cu`` under the
    host stand-in, compiled once for every case (it launches with
    ``cudaLaunchKernelEx``, which the stand-in runs itself)."""
    lib = host_library(tmp_path_factory.mktemp("polarized_matmul_tc"), "polarized_matmul_tc",
                       None)
    assert tuple(lib.forms_polarized_matmul_tc_tile(i) for i in range(4)) == (
        pm._TC_BM, pm._TC_BN, pm._KC, pm._TC_MAX_CLUSTER)
    return _tc_fn(lib)


def _tc_fn(lib):
    fn = getattr(lib, pm._TC_ENTRY)
    fn.argtypes, fn.restype = pm._TC_ARGTYPES, ctypes.c_int
    return fn


def _tc_run(fn, xbits, mags, signs, scale, m, mask=None, gate=None, y=None, fast=None,
            cluster=1):
    """One launch of the tensor-core entry on numpy buffers, the K range of
    each output tile split over a cluster of ``cluster`` blocks."""
    M, K = xbits.shape
    N = mags.shape[1]
    if fast is None:
        fast = int(K % 8 == 0 and N % 16 == 0)
    y = np.zeros((M, N), np.float32) if y is None else y
    ptr = lambda a: None if a is None else a.ctypes.data
    assert fn(*(a.ctypes.data for a in (xbits, mags, signs, scale)), ptr(mask), ptr(gate),
              y.ctypes.data, M, N, K, m, fast, cluster, None) == 0
    return y


@pytest.mark.parametrize("M,K,N,m,fast,cluster", [
    (20, 264, 72, 8, 0, 1),     # ragged M, N (not 16-aligned): plain loads, 5 stages
    (20, 264, 80, 8, 1, 1),     # TMA, a partial column tile, 32 tokens for 20 rows
    (70, 512, 48, 16, 1, 1),    # two row tiles, m = 16
    (5, 268, 40, 4, 0, 2),      # K % 8 != 0, 8 tokens for 5 rows, m = 4, a cluster of 2
    (20, 774, 32, 3, 0, 2),     # m = 3: fragments straddle stages; a cluster of 2
    (9, 520, 70, 8, 0, 2),      # N % 4 != 0: the scalar epilogue; a cluster of 2
    (13, 320, 256, 8, 1, 1),    # M not a multiple of 8 (16 tokens), two column tiles
    (130, 256, 64, 8, 1, 2),    # three row tiles, the last of 2 rows, a cluster of 2
    (20, 774, 32, 3, 0, 4),     # m = 3 over a cluster of 4 (ranks of 3 stages)
    (12, 1032, 40, 3, 0, 4),    # m = 3, a cluster of 4 with a ragged last stage
    (16, 1040, 32, 8, 1, 1),    # a ring of 13 stages for 17: the ring refills
    (64, 1024, 128, 8, 1, 4),   # TMA over a cluster of 4, 64 tokens
    (16, 128, 24, 8, 0, 1),     # N % 16 != 0 on the plain-load path
    (16, 192, 32, 1, 1, 2),     # m = 1: 64 sign rows a stage by TMA
    (8, 512, 32, 128, 1, 2),    # m = 128 does not divide a stage: plain loads
])
def test_tc_source_under_host_emulation(tc_fn, M, K, N, m, fast, cluster):
    """``csrc/polarized_matmul_tc.cu`` compiled with g++ against the host
    stand-in (mbarriers, TMA tile loads in the 128-byte swizzle, wgmma as a
    warpgroup collective in the PTX fragment layout, clusters): equal to the
    plain version on the bf16-rounded x, by TMA and by plain loads, with
    ragged edges, padded token tiles, a refilling ring and the K range over
    clusters of 1, 2 and 4 blocks."""
    x, mags, signs, scale = _mk(11, M, K, N, m)
    xbits, xf = _bf16(x)
    y = _tc_run(tc_fn, xbits, mags, signs, scale, m, fast=fast, cluster=cluster)
    want = ref.ref_polarized_matmul_fast(xf, *_torch(mags, signs, scale), m).numpy()
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_tc_skip_and_gate_under_host_emulation(tc_fn):
    """The tensor-core source's mask and gate: with whole (64-row tile,
    K slice) tiles of x zeroed, the masked launch equals the dense launch
    bit for bit (and the plain tile-skip sum), by TMA and by plain loads and
    over clusters of 1, 2 and 4, where whole ranks are dead and join the sum
    with zeros; a second launch gives the same bits; a gate reading 0 leaves
    the output untouched, one reading 1 writes the dense result."""
    fn = tc_fn
    M, K, N, m = 70, 776, 32, 8
    x, mags, signs, scale = _mk(12, M, K, N, m)
    bm, kc = pm._TC_BM, pm._KC
    for i, k in ((0, 1), (1, 0), (1, 3)):
        x[i * bm:(i + 1) * bm, k * kc:(k + 1) * kc] = 0.0
    xbits, xf = _bf16(x)
    mask = pm._tile_mask(xf, bm).numpy()
    assert mask.shape == (2, 4) and int(mask.size - mask.sum()) == 3
    plain = ref.ref_polarized_matmul_skip(xf, *_torch(mags, signs, scale),
                                          torch.from_numpy(mask), m, bm, kc).numpy()
    run = lambda **kw: _tc_run(fn, xbits, mags, signs, scale, m, **kw)
    dense = run()
    np.testing.assert_allclose(dense, plain, rtol=1e-5, atol=1e-5 * np.abs(plain).max())
    assert np.array_equal(run(), dense)
    # a cluster of 4 over 13 stages gives ranks of 4, 4, 4 and 1: rank 1 of
    # row tile 0 and ranks 0 and 3 of row tile 1 see only dead tiles
    for fast in (1, 0):
        for cluster in (1, 2, 4):
            want = run(fast=fast, cluster=cluster)
            assert np.array_equal(run(mask=mask, fast=fast, cluster=cluster), want)
            np.testing.assert_allclose(want, plain, rtol=1e-5, atol=1e-5 * np.abs(plain).max())
    closed, open_ = np.zeros(1, np.int32), np.ones(1, np.int32)
    y = np.full((M, N), 7.0, np.float32)
    assert (run(gate=closed, y=y, cluster=2) == 7.0).all()
    assert np.array_equal(run(gate=open_, y=y), dense)
