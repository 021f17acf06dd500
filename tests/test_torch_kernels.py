"""PyTorch port vs the JAX package: the polarized matmul.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX **Pallas kernel in interpret mode** at the shapes and
tolerances of ``tests/test_kernels.py``.  The CUDA kernel itself runs only on
a card (``tests/test_torch_gpu.py`` holds it against the plain version
there); here its source is compiled against a host stand-in for the CUDA
names and checked for its logic only.
"""
import ctypes
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.polarized_matmul import polarized_matmul as pallas_matmul
from repro_torch.forms import FormsSpec
from repro_torch.kernels import ops, ref
from repro_torch.kernels import polarized_matmul as pm

def _mk(seed, M, K, N, m, levels=256):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    mags = rng.randint(0, levels, (K, N)).astype(np.uint8 if levels <= 256 else np.int32)
    signs = np.where(rng.rand(K // m, N) < 0.5, 1, -1).astype(np.int8)
    scale = np.full((1, N), 0.0123, np.float32)
    return x, mags, signs, scale


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("M,K,N,m,bm,bn,bk", [
    (16, 64, 32, 8, 16, 32, 32),
    (8, 32, 16, 4, 8, 16, 16),
    (32, 128, 64, 16, 16, 32, 64),
    (4, 16, 8, 8, 4, 8, 16),
])
def test_plain_matches_pallas_interpret(M, K, N, m, bm, bn, bk):
    x, mags, signs, scale = _mk(0, M, K, N, m)
    want = np.asarray(pallas_matmul(jnp.asarray(x), jnp.asarray(mags), jnp.asarray(signs),
                                    jnp.asarray(scale), m=m, bm=bm, bn=bn, bk=bk,
                                    interpret=True))
    tx, tm, ts, tsc = _torch(x, mags, signs, scale)
    for fn in (ref.ref_polarized_matmul_fast, ref.ref_polarized_matmul, pm.polarized_matmul):
        np.testing.assert_allclose(fn(tx, tm, ts, tsc, m).numpy(), want, rtol=1e-5, atol=1e-4)


def test_plain_matches_pallas_interpret_bf16_activations():
    x, mags, signs, scale = _mk(1, 16, 64, 32, 8)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(pallas_matmul(xb, jnp.asarray(mags), jnp.asarray(signs),
                                    jnp.asarray(scale), m=8, bm=16, bn=32, bk=32,
                                    interpret=True))
    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = pm.polarized_matmul(tx, *_torch(mags, signs, scale), 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-1)


@pytest.mark.parametrize("M,K,N,m,levels", [(7, 24, 9, 8, 256), (5, 40, 12, 4, 1024)])
def test_ops_wrapper_odd_shapes_match_reference_ops(M, K, N, m, levels):
    """Odd shapes (the reference pads them to tiles; the port's kernel
    masks edges itself) and int32 magnitude codes (bits > 8)."""
    x, mags, signs, scale = _mk(2, M, K, N, m, levels)
    want = np.asarray(jops.polarized_matmul(jnp.asarray(x), jnp.asarray(mags),
                                            jnp.asarray(signs), jnp.asarray(scale),
                                            m=m, prefer_ref=False))
    got = ops.polarized_matmul(*_torch(x, mags, signs, scale), m=m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_geometry_errors_raise():
    x, mags, signs, scale = _torch(*_mk(3, 4, 24, 8, 8))
    with pytest.raises(ValueError, match="do not tile into fragments"):
        ops.polarized_matmul(x[:, :20], mags[:20], signs, scale, m=8)
    with pytest.raises(ValueError, match="one row per fragment"):
        ops.polarized_matmul(x, mags, signs[:2], scale, m=8)
    with pytest.raises(ValueError, match="disagree on K"):
        ops.polarized_matmul(x[:, :16], mags, signs, scale, m=8)
    with pytest.raises(ValueError, match="zero_skip must be one of"):
        ops.polarized_matmul(x, mags, signs, scale, m=8, zero_skip="banana")
    with pytest.raises(ValueError, match="whole number of fragments"):
        ops.polarized_matmul(x[:, :21], mags[:21], torch.ones(7, 8, dtype=torch.int8), scale,
                             m=3, zero_skip="block")


def test_device_picks_the_route():
    """CPU tensors run the plain version without touching the launch count;
    tensors of any other device than CPU or CUDA are refused, and so are
    operands on mixed devices."""
    x, mags, signs, scale = _torch(*_mk(4, 4, 16, 8, 8))
    before = pm.polarized_matmul.launches
    pm.polarized_matmul(x, mags, signs, scale, 8)
    assert pm.polarized_matmul.launches == before
    meta = [t.to("meta") for t in (x, mags, signs, scale)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        pm.polarized_matmul(*meta, 8)
    with pytest.raises(ValueError, match="different devices"):
        pm.polarized_matmul(meta[0], mags, signs, scale, 8)


def test_sign_conversion_accepts_only_unit_floats():
    s = torch.tensor([[1.0, -1.0], [-1.0, 1.0]])
    assert pm._int8_signs(s).dtype == torch.int8
    assert pm._int8_signs(s.to(torch.int8)).dtype == torch.int8
    with pytest.raises(TypeError):
        pm._int8_signs(torch.tensor([[0.5, -1.0]]))
    with pytest.raises(TypeError):
        pm._int8_signs(torch.tensor([[1, -1]], dtype=torch.int32))


def test_kernel_source_carries_its_note_and_c_interface():
    src = (pm.build.CSRC / "polarized_matmul.cu").read_text()
    assert "src/repro/kernels/polarized_matmul.py::_kernel" in src
    for entry in pm._ENTRY.values():
        assert f"int {entry}(" in src
    assert "compute_90a,code=sm_90a" in " ".join(pm.build.NVCC_FLAGS)
    assert pm.build.library_path("polarized_matmul").parent == pm.build.BUILD_DIR


def host_library(tmp_path, name: str, kernel: str):
    """``csrc/<name>.cu`` compiled with g++ against a host stand-in for the
    CUDA names (``tests/cuda_host``), its one launch of ``kernel`` run block
    by block on the CPU; skips without g++."""
    import re
    import shutil
    import subprocess

    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed")
    src = (pm.build.CSRC / f"{name}.cu").read_text()
    src, n = re.subn(rf"({re.escape(kernel)})<<<grid, THREADS, 0, ([^>]*)>>>\(([^;]*)\);",
                     r"host_launch(grid, THREADS, [=] { \1(\3); });", src)
    assert n == 1
    (tmp_path / f"{name}.cpp").write_text(src)
    lib_path = tmp_path / f"{name}.so"
    include = pathlib.Path(__file__).parent / "cuda_host"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{include}", "-o", str(lib_path), str(tmp_path / f"{name}.cpp"), "-lpthread"],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib_path))


def test_cuda_source_under_host_emulation(tmp_path):
    """The kernel source itself, compiled with g++ against a host stand-in
    for the CUDA names (``tests/cuda_host``) and run block by block on the
    CPU, matches the plain version: its tiling, masks, vector and scalar
    paths, K slices and ticketed slice sum (tickets back at zero after)."""
    lib = host_library(tmp_path, "polarized_matmul", "polarized_matmul_kernel<BM, Fast, MagT>")
    kc = lib.forms_polarized_matmul_kc()
    assert kc == pm._KC
    # the vector path at BM=8 (uint8), the masked scalar path at BM=4 with
    # ragged N and int32 codes; both cut K into slices
    for M, K, N, m, levels, fast in [(9, 520, 36, 4, 256, 1), (3, 272, 70, 8, 1024, 0)]:
        x, mags, signs, scale = _mk(7, M, K, N, m, levels)
        bm, slices = (4 if M <= 4 else 8), -(-K // kc)
        y = np.zeros((M, N), np.float32)
        work = np.zeros(slices * M * N, np.float32)
        tickets = np.zeros(-(-N // pm._BN) * -(-M // bm), np.int32)
        fn = getattr(lib, pm._ENTRY[torch.int32 if levels > 256 else torch.uint8])
        fn.argtypes, fn.restype = pm._ARGTYPES, ctypes.c_int
        assert fn(*(a.ctypes.data for a in (x, mags, signs, scale)), None, None,
                  *(a.ctypes.data for a in (y, work, tickets)), M, N, K, m, fast, None) == 0
        want = ref.ref_polarized_matmul_fast(*_torch(x, mags, signs, scale), m).numpy()
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-4 * np.abs(want).max())
        assert not tickets.any()


@pytest.mark.parametrize("M,K,N,m,levels,fast,dead", [
    (9, 776, 36, 4, 256, 1, ((0, 1), (1, 0), (1, 2))),   # BM=8, vector loads, 2x4 tiles
    (3, 520, 70, 8, 1024, 0, ((0, 1),)),                 # BM=4, scalar loads
    (4, 200, 12, 8, 256, 1, ((0, 0),)),                  # one slice, all dead
])
def test_skip_kernel_under_host_emulation(tmp_path, M, K, N, m, levels, fast, dead):
    """The block-skip entry of the same source, under the host stand-in: with
    whole (row tile, K slice) tiles of x zeroed, the masked launch equals the
    dense launch bit for bit, ticket counters return to zero, and a gate
    reading 0 leaves the output untouched."""
    lib = host_library(tmp_path, "polarized_matmul", "polarized_matmul_kernel<BM, Fast, MagT>")
    x, mags, signs, scale = _mk(8, M, K, N, m, levels)
    bm, kc = pm.tile_rows(M), pm._KC
    for i, k in dead:
        x[i * bm:(i + 1) * bm, k * kc:(k + 1) * kc] = 0.0
    mask = pm.tile_mask(torch.from_numpy(x)).numpy()
    assert int(mask.size - mask.sum()) == len(dead)
    slices = -(-K // kc)
    mag_t = torch.int32 if levels > 256 else torch.uint8
    fn = getattr(lib, pm._ENTRY[mag_t])
    fn.argtypes, fn.restype = pm._ARGTYPES, ctypes.c_int

    def run(mask, gate, y=None):
        y = np.zeros((M, N), np.float32) if y is None else y
        work = np.zeros(slices * M * N, np.float32)
        tickets = np.zeros(-(-N // pm._BN) * -(-M // bm), np.int32)
        ptrs = [a.ctypes.data for a in (x, mags, signs, scale)]
        assert fn(*ptrs, mask, gate, y.ctypes.data, work.ctypes.data, tickets.ctypes.data,
                  M, N, K, m, fast, None) == 0
        assert not tickets.any()
        return y

    want = run(None, None)
    got = run(mask.ctypes.data, None)
    assert np.array_equal(got, want)
    plain = ref.ref_polarized_matmul_skip(*_torch(x, mags, signs, scale), torch.from_numpy(mask),
                                          m, bm, kc).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-4 * np.abs(plain).max())
    closed, open_ = np.zeros(1, np.int32), np.ones(1, np.int32)
    y = np.full((M, N), 7.0, np.float32)
    assert (run(None, closed.ctypes.data, y=y) == 7.0).all()
    assert np.array_equal(run(None, open_.ctypes.data, y=y), want)


@pytest.mark.parametrize("M,K,N,m,input_bits,cell_bits,C,adc_bits", [
    (5, 96, 40, 8, 8, 2, 4, None),     # 2 row tiles, 2 column tiles, ragged both
    (3, 80, 33, 4, 8, 2, 4, 3),        # ADC clipping
    (4, 1040, 8, 8, 16, 2, 4, None),   # 5 K ranges: wraps int32 on its way
    (2, 64, 16, 16, 4, 1, 8, 2),       # one-bit cells, m = 16
])
def test_bitserial_source_under_host_emulation(tmp_path, M, K, N, m, input_bits, cell_bits,
                                               C, adc_bits):
    """``csrc/bitserial_crossbar.cu`` under the host stand-in: ``acc`` and
    ``eic`` equal the plain version exactly (integers), for clipped and
    ideal ADCs, ragged tiles, several K ranges and a result that wraps."""
    from repro_torch.core.zeroskip import fragment_eic
    from repro_torch.kernels import bitserial_crossbar as bx

    lib = host_library(tmp_path, "bitserial_crossbar", "bitserial_crossbar_kernel")
    assert lib.forms_bitserial_max_m() == bx._MAX_M
    rng = np.random.RandomState(9)
    x = rng.randint(0, 2 ** input_bits, (M, K)).astype(np.int32)
    x[:, :m] = 0                                     # a dead fragment
    x[0, m:2 * m] = 1                                # an EIC of 1
    x[-1, 2 * m] = 2 ** input_bits + 5               # a bit above the streamed ones
    x[-1, 3 * m] = -7                                # two's-complement bits
    cells = rng.randint(0, 2 ** cell_bits, (C, K, N)).astype(np.uint8)
    signs = np.where(rng.rand(K // m, N) < 0.5, 1, -1).astype(np.int8)
    acc = np.zeros((M, N), np.int32)
    eic = np.full((M, K // m), -1, np.int32)
    fn = lib.forms_bitserial_crossbar
    fn.argtypes, fn.restype = bx._ARGTYPES, ctypes.c_int
    adc_max = 0xFFFFFFFF if adc_bits is None else (1 << adc_bits) - 1
    assert fn(*(a.ctypes.data for a in (x, cells, signs, acc, eic)), M, N, K, C, m,
              input_bits, cell_bits, adc_max, None) == 0
    tx, tc, ts = _torch(x, cells, signs)
    want, _ = ref.ref_bitserial_crossbar(tx, tc, ts, m, input_bits, cell_bits, adc_bits)
    np.testing.assert_array_equal(acc, want.numpy())
    np.testing.assert_array_equal(eic, fragment_eic(tx, m, input_bits).numpy())
