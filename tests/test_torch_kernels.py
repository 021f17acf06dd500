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


def _case(*values, id=None):
    return pytest.param(*values, id=id or "-".join(map(str, values[:-1])))


def host_library(tmp_path, name: str, kernel):
    """``csrc/<name>.cu`` compiled with g++ against a host stand-in for the
    CUDA names (``tests/cuda_host``), its one ``<<<>>>`` launch of
    ``kernel`` (None: no such launch) run block by block on the CPU; skips
    without g++."""
    import re
    import shutil
    import subprocess

    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed")
    src = (pm.build.CSRC / f"{name}.cu").read_text()
    if kernel is not None:   # a source that launches with cudaLaunchKernelEx needs none
        src, n = re.subn(rf"({re.escape(kernel)})<<<grid, THREADS, [^,>]*, ([^>]*)>>>\(([^;]*)\);",
                         r"host_launch(grid, THREADS, [=] { \1(\3); });", src)
        assert n == 1
    (tmp_path / f"{name}.cpp").write_text(src)
    lib_path = tmp_path / f"{name}.so"
    include = pathlib.Path(__file__).parent / "cuda_host"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{include}", "-o", str(lib_path), str(tmp_path / f"{name}.cpp"), "-lpthread"],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib_path))


@pytest.fixture(scope="module")
def f32_host_lib(tmp_path_factory):
    """``csrc/polarized_matmul.cu`` under the host stand-in, compiled once
    for every case."""
    return host_library(tmp_path_factory.mktemp("polarized_matmul"), "polarized_matmul",
                        "polarized_matmul_kernel<BM, Frag, MagT, XT>")


def _f32_run(lib, x, mags, signs, scale, m, sms, mask=None, gate=None, y=None, fast=None):
    """One launch of the f32 kernel's entry for x's dtype (f32, or bf16 as
    uint16 bits) and the codes' on numpy buffers, at the wrapper's plan for
    a card of ``sms`` SMs; checks that the ticket counters come back to
    zero."""
    M, K = x.shape
    N = mags.shape[1]
    x_t = torch.bfloat16 if x.dtype == np.uint16 else torch.float32
    mag_t = torch.int32 if mags.dtype == np.int32 else torch.uint8
    fn = getattr(lib, pm._ENTRY[x_t, mag_t])
    fn.argtypes, fn.restype = pm._ARGTYPES, ctypes.c_int
    if fast is None:
        fast = int(K % 8 == 0 and N % 16 == 0)
    group, splits = pm.decode_split(M, N, K, sms)
    y = np.zeros((M, N), np.float32) if y is None else y
    work = np.zeros(splits * M * N, np.float32)
    tickets = np.zeros(-(-N // pm._BN) * -(-M // pm.tile_rows(M)), np.int32)
    ptr = lambda a: None if a is None else a.ctypes.data
    assert fn(*(a.ctypes.data for a in (x, mags, signs, scale)), ptr(mask), ptr(gate),
              y.ctypes.data, work.ctypes.data, tickets.ctypes.data, M, N, K, m, fast,
              group, None) == 0
    assert not tickets.any()
    return y


@pytest.mark.parametrize("M,K,N,m,levels,sms", [
    _case(1, 1040, 160, 8, 256, 3, id="M1-ragged-K-two-column-tiles-2-slices-a-block-3-splits"),
    _case(4, 1536, 256, 8, 256, 4, id="M4-ring-wraps-3-slices-a-block-2-splits"),
    _case(8, 776, 72, 8, 256, 2, id="M8-ragged-N-element-staging-2-splits"),
    _case(9, 528, 48, 16, 1024, 4, id="M9-two-row-tiles-int32-m16"),
    _case(4, 768, 48, 3, 256, 2, id="m3-signs-per-code"),
    _case(5, 264, 40, 4, 1024, 2, id="M5-int32-m4-element-staging"),
])
def test_cuda_source_under_host_emulation(f32_host_lib, M, K, N, m, levels, sms):
    """``csrc/polarized_matmul.cu`` compiled with g++ against a host stand-in
    for the CUDA names (cp.async done at once) and run block by block on the
    CPU, at the wrapper's plan (:func:`decode_split`): equal to the plain
    version across ring wraps, K splits, ragged K and N, both staging paths,
    int32 codes and fragment signs applied per partial or per code; and the
    bf16-x entry equals the f32 entry on the widened x bit for bit."""
    lib = f32_host_lib
    assert lib.forms_polarized_matmul_kc() == pm._KC
    x, mags, signs, scale = _mk(7, M, K, N, m, levels)
    xbits, xf = _bf16(x)
    y32 = _f32_run(lib, xf.numpy(), mags, signs, scale, m, sms)
    y16 = _f32_run(lib, xbits, mags, signs, scale, m, sms)
    assert np.array_equal(y16, y32)
    want = ref.ref_polarized_matmul_fast(xf, *_torch(mags, signs, scale), m).numpy()
    np.testing.assert_allclose(y32, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    y = _f32_run(lib, x, mags, signs, scale, m, sms)
    want = ref.ref_polarized_matmul_fast(*_torch(x, mags, signs, scale), m).numpy()
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_f32_kernel_plan():
    """:func:`decode_split` gives the grids PERF.md reports for qwen2-1.5b at
    M = 4 on 132 SMs -- the busiest SM streams as few K slices as any split
    allows, with the fewest splits -- and stays within the kernel's limit of
    32 slices a block."""
    def grid(M, K, N):
        group, splits = pm.decode_split(M, N, K, 132)
        return group, -(-N // pm._BN) * -(-M // pm.tile_rows(M)) * splits
    assert [grid(4, K, N) for K, N in ((1536, 1536), (1536, 256), (1536, 8960),
                                       (8960, 1536))] == [(1, 72), (1, 12), (2, 210), (4, 108)]
    for M in (1, 4, 8, 9, 64, 4096):
        for K in (8, 256, 8960, 10 ** 6):
            for N in (1, 256, 8960):
                group, splits = pm.decode_split(M, N, K, 132)
                assert splits == -(-(-(-K // pm._KC)) // group)
                assert 1 <= group <= 32


@pytest.mark.parametrize("M,K,N,m,levels,sms,x_dtype,dead", [
    # BM=8, two row tiles, 4 slices a block: dead slices inside one block's
    # range, and the whole range of the second block (row tile 0) dead
    (9, 1552, 48, 8, 256, 4, "f32", ((0, 1), (1, 0), (1, 2), (0, 4), (0, 5), (0, 6))),
    (9, 1552, 48, 8, 256, 4, "bf16", ((0, 1), (1, 0), (1, 2), (0, 4), (0, 5), (0, 6))),
    (3, 520, 70, 8, 1024, 64, "f32", ((0, 1),)),         # BM=4, element staging, int32
    (4, 200, 12, 8, 256, 2, "f32", ((0, 0),)),           # one slice, all dead
])
def test_skip_kernel_under_host_emulation(f32_host_lib, M, K, N, m, levels, sms, x_dtype,
                                          dead):
    """The block-skip entry of the same source, under the host stand-in: with
    whole (row tile, K slice) tiles of x zeroed, the masked launch equals the
    dense launch bit for bit, ticket counters return to zero, and a gate
    reading 0 leaves the output untouched."""
    lib = f32_host_lib
    x, mags, signs, scale = _mk(8, M, K, N, m, levels)
    bm, kc = pm.tile_rows(M), pm._KC
    for i, k in dead:
        x[i * bm:(i + 1) * bm, k * kc:(k + 1) * kc] = 0.0
    xbits, xf = _bf16(x)
    xk = xbits if x_dtype == "bf16" else x
    mask = pm.tile_mask(torch.from_numpy(x)).numpy()
    assert int(mask.size - mask.sum()) == len(dead)
    run = lambda **kw: _f32_run(lib, xk, mags, signs, scale, m, sms, **kw)

    want = run()
    got = run(mask=mask)
    assert np.array_equal(got, want)
    xp = xf if x_dtype == "bf16" else torch.from_numpy(x)
    plain = ref.ref_polarized_matmul_skip(xp, *_torch(mags, signs, scale), torch.from_numpy(mask),
                                          m, bm, kc).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-4 * np.abs(plain).max())
    closed, open_ = np.zeros(1, np.int32), np.ones(1, np.int32)
    y = np.full((M, N), 7.0, np.float32)
    assert (run(gate=closed, y=y) == 7.0).all()
    assert np.array_equal(run(gate=open_, y=y), want)


@pytest.fixture(scope="module")
def bitserial_host_lib(tmp_path_factory):
    """``csrc/bitserial_crossbar.cu`` under the host stand-in, compiled once
    for every case."""
    return host_library(tmp_path_factory.mktemp("bitserial"), "bitserial_crossbar",
                        "bitserial_crossbar_kernel<Multi, Clip>")


@pytest.mark.parametrize("M,K,N,m,input_bits,cell_bits,C,adc_bits,cell_top", [
    _case(5, 96, 40, 8, 8, 2, 4, None, None),      # 2 column tiles, ragged both
    _case(3, 80, 33, 4, 8, 2, 4, 3, None),         # ADC clipping
    _case(4, 1040, 8, 8, 16, 2, 4, None, None),    # 2 K ranges: wraps int32 on its way
    _case(2, 64, 16, 16, 4, 1, 8, 2, None),        # one-bit cells, m = 16, two plane groups
    _case(5, 96, 24, 3, 12, 2, 4, None, None, id="m3-padded-fragments-two-pair-tiles"),
    _case(2, 160, 16, 40, 8, 2, 4, None, None, id="m40-fragment-spans-chunks"),
    _case(2, 160, 16, 40, 8, 2, 4, 5, 255, id="m40-wide-cells-clipped"),
    _case(3, 128, 24, 8, 8, 2, 4, None, 255, id="cells-past-cell-bits"),
    _case(2, 64, 16, 8, 8, 4, 5, None, None, id="20-weight-bits"),
    _case(4, 128, 16, 16, 8, 2, 4, 4, None, id="m16-clipped"),
])
def test_bitserial_source_under_host_emulation(bitserial_host_lib, M, K, N, m, input_bits,
                                               cell_bits, C, adc_bits, cell_top):
    """``csrc/bitserial_crossbar.cu`` (int8 tensor cores, the m16n8k32 MMA
    emulated as a warp collective) under the host stand-in: ``acc`` and
    ``eic`` equal the plain version exactly (integers), for clipped and
    ideal ADCs, ragged tiles, several K ranges, plane groups and pair tiles,
    a result that wraps, padded fragments (m = 3), fragments that span k32
    chunks (m = 40), cells read whole past ``cell_bits`` and 20 weight
    bits."""
    from repro_torch.core.zeroskip import fragment_eic
    from repro_torch.kernels import bitserial_crossbar as bx

    lib = bitserial_host_lib
    rng = np.random.RandomState(9)
    x = rng.randint(0, 2 ** input_bits, (M, K)).astype(np.int32)
    x[:, :m] = 0                                     # a dead fragment
    x[0, m:2 * m] = 1                                # an EIC of 1
    x[-1, 2 * m] = 2 ** input_bits + 5               # a bit above the streamed ones
    x[-1, 3 * m] = -7                                # two's-complement bits
    top = 2 ** cell_bits - 1 if cell_top is None else cell_top
    cells = rng.randint(0, top + 1, (C, K, N)).astype(np.uint8)
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


def _bf16(x):
    """x rounded to bf16: (its bits as uint16 for the kernel, its f32 value)."""
    xb = torch.from_numpy(x).to(torch.bfloat16)
    return xb.view(torch.int16).numpy().view(np.uint16).copy(), xb.float()


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("mag_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_tensor_core_route_is_cuda_bf16_uint8_at_prefill_rows(x_dtype, mag_dtype, device_type):
    """The route as a pure function of dtypes, device type, M and N: the
    tensor-core kernel exactly for CUDA + bf16 x + uint8 codes + M >=
    TC_MIN_ROWS + N >= TC_MIN_COLS (the mLSTM's wi/wf at N = 4, 2 and 1 take
    the f32 kernel at every M), and its 64-row tiling for the zero-skip mask
    then, also through ``tile_mask``."""
    for M in (1, 4, pm.TC_MIN_ROWS - 1, pm.TC_MIN_ROWS, 64, 257):
        for N in (1, 2, 4, pm.TC_MIN_COLS - 1, pm.TC_MIN_COLS, 256, 8960):
            want = (device_type == "cuda" and x_dtype == torch.bfloat16
                    and mag_dtype == torch.uint8 and M >= pm.TC_MIN_ROWS
                    and N >= pm.TC_MIN_COLS)
            assert pm.uses_tensor_cores(x_dtype, mag_dtype, device_type, M, N) is want
            assert pm.tile_rows(M, want) == (64 if want else 4 if M <= 4 else 8)
    if device_type == "cpu":
        x = torch.ones((70, 512), dtype=x_dtype)
        assert pm.tile_mask(x, mag_dtype, N=1).shape == (9, 2)


def test_tensor_core_source_and_grid():
    """The tensor-core source names the TPU kernels it replaces, its PTX
    (wgmma on register A, TMA into an mbarrier ring, a cluster's sum over
    distributed shared memory) and its C entry; the wrapper's clusters give
    the grids PERF.md reports for qwen2-1.5b at M = 64 on 132 SMs, and token
    tiles of 8, 16, 32 or 64 rows."""
    src = (pm.build.CSRC / "polarized_matmul_tc.cu").read_text()
    assert "src/repro/kernels/polarized_matmul.py:45" in src
    assert "src/repro/kernels/polarized_matmul.py:68" in src
    assert f"int {pm._TC_ENTRY}(" in src
    for ptx in ("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                "cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity", "mapa.shared::cluster",
                "barrier.cluster.arrive", "cudaLaunchAttributeClusterDimension"):
        assert ptx in src
    assert "atomicAdd(" not in src and "mma.sync.aligned" not in src

    def grid(M, K, N):
        return -(-N // pm._TC_BN) * -(-M // pm.tc_tokens(M)) * pm.tc_group(M, N, K, 132)
    assert [grid(64, K, N) for K, N in ((1536, 1536), (1536, 256), (1536, 8960),
                                         (8960, 1536))] == [96, 16, 70, 96]
    assert [pm.tc_tokens(M) for M in (1, 8, 9, 16, 20, 32, 33, 64, 65, 1024)] == [
        8, 8, 16, 16, 32, 32, 64, 64, 64, 64]
    assert all(1 <= pm.tc_group(M, N, K, 132) <= min(pm._TC_MAX_CLUSTER, -(-K // 64))
               for M in (8, 64, 4096) for N in (1, 256, 8960) for K in (8, 256, 8960, 10 ** 6))


def test_cpu_bf16_activations_give_the_f32_paths_bits():
    """On the CPU, bf16 x through forms.apply and every kernel wrapper gives
    the same bits as x widened to f32 (the widening happens before the
    plain product), and no wrapper counts a launch."""
    from repro_torch import forms

    rng = np.random.RandomState(13)
    w = torch.from_numpy(rng.randn(72, 40).astype(np.float32))
    leaf, _ = forms.from_dense(w, FormsSpec(m=8, bits=8))
    xb = torch.from_numpy(rng.randn(3, 24, 72).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(forms.apply(leaf, xb), forms.apply(leaf, xb.float()))
    for zs in ("block", "compact"):
        spec = FormsSpec(m=8, bits=8, zero_skip=zs)
        assert torch.equal(forms.apply(leaf, xb, spec), forms.apply(leaf, xb.float(), spec))
    x2 = xb.reshape(-1, 72)
    counts = {f: f.launches for f in (pm.polarized_matmul, pm.polarized_matmul_skip,
                                      pm.polarized_matmul_tc, pm.polarized_matmul_tc_skip)}
    args = (leaf.mags, leaf.signs, leaf.scale, 8)
    want = ref.ref_polarized_matmul_fast(x2.float(), *args)
    for fn in (pm.polarized_matmul, pm.polarized_matmul_tc, pm.polarized_matmul_skip):
        assert torch.equal(fn(x2, *args), want)
    assert torch.equal(pm.polarized_matmul_tc_skip(x2, *args),
                       ref.ref_polarized_matmul_skip(x2.float(), *args[:3], None, 8, 64, 256))
    assert all(f.launches == n for f, n in counts.items())
