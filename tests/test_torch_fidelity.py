"""PyTorch port vs the JAX package: the bit-serial fidelity path.

Activation quantization and cell slicing, the EIC bookkeeping of
``core.zeroskip``, the plain bit-serial crossbar against the reference's
Pallas kernel (interpret mode) and its oracle, and ``apply_simulated`` on a
compressed leaf.  Integer results are held to equality; inputs come from
numpy with a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import forms as jforms
from repro.core import quantization as JQ
from repro.core import zeroskip as JZ
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bitserial_crossbar import bitserial_crossbar as pallas_bitserial
from repro_torch import forms as tforms
from repro_torch.core import quantization as TQ
from repro_torch.core import zeroskip as TZ
from repro_torch.kernels import bitserial_crossbar as bx
from repro_torch.kernels import ops, ref

from torch_parity_util import shared_codes


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("input_bits", [1, 4, 8, 16, 32])
def test_effective_bits_and_eic_equal_reference(input_bits):
    """Bits at and above ``input_bits`` and negative int32 codes included,
    as ``tests/test_properties.py`` draws them."""
    codes = np.random.RandomState(input_bits).randint(-(2 ** 20), 2 ** 20, (4, 61)).astype(np.int32)
    codes[0, :9] = 0
    tc, jc = torch.from_numpy(codes), jnp.asarray(codes)
    _eq(TZ.effective_bits(tc, input_bits), JZ.effective_bits(jc, input_bits))
    for m in (1, 4, 8):     # 61 pads to whole fragments
        _eq(TZ.fragment_eic(tc, m, input_bits), JZ.fragment_eic(jc, m, input_bits))
        for skip in (True, False):
            got = TZ.layer_cycles(tc, m, input_bits, zero_skip=skip)
            assert got == JZ.layer_cycles(jc, m, input_bits, zero_skip=skip)
            assert isinstance(got, np.int64)
    with pytest.raises(ValueError):
        TZ.effective_bits(tc, 33)


def test_eic_stats_equal_reference():
    codes = np.random.RandomState(1).randint(0, 2 ** 16, (8, 64)).astype(np.int32)
    codes[:, ::3] = 0
    got = TZ.eic_stats(torch.from_numpy(codes), 4, 16)
    want = JZ.eic_stats(jnp.asarray(codes), 4, 16)
    assert got.mean_eic == want.mean_eic and got.savings == want.savings
    np.testing.assert_array_equal(got.histogram, want.histogram)
    assert TZ.speedup_from_skipping(got) == JZ.speedup_from_skipping(want)


def test_quantization_helpers_equal_reference():
    rng = np.random.RandomState(2)
    x = (rng.randn(5, 24) * 3).astype(np.float32)
    for bits in (8, 16):
        codes, scale = TQ.quantize_activations(torch.from_numpy(x), bits)
        jcodes, jscale = JQ.quantize_activations(jnp.asarray(x), bits)
        _eq(codes, jcodes)
        _eq(scale, jscale)
        assert codes.dtype == torch.float32
    mags = rng.randint(0, 256, (24, 7)).astype(np.int32)
    for spec in (JQ.QuantSpec(bits=8), JQ.QuantSpec(bits=6, cell_bits=3)):
        tspec = TQ.QuantSpec(bits=spec.bits, cell_bits=spec.cell_bits)
        m = mags % (1 << spec.bits)
        planes = TQ.slice_to_cells(torch.from_numpy(m), tspec)
        _eq(planes, JQ.slice_to_cells(jnp.asarray(m), spec))
        _eq(TQ.cells_to_codes(planes, tspec), m)
    xc = rng.randint(0, 256, (3, 10)).astype(np.int32)
    _eq(TQ.input_bit_planes(torch.from_numpy(xc), 8), JQ.input_bit_planes(jnp.asarray(xc), 8))


def _crossbar_inputs(seed, M, K, N, m, input_bits):
    rng = np.random.RandomState(seed)
    xc = rng.randint(0, 2 ** input_bits, (M, K)).astype(np.int32)
    xc[:, :m] = 0
    mcodes = rng.randint(0, 256, (K, N)).astype(np.int32)
    signs = np.where(rng.rand(K // m, N) < 0.5, 1, -1).astype(np.int32)
    cells = np.stack([(mcodes >> (2 * c)) & 3 for c in range(4)])
    return xc, mcodes, cells, signs


@pytest.mark.parametrize("adc_bits", [None, 3])
@pytest.mark.parametrize("input_bits", [4, 8])
@pytest.mark.parametrize("m", [4, 8])
def test_bitserial_plain_equals_pallas_and_oracle(m, input_bits, adc_bits):
    M, K, N = 8, 32, 16
    xc, _, cells, signs = _crossbar_inputs(3, M, K, N, m, input_bits)
    tx, tcl, ts = map(torch.from_numpy, (xc, cells, signs))
    acc, cycles = ref.ref_bitserial_crossbar(tx, tcl, ts, m, input_bits, 2, adc_bits)
    jacc, jcycles = jref.ref_bitserial_crossbar(*map(jnp.asarray, (xc, cells, signs)), m,
                                                input_bits, 2, adc_bits=adc_bits)
    _eq(acc, jacc)
    assert int(cycles) == int(jcycles)
    pacc, peic = pallas_bitserial(*map(jnp.asarray, (xc, cells, signs)), m=m,
                                  input_bits=input_bits, cell_bits=2, adc_bits=adc_bits,
                                  bm=8, bn=16, interpret=True)
    _eq(acc, pacc)
    got_acc, got_eic = ops.bitserial_crossbar(tx, tcl, ts, m=m, input_bits=input_bits,
                                              adc_bits=adc_bits)
    _eq(got_acc, pacc)
    _eq(got_eic, peic)


@pytest.mark.parametrize("m,K,C,cell_bits,cell_top,adc_bits", [
    (40, 80, 4, 2, 3, None),      # a fragment past 32 inputs
    (40, 80, 4, 2, 3, 4),
    (8, 32, 4, 2, 255, None),     # cells read whole, past 2^cell_bits - 1
    (8, 32, 5, 4, 15, 5),         # 20 weight bits
])
def test_bitserial_plain_equals_pallas_wide_fragments_and_cells(m, K, C, cell_bits, cell_top,
                                                                adc_bits):
    """Fragments of more than 32 inputs, cells read whole past
    2^cell_bits - 1 and 20 weight bits: the plain version (the CPU route of
    the wrapper) equals the reference's Pallas kernel in interpret mode and
    its oracle, acc and eic."""
    M, N, input_bits = 8, 16, 8
    rng = np.random.RandomState(11)
    xc = rng.randint(0, 2 ** input_bits, (M, K)).astype(np.int32)
    xc[:, :m] = 0
    cells = rng.randint(0, cell_top + 1, (C, K, N)).astype(np.int32)
    signs = np.where(rng.rand(K // m, N) < 0.5, 1, -1).astype(np.int32)
    jx, jc, js = map(jnp.asarray, (xc, cells, signs))
    pacc, peic = pallas_bitserial(jx, jc, js, m=m, input_bits=input_bits, cell_bits=cell_bits,
                                  adc_bits=adc_bits, bm=8, bn=16, interpret=True)
    jacc, _ = jref.ref_bitserial_crossbar(jx, jc, js, m, input_bits, cell_bits,
                                          adc_bits=adc_bits)
    _eq(torch.from_numpy(np.asarray(pacc)), jacc)
    acc, eic = ops.bitserial_crossbar(*map(torch.from_numpy, (xc, cells, signs)), m=m,
                                      input_bits=input_bits, cell_bits=cell_bits,
                                      adc_bits=adc_bits)
    _eq(acc, pacc)
    _eq(eic, peic)
    if adc_bits is not None:     # the ADC clips in these cases
        ideal, _ = ops.bitserial_crossbar(*map(torch.from_numpy, (xc, cells, signs)), m=m,
                                          input_bits=input_bits, cell_bits=cell_bits)
        assert not torch.equal(acc, ideal)


def test_bitserial_wraps_int32_as_the_reference():
    """16-bit inputs at K = 1024 push the shift-add past 2^31: the plain
    version wraps as the reference's int32 does, and with an ideal ADC it is
    the exact integer product, wrapped the same way."""
    M, K, N, m = 2, 1024, 4, 8
    xc, mcodes, cells, signs = _crossbar_inputs(4, M, K, N, m, 16)
    xc[:, m:] = 2 ** 16 - 1
    mcodes[:] = 255
    cells = np.stack([(mcodes >> (2 * c)) & 3 for c in range(4)])
    signs[:] = 1
    tx, tcl, ts = map(torch.from_numpy, (xc, cells, signs))
    acc, _ = ref.ref_bitserial_crossbar(tx, tcl, ts, m, 16, 2)
    jacc, _ = jref.ref_bitserial_crossbar(*map(jnp.asarray, (xc, cells, signs)), m, 16, 2)
    _eq(acc, jacc)
    exact = ref.ref_exact_int_matmul(tx, torch.from_numpy(mcodes), ts, m)
    _eq(exact, jref.ref_exact_int_matmul(*map(jnp.asarray, (xc, mcodes, signs)), m))
    _eq(acc, exact.numpy())
    true = xc.astype(np.int64) @ (mcodes.astype(np.int64) * np.repeat(signs, m, axis=0))
    assert (np.abs(true) > 2 ** 31).any() and (acc.numpy() != true).any()


def test_bitserial_exact_when_adc_sufficient():
    M, K, N, m = 4, 64, 8, 8
    xc, mcodes, cells, signs = _crossbar_inputs(5, M, K, N, m, 8)
    before = bx.bitserial_crossbar.launches
    acc, eic = ops.bitserial_crossbar(*map(torch.from_numpy, (xc, cells, signs)), m=m,
                                      input_bits=8)
    _eq(acc, ref.ref_exact_int_matmul(*map(torch.from_numpy, (xc, mcodes, signs)), m))
    _eq(eic, JZ.fragment_eic(jnp.asarray(xc), m, 8))
    assert bx.bitserial_crossbar.launches == before     # CPU: the plain version
    jacc, jeic = jops.bitserial_crossbar(*map(jnp.asarray, (xc, cells, signs)), m=m,
                                         input_bits=8, prefer_ref=False, bm=4, bn=8)
    _eq(acc, jacc)
    _eq(eic, jeic)


@pytest.mark.parametrize("adc_bits", [None, 4])
def test_apply_simulated_equals_reference(adc_bits):
    """``apply_simulated`` on the same compressed leaf and activations:
    eic equal, y within 1e-6 (one f32 product of the int result and the
    two scales)."""
    jtree, ttree = shared_codes()
    jleaf, tleaf = jtree["blocks"]["mlp"]["up"], ttree["blocks"]["mlp"]["up"].layer(0)
    jleaf = jforms.FormsLinearParams(mags=jleaf.mags[0], signs=jleaf.signs[0],
                                     scale=jleaf.scale[0], k=jleaf.k, m=jleaf.m,
                                     bits=jleaf.bits)
    x = np.maximum(np.random.RandomState(6).randn(2, 3, tleaf.k), 0).astype(np.float32)
    x[..., :16] = 0.0
    jspec = jforms.FormsSpec(m=8, input_bits=8, adc_bits=adc_bits)
    tspec = tforms.FormsSpec(m=8, input_bits=8, adc_bits=adc_bits)
    y, eic, xs = tforms.apply_simulated(tleaf, torch.from_numpy(x), tspec)
    jy, jeic, jxs = jforms.apply_simulated(jleaf, jnp.asarray(x), jspec)
    _eq(eic, jeic)
    _eq(xs, jxs)
    assert y.shape == (2, 3, tleaf.n)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=0)
    assert (eic[:, :2] == 0).all()
    dense = tforms.apply(tleaf, torch.from_numpy(x))
    if adc_bits is None:   # 8-bit activations: the simulator tracks the float product
        np.testing.assert_allclose(y.numpy(), dense.numpy(), rtol=0.05,
                                   atol=0.02 * float(dense.abs().max()))


def test_bitserial_wrapper_checks_shapes():
    xc, _, cells, signs = map(torch.from_numpy, _crossbar_inputs(7, 2, 16, 4, 8, 8))
    with pytest.raises(ValueError, match="fragments"):
        ops.bitserial_crossbar(xc, cells, signs[:1], m=8)
    with pytest.raises(ValueError, match="input_bits"):
        ops.bitserial_crossbar(xc, cells, signs, m=8, input_bits=40)
    with pytest.raises(ValueError, match="cell_bits"):
        ops.bitserial_crossbar(xc, cells, signs, m=8, cell_bits=0)
    spec = tforms.FormsSpec(m=8, input_bits=8, adc_bits=2)
    acc, _ = ops.bitserial_crossbar(xc, cells, signs, spec=spec)
    want, _ = ref.ref_bitserial_crossbar(xc, cells, signs, 8, 8, 2, adc_bits=2)
    assert torch.equal(acc, want)


def test_eic_of_out_of_range_codes_follows_the_oracle_route():
    """For codes with bits at or above ``input_bits`` (or negative), the
    reference's Pallas kernel reports a longer EIC than its oracle route
    (``fragment_eic``, which masks to the streamed bits).  The port follows
    the oracle on every route; acc agrees with both reference routes."""
    x = np.zeros((8, 16), np.int32)
    x[0, 0], x[1, 0], x[2, 9] = 20, -3, 7
    cells = np.random.RandomState(8).randint(0, 4, (4, 16, 8)).astype(np.int32)
    signs = np.ones((2, 8), np.int32)
    jx, jc, js = map(jnp.asarray, (x, cells, signs))
    acc, eic = ops.bitserial_crossbar(*map(torch.from_numpy, (x, cells, signs)), m=8,
                                      input_bits=4)
    oacc, oeic = jops.bitserial_crossbar(jx, jc, js, m=8, input_bits=4, prefer_ref=True)
    pacc, peic = pallas_bitserial(jx, jc, js, m=8, input_bits=4, bm=8, bn=8, interpret=True)
    _eq(eic, oeic)
    _eq(acc, oacc)
    _eq(acc, pacc)
    assert int(eic[0, 0]) == 3 and int(np.asarray(peic)[0, 0]) == 4
