"""PyTorch port vs the JAX package: the FORMS hardware model.

``repro_torch.core.crossbar`` and ``repro_torch.core.perfmodel`` are plain
arithmetic on published constants, so every public function must give the
reference's numbers exactly (``==`` on floats) over a grid of fragment
sizes m in {4, 8, 16}, magnitude widths in {2, 4, 8, 16}, mean EIC in
{None, 14.573} (the port's measured fidelity EIC) and the crossbar test's
shapes plus CNN and LM layer shapes.  The calibrated Table III-V bands the
reference's tests assert are held on the port's copy too.
"""
import dataclasses

import pytest

from repro.core import crossbar as JX
from repro.core import perfmodel as JPM
from repro.core.fragments import FragmentSpec as JFrag
from repro.core.quantization import QuantSpec as JQuant
from repro_torch.core import crossbar as TX
from repro_torch.core import perfmodel as TPM
from repro_torch.core.fragments import FragmentSpec as TFrag
from repro_torch.core.quantization import QuantSpec as TQuant

MS = (4, 8, 16)
BITS = (2, 4, 8, 16)
EICS = (None, 14.573)
# tests/test_crossbar.py's shapes, CNN layers as crossbar matrices (VGG/ResNet
# 3x3 convs: 9*C_in x C_out, a first layer 27 x 64, an FC), and LM projections
# (qwen2-1.5b, h2o-danube-1.8b, yi-9b and the untied heads)
SHAPES = [(128, 32), (128, 33), (129, 32), (1024, 1024), (256, 256),
          (27, 64), (576, 128), (1152, 256), (4608, 512), (25088, 4096), (4096, 1000),
          (1536, 1536), (1536, 256), (1536, 8960), (8960, 1536), (2560, 640),
          (6912, 2560), (4096, 11008), (2560, 32000), (4096, 64000), (1536, 151936)]


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("m", MS)
def test_crossbar_counts_equal_reference(m, bits):
    jq, tq = JQuant(bits=bits, cell_bits=2), TQuant(bits=bits, cell_bits=2)
    jf, tf = JFrag(m=m), TFrag(m=m)
    for rows, cols in ((128, 128), (256, 64), (64, 256)):
        jx, tx = JX.CrossbarSpec(rows, cols), TX.CrossbarSpec(rows, cols)
        assert tx.subarrays(tf) == jx.subarrays(jf)
        for shape in SHAPES:
            for split in (False, True):
                for wb in (None, 16):
                    assert TX.crossbars_for_matrix(shape, tx, tq, split, wb) == \
                        JX.crossbars_for_matrix(shape, jx, jq, split, wb)
        for split in (False, True):
            assert TX.model_crossbars(SHAPES, tx, tq, split) == \
                JX.model_crossbars(SHAPES, jx, jq, split)
    for shape in SHAPES:
        assert TX.sign_indicator_bits(shape, tf) == JX.sign_indicator_bits(shape, jf)


@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("baseline_bits", (8, 16))
def test_reduction_report_equals_reference(bits, baseline_bits):
    dense = SHAPES[:11]
    pruned = [(max(1, k // 4), max(1, n // 2)) for k, n in dense]
    tr = TX.reduction_report(dense, pruned, TX.CrossbarSpec(), TQuant(bits=bits),
                             baseline_bits=baseline_bits)
    jr = JX.reduction_report(dense, pruned, JX.CrossbarSpec(), JQuant(bits=bits),
                             baseline_bits=baseline_bits)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tr.total == jr.total


def _chip(c):
    return (dataclasses.asdict(c), c.tile_power, c.tile_area, c.chip_power_mw, c.chip_area_mm2)


def _throughput(t):
    return (dataclasses.asdict(t), t.events_per_column_per_input, t.event_rate_gs,
            t.columns_per_second_rel)


@pytest.mark.parametrize("m", MS)
def test_components_and_chips_equal_reference(m):
    tc, jc = TPM.forms_mcu_components(m), JPM.forms_mcu_components(m)
    assert [dataclasses.asdict(c) for c in tc] == [dataclasses.asdict(c) for c in jc]
    assert [(c.total_power, c.total_area) for c in tc] == \
        [(c.total_power, c.total_area) for c in jc]
    assert TPM.mcu_rollup(tc) == JPM.mcu_rollup(jc)
    assert _chip(TPM.forms_chip(m)) == _chip(JPM.forms_chip(m))
    assert _chip(TPM.isaac_chip()) == _chip(JPM.isaac_chip())
    assert [dataclasses.asdict(c) for c in TPM.isaac_mcu_components()] == \
        [dataclasses.asdict(c) for c in JPM.isaac_mcu_components()]
    assert TPM.TABLE_V_PUBLISHED == JPM.TABLE_V_PUBLISHED
    assert (TPM.DADIANNAO_CHIP_POWER_MW, TPM.DADIANNAO_CHIP_AREA_MM2,
            TPM.ISAAC_OFFSET_OVERHEAD, TPM.POLARIZATION_XBAR_FACTOR) == \
        (JPM.DADIANNAO_CHIP_POWER_MW, JPM.DADIANNAO_CHIP_AREA_MM2,
         JPM.ISAAC_OFFSET_OVERHEAD, JPM.POLARIZATION_XBAR_FACTOR)


@pytest.mark.parametrize("mean_eic", EICS, ids=["no-skip", "eic14.573"])
@pytest.mark.parametrize("m", MS)
def test_throughput_table_v_and_fps_equal_reference(m, mean_eic):
    for input_bits in (8, 16):
        ti, ji = TPM.isaac_throughput(input_bits), JPM.isaac_throughput(input_bits)
        tf = TPM.forms_throughput(m, mean_eic=mean_eic, input_bits=input_bits)
        jf = JPM.forms_throughput(m, mean_eic=mean_eic, input_bits=input_bits)
        assert _throughput(ti) == _throughput(ji)
        assert _throughput(tf) == _throughput(jf)
        assert tf.peak_throughput_rel(ti) == jf.peak_throughput_rel(ji)
    for pq in (26.4, 7.5, 200.8):
        assert [dataclasses.asdict(r) for r in TPM.table_v(m, mean_eic, pq)] == \
            [dataclasses.asdict(r) for r in JPM.table_v(m, mean_eic, pq)]
    for prune, quant in ((7.5 / 2, 2.0), (200.8 / 4, 4.0), (1.0, 1.0)):
        for input_bits in (8, 16):
            assert TPM.fps_speedup(prune, quant, m, mean_eic, input_bits=input_bits) == \
                JPM.fps_speedup(prune, quant, m, mean_eic, input_bits=input_bits)


def test_calibrated_bands_hold_on_the_port():
    """The reference's calibration checks (tests/test_perfmodel.py), on the
    port's copy: Tables III-IV roll-ups, Table V rows, the Fig 13/14 ranges."""
    p, _ = TPM.mcu_rollup(TPM.forms_mcu_components(8))
    assert abs(p - 23.3) / 23.3 < 0.15
    forms, isaac = TPM.forms_chip(8), TPM.isaac_chip()
    assert abs(forms.chip_power_mw - 66360.8) / 66360.8 < 0.10
    assert abs(forms.chip_area_mm2 - 89.15) / 89.15 < 0.10
    assert abs(isaac.chip_area_mm2 - 85.09) / 85.09 < 0.10
    rows = {r.name: r for r in TPM.table_v(8, mean_eic=12.0)}
    pol = rows["FORMS (polarization only, 8)"]
    assert 0.40 <= pol.gops_per_mm2_rel <= 0.68 and 0.40 <= pol.gops_per_w_rel <= 0.80
    assert 27.0 <= rows["FORMS (full optimization, 8)"].gops_per_mm2_rel <= 45.0
    low = TPM.fps_speedup(7.5 / 2, 2.0, fragment=8, mean_eic=11.0)
    high = TPM.fps_speedup(200.8 / 4, 4.0, fragment=8, mean_eic=11.0)
    assert 3.2 <= low["forms_model_opt"] <= 5.0
    assert 95.0 <= high["forms_model_opt"] <= 125.0
    assert TPM.forms_throughput(8).events_per_column_per_input == (128 / 8) * 16
    assert TPM.forms_throughput(8, mean_eic=8.0).events_per_column_per_input == (128 / 8) * 8
