"""Analytical FORMS / ISAAC / DaDianNao hardware model (Tables III-V, Figs 13/14).

The port's copy of the JAX package's module: the published constants and
the calibration below carry over verbatim, so every number equals the
reference's.  These are model numbers of a ReRAM accelerator, never times of
the GPU the port runs on.

The paper evaluates with an in-house simulator whose component constants come
from CACTI/NVSIM + published ADC surveys; those published constants (its
Tables III/IV) are the *inputs* here, and the model reproduces the paper's
derived quantities:

* per-MCU and per-chip area/power roll-ups (Tables III/IV);
* peak nominal throughput per mm^2 / per W normalized to ISAAC (Table V);
* frame-per-second speedups when pruning/quantization/polarization/zero-skip
  compose (Figs 13/14).

Throughput arithmetic (calibrated against Table V):

  A crossbar column must be ADC-converted once per *conversion event*.
  ISAAC: one event per input bit-plane (all 128 rows summed at once)
         -> ``input_bits`` events per column per input vector.
  FORMS: one event per (fragment x effective bit)
         -> ``(rows/m) * mean_EIC`` events per column per input vector.
  Event service rate = ADCs-per-crossbar x ADC frequency.  Three factors then
  compose:

  * fine-grained event ratio: (4x2.1GHz/1.2GHz) / (16 waves) = 0.4375 at m=8
    — FORMS pays a raw-throughput penalty per crossbar (paper §I admits this);
  * offset-elimination gain ~1.25x: ISAAC's offset mapping must count input
    1s and subtract 2^15-biases per input (paper §II-B "significant
    overhead"); the sign indicator is free by comparison.  1.25 is fitted so
    the model lands on the published 0.54 (pol-only, m=8) and the 4x-109.6x
    model-opt FPS range simultaneously;
  * polarization crossbar reduction 2x: enters *crossbar-count* accounting
    (Tables I/II measure against the splitting scheme [41]) — i.e. the
    replication/FPS and full-optimization rows, never the pol-only peak rate.

  Calibration result (model vs published Table V): pol-only-8 0.52 vs 0.54,
  full-opt-8 ~35 vs 36.02, FPS model-opt range 4.1x-110x vs 4x-109.6x.
  frag-16 rows land within ~±40% (the paper's per-fragment ADC frequency and
  EIC at m=16 are not fully specified); tests assert the calibrated bands.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Component constants (paper Tables III & IV, mW / mm^2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Component:
    name: str
    power_mw: float
    area_mm2: float
    count: int = 1

    @property
    def total_power(self) -> float:
        return self.power_mw

    @property
    def total_area(self) -> float:
        return self.area_mm2


def forms_mcu_components(fragment: int = 8) -> List[Component]:
    """FORMS MCU (Table III).  ADC resolution: 3/4/5 bits for m=4/8/16."""
    adc_bits = {4: 3, 8: 4, 16: 5}[fragment]
    # Table III is given for fragment 8 (4-bit ADC).  ADC area/power scale
    # ~2x per bit (paper: "grow exponentially with the number of bits").
    scale = 2.0 ** (adc_bits - 4)
    return [
        Component("adc", 15.2 * scale, 0.0091 * scale, count=32),
        Component("dac", 4.0, 0.00017, count=8 * 128),
        Component("sample_hold", 0.0055, 0.000023, count=8 * 128),
        Component("crossbar", 2.44, 0.00024, count=8),
        Component("shift_add", 0.2, 0.000024, count=4),
        Component("skipping_logic", 0.01, 0.0000001),
        Component("sign_indicator", 0.012, 0.0000031),
    ]


def isaac_mcu_components() -> List[Component]:
    return [
        Component("adc", 16.0, 0.0096, count=8),
        Component("dac", 4.0, 0.00017, count=8 * 128),
        Component("sample_hold", 0.01, 0.00004, count=8 * 128),
        Component("crossbar", 2.43, 0.00023, count=8),
        Component("shift_add", 0.2, 0.000024, count=4),
    ]


def mcu_rollup(components: List[Component]) -> Tuple[float, float]:
    """(power_mW, area_mm2) of one MCU — Table III totals."""
    return (sum(c.power_mw for c in components),
            sum(c.area_mm2 for c in components))


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Chip-level roll-up (Table IV)."""

    name: str
    mcu_power_mw: float
    mcu_area_mm2: float
    dig_unit_power_mw: float
    dig_unit_area_mm2: float
    mcus_per_tile: int = 12
    tiles: int = 168
    ht_power_mw: float = 10400.0
    ht_area_mm2: float = 22.88

    @property
    def tile_power(self) -> float:
        return self.mcu_power_mw * self.mcus_per_tile + self.dig_unit_power_mw

    @property
    def tile_area(self) -> float:
        return self.mcu_area_mm2 * self.mcus_per_tile + self.dig_unit_area_mm2

    @property
    def chip_power_mw(self) -> float:
        return self.tile_power * self.tiles + self.ht_power_mw

    @property
    def chip_area_mm2(self) -> float:
        return self.tile_area * self.tiles + self.ht_area_mm2


def forms_chip(fragment: int = 8) -> ChipSpec:
    p, a = mcu_rollup(forms_mcu_components(fragment))
    # Table IV: FORMS dig unit is larger than ISAAC's (bigger eDRAM 128KB vs
    # 64KB, 512-bit vs 256-bit bus, accumulation blocks).
    return ChipSpec("FORMS", p, a, dig_unit_power_mw=53.05, dig_unit_area_mm2=0.25)


def isaac_chip() -> ChipSpec:
    p, a = mcu_rollup(isaac_mcu_components())
    return ChipSpec("ISAAC", p, a, dig_unit_power_mw=40.85, dig_unit_area_mm2=0.213)


DADIANNAO_CHIP_POWER_MW = 19856.0
DADIANNAO_CHIP_AREA_MM2 = 86.2
# Table V reference rows (normalized to ISAAC) for reporting alongside ours.
TABLE_V_PUBLISHED = {
    "ISAAC": (1.0, 1.0),
    "DaDianNao": (0.13, 0.45),
    "PUMA": (0.70, 0.79),
    "TPU": (0.08, 0.48),
    "FORMS (polarization only, 8)": (0.54, 0.61),
    "FORMS (polarization only, 16)": (0.77, 0.84),
    "Pruned/Quantized-ISAAC": (26.4, 26.61),
    "FORMS (full optimization, 8)": (36.02, 27.73),
    "FORMS (full optimization, 16)": (39.48, 51.26),
}


# ---------------------------------------------------------------------------
# Throughput / cycle model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ThroughputSpec:
    """Conversion-event arithmetic for one design point."""

    rows: int = 128               # crossbar rows
    fragment: int = 128           # rows activated per conversion (ISAAC: all)
    adcs_per_crossbar: int = 1
    adc_freq_ghz: float = 1.2
    input_bits: int = 16
    mean_eic: Optional[float] = None  # zero-skipping effective cycles; None = off
    offset_overhead: float = 1.0      # ISAAC offset-mapping digital overhead

    @property
    def events_per_column_per_input(self) -> float:
        waves = self.rows / self.fragment
        bits = self.mean_eic if self.mean_eic is not None else self.input_bits
        return waves * bits * self.offset_overhead

    @property
    def event_rate_gs(self) -> float:
        return self.adcs_per_crossbar * self.adc_freq_ghz

    @property
    def columns_per_second_rel(self) -> float:
        """Column-results/s per crossbar (GHz-events / events-per-column)."""
        return self.event_rate_gs / self.events_per_column_per_input

    def peak_throughput_rel(self, baseline: "ThroughputSpec") -> float:
        """Ops/s ratio vs baseline at equal crossbar count."""
        return self.columns_per_second_rel / baseline.columns_per_second_rel


ISAAC_OFFSET_OVERHEAD = 1.25   # calibrated; see module docstring
POLARIZATION_XBAR_FACTOR = 2.0  # vs the splitting mapping [41] (Tables I/II)


def isaac_throughput(input_bits: int = 16) -> ThroughputSpec:
    return ThroughputSpec(rows=128, fragment=128, adcs_per_crossbar=1,
                          adc_freq_ghz=1.2, input_bits=input_bits,
                          offset_overhead=ISAAC_OFFSET_OVERHEAD)


def forms_throughput(fragment: int = 8, mean_eic: Optional[float] = None,
                     input_bits: int = 16) -> ThroughputSpec:
    # iso-area: 4x 4-bit ADCs replace one 8-bit ADC, 2.1 GHz (paper §IV-C).
    freq = {4: 2.4, 8: 2.1, 16: 1.8}[fragment]
    return ThroughputSpec(rows=128, fragment=fragment, adcs_per_crossbar=4,
                          adc_freq_ghz=freq, input_bits=input_bits,
                          mean_eic=mean_eic)


@dataclasses.dataclass
class TableVRow:
    name: str
    gops_per_mm2_rel: float
    gops_per_w_rel: float


def table_v(fragment: int = 8, mean_eic: Optional[float] = None,
            crossbar_reduction_pq: float = 26.4) -> List[TableVRow]:
    """Model-derived Table V rows (normalized to non-optimized ISAAC).

    ``crossbar_reduction_pq``: pruning x quantization crossbar-reduction of the
    evaluated workload mix (the paper's optimized models; its Table V uses the
    aggregate 26.4x).  Polarization's 2x and zero-skipping enter via
    ThroughputSpec.
    """
    isaac_t, isaac_c = isaac_throughput(), isaac_chip()
    f_chip = forms_chip(fragment)
    area_ratio = f_chip.chip_area_mm2 / isaac_c.chip_area_mm2
    power_ratio = f_chip.chip_power_mw / isaac_c.chip_power_mw

    def row(name, rel_throughput, a_ratio=1.0, p_ratio=1.0):
        return TableVRow(name, rel_throughput / a_ratio, rel_throughput / p_ratio)

    rows = [row("ISAAC", 1.0)]
    pol = forms_throughput(fragment).peak_throughput_rel(isaac_t)
    rows.append(row(f"FORMS (polarization only, {fragment})", pol,
                    area_ratio, power_ratio))
    rows.append(row("Pruned/Quantized-ISAAC", crossbar_reduction_pq))
    full = forms_throughput(fragment, mean_eic=mean_eic).peak_throughput_rel(isaac_t)
    rows.append(row(f"FORMS (full optimization, {fragment})",
                    full * crossbar_reduction_pq * POLARIZATION_XBAR_FACTOR,
                    area_ratio, power_ratio))
    return rows


# ---------------------------------------------------------------------------
# Frame-per-second model (Figs 13/14)
# ---------------------------------------------------------------------------

def fps_speedup(
    crossbar_reduction_prune: float,
    crossbar_reduction_quant: float,
    fragment: int = 8,
    mean_eic: Optional[float] = None,
    include_polarization: bool = True,
    input_bits: int = 16,
) -> Dict[str, float]:
    """Composed FPS speedup vs the original (unpruned, 16-bit) ISAAC.

    Iso-area: fewer crossbars per model => proportional replication =>
    proportional FPS (the paper's 7.5x-200.8x pruned-ISAAC range comes from
    exactly this), then FORMS swaps the crossbar cycle model.

    Returns the cumulative speedups in the order the paper's bars stack.
    """
    isaac_t = isaac_throughput(input_bits)
    out: Dict[str, float] = {}
    pq = crossbar_reduction_prune * crossbar_reduction_quant
    out["pruned_quantized_isaac"] = pq
    # FPS replication vs the ISAAC-offset baseline: FORMS stores the same
    # weights/crossbar as offset mapping, so polarization adds no replication
    # here (its 2x appears only in the split-scheme crossbar accounting of
    # Tables I/II); FORMS' gain is the offset-circuitry elimination, which is
    # inside peak_throughput_rel.  Calibrated: 4.1x-110x vs published 4x-109.6x.
    base = pq
    del include_polarization  # kept for API symmetry; see comment above
    forms_nozs = forms_throughput(fragment, mean_eic=None, input_bits=input_bits)
    out["forms_model_opt"] = base * forms_nozs.peak_throughput_rel(isaac_t)
    forms_zs = forms_throughput(fragment, mean_eic=mean_eic, input_bits=input_bits)
    out["forms_full_zero_skip"] = base * forms_zs.peak_throughput_rel(isaac_t)
    return out
