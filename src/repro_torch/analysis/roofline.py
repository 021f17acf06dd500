"""Three-term roofline of one dry-run cell, against one card's peak rates.

  compute term    = FLOPs per device            / peak_flops
  memory term     = HBM bytes per device        / hbm_bytes_per_s
  collective term = collective bytes per device / link_bytes_per_s

The JAX package's report (``RooflineReport``, ``model_flops``,
``summarize``) with its peak rates taken from a :class:`Hardware` record
instead of module constants.  The port's record is :data:`H100`, the
NVIDIA H100 SXM (80 GB HBM3):

* ``peak_flops`` 989e12 FLOP/s: the dense bf16 tensor-core rate of the
  H100 SXM datasheet (1,979 Tflop/s is its 2:4-sparse figure);
* ``hbm_bytes_per_s`` 3.35e12 B/s: the HBM3 bandwidth of the datasheet;
* ``hbm_bytes`` 80e9: the device memory of the datasheet, for the memory
  check (``fits_hbm``);
* ``link_bytes_per_s`` 50e9 B/s per device: one 400 Gb/s NDR InfiniBand
  link per GPU.  Every axis of the production meshes (16 ranks) spans more
  than one 8-GPU NVLink node, so the inter-node link sets the pace; within
  a node NVLink 4 gives 450 GB/s each way.  No collective of the port has
  been measured.

MODEL_FLOPS is the classic 6·N·D (train) / 2·N·D (inference) with N the
active params and D the tokens of one step; MODEL_FLOPS over the counted
FLOPs exposes remat and redundant work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device's peak rates and memory."""

    name: str
    peak_flops: float          # dense bf16 FLOP/s
    hbm_bytes_per_s: float
    link_bytes_per_s: float    # collective bytes per second per device
    hbm_bytes: float


H100 = Hardware(name="NVIDIA H100 SXM 80GB", peak_flops=989e12, hbm_bytes_per_s=3.35e12,
                link_bytes_per_s=50e9, hbm_bytes=80e9)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    kind: str                       # train | prefill | decode
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_global: float
    tokens_per_step: int
    peak_memory_bytes: Optional[float] = None
    hardware: Hardware = dataclasses.field(default=H100, repr=False, compare=False)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops_per_device / self.hardware.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes_per_device / self.hardware.hbm_bytes_per_s

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / self.hardware.link_bytes_per_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: the dominant term (perfect overlap model)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global); below 1 it exposes remat
        recompute and redundant work."""
        hlo_global = self.hlo_flops_per_device * self.chips
        return self.model_flops_global / max(hlo_global, 1.0)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        return (self.model_flops_global
                / (self.chips * self.hardware.peak_flops * max(self.step_time_s, 1e-12)))

    def to_dict(self) -> Dict:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if f.name != "hardware"}
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, bottleneck=self.bottleneck,
                 step_time_s=self.step_time_s, mfu=self.mfu,
                 useful_flops_fraction=self.useful_flops_fraction)
        return d


def model_flops(kind: str, active_params: int, tokens: int) -> float:
    """6ND for training (fwd+bwd), 2ND for inference forward."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * active_params * tokens


def summarize(report: RooflineReport) -> str:
    r = report
    return (f"{r.arch:>20s} {r.shape:>12s} {r.mesh:>9s} "
            f"compute {r.compute_s*1e3:9.3f}ms  memory {r.memory_s*1e3:9.3f}ms  "
            f"collective {r.collective_s*1e3:9.3f}ms  -> {r.bottleneck:10s} "
            f"mfu {r.mfu*100:5.1f}%  useful {r.useful_flops_fraction*100:5.1f}%")
