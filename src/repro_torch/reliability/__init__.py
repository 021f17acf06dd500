"""Reliability of the port: ReRAM fault injection, variation-resilient
encoding and self-healing serving, as in the JAX package's
``repro.reliability``.

* :mod:`~repro_torch.reliability.faults`: deterministic, seeded corruption
  of compressed ``FormsLinearParams`` trees in their native uint8/int8
  domain (lognormal conductance variation, stuck-at cells, retention
  drift), drawing the reference's numbers.
* :mod:`~repro_torch.reliability.encoding`: the cell-level readouts, plain
  ``binary`` bit-slice and VECOM-style ``vecom`` reference-column offset
  compensation (``FormsSpec.encoding``).
* :mod:`~repro_torch.reliability.health`: golden-probe drift detection,
  per-leaf fault scoreboards and re-encoding from the reference copy,
  hooked into both serving schedulers.
"""
from repro_torch.reliability.encoding import N_REF, VALID_ENCODINGS
from repro_torch.reliability.faults import (FaultModel, FaultReport, LeafFaults,
                                            inject_leaf, inject_tree)
from repro_torch.reliability.health import HealthConfig, HealthMonitor

__all__ = ["N_REF", "VALID_ENCODINGS", "FaultModel", "FaultReport",
           "HealthConfig", "HealthMonitor", "LeafFaults", "inject_leaf",
           "inject_tree"]
