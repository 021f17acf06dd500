"""The FORMS matmul (``kernels/ops.polarized_matmul``): each call's
2·M·K·N operations and its bytes (x, codes, signs, scales, y once each),
M the rows that carry real tokens."""
from port_bench.harness import spans as Sp
from port_bench.harness import yardstick as Y

TARGET = "repro_torch.kernels.ops:polarized_matmul"
MARKER = True
NEEDS = ("prefill_slot", "decode_round")


def work(spans, out, x, mags, signs, scale, m=8, spec=None, **kw):
    frag = spec.m if spec is not None else m
    return Y.forms_mm_work(Sp.real_rows(spans, x.shape[0]), x.shape[1], mags.shape[1],
                           x.element_size(), mags.element_size(), frag)
