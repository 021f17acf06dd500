"""The FORMS matmul's share of its roofline in the profiled call: each
``kernels/ops.polarized_matmul`` call's 2·M·K·N operations and its bytes
(x, codes, signs, scales, y once each; M the rows of real tokens) at the
yardstick's peaks, over the device time of the kernels launched under
those calls."""
from port_bench.harness import yardstick as Y

SPANS = ("forms_mm",)


def read(m):
    if m.trace is None:
        return None
    return Y.roofline_share(m.spans.work("pb.forms_mm"),
                            m.trace.range_device_s.get("pb.forms_mm", 0.0))
