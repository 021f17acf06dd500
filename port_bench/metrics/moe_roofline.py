"""The MoE FFN's share of its roofline in the profiled call: the router
and each real token's top-k experts (operations), x, y, the router and the
codes of the experts that received a token (bytes), over the device time
of the kernels launched under ``models/moe.moe_ffn``."""
from port_bench.harness import yardstick as Y

SPANS = ("moe",)


def read(m):
    if m.trace is None:
        return None
    return Y.roofline_share(m.spans.work("pb.moe"), m.trace.range_device_s.get("pb.moe", 0.0))
