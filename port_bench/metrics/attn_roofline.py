"""Attention's share of its roofline in the profiled call: the ideal time
of prefill attention (``layers.causal_attention``, the causal half over
the real prompt) and decode attention (``layers.decode_attention``, each
active slot's context) over the device time of the kernels launched under
those calls."""
from port_bench.harness import yardstick as Y

SPANS = ("attn_prefill", "attn_decode")
NAMES = ("pb.attn_prefill", "pb.attn_decode")


def read(m):
    if m.trace is None:
        return None
    work = [w for n in NAMES for w in m.spans.work(n)]
    return Y.roofline_share(work, sum(m.trace.range_device_s.get(n, 0.0) for n in NAMES))
