"""The whole step's model FLOPs over the window's wall time, as a share of
the bf16 peak.  Serving: every prompt token and generated token of the
window's requests through the active parameters, one head row per
generated token, causal attention over each context.  Training: 6 x the
layer and head parameters per token plus forward and backward causal
attention per step (recomputation not counted)."""
from port_bench.harness import yardstick as Y

SPANS = ()


def read(m):
    if m.window_s <= 0:
        return None
    if hasattr(m, "steps"):
        if not m.steps:
            return None
        flops = Y.train_model_flops(m.cell.port, int(m.cell.traffic["batch"]),
                                    int(m.cell.traffic["seq_len"])) * m.steps
    else:
        if not m.served:
            return None
        flops = Y.serve_model_flops(m.cell.port, m.served)
    return 100.0 * flops / m.window_s / Y.PEAK_FLOPS
