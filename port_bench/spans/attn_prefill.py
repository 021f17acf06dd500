"""Prefill attention (``models/layers.causal_attention``): the causal half
over the prompt's real length, q/k/v read and the output written once."""
from port_bench.harness import spans as Sp
from port_bench.harness import yardstick as Y

TARGET = "repro_torch.models.layers:causal_attention"
MARKER = True
NEEDS = ("prefill_slot",)


def work(spans, out, q, k, v, **kw):
    b, s, h, hd = q.shape
    return Y.causal_attention_work(b, Sp.real_rows(spans, s), h, k.shape[2], hd,
                                   q.element_size())
