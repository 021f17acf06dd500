"""The MoE FFN (``models/moe.moe_ffn``): the router and each real token's
top-k SwiGLU experts (operations); x, y, the router and the codes of the
experts that received a token (bytes)."""
from port_bench.harness import spans as Sp
from port_bench.harness import yardstick as Y

TARGET = "repro_torch.models.moe:moe_ffn"
MARKER = True
NEEDS = ("top_k", "prefill_slot", "decode_round")


def work(spans, out, p, x, mcfg, dtype, batch_aux=False):
    hit = spans.state.pop("experts_hit", mcfg.num_experts)
    tokens = Sp.real_rows(spans, x.shape[0] * x.shape[1])
    return Y.moe_work(tokens, mcfg.d_model, mcfg.moe_d_ff, mcfg.num_experts,
                      mcfg.experts_per_token, hit, spans.state["forms_m"])
