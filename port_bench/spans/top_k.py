"""The MoE router's top-k (``models/moe.top_k``), called once inside each
``moe_ffn``: while work is recorded, how many experts received a token
from a real row, for the ``moe`` span's work (a device scalar: counted
without reading anything back)."""
from port_bench.harness import spans as Sp

TARGET = "repro_torch.models.moe:top_k"
NEEDS = ("prefill_slot", "decode_round")


def after(spans, out, probs, k):
    if not spans.recording:
        return
    import torch
    e = probs.shape[-1]
    idx = out[1].reshape(-1, out[1].shape[-1])
    mask = Sp.real_mask(spans, idx.shape[0], idx.device)
    if mask is not None:
        idx = torch.where(mask[:, None], idx, e)          # padding rows to a spare bin
    hit = torch.zeros(e + 1, dtype=torch.bool, device=idx.device)
    hit.index_fill_(0, idx.reshape(-1).long(), True)
    spans.state["experts_hit"] = hit[:e].sum()
