"""Decode attention (``models/layers.decode_attention``): each active
slot's queries over the positions they attend to, the cached K and V rows
read once."""
from port_bench.harness import spans as Sp
from port_bench.harness import yardstick as Y

TARGET = "repro_torch.models.layers:decode_attention"
MARKER = True
NEEDS = ("decode_round",)


def work(spans, out, q, k_cache, v_cache, pos, window=None):
    b, t, h, hd = q.shape
    ctx = (pos.reshape(b, -1).expand(b, t).long() + 1).clamp(max=k_cache.shape[1])
    mask = Sp.real_mask(spans, b, ctx.device)
    if mask is not None:
        ctx = ctx * mask[:, None]                 # an inactive slot attends to nothing
    return Y.decode_attention_work(ctx.sum(), ctx.amax(dim=1).sum(), Sp.real_rows(spans, b) * t,
                                   h, k_cache.shape[2], hd, k_cache.element_size())
