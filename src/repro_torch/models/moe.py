"""MoE transformer family (olmoe: 64 experts, top-8), in PyTorch.

GQA/MHA attention blocks with a capacity-based mixture-of-experts FFN, as
the JAX package's ``models/moe.py``: the router picks each token's top-k
experts, a sort gives each (token, expert) pair its position in the
expert's buffer, pairs past ``cap = max(4, int(capacity_factor * T * k /
E))`` are dropped, the experts run batched on the ``(E, cap, d)`` buffer
and the outputs are combined with the normalized gates.  This is the
reference's single-device scatter path; its expert-parallel dispatch over
a mesh is ROADMAP item 13.

Ties break as the reference's: ``lax.top_k`` puts the lower expert index
first among equal probabilities (a stable descending sort here), and the
position sort is stable (``jnp.argsort`` is).  The capacity depends on the
token count, so padding a prompt would change which tokens are dropped:
the family is served at the exact prompt length
(``registry.Model.padded_prefill``).

Projections (attention, the router, the untied head) go through
``layers.linear``: the polarized-matmul kernel on a FORMS tree, except the
router, which ``compress_tree`` leaves dense in both packages (the
crossbar predicate's ``"/ro"`` matches ``router``).  The
expert FFN is ``torch.einsum`` on the dequantized stacked experts, as the
reference's ``einsum`` on ``L.wload`` is (no Pallas kernel there either):
``layers.wload`` rebuilds a layer's ``(E, K, N)`` expert slice on the card
for it.  MLA attention and the multi-token-prediction module (deepseek-v3)
are ROADMAP item 10b.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_serving_head, layer_params,
                                            unstack_layers, with_head_cast)
from repro_torch.serving import kv_cache as KV

Params = Dict[str, Any]

__all__ = ["init", "forward", "head_matrix", "init_cache", "init_paged_cache",
           "prefill", "prefill_paged", "decode_step", "decode_paged",
           "moe_ffn", "with_head_cast"]


def check_supported(cfg: ModelConfig) -> None:
    """MLA and the MTP module (deepseek-v3) are not ported yet: the
    registry refuses such a config before it binds this family."""
    if cfg.mla is not None or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention and the multi-token-prediction module "
            f"(deepseek-v3) are not ported yet (ROADMAP queue 1, item 10b)")


def _normal(g: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.float32, device=g.device).mul_(std)


# ---------------------------------------------------------------------------
# capacity-based MoE FFN
# ---------------------------------------------------------------------------

def moe_ffn_init(g: torch.Generator, cfg: ModelConfig, n: int) -> Params:
    """``n`` layers of router + stacked experts (+ shared experts), each
    drawn as the reference draws them (other draws)."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": _normal(g, (n, d, e), 0.02),
        "w_gate": _normal(g, (n, e, d, f), d ** -0.5),
        "w_up": _normal(g, (n, e, d, f), d ** -0.5),
        "w_down": _normal(g, (n, e, f, d), f ** -0.5),
    }
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        p["shared_gate"] = _normal(g, (n, d, fs), d ** -0.5)
        p["shared_up"] = _normal(g, (n, d, fs), d ** -0.5)
        p["shared_down"] = _normal(g, (n, fs, d), fs ** -0.5)
    return p


def _expert_ffn(p: Params, bufe: torch.Tensor, dtype) -> torch.Tensor:
    """Batched per-expert SwiGLU on the dispatched buffer (E, C, d)."""
    h = F.silu(torch.einsum("ecd,edf->ecf", bufe, L.wload(p, "w_gate", dtype)))
    h = h * torch.einsum("ecd,edf->ecf", bufe, L.wload(p, "w_up", dtype))
    return torch.einsum("ecf,efd->ecd", h, L.wload(p, "w_down", dtype))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest per row, the lower index first among
    equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, dtype
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss), the reference's scatter path."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    logits = L.linear(p, "router", xt, dtype).float()             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, k)                                    # (T, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # aux load-balance loss (switch-style)
    density = torch.mean(F.one_hot(idx[:, 0], e).float(), dim=0)
    prob_mean = torch.mean(probs, dim=0)
    aux = e * torch.sum(density * prob_mean)

    cap = max(4, int(cfg.capacity_factor * t * k / e))
    dev = x.device
    e_flat = idx.reshape(t * k)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    pos_sorted = torch.arange(t * k, device=dev) - seg_start[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    valid = pos < cap
    dest = torch.where(valid, e_flat * cap + pos, torch.zeros_like(pos))
    x_rep = xt.repeat_interleave(k, dim=0).to(dtype)
    upd = torch.where(valid[:, None], x_rep, torch.zeros_like(x_rep))
    bufe = torch.zeros((e * cap, d), dtype=dtype, device=dev).index_add_(0, dest, upd)
    out_buf = _expert_ffn(p, bufe.reshape(e, cap, d), dtype).reshape(e * cap, d)
    y_tk = out_buf[dest]
    y_tk = torch.where(valid[:, None], y_tk, torch.zeros_like(y_tk))
    y_tk = y_tk * gates.reshape(t * k, 1).to(dtype)
    y = y_tk.reshape(t, k, d).sum(dim=1)

    if cfg.num_shared_experts:
        xd = xt.to(dtype)
        hs = F.silu(L.linear(p, "shared_gate", xd, dtype)) * L.linear(p, "shared_up", xd, dtype)
        y = y + L.linear(p, "shared_down", hs, dtype)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# blocks / model
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random params on the generator's device, shaped and keyed like the
    reference's ``init`` (same distributions; other draws)."""
    g, dev = generator, generator.device
    n, d = cfg.num_layers, cfg.d_model
    hd, nh, nkv = cfg.hd(), cfg.num_heads, cfg.num_kv_heads
    return {
        "embed": _normal(g, (cfg.vocab_size, d), 0.02),
        "blocks": {
            "norm1": torch.ones((n, d), device=dev),
            "norm2": torch.ones((n, d), device=dev),
            "attn": {"wq": _normal(g, (n, d, nh * hd), d ** -0.5),
                     "wk": _normal(g, (n, d, nkv * hd), d ** -0.5),
                     "wv": _normal(g, (n, d, nkv * hd), d ** -0.5),
                     "wo": _normal(g, (n, nh * hd, d), (nh * hd) ** -0.5)},
            "moe": moe_ffn_init(g, cfg, n),
        },
        "final_norm": torch.ones((d,), device=dev),
        "head": _normal(g, (d, cfg.vocab_size), 0.02),
    }


def _block_apply(cfg: ModelConfig, bp: Params, x: torch.Tensor, positions: torch.Tensor,
                 cache, cache_pos, dtype, q_chunk: int, collect_kv: bool = False):
    h, new_kv = L.attention_block(
        bp["attn"], L.rmsnorm(x, bp["norm1"], cfg.norm_eps),
        n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, hd=cfg.hd(),
        rope_theta=cfg.rope_theta, positions=positions, q_chunk=q_chunk,
        cache=cache, cache_pos=cache_pos, return_kv=collect_kv, dtype=dtype)
    x = x + h
    y, aux = moe_ffn(bp["moe"], L.rmsnorm(x, bp["norm2"], cfg.norm_eps), cfg, dtype)
    return x + y, aux, new_kv


def head_matrix(cfg: ModelConfig, params: Params):
    return params["head"]


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            remat: bool = False, q_chunk: int = L.DEFAULT_Q_CHUNK,
            return_hidden: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  Returns (logits (B, S, V), aux) with
    ``aux["moe_aux_loss"]`` the mean over layers of the load-balance loss."""
    dtype = L.DTYPES[cfg.dtype]
    x = L.embed_lookup(params["embed"], batch["tokens"], dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def body(x, bp):
        out, aux, _ = _block_apply(cfg, bp, x, positions, None, None, dtype, q_chunk)
        return out, aux

    auxs = []
    for bp in unstack_layers(params["blocks"], cfg.num_layers):
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(body, x, bp, use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = body(x, bp)
        auxs.append(aux)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    aux_out = {"moe_aux_loss": torch.stack(auxs).mean()}
    if return_hidden:
        return x, aux_out
    return L.lm_logits(x, _serving_head(cfg, params), dtype), aux_out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The dense slot cache: ``(L, batch, max_len, kv, hd)`` per leaf."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device, dtype=torch.bfloat16) -> KV.PagedKVCache:
    """Page-pool cache of GQA K/V, ``(L, num_pages, page_size, kv, hd)``."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.hd())
    return KV.PagedKVCache(pool={"k": torch.zeros(shape, dtype=dtype, device=device),
                                 "v": torch.zeros(shape, dtype=dtype, device=device)},
                           page_size=page_size)


def _prefill_core(cfg: ModelConfig, params: Params, tokens: torch.Tensor, length: int):
    """Bulk prefill compute over a (1, S) prompt.  Returns the logits of
    the last real token (1, V) and the full-prompt K/V rows
    ``(L, 1, S, kv, hd)`` per leaf."""
    dtype = L.DTYPES[cfg.dtype]
    x = L.embed_lookup(params["embed"], tokens, dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, _, (k, v) = _block_apply(cfg, layer_params(params["blocks"], i), x, positions,
                                    None, None, dtype, L.DEFAULT_Q_CHUNK, collect_kv=True)
        ks.append(k)
        vs.append(v)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_logits(x[:, length - 1:length], _serving_head(cfg, params), dtype)
    return logits[:, 0], {"k": torch.stack(ks), "v": torch.stack(vs)}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor], slot: int, length: int
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Bulk prefill of one slot of the dense cache, served unpadded: pad
    tokens would enter the capacity-based dispatch and take capacity from
    real tokens.  Prefill routes the whole prompt in one batch while decode
    routes ``batch_slots`` tokens per step, so drops can differ between the
    two, as in the reference."""
    logits, rows = _prefill_core(cfg, params, tokens, length)
    for name, arr in rows.items():
        leaf = cache[name]
        leaf[:, slot:slot + 1, :arr.shape[2]] = arr.to(leaf.dtype)
    return logits, cache


def prefill_paged(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  cache: KV.PagedKVCache, pages: torch.Tensor, slot: int,
                  length: int) -> Tuple[torch.Tensor, KV.PagedKVCache]:
    """Paged bulk prefill (exact length), one whole-page write at ``pages``."""
    del slot
    logits, rows = _prefill_core(cfg, params, tokens, length)
    return logits, KV.commit_pages(cache, rows, pages)


def _decode_core(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor):
    """Decode compute against ``(L, B, S, kv, hd)`` cache views; token t of
    row b sits at ``pos[b] + t``.  A multi-token verify (T > 1) routes B*T
    tokens through the dispatch, so drops can differ from T = 1, as in the
    reference."""
    dtype = L.DTYPES[cfg.dtype]
    b, t = tokens.shape
    x = L.embed_lookup(params["embed"], tokens, dtype)
    positions = L.position_span(pos.to(torch.int32).expand(b), t)
    k_tok, v_tok = [], []
    for i in range(cfg.num_layers):
        x, _, (k, v) = _block_apply(cfg, layer_params(params["blocks"], i), x, positions,
                                    (k_cache[i], v_cache[i]), positions, dtype,
                                    L.DEFAULT_Q_CHUNK)
        k_tok.append(k)
        v_tok.append(v)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_logits(x, _serving_head(cfg, params), dtype)
    return logits, torch.stack(k_tok), torch.stack(v_tok)


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode step on the dense cache; the attention layers write the new
    rows into the cache leaves in place (rows past max_len are dropped)."""
    pos = pos.to(torch.int32).expand(tokens.shape[0])
    logits, _, _ = _decode_core(cfg, params, tokens, cache["k"], cache["v"], pos)
    return logits, cache


def decode_paged(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 cache: KV.PagedKVCache, pos: torch.Tensor,
                 block_tables: torch.Tensor) -> Tuple[torch.Tensor, KV.PagedKVCache]:
    """Paged decode step: block-table gathers, attention, then the new
    tokens' rows committed into their pages in place."""
    pos = pos.to(torch.int32).expand(tokens.shape[0])
    views = KV.gather_views(cache, block_tables)
    logits, k_tok, v_tok = _decode_core(cfg, params, tokens, views["k"], views["v"], pos)
    cache = KV.commit_tokens(cache, {"k": k_tok, "v": v_tok}, block_tables, pos)
    return logits, cache
