"""Dense decoder-only transformer family (qwen2 and its kin), in PyTorch.

GQA with arbitrary KV heads, optional QKV bias, sliding-window attention and
tied embeddings, as in the JAX package.  Block params are stacked along a
leading L axis exactly like the reference tree; where the reference runs
``lax.scan`` over layers, the port runs a Python loop over L slices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.forms.linear import FormsLinearParams
from repro_torch.models import layers as L
from repro_torch.serving import kv_cache as KV

Params = Dict[str, Any]


def _normal(g: torch.Generator, shape, std: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.float32, device=device) * std


def init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random params on the generator's device, shaped and keyed like the
    reference's ``init`` (same distributions; other draws)."""
    dev = generator.device
    n, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    hd, nh, nkv = cfg.hd(), cfg.num_heads, cfg.num_kv_heads

    def dense(d_in, d_out, std=None):
        return _normal(generator, (n, d_in, d_out), std or d_in ** -0.5, dev)

    attn = {"wq": dense(d, nh * hd), "wk": dense(d, nkv * hd),
            "wv": dense(d, nkv * hd), "wo": dense(nh * hd, d)}
    if cfg.qkv_bias:
        for name, width in (("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd)):
            attn[name] = torch.zeros((n, width), device=dev)
    params: Params = {
        "embed": _normal(generator, (cfg.vocab_size, d), 0.02, dev),
        "blocks": {
            "norm1": torch.ones((n, d), device=dev),
            "attn": attn,
            "norm2": torch.ones((n, d), device=dev),
            "mlp": {"gate": dense(d, f), "up": dense(d, f), "down": dense(f, d)},
        },
        "final_norm": torch.ones((d,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = _normal(generator, (d, cfg.vocab_size), 0.02, dev)
    return params


def layer_params(blocks: Any, i: int) -> Any:
    """Layer ``i`` of the stacked block tree (what ``lax.scan`` hands a step)."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    if isinstance(blocks, FormsLinearParams):
        return blocks.layer(i)
    return blocks[i]


def _block_apply(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                 positions: torch.Tensor, cache, cache_pos, dtype, q_chunk: int,
                 collect_kv: bool = False):
    h, new_kv = L.attention_block(
        bp["attn"], L.rmsnorm(x, bp["norm1"], cfg.norm_eps),
        n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, hd=cfg.hd(),
        rope_theta=cfg.rope_theta, positions=positions,
        window=cfg.sliding_window, q_chunk=q_chunk,
        cache=cache, cache_pos=cache_pos, return_kv=collect_kv, dtype=dtype)
    x = x + h
    if cfg.act_sparsity > 0.0:
        raise NotImplementedError(
            "act_sparsity is part of zero-skip, not ported yet (ROADMAP "
            "queue 1, item 5)")
    x = x + L.swiglu(bp["mlp"], L.rmsnorm(x, bp["norm2"], cfg.norm_eps), dtype,
                     act=cfg.mlp_act)
    return x, new_kv


def head_matrix(cfg: ModelConfig, params: Params):
    """The LM head: the serving cast copy if one was made, the untied
    ``head``, or the tied ``embed.T``."""
    cast = params.get("head_cast")
    if cast is not None:
        return cast
    head = params.get("head")
    return head if head is not None else params["embed"].T


def with_head_cast(cfg: ModelConfig, params: Params) -> Params:
    """A shallow copy of ``params`` holding the dense head once in the compute
    dtype.  ``lm_logits`` casts the head on every call; for a tied (V, d)
    embedding that is a full-table read and write per step, and a copy made
    once gives the same numbers."""
    head = head_matrix(cfg, params)
    if isinstance(head, FormsLinearParams):
        return params
    return {**params, "head_cast": head.to(L.DTYPES[cfg.dtype])}


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  Returns (logits (B, S, V), aux)."""
    dtype = L.DTYPES[cfg.dtype]
    x = L.embed_lookup(params["embed"], batch["tokens"], dtype)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    for i in range(cfg.num_layers):
        x, _ = _block_apply(cfg, layer_params(params["blocks"], i), x, positions,
                            None, None, dtype, L.DEFAULT_Q_CHUNK)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.lm_logits(x, head_matrix(cfg, params), dtype), {}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device, dtype=torch.bfloat16) -> KV.PagedKVCache:
    """Page-pool cache of ``(L, num_pages, page_size, kv, hd)`` per leaf.
    bf16 by default whatever ``cfg.dtype`` is, as in the reference."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.hd())
    return KV.PagedKVCache(pool={"k": torch.zeros(shape, dtype=dtype, device=device),
                                 "v": torch.zeros(shape, dtype=dtype, device=device)},
                           page_size=page_size)


def _prefill_core(cfg: ModelConfig, params: Params, tokens: torch.Tensor, length: int):
    """Bulk prefill compute over a (1, S) padded prompt.  Returns the logits
    of the last real token (1, V) and the full-prompt K/V rows
    ``(L, 1, S, kv, hd)`` per leaf."""
    dtype = L.DTYPES[cfg.dtype]
    x = L.embed_lookup(params["embed"], tokens, dtype)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _block_apply(cfg, layer_params(params["blocks"], i), x,
                                 positions, None, None, dtype, L.DEFAULT_Q_CHUNK,
                                 collect_kv=True)
        ks.append(k)
        vs.append(v)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    x_last = x[:, length - 1:length]
    logits = L.lm_logits(x_last, head_matrix(cfg, params), dtype)
    return logits[:, 0], {"k": torch.stack(ks), "v": torch.stack(vs)}


def prefill_paged(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  cache: KV.PagedKVCache, pages: torch.Tensor, slot: int,
                  length: int) -> Tuple[torch.Tensor, KV.PagedKVCache]:
    """Paged bulk prefill, committed as a one-shot whole-page write at
    ``pages`` (scratch-0 entries protect prefix-shared pages)."""
    del slot
    logits, rows = _prefill_core(cfg, params, tokens, length)
    return logits, KV.commit_pages(cache, rows, pages)


def _decode_core(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor):
    """Decode compute against ``(L, B, S, kv, hd)`` cache views.  tokens:
    (B, T) with token t of row b at ``pos[b] + t``.  Returns (logits
    (B, T, V), new-token K and V of shape (L, B, T, kv, hd))."""
    dtype = L.DTYPES[cfg.dtype]
    b, t = tokens.shape
    pos = pos.to(torch.int32).expand(b)
    x = L.embed_lookup(params["embed"], tokens, dtype)
    positions = L.position_span(pos, t)
    k_tok, v_tok = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _block_apply(cfg, layer_params(params["blocks"], i), x,
                                 positions, (k_cache[i], v_cache[i]), positions,
                                 dtype, L.DEFAULT_Q_CHUNK)
        k_tok.append(k)
        v_tok.append(v)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_logits(x, head_matrix(cfg, params), dtype)
    return logits, torch.stack(k_tok), torch.stack(v_tok)


def decode_paged(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 cache: KV.PagedKVCache, pos: torch.Tensor,
                 block_tables: torch.Tensor) -> Tuple[torch.Tensor, KV.PagedKVCache]:
    """Paged decode step: gather per-slot views through the block tables,
    attend, then commit the new tokens into their pages in place."""
    b = tokens.shape[0]
    pos = pos.to(torch.int32).expand(b)
    views = KV.gather_views(cache, block_tables)
    logits, k_tok, v_tok = _decode_core(cfg, params, tokens, views["k"],
                                        views["v"], pos)
    cache = KV.commit_tokens(cache, {"k": k_tok, "v": v_tok}, block_tables, pos)
    return logits, cache
