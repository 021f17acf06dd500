"""Dense decoder-only transformer family (qwen2 and its kin), in PyTorch.

GQA with arbitrary KV heads, optional QKV bias, sliding-window attention and
tied embeddings, as in the JAX package.  Block params are stacked along a
leading L axis exactly like the reference tree; where the reference runs
``lax.scan`` over layers, the port runs a Python loop over L slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import checkpointed, model_ctx, set_shard, shard_of
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
    return L.take_layer(blocks, i)


def unstack_layers(blocks: Any, n: int) -> list:
    """The stacked block tree as ``n`` per-layer trees.  Each stacked tensor
    is unbound once, so a backward pass returns the ``n`` layer gradients as
    one stack; taking layer i out by indexing would cost a zero-filled
    full-size gradient and its addition for every layer.  A sharded leaf
    keeps its layout per slice (an FSDP slice is gathered in its block)."""
    if isinstance(blocks, dict):
        cols = {k: unstack_layers(v, n) for k, v in blocks.items()}
        return [{k: cols[k][i] for k in cols} for i in range(n)]
    if isinstance(blocks, FormsLinearParams):
        return [blocks.layer(i) for i in range(n)]
    _check_layer_axis(blocks)
    sh = shard_of(blocks)
    if sh is not None:
        return [set_shard(t, sh.layer()) for t in blocks.unbind(0)]
    return list(blocks.unbind(0))


def _check_layer_axis(t: Any) -> None:
    sh = shard_of(t)
    if sh is not None and sh.spec[0] is not None:
        raise NotImplementedError(
            f"a stacked leaf split along its layer axis (spec {sh.spec}) has no local "
            "layer slice; shard it along K or N")


def _block_apply(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                 positions: torch.Tensor, cache, cache_pos, dtype, q_chunk: int,
                 collect_kv: bool = False, seq_offset: Optional[int] = None):
    h, new_kv = L.attention_block(
        bp["attn"], L.rmsnorm(x, bp["norm1"], cfg.norm_eps),
        n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, hd=cfg.hd(),
        rope_theta=cfg.rope_theta, positions=positions,
        window=cfg.sliding_window, q_chunk=q_chunk,
        cache=cache, cache_pos=cache_pos, return_kv=collect_kv, dtype=dtype,
        seq_offset=seq_offset)
    x = x + h
    mlp_in = L.rmsnorm(x, bp["norm2"], cfg.norm_eps)
    if cfg.act_sparsity > 0.0:
        # fragment-structured sparsification of the MLP input, so that the
        # gate/up projections have dead whole fragments to skip too
        mlp_in = L.sparsify_fragments(mlp_in, cfg.act_fragment, cfg.act_sparsity)
    x = x + L.swiglu(bp["mlp"], mlp_in, dtype, act=cfg.mlp_act,
                     frag_drop=cfg.act_sparsity, frag_m=cfg.act_fragment)
    return x, new_kv


def head_matrix(cfg: ModelConfig, params: Params):
    """The LM head: the untied ``head`` or the tied ``embed.T``.  Training
    reads this one, so a tied head's gradient reaches the embedding."""
    head = params.get("head")
    if head is not None:
        return head
    embed = params["embed"]
    sh = shard_of(embed)
    return set_shard(embed.T, sh.transpose() if sh is not None else None)


def _serving_head(cfg: ModelConfig, params: Params):
    """The head the serving paths read: the cast copy if one was made."""
    cast = params.get("head_cast")
    return cast if cast is not None else head_matrix(cfg, params)


def with_head_cast(cfg: ModelConfig, params: Params) -> Params:
    """A shallow copy of ``params`` holding the dense head once in the compute
    dtype.  ``lm_logits`` casts the head on every call; for a tied (V, d)
    embedding that is a full-table read and write per step, and a copy made
    once gives the same numbers.  Serving only: training reads
    :func:`head_matrix`."""
    head = head_matrix(cfg, params)
    if isinstance(head, FormsLinearParams):
        return params
    sh = shard_of(head)
    return {**params, "head_cast": set_shard(head.to(L.DTYPES[cfg.dtype]), sh)}


def _embed_inputs(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
                  dtype: torch.dtype) -> torch.Tensor:
    """The token embeddings, prefixed (VLM) by the batch's precomputed patch
    embeddings ``(B, num_image_tokens, d_model)`` in the compute dtype."""
    x = L.embed_lookup(params["embed"], batch["tokens"], dtype)
    if cfg.num_image_tokens and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(dtype), x], dim=1)
    return x


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            remat: bool = False, q_chunk: int = L.DEFAULT_Q_CHUNK,
            return_hidden: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward (train / prefill).  Returns (logits (B, S, V),
    aux), S counting a VLM batch's patch prefix (``patch_embeds``) before
    its tokens; ``return_hidden=True`` returns the final hidden states
    instead (the chunked-CE training loss never materializes the full
    logits).
    ``remat`` recomputes each block's activations in the backward pass
    (``torch.utils.checkpoint``), keeping only the residual stream between
    blocks, as the reference's ``jax.checkpoint`` over the layer scan does.
    On a training mesh each FSDP leaf is gathered inside its block (a
    recompute gathers it again), the others once up front."""
    dtype = L.DTYPES[cfg.dtype]
    params = L.gathered_top(params)
    x = _embed_inputs(cfg, params, batch, dtype)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)

    def body(x, bp):
        return _block_apply(cfg, L.gathered(bp), x, positions, None, None, dtype, q_chunk)[0]

    for bp in unstack_layers(params["blocks"], cfg.num_layers):
        if remat and torch.is_grad_enabled():
            x = checkpointed(body, x, bp)
        else:
            x = body(x, bp)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, {}
    return L.lm_logits(x, _serving_head(cfg, params), dtype), {}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The dense slot cache: ``(L, batch, max_len, kv, hd)`` per leaf."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device, dtype=torch.bfloat16, slots: int = 1,
                     max_len: Optional[int] = None) -> KV.PagedKVCache:
    """Page-pool cache of ``(L, num_pages, page_size, kv, hd)`` per leaf.
    bf16 by default whatever ``cfg.dtype`` is, as in the reference.
    (``slots``/``max_len`` size only slot-addressed leaves, which this
    family has none of.)"""
    del slots, max_len
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
    logits = L.lm_logits(x_last, _serving_head(cfg, params), dtype)
    return logits[:, 0], {"k": torch.stack(ks), "v": torch.stack(vs)}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor], slot: int, length: int
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Bulk prefill of one slot of the dense cache: the (1, S) padded
    prompt's rows are written at ``[:, slot, :S]`` in place.  Padded rows
    sit past the slot's length and are rewritten before a mask admits
    them."""
    logits, rows = _prefill_core(cfg, params, tokens, length)
    off = seq_offset(cache["k"])
    for name, arr in rows.items():
        write_slot_rows(cache[name], slot, arr, off)
    return logits, cache


def write_slot_rows(leaf: torch.Tensor, slot: int, rows: torch.Tensor,
                    off: Optional[int]) -> None:
    """A prompt's rows ``(L, 1, S, ...)`` into slot ``slot`` of a dense
    ``(L, B, S_max, ...)`` cache leaf at positions ``0 .. S-1``, in place;
    where the leaf holds this rank's sequence slice from position ``off``
    (context-parallel decode, :func:`seq_offset`), only the rows it holds."""
    s = rows.shape[2]
    if off is None:
        leaf[:, slot:slot + 1, :s] = rows.to(leaf.dtype)
        return
    hi = min(off + leaf.shape[2], s)
    if hi > off:
        leaf[:, slot:slot + 1, :hi - off] = rows[:, :, off:hi].to(leaf.dtype)


def seq_offset(leaf: torch.Tensor) -> Optional[int]:
    """The first cache position this rank holds of a dense ``(L, B, S, ...)``
    cache leaf whose sequence is sharded over ``model`` (context-parallel
    decode), else None."""
    sh = shard_of(leaf)
    ctx = model_ctx()
    if sh is None or ctx is None or not sh.on_model(2):
        return None
    return ctx.coord("model") * leaf.shape[2]


def prefill_paged(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  cache: KV.PagedKVCache, pages: torch.Tensor, slot: int,
                  length: int) -> Tuple[torch.Tensor, KV.PagedKVCache]:
    """Paged bulk prefill, committed as a one-shot whole-page write at
    ``pages`` (scratch-0 entries protect prefix-shared pages)."""
    del slot
    logits, rows = _prefill_core(cfg, params, tokens, length)
    return logits, KV.commit_pages(cache, rows, pages)


def _decode_core(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor,
                 seq_off: Optional[int] = None):
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
                                 dtype, L.DEFAULT_Q_CHUNK, seq_offset=seq_off)
        k_tok.append(k)
        v_tok.append(v)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_logits(x, _serving_head(cfg, params), dtype)
    return logits, torch.stack(k_tok), torch.stack(v_tok)


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode step on the dense cache.  tokens: (B, T); pos: (B,) positions
    of the first token.  The attention layers write the new rows straight
    into the cache leaves (positions past max_len are dropped), which is
    the reference's token-column commit, done in place."""
    b = tokens.shape[0]
    pos = pos.to(torch.int32).expand(b)
    logits, _, _ = _decode_core(cfg, params, tokens, cache["k"], cache["v"], pos,
                                seq_off=seq_offset(cache["k"]))
    return logits, cache


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
