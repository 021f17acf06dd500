"""Whisper-small, in PyTorch: an encoder-decoder transformer.  The conv
frontend is a stub, as in the JAX package: the encoder takes precomputed
frame embeddings ``(B, S, d)`` through one ``frame_proj`` matrix.

As the reference (its DESIGN.md §8): sinusoidal positional embeddings on
both sides instead of whisper's learned decoder positions, so the param
shapes do not depend on the sequence lengths; LayerNorm with bias; the
biased GELU MLP (tanh form); MHA self-attention without rope (the encoder
bidirectional, the decoder causal); cross attention from the decoder to
the whole encoder output; the head tied to the embedding.

Decode: the decoder's self-attention K/V cache, paged or dense, and the
encoder output ``enc_out`` beside it, slot-addressed (the paged cache's
``dense`` leaf, or the dense cache's third leaf), from which every decode
step projects the cross-attention K/V.  The serving engine, in both
packages, never writes ``enc_out``: it serves against a zero encoder
context unless the caller writes ``encode(frames)`` into the cache.

On a mesh (explicit SPMD, ``models/layers``): the attention blocks run on
the rank's heads where the model axis divides them, else on all heads;
``frame_proj`` is replicated; the MLP keeps its hidden columns local.  The
self-attention cache follows the reference's ``cache_logical_axes``: the
page pool splits its heads over ``model`` (or replicates them where they
do not divide), the dense slot cache splits its heads or, where they do
not divide, its sequence (context-parallel decode).  ``enc_out`` is held
``("batch", None, "model")``: each rank's slots, ``d`` split over
``model``; a decode step gathers it over ``model`` once, before the
layers' cross k/v projections.  Training gathers each FSDP leaf inside
its block (``layers.gathered``), the others once (``layers.gathered_top``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import checkpointed, model_ctx
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_normal, _serving_head, head_matrix,
                                            layer_params, seq_offset, unstack_layers,
                                            with_head_cast, write_slot_rows)
from repro_torch.serving import kv_cache as KV

Params = Dict[str, Any]

__all__ = ["init", "encode", "forward", "head_matrix", "init_cache", "init_paged_cache",
           "prefill", "prefill_paged", "decode_step", "decode_paged", "with_head_cast",
           "sinusoidal_embed", "sinusoidal_positions"]

Q_CHUNK = 512


def sinusoidal_embed(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings of integer positions (S,) -> (S, d) f32: sin at
    the even features, cos at the odd ones."""
    pos = positions.float()[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device)[None, :]
    angle = pos / torch.pow(L._f32_scalar(10000.0, positions.device), dim / d)
    return torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).reshape(-1, d)


def sinusoidal_positions(s: int, d: int, device=None) -> torch.Tensor:
    return sinusoidal_embed(torch.arange(s, device=device), d)


def _blocks_init(g: torch.Generator, cfg: ModelConfig, n: int, cross: bool) -> Params:
    d, f, dev = cfg.d_model, cfg.d_ff, g.device
    hd, nh, nkv = cfg.hd(), cfg.num_heads, cfg.num_kv_heads

    def norm():
        return {"scale": torch.ones((n, d), device=dev), "bias": torch.zeros((n, d), device=dev)}

    def attn(kv):
        return {"wq": _normal(g, (n, d, nh * hd), d ** -0.5, dev),
                "wk": _normal(g, (n, d, kv * hd), d ** -0.5, dev),
                "wv": _normal(g, (n, d, kv * hd), d ** -0.5, dev),
                "wo": _normal(g, (n, nh * hd, d), (nh * hd) ** -0.5, dev)}

    p: Params = {"norm1": norm(), "attn": attn(nkv)}
    if cross:
        p["norm_x"] = norm()
        p["xattn"] = attn(nh)
    p["norm2"] = norm()
    p["mlp"] = {"up": _normal(g, (n, d, f), d ** -0.5, dev),
                "down": _normal(g, (n, f, d), f ** -0.5, dev),
                "b_up": torch.zeros((n, f), device=dev), "b_down": torch.zeros((n, d), device=dev)}
    return p


def init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random params on the generator's device, shaped and keyed like the
    reference's ``init`` (same distributions; other draws)."""
    g, d, dev = generator, cfg.d_model, generator.device

    def norm():
        return {"scale": torch.ones((d,), device=dev), "bias": torch.zeros((d,), device=dev)}

    return {
        "frame_proj": _normal(g, (d, d), d ** -0.5, dev),
        "embed": _normal(g, (cfg.vocab_size, d), 0.02, dev),
        "enc_blocks": _blocks_init(g, cfg, cfg.encoder_layers, cross=False),
        "dec_blocks": _blocks_init(g, cfg, cfg.num_layers, cross=True),
        "enc_final_norm": norm(),
        "final_norm": norm(),
    }


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           remat: bool = False, q_chunk: int = Q_CHUNK) -> torch.Tensor:
    """frames: (B, S, d) precomputed frame embeddings (the stub frontend)
    -> the encoder output (B, S, d)."""
    dtype = L.DTYPES[cfg.dtype]
    params = L.gathered_top(params)
    s = frames.shape[1]
    x = L.linear(params, "frame_proj", frames.to(dtype), dtype)
    x = x + sinusoidal_positions(s, cfg.d_model, x.device).to(dtype)[None]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)

    def body(x, bp):
        bp = L.gathered(bp)
        h, _ = L.attention_block(
            bp["attn"], L.layernorm(x, bp["norm1"], cfg.norm_eps),
            n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, hd=cfg.hd(),
            rope_theta=cfg.rope_theta, positions=positions, q_chunk=q_chunk,
            use_rope=False, causal=False, dtype=dtype)
        x = x + h
        return x + L.gelu_mlp(bp["mlp"], L.layernorm(x, bp["norm2"], cfg.norm_eps), dtype)

    for bp in unstack_layers(params["enc_blocks"], cfg.encoder_layers):
        if remat and torch.is_grad_enabled():
            x = checkpointed(body, x, bp)
        else:
            x = body(x, bp)
    return L.layernorm(x, params["enc_final_norm"], cfg.norm_eps)


def _dec_block_apply(cfg: ModelConfig, bp: Params, x: torch.Tensor, enc_out: torch.Tensor,
                     positions: torch.Tensor, cache, cache_pos, dtype, q_chunk: int,
                     collect_kv: bool = False, seq_off: Optional[int] = None):
    h, new_kv = L.attention_block(
        bp["attn"], L.layernorm(x, bp["norm1"], cfg.norm_eps),
        n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, hd=cfg.hd(),
        rope_theta=cfg.rope_theta, positions=positions, q_chunk=q_chunk,
        cache=cache, cache_pos=cache_pos, use_rope=False, return_kv=collect_kv,
        dtype=dtype, seq_offset=seq_off)
    x = x + h
    x = x + L.cross_attention_block(bp["xattn"], L.layernorm(x, bp["norm_x"], cfg.norm_eps),
                                    enc_out, n_heads=cfg.num_heads, hd=cfg.hd(), dtype=dtype)
    x = x + L.gelu_mlp(bp["mlp"], L.layernorm(x, bp["norm2"], cfg.norm_eps), dtype)
    return x, new_kv


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           positions: torch.Tensor, dtype) -> torch.Tensor:
    """Token embeddings plus the sinusoidal embeddings of their positions
    ((S,) or a (B, T) grid)."""
    x = L.embed_lookup(params["embed"], tokens, dtype)
    pe = sinusoidal_embed(positions.reshape(-1), cfg.d_model).to(dtype)
    return x + (pe[None] if positions.ndim == 1 else pe.reshape(x.shape))


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            remat: bool = False, q_chunk: int = Q_CHUNK, return_hidden: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: ``{"frames": (B, S, d), "tokens": (B, S)}`` -> the decoder's
    logits (B, S, V) (or its final hidden states) and an empty aux."""
    dtype = L.DTYPES[cfg.dtype]
    params = L.gathered_top(params)
    enc_out = encode(cfg, params, batch["frames"], remat=remat, q_chunk=q_chunk)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
    x = _embed(cfg, params, tokens, positions, dtype)

    def body(x, bp):
        return _dec_block_apply(cfg, L.gathered(bp), x, enc_out, positions, None, None,
                                dtype, q_chunk)[0]

    for bp in unstack_layers(params["dec_blocks"], cfg.num_layers):
        if remat and torch.is_grad_enabled():
            x = checkpointed(body, x, bp)
        else:
            x = body(x, bp)
    x = L.layernorm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, {}
    return L.lm_logits(x, _serving_head(cfg, params), dtype), {}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The decoder's self-attention K/V ``(L, batch, max_len, kv, hd)`` and
    the encoder output ``(batch, max_len, d)`` (the encoder context is
    ``max_len`` frames long)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "enc_out": torch.zeros((batch, max_len, cfg.d_model), dtype=dtype, device=device)}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, device,
                     dtype=torch.bfloat16, slots: int = 1,
                     max_len: Optional[int] = None) -> KV.PagedKVCache:
    """The decoder's self-attention K/V paged ``(L, num_pages, page_size,
    kv, hd)``; the encoder output, consumed whole per slot, stays
    slot-addressed in ``dense`` as ``(slots, max_len, d)``."""
    if max_len is None:
        raise ValueError("whisper's paged cache holds a slot-addressed encoder output: "
                         "pass slots= and max_len=")
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.hd())
    return KV.PagedKVCache(
        pool={"k": torch.zeros(shape, dtype=dtype, device=device),
              "v": torch.zeros(shape, dtype=dtype, device=device)},
        page_size=page_size,
        dense={"enc_out": torch.zeros((slots, max_len, cfg.d_model), dtype=dtype,
                                      device=device)})


def _prefill_core(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  enc_out: torch.Tensor, length: int):
    """Decoder bulk prefill over a (1, S) padded prompt against one slot's
    encoder output.  Returns the logits of the last real token (1, V) and
    the full-prompt K/V rows ``(L, 1, S, kv, hd)``."""
    dtype = L.DTYPES[cfg.dtype]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
    x = _embed(cfg, params, tokens, positions, dtype)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _dec_block_apply(cfg, layer_params(params["dec_blocks"], i), x, enc_out,
                                     positions, None, None, dtype, Q_CHUNK, collect_kv=True)
        ks.append(k)
        vs.append(v)
    x = L.layernorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_logits(x[:, length - 1:length], _serving_head(cfg, params), dtype)
    return logits[:, 0], {"k": torch.stack(ks), "v": torch.stack(vs)}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor], slot: int, length: int
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Bulk decoder prefill of one slot of the dense cache against the
    slot's cached encoder output; the prompt's K/V rows are written at
    ``[:, slot, :S]`` in place and ``enc_out`` is left as it is."""
    dtype = L.DTYPES[cfg.dtype]
    enc_out = whole_enc_out(cfg, cache["enc_out"][slot:slot + 1]).to(dtype)
    logits, rows = _prefill_core(cfg, params, tokens, enc_out, length)
    off = seq_offset(cache["k"])
    for name, arr in rows.items():
        write_slot_rows(cache[name], slot, arr, off)
    return logits, cache


def whole_enc_out(cfg: ModelConfig, enc: torch.Tensor) -> torch.Tensor:
    """The slot-addressed encoder output whole along ``d``: on a mesh that
    splits its last dim over ``model`` (``("batch", None, "model")``) the
    ranks' shares gathered, else ``enc`` itself."""
    if enc.shape[-1] == cfg.d_model:
        return enc
    return model_ctx().all_gather(enc, "model", -1)


def prefill_paged(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  cache: KV.PagedKVCache, pages: torch.Tensor, slot: int,
                  length: int) -> Tuple[torch.Tensor, KV.PagedKVCache]:
    """Paged decoder prefill: the self-attention K/V land in whole pages;
    the encoder output is read from the slot-addressed ``dense`` leaf."""
    dtype = L.DTYPES[cfg.dtype]
    enc_out = whole_enc_out(cfg, cache.dense["enc_out"][slot:slot + 1]).to(dtype)
    logits, rows = _prefill_core(cfg, params, tokens, enc_out, length)
    return logits, KV.commit_pages(cache, rows, pages)


def _decode_core(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, enc_out: torch.Tensor,
                 pos: torch.Tensor, seq_off: Optional[int] = None):
    """Decode compute against ``(L, B, S, kv, hd)`` self-attention views,
    written in place; token t of row b sits at ``pos[b] + t``.  Returns
    (logits (B, T, V), new-token K and V ``(L, B, T, kv, hd)``).
    ``seq_off``: the first position of a sequence-sharded dense cache."""
    dtype = L.DTYPES[cfg.dtype]
    b, t = tokens.shape
    positions = L.position_span(pos.to(torch.int32).expand(b), t)
    x = _embed(cfg, params, tokens, positions, dtype)
    enc_out = whole_enc_out(cfg, enc_out).to(dtype)
    k_tok, v_tok = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _dec_block_apply(cfg, layer_params(params["dec_blocks"], i), x, enc_out,
                                     positions, (k_cache[i], v_cache[i]), positions, dtype,
                                     Q_CHUNK, seq_off=seq_off)
        k_tok.append(k)
        v_tok.append(v)
    x = L.layernorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_logits(x, _serving_head(cfg, params), dtype)
    return logits, torch.stack(k_tok), torch.stack(v_tok)


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode step on the dense cache: the layers write the new K/V rows
    into the cache leaves in place (rows past max_len are dropped)."""
    pos = pos.to(torch.int32).expand(tokens.shape[0])
    logits, _, _ = _decode_core(cfg, params, tokens, cache["k"], cache["v"],
                                cache["enc_out"], pos, seq_off=seq_offset(cache["k"]))
    return logits, cache


def decode_paged(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 cache: KV.PagedKVCache, pos: torch.Tensor,
                 block_tables: torch.Tensor) -> Tuple[torch.Tensor, KV.PagedKVCache]:
    """Paged decode step: block-table gathers feed the decoder's
    self-attention, the cross attention reads the slot-addressed encoder
    output, and the new tokens' K/V are committed into their pages."""
    pos = pos.to(torch.int32).expand(tokens.shape[0])
    views = KV.gather_views(cache, block_tables)
    logits, k_tok, v_tok = _decode_core(cfg, params, tokens, views["k"], views["v"],
                                        cache.dense["enc_out"], pos)
    return logits, KV.commit_tokens(cache, {"k": k_tok, "v": v_tok}, block_tables, pos)
