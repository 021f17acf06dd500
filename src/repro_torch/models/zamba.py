"""Zamba2 hybrid (arXiv:2411.15242), in PyTorch: a Mamba2 backbone and one
weight-shared attention block applied after every ``shared_attn_every``
Mamba blocks.

As the reference (``repro/models/zamba.py``): the Mamba2 blocks run the
chunked linear recurrence of ``ssm_common`` (q = C, k = B, v = x, decay
exp(dt * A), gate dt); the causal conv acts on the x stream only; the
shared block is a GQA transformer block without per-application LoRA
deltas.  Its weights are shared, its activations are not: each of the
``num_layers / shared_attn_every`` applications has its own K/V rows.

The Mamba block params are stacked along a leading layer axis (``in_proj``
is (L, d, 2 d_in + 2 st + heads)); a layer is taken out with
``transformer.layer_params`` (``FormsLinearParams.layer(i)`` for a
compressed leaf), where the reference scans over the stack.

Decode: the Mamba state is O(1) in the sequence (``ssm`` f32, ``conv`` the
last ``ssm_conv - 1`` inputs in the cache dtype), the shared attention
decodes against its dense K/V rows.  Prefill overwrites a slot's whole
recurrent state with the final state of a fresh pass; decode advances
every slot's state, live or not, and writes each slot's new K/V at its own
position.

On a mesh (an ambient context whose model axis has tp > 1 members) the
Mamba blocks run in the layout of the cache rules (``distributed/
sharding.cache_logical_axes``): the SSM heads over ``model`` where tp
divides them, the conv channels (``d_in``) where tp divides those.  The
Mamba weights match no tensor-parallel rule (their paths are
``blocks/in_proj``..., not ``ssm/...``) and are whole on every rank, so
each rank computes the whole ``in_proj`` product and cuts its channels of
``xs`` and its heads of ``dt`` (and of the per-head weights) out of it,
keeping ``B``, ``C`` and ``z`` whole; ``y`` is gathered over ``model``
before the gate norm (an RMS norm over all of ``d_in``) and the whole
``out_proj``, so every number is the one-device one.  In training the cut
streams take ``split`` (its backward gathers), ``B``/``C`` take
``copy_to`` (every local head adds to their cotangent, which is summed over
``model``).  The shared block is ``layers.attention_block``: its heads over
``model``, or all heads on a dense K/V cache whose sequence is split
(context-parallel decode).  FSDP leaves are gathered per layer slice inside
the (remat'd) block, the others once.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import checkpointed, model_ctx
from repro_torch.models import layers as L
from repro_torch.models.ssm_common import (DEFAULT_CHUNK, causal_conv1d,
                                           chunked_linear_recurrence, recurrence_decode_step)
from repro_torch.models.transformer import (_normal, _serving_head, head_matrix,
                                            layer_params, seq_offset, unstack_layers,
                                            with_head_cast, write_slot_rows)

Params = Dict[str, Any]

__all__ = ["init", "forward", "head_matrix", "init_cache", "prefill", "decode_step",
           "with_head_cast", "mamba_block", "mamba_decode"]


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(applications of the shared block, Mamba blocks before each)."""
    per = cfg.shared_attn_every if cfg.shared_attn_every > 0 else cfg.num_layers
    if cfg.num_layers % per:
        raise ValueError(f"{cfg.num_layers} layers do not split into groups of {per}")
    return cfg.num_layers // per, per


def mamba_init(g: torch.Generator, cfg: ModelConfig) -> Params:
    """The stacked Mamba2 block params of all ``num_layers`` layers."""
    n, d, dev = cfg.num_layers, cfg.d_model, g.device
    d_in, heads = _dims(cfg)
    proj_out = 2 * d_in + 2 * cfg.ssm_state + heads
    a_log = torch.log(torch.linspace(1.0, 16.0, heads, device=dev))
    return {
        "norm": torch.ones((n, d), device=dev),
        "in_proj": _normal(g, (n, d, proj_out), d ** -0.5, dev),
        "conv_w": _normal(g, (n, cfg.ssm_conv, d_in), 0.1, dev),
        "conv_b": torch.zeros((n, d_in), device=dev),
        "a_log": a_log.expand(n, heads).clone(),
        "dt_bias": torch.zeros((n, heads), device=dev),
        "d_skip": torch.ones((n, heads), device=dev),
        "out_proj": _normal(g, (n, d_in, d), d_in ** -0.5, dev),
        "gate_norm": torch.ones((n, d_in), device=dev),
    }


def _ssm_split(cfg: ModelConfig) -> Tuple[bool, bool]:
    """Whether this rank runs its share of (the SSM heads, the conv
    channels) over ``model``: the cache rules' layout of ``ssm`` and
    ``conv`` (each where tp divides it; off a mesh neither)."""
    ctx = model_ctx()
    if ctx is None:
        return False, False
    tp = ctx.axis_size("model")
    d_in, heads = _dims(cfg)
    return heads % tp == 0, d_in % tp == 0


def _mamba_streams(p: Params, x: torch.Tensor, cfg: ModelConfig, dtype,
                   conv_state: Optional[torch.Tensor]):
    b, s, _ = x.shape
    d_in, heads = _dims(cfg)
    st = cfg.ssm_state
    proj = L.linear(p, "in_proj", x, dtype)      # whole on every rank (replicated)
    z, xs, bmat, cmat, dt = torch.split(proj, [d_in, d_in, st, st, heads], dim=-1)
    a_log, dt_bias, conv_w, conv_b = p["a_log"], p["dt_bias"], p["conv_w"], p["conv_b"]
    heads_split, conv_split = _ssm_split(cfg)
    ctx = model_ctx()
    if conv_split:
        # this rank's channels of the conv (its slice of the conv state)
        xs, conv_w, conv_b = (ctx.split(t, "model", -1) for t in (xs, conv_w, conv_b))
    xs, new_conv = causal_conv1d(xs, conv_w.to(dtype), conv_b.to(dtype), conv_state)
    xs = F.silu(xs)
    if conv_split and not heads_split:
        xs = ctx.all_gather(xs, "model", -1)     # every head on every rank
    if heads_split:
        dt, a_log, dt_bias = (ctx.split(t, "model", -1) for t in (dt, a_log, dt_bias))
        bmat, cmat = ctx.copy_to(bmat, "model"), ctx.copy_to(cmat, "model")
    h = dt.shape[-1]
    # F.softplus switches to the identity above threshold=20, where JAX's
    # softplus is logaddexp(x, 0); the two differ by less than e^-20 there
    dt = F.softplus(dt.float() + dt_bias)                             # (B, S, H)
    a = -torch.exp(a_log)                                              # (H,)
    log_a = dt * a[None, None, :]                                      # <= 0
    v = xs.reshape(b, s, h, cfg.ssm_head_dim)
    k = bmat[:, :, None, :].expand(b, s, h, st)
    q = cmat[:, :, None, :].expand(b, s, h, st)
    return z, v, k, q, log_a, dt, new_conv


def _mamba_finish(p: Params, y: torch.Tensor, v: torch.Tensor, z: torch.Tensor,
                  cfg: ModelConfig, dtype, b: int, s: int) -> torch.Tensor:
    d_skip = p["d_skip"]
    heads_split, _ = _ssm_split(cfg)
    if heads_split:
        d_skip = model_ctx().split(d_skip, "model", -1)
    y = y + v * d_skip[None, None, :, None].to(dtype)
    y = y.reshape(b, s, -1)
    if heads_split:
        # the gate norm is over all of d_in: every rank takes the whole y
        y = model_ctx().all_gather(y, "model", -1)
    y = L.rmsnorm(y, p["gate_norm"], cfg.norm_eps) * F.silu(z)
    return L.linear(p, "out_proj", y, dtype)


def mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig, dtype,
                chunk: int = DEFAULT_CHUNK, return_state: bool = False):
    """Full-sequence Mamba2 block of one layer.  ``return_state=True`` also
    returns the final (ssm_state, conv_state), which bulk prefill writes
    into the slot."""
    b, s, _ = x.shape
    xa = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    z, v, k, q, log_a, dt, new_conv = _mamba_streams(p, xa, cfg, dtype, None)
    y, fstate = chunked_linear_recurrence(q, k, v, log_a, dt, chunk=chunk)
    out = x + _mamba_finish(p, y.to(dtype), v, z, cfg, dtype, b, s)
    if return_state:
        return out, fstate, new_conv
    return out


def mamba_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, dtype,
                 ssm_state: torch.Tensor, conv_state: torch.Tensor,
                 ssm_out: Optional[torch.Tensor] = None):
    """One decode step (x: (B, 1, d)).  Returns (out, new_ssm, new_conv);
    ``ssm_out`` receives the new ssm state in place."""
    b = x.shape[0]
    xa = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    z, v, k, q, log_a, dt, new_conv = _mamba_streams(p, xa, cfg, dtype, conv_state)
    y, new_ssm = recurrence_decode_step(q[:, 0], k[:, 0], v[:, 0], log_a[:, 0], dt[:, 0],
                                        ssm_state, out=ssm_out)
    out = x + _mamba_finish(p, y[:, None].to(dtype), v, z, cfg, dtype, b, 1)
    return out, new_ssm, new_conv


def shared_attn_init(g: torch.Generator, cfg: ModelConfig) -> Params:
    d, f, dev = cfg.d_model, cfg.d_ff, g.device
    hd, nh, nkv = cfg.hd(), cfg.num_heads, cfg.num_kv_heads

    def dense(d_in, d_out):
        return _normal(g, (d_in, d_out), d_in ** -0.5, dev)

    return {
        "norm1": torch.ones((d,), device=dev),
        "attn": {"wq": dense(d, nh * hd), "wk": dense(d, nkv * hd),
                 "wv": dense(d, nkv * hd), "wo": dense(nh * hd, d)},
        "norm2": torch.ones((d,), device=dev),
        "mlp": {"gate": dense(d, f), "up": dense(d, f), "down": dense(f, d)},
    }


def _shared_attn_apply(sp: Params, x: torch.Tensor, cfg: ModelConfig,
                       positions: torch.Tensor, cache, pos, dtype, q_chunk: int,
                       collect_kv: bool = False, seq_off: Optional[int] = None):
    h, new_kv = L.attention_block(
        sp["attn"], L.rmsnorm(x, sp["norm1"], cfg.norm_eps),
        n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, hd=cfg.hd(),
        rope_theta=cfg.rope_theta, positions=positions, q_chunk=q_chunk,
        cache=cache, cache_pos=pos, return_kv=collect_kv, dtype=dtype,
        seq_offset=seq_off)
    x = x + h
    x = x + L.swiglu(sp["mlp"], L.rmsnorm(x, sp["norm2"], cfg.norm_eps), dtype)
    return x, new_kv


def init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random params on the generator's device, shaped and keyed like the
    reference's ``init`` (same distributions; other draws)."""
    dev = generator.device
    return {
        "embed": _normal(generator, (cfg.vocab_size, cfg.d_model), 0.02, dev),
        "blocks": mamba_init(generator, cfg),
        "shared_attn": shared_attn_init(generator, cfg),
        "final_norm": torch.ones((cfg.d_model,), device=dev),
        "head": _normal(generator, (cfg.d_model, cfg.vocab_size), 0.02, dev),
    }


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            remat: bool = False, q_chunk: int = L.DEFAULT_Q_CHUNK,
            return_hidden: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  Returns (logits (B, S, V), {}); with
    ``return_hidden`` the final hidden states instead.  ``remat``
    recomputes each Mamba block in the backward pass, as the reference's
    ``jax.checkpoint`` of its scan body (the shared block is not)."""
    dtype = L.DTYPES[cfg.dtype]
    params = L.gathered_top(params)
    x = L.embed_lookup(params["embed"], batch["tokens"], dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    n_groups, per = _groups(cfg)
    layers = unstack_layers(params["blocks"], cfg.num_layers)

    def body(x, bp):
        return mamba_block(L.gathered(bp), x, cfg, dtype)

    for g in range(n_groups):
        for bp in layers[g * per:(g + 1) * per]:
            if remat and torch.is_grad_enabled():
                x = checkpointed(body, x, bp)
            else:
                x = body(x, bp)
        x, _ = _shared_attn_apply(params["shared_attn"], x, cfg, positions, None, None,
                                  dtype, q_chunk)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, {}
    return L.lm_logits(x, _serving_head(cfg, params), dtype), {}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """``ssm`` (L, B, H, st, hd) f32; ``conv`` (L, B, K-1, d_in) and the
    shared block's ``attn_k``/``attn_v`` (groups, B, max_len, kv, hd) in
    ``dtype``."""
    d_in, heads = _dims(cfg)
    n_groups, _ = _groups(cfg)
    kv_shape = (n_groups, batch, max_len, cfg.num_kv_heads, cfg.hd())
    return {
        "ssm": torch.zeros((cfg.num_layers, batch, heads, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.num_layers, batch, cfg.ssm_conv - 1, d_in), dtype=dtype,
                            device=device),
        "attn_k": torch.zeros(kv_shape, dtype=dtype, device=device),
        "attn_v": torch.zeros(kv_shape, dtype=dtype, device=device),
    }


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor], slot: int, length: int
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Bulk prefill of one slot, in place: the chunked SSD over the prompt
    from a fresh state, each layer's final ssm/conv state written over the
    slot's, and each shared-block application's K/V rows at ``[:S]``.
    tokens: (1, S), NOT padded: the SSM and conv state consume every token
    (``Model.padded_prefill``).  On a mesh ``slot`` is this data rank's
    index, and a K/V cache whose sequence is split over ``model`` takes
    the rank's positions only."""
    dtype = L.DTYPES[cfg.dtype]
    params = L.gathered_top(params)
    x = L.embed_lookup(params["embed"], tokens, dtype)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    n_groups, per = _groups(cfg)
    off = seq_offset(cache["attn_k"])
    for g in range(n_groups):
        for i in range(g * per, (g + 1) * per):
            x, fs, fc = mamba_block(L.gathered(layer_params(params["blocks"], i)), x, cfg,
                                    dtype, return_state=True)
            cache["ssm"][i, slot].copy_(fs[0])
            cache["conv"][i, slot].copy_(fc[0])
        x, (k, v) = _shared_attn_apply(params["shared_attn"], x, cfg, positions, None, None,
                                       dtype, L.DEFAULT_Q_CHUNK, collect_kv=True)
        write_slot_rows(cache["attn_k"][g:g + 1], slot, k[None], off)
        write_slot_rows(cache["attn_v"][g:g + 1], slot, v[None], off)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_logits(x[:, length - 1:length], _serving_head(cfg, params), dtype)
    return logits[:, 0], cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step for every slot, in place.  tokens: (B, 1); pos: (B,)
    per-slot positions (or a scalar).  Each layer's ssm state advances in
    its cache buffer, the conv state is rewritten in the cache dtype, and
    the shared block writes each slot's new K/V at ``(slot, pos[slot])``
    (positions past max_len are dropped, as the reference's scatter)."""
    dtype = L.DTYPES[cfg.dtype]
    params = L.gathered_top(params)
    b = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device).to(torch.int32).expand(b)
    x = L.embed_lookup(params["embed"], tokens, dtype)
    positions = pos[:, None]
    n_groups, per = _groups(cfg)
    off = seq_offset(cache["attn_k"])
    for g in range(n_groups):
        for i in range(g * per, (g + 1) * per):
            ssm = cache["ssm"][i]
            x, _, new_conv = mamba_decode(L.gathered(layer_params(params["blocks"], i)), x,
                                          cfg, dtype, ssm, cache["conv"][i], ssm_out=ssm)
            cache["conv"][i].copy_(new_conv)
        x, _ = _shared_attn_apply(params["shared_attn"], x, cfg, positions,
                                  (cache["attn_k"][g], cache["attn_v"][g]), positions,
                                  dtype, L.DEFAULT_Q_CHUNK, seq_off=off)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.lm_logits(x, _serving_head(cfg, params), dtype), cache
