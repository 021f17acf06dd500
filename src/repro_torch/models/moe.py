"""MoE transformer family (olmoe: 64 experts, top-8; deepseek-v3: MLA, one
shared and 256 routed experts top-8, and multi-token prediction), in
PyTorch.

GQA/MHA or MLA attention blocks with a capacity-based mixture-of-experts
FFN, as the JAX package's ``models/moe.py``: the router picks each token's
top-k experts, a sort gives each (token, expert) pair its position in the
expert's buffer, pairs past ``cap = max(4, int(capacity_factor * T * k /
E))`` are dropped, the experts run batched on the ``(E, cap, d)`` buffer
and the outputs are combined with the normalized gates (the reference's
scatter path).  On a mesh whose model axis splits the experts, the tokens
take the reference's expert-parallel path (``distributed/moe_dispatch``:
``all_to_all`` over ``model``, capacity per (rank, expert)) when they split
over it evenly; otherwise the scatter path runs this rank's experts on
their rows of the buffer and the ranks' outputs are summed over ``model``.

Ties break as the reference's: ``lax.top_k`` puts the lower expert index
first among equal probabilities (a stable descending sort here), and the
position sort is stable (``jnp.argsort`` is).  The capacity depends on the
token count, so padding a prompt would change which tokens are dropped:
the family is served at the exact prompt length
(``registry.Model.padded_prefill``).

MLA (deepseek-v3): forward and prefill run the expanded form (per-head
q/k of ``nope + rope`` dims and v of ``v_head_dim`` through
``layers.causal_attention``); decode runs the *absorbed* form, attending
in the latent space against a cache of the compressed latents ``c_kv``
(``kv_lora_rank`` wide) and the shared rope key ``k_rope``, dense ``(L, B,
Smax, .)`` or paged ``(L, P, page, .)``.  The multi-token-prediction module
(``params["mtp"]``: ``proj`` of ``[h_t, emb(token_{t+1})]``, one unstacked
block and a norm) runs in ``forward`` only; serving never runs it, in
either package.

Projections (attention, the shared expert, the untied head) go through
``layers.linear``: the polarized-matmul kernel on a FORMS tree, except the
router, which ``compress_tree`` leaves dense in both packages (the
crossbar predicate's ``"/ro"`` matches ``router``).  Two products run on
weights rebuilt by ``layers.wload``, as the reference's ``einsum`` on
``L.wload`` does (no Pallas kernel there either): the expert FFN
(``torch.einsum`` on a layer's ``(E, K, N)`` experts) and the absorbed
decode's ``kv_up`` (folded into the query and the output).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.distributed import moe_dispatch
from repro_torch.distributed.context import checkpointed, current_context, model_ctx
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_serving_head, layer_params,
                                            unstack_layers, with_head_cast)
from repro_torch.serving import kv_cache as KV

Params = Dict[str, Any]

__all__ = ["init", "forward", "head_matrix", "init_cache", "init_paged_cache",
           "prefill", "prefill_paged", "decode_step", "decode_paged",
           "moe_ffn", "mla_full", "mla_decode", "with_head_cast"]


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


@obs.spanned("rt.moe.ffn")
def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, dtype, batch_aux: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss), the reference's scatter path.
    ``batch_aux`` (the training forward, which every rank runs alike) takes
    the aux loss's means over the whole batch on a mesh whose batch axes
    split it; serving's data ranks run their own slots, so theirs stay
    local."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    logits = L.linear(p, "router", xt, dtype).float()             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, k)                                    # (T, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # aux load-balance loss (switch-style); on a training mesh both means
    # run over the global batch before their product
    mean = _batch_mean if batch_aux else (lambda t: torch.mean(t, dim=0))
    density = mean(F.one_hot(idx[:, 0], e).float())
    prob_mean = mean(probs)
    aux = e * torch.sum(density * prob_mean)

    ctx = model_ctx()
    if moe_dispatch.can_use(ctx, t, e):
        # expert-parallel: this rank's token slice, all_to_all over model
        tp, r = ctx.axis_size("model"), ctx.coord("model")
        t_loc = t // tp
        rows = slice(r * t_loc, (r + 1) * t_loc)
        c2 = max(1, int(cfg.capacity_factor * t_loc * k / e))
        quant = cfg.moe_dispatch_int8
        bufe, slots = moe_dispatch.dispatch(ctx.split(xt, "model", 0).to(dtype), idx[rows],
                                            e, c2, ctx, quantized=quant)
        out_buf = _expert_ffn(p, bufe, dtype)
        y = moe_dispatch.combine(out_buf, idx[rows], slots, ctx.split(gates, "model", 0),
                                 e, c2, ctx, quantized=quant)
        y = ctx.all_gather(y, "model", 0)
    else:
        y = _scatter_experts(p, xt, idx, gates, cfg, dtype)

    if cfg.num_shared_experts:
        xd = xt.to(dtype)
        entry = L.all_split(p, ("shared_gate", "shared_up"))
        if entry:
            xd = L.model_entry(xd)
        hs = (F.silu(L.linear(p, "shared_gate", xd, dtype, x_entry=entry))
              * L.linear(p, "shared_up", xd, dtype, x_entry=entry))
        y = y + L.linear(p, "shared_down", hs, dtype)
    return y.reshape(b, s, d), aux


def _batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over dim 0 of the tokens of the whole batch: on a mesh
    whose batch axes split the tokens, each rank's sum is summed over them
    (backward: the identity, each rank's own tokens)."""
    ctx = current_context()
    nb = ctx.axis_size("batch") if ctx is not None else 1
    if nb == 1:
        return torch.mean(x, dim=0)
    return ctx.all_reduce(x.sum(dim=0), "batch") / (x.shape[0] * nb)


def _scatter_experts(p: Params, xt: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor,
                     cfg: ModelConfig, dtype) -> torch.Tensor:
    """The reference's scatter path: capacity ``max(4, int(cf * T * K /
    E))`` over all T tokens.  With the experts sharded over ``model`` this
    rank runs its experts on their rows of the buffer and the ranks'
    outputs are summed."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    if _local_experts(p["w_gate"]) < e:
        # this rank's experts see every token: the cotangents of the tokens
        # and the gates are partial until summed over model
        ctx = model_ctx()
        xt, gates = ctx.copy_to(xt, "model"), ctx.copy_to(gates, "model")
    cap = max(4, int(cfg.capacity_factor * t * k / e))
    dev = xt.device
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
    e_loc = _local_experts(p["w_gate"])
    ctx = model_ctx()
    lo = (ctx.coord("model") * e_loc) if e_loc < e else 0
    out_loc = _expert_ffn(p, bufe.reshape(e, cap, d)[lo:lo + e_loc], dtype)
    out_loc = out_loc.reshape(e_loc * cap, d)
    mine = valid & (e_flat >= lo) & (e_flat < lo + e_loc)
    y_tk = out_loc[torch.where(mine, dest - lo * cap, 0)]
    y_tk = torch.where(mine[:, None], y_tk, torch.zeros_like(y_tk))
    y_tk = y_tk * gates.reshape(t * k, 1).to(dtype)
    y = y_tk.reshape(t, k, d).sum(dim=1)
    if e_loc < e:
        y = ctx.all_reduce(y.float(), "model").to(dtype)
    return y


def _local_experts(w) -> int:
    """How many experts this rank holds of one layer's expert leaf."""
    if isinstance(w, dict):
        w = w["q"]
    return (w.mags if hasattr(w, "mags") else w).shape[-3]


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v3)
# ---------------------------------------------------------------------------

def mla_init(g: torch.Generator, cfg: ModelConfig, n: int) -> Params:
    """``n`` layers of MLA projections and norms, drawn as the reference
    draws them (other draws)."""
    m: MLAConfig = cfg.mla
    d, h, dev = cfg.d_model, cfg.num_heads, g.device
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim

    def dense(d_in, d_out):
        return _normal(g, (n, d_in, d_out), d_in ** -0.5)

    return {
        "q_down": dense(d, m.q_lora_rank),
        "q_up": dense(m.q_lora_rank, h * qk),
        "kv_down": dense(d, m.kv_lora_rank + m.qk_rope_head_dim),
        "kv_up": dense(m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
        "wo": dense(h * m.v_head_dim, d),
        "q_norm": torch.ones((n, m.q_lora_rank), device=dev),
        "kv_norm": torch.ones((n, m.kv_lora_rank), device=dev),
    }


def _mla_heads(cfg: ModelConfig) -> Tuple[int, bool]:
    """The heads this rank attends with, and whether they are its own
    share: on a mesh whose model size divides the heads, ``H / tp`` (its
    columns of ``q_up`` and ``kv_up``, its rows of ``wo``); otherwise all
    of them, as ``layers.attention_block`` does."""
    ctx = model_ctx()
    tp = ctx.axis_size("model") if ctx is not None else 1
    if tp > 1 and cfg.num_heads % tp == 0:
        return cfg.num_heads // tp, True
    return cfg.num_heads, False


def _mla_q(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, dtype,
           h: int, local: bool):
    """Per-head ``(q_nope, q_rope)`` with rope applied, on ``h`` heads (the
    rank's own when ``local``), and the new tokens' latents ``(c_kv,
    k_rope)``, whole on every rank (``q_down`` and ``kv_down`` are
    replicated)."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    nope, rope, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    cq = L.rmsnorm(L.linear(p, "q_down", x, dtype), p["q_norm"], cfg.norm_eps)
    q = L.linear(p, "q_up", cq, dtype, out_local=local).reshape(b, s, h, nope + rope)
    q_rope = L.apply_rope(q[..., nope:], positions, cfg.rope_theta)
    kv = L.linear(p, "kv_down", x, dtype)
    c_kv = L.rmsnorm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(kv[..., r:], positions, cfg.rope_theta)
    return q[..., :nope], q_rope, c_kv, k_rope


def _mla_qkv_full(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                  dtype, h: int, local: bool):
    """Expanded-form q, k, v for full-sequence attention on ``h`` heads,
    and the latents."""
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_q(p, x, cfg, positions, dtype, h, local)
    kvu = L.linear(p, "kv_up", c_kv, dtype, out_local=local).reshape(b, s, h,
                                                                     nope + m.v_head_dim)
    k_nope, v = kvu[..., :nope], kvu[..., nope:]
    # the shared rope key meets only this rank's heads: its cotangent is
    # partial until summed over model
    k_rope_h = model_ctx().copy_to(k_rope, "model") if local else k_rope
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_h[:, :, None, :].expand(b, s, h, rope)], dim=-1)
    return q_full, k_full, v, c_kv, k_rope


def mla_full(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
             dtype, q_chunk: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expanded-form MLA.  Returns (out, latents): the per-position decode
    cache entries ``{"c_kv", "k_rope"}`` (whole), for prefill's one-shot
    write.  On a mesh the attention runs on :func:`_mla_heads`'s heads and
    ``wo`` sums its K rows' partials over ``model``."""
    h, local = _mla_heads(cfg)
    q, k, v, c_kv, k_rope = _mla_qkv_full(p, x, cfg, positions, dtype, h, local)
    out = L.causal_attention(q, k, v, q_chunk=q_chunk, positions=positions)
    b, s = x.shape[:2]
    return (L.linear(p, "wo", out.reshape(b, s, -1), dtype, x_local=local),
            {"c_kv": c_kv, "k_rope": k_rope})


def cache_rows(arr: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Rows for a latent cache leaf (whole along the last dim) in the
    leaf's layout: this rank's share of the last dim where the leaf holds
    one (``c_kv``'s ``kv_lora_rank`` split over ``model``), else ``arr``."""
    if arr.shape[-1] == leaf.shape[-1]:
        return arr
    return L._cols(arr, model_ctx())


def mla_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Dict[str, torch.Tensor],
               pos: torch.Tensor, dtype) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-form decode: attention in the compressed latent space.

    cache: ``{"c_kv": (B, Smax, r), "k_rope": (B, Smax, rope)}`` views (a
    dense cache's leaves or paged gathers); x is (B, T, d) (T = 1, or K+1
    for a speculative verify); pos is (B,) first-token positions or a
    (B, T) grid.  The new latents are written into the views in place
    (rows past the view are dropped), and only the new tokens' latents
    are returned, for the caller's commit.  The casts are the reference's:
    the query's latent and rope parts go to the cache dtype, the scores
    and the latent output sum in f32, the probabilities go to the cache
    dtype and the latent output to ``dtype``.

    On a mesh the block runs on :func:`_mla_heads`'s heads, with ``w_uk``
    and ``w_uv`` from the rank's ``kv_up`` columns (its heads).  A latent
    cache split along ``r`` over ``model`` (the reference's
    ``cache_logical_axes``) takes this rank's share of the new latents, and
    its view is gathered over ``model`` per layer before the scores, which
    need all of ``r`` for every head: the per-head sums are then the
    one-device ones.  The new latents come back in the cache's layout.
    """
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    nope, dv, r = m.qk_nope_head_dim, m.v_head_dim, m.kv_lora_rank
    h, local = _mla_heads(cfg)
    positions = L.position_grid(pos, b, s)                # (B, T)
    q_nope, q_rope, c_new, k_rope_new = _mla_q(p, x, cfg, positions, dtype, h, local)
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    c_t = cache_rows(c_new.to(c_cache.dtype), c_cache)
    r_t = k_rope_new.to(r_cache.dtype)
    L.write_view(c_cache, c_t, positions)
    L.write_view(r_cache, r_t, positions)
    if c_cache.shape[-1] != r:
        c_cache = model_ctx().all_gather(c_cache, "model", -1)

    # absorb: q_lat[b,t,h,r] = q_nope @ W_uk(h)^T
    w = L.wload(p, "kv_up", dtype)
    if local and w.shape[-1] != h * (nope + dv):
        # a whole kv_up (an int-grid leaf: the MLA rules do not match its
        # ``/q`` codes, in either package): this rank's heads
        w = L._cols(w, model_ctx())
    w = w.reshape(r, h, nope + dv)
    w_uk, w_uv = w[..., :nope], w[..., nope:]
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope.float(), w_uk.float()).to(dtype)
    scale = L.attn_scale(nope + m.qk_rope_head_dim, x.device)
    scores = (torch.einsum("bthr,bsr->bhts", q_lat.to(c_cache.dtype).float(), c_cache.float())
              + torch.einsum("bthp,bsp->bhts", q_rope.to(r_cache.dtype).float(),
                             r_cache.float())) * scale
    kpos = torch.arange(c_cache.shape[1], dtype=torch.int32, device=x.device)
    mask = kpos[None, None, :] <= positions[:, :, None]    # (B, T, S)
    scores = torch.where(mask[:, None], scores, L.MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhts,bsr->bthr", probs.to(c_cache.dtype).float(),
                         c_cache.float()).to(dtype)
    o = torch.einsum("bthr,rhv->bthv", o_lat.float(), w_uv.float()).to(dtype)
    return (L.linear(p, "wo", o.reshape(b, s, h * dv), dtype, x_local=local),
            {"c_kv": c_t, "k_rope": r_t})


# ---------------------------------------------------------------------------
# blocks / model
# ---------------------------------------------------------------------------

def _blocks_init(g: torch.Generator, cfg: ModelConfig, n: int) -> Params:
    d, dev = cfg.d_model, g.device
    hd, nh, nkv = cfg.hd(), cfg.num_heads, cfg.num_kv_heads
    p: Params = {"norm1": torch.ones((n, d), device=dev),
                 "norm2": torch.ones((n, d), device=dev)}
    if cfg.mla is not None:
        p["mla"] = mla_init(g, cfg, n)
    else:
        p["attn"] = {"wq": _normal(g, (n, d, nh * hd), d ** -0.5),
                     "wk": _normal(g, (n, d, nkv * hd), d ** -0.5),
                     "wv": _normal(g, (n, d, nkv * hd), d ** -0.5),
                     "wo": _normal(g, (n, nh * hd, d), (nh * hd) ** -0.5)}
    p["moe"] = moe_ffn_init(g, cfg, n)
    return p


def init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random params on the generator's device, shaped and keyed like the
    reference's ``init`` (same distributions; other draws).  With
    ``cfg.mtp`` the MTP module's block is one unstacked block."""
    g, dev = generator, generator.device
    d = cfg.d_model
    params: Params = {
        "embed": _normal(g, (cfg.vocab_size, d), 0.02),
        "blocks": _blocks_init(g, cfg, cfg.num_layers),
        "final_norm": torch.ones((d,), device=dev),
        "head": _normal(g, (d, cfg.vocab_size), 0.02),
    }
    if cfg.mtp:
        params["mtp"] = {"proj": _normal(g, (2 * d, d), (2 * d) ** -0.5),
                         "block": layer_params(_blocks_init(g, cfg, 1), 0),
                         "norm": torch.ones((d,), device=dev)}
    return params


def _block_apply(cfg: ModelConfig, bp: Params, x: torch.Tensor, positions: torch.Tensor,
                 cache: Optional[Dict[str, torch.Tensor]], cache_pos, dtype, q_chunk: int,
                 collect_kv: bool = False, batch_aux: bool = False):
    """One block.  ``cache``: this layer's cache views by leaf name (MLA
    latents or GQA K/V), or None for full-sequence attention.  Returns (x,
    the load-balance loss, the new rows by leaf name or None)."""
    xa = L.rmsnorm(x, bp["norm1"], cfg.norm_eps)
    new = None
    if cfg.mla is not None:
        if cache is None:
            h, latents = mla_full(bp["mla"], xa, cfg, positions, dtype, q_chunk)
            new = latents if collect_kv else None
        else:
            h, new = mla_decode(bp["mla"], xa, cfg, cache, cache_pos, dtype)
    else:
        h, new_kv = L.attention_block(
            bp["attn"], xa, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, hd=cfg.hd(),
            rope_theta=cfg.rope_theta, positions=positions, q_chunk=q_chunk,
            cache=(cache["k"], cache["v"]) if cache is not None else None,
            cache_pos=cache_pos, return_kv=collect_kv, dtype=dtype)
        if new_kv is not None:
            new = {"k": new_kv[0], "v": new_kv[1]}
    x = x + h
    y, aux = moe_ffn(bp["moe"], L.rmsnorm(x, bp["norm2"], cfg.norm_eps), cfg, dtype,
                     batch_aux=batch_aux)
    return x + y, aux, new


def head_matrix(cfg: ModelConfig, params: Params):
    return params["head"]


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            remat: bool = False, q_chunk: int = L.DEFAULT_Q_CHUNK,
            return_hidden: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  Returns (logits (B, S, V), aux) with
    ``aux["moe_aux_loss"]`` the mean over layers of the load-balance loss.
    With the MTP module, the hidden state at t and the embedding of token
    t+1 go through ``proj``, its block and its norm to predict token t+2:
    its load-balance loss adds ``/ num_layers``, and ``aux`` gains
    ``mtp_logits`` (or ``mtp_hidden`` with ``return_hidden``)."""
    dtype = L.DTYPES[cfg.dtype]
    params = L.gathered_top(params)
    x = L.embed_lookup(params["embed"], batch["tokens"], dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def body(x, bp):
        out, aux, _ = _block_apply(cfg, L.gathered(bp), x, positions, None, None, dtype,
                                   q_chunk, batch_aux=True)
        return out, aux

    auxs = []
    for bp in unstack_layers(params["blocks"], cfg.num_layers):
        if remat and torch.is_grad_enabled():
            x, aux = checkpointed(body, x, bp)
        else:
            x, aux = body(x, bp)
        auxs.append(aux)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    aux_out = {"moe_aux_loss": torch.stack(auxs).mean()}
    if cfg.mtp and "mtp" in params:
        mtp = params["mtp"]
        emb_next = torch.roll(L.embed_lookup(params["embed"], batch["tokens"], dtype),
                              -1, dims=1)
        hm = L.linear(mtp, "proj", torch.cat([x, emb_next], dim=-1), dtype)
        hm, mtp_aux = body(hm, mtp["block"])
        hm = L.rmsnorm(hm, mtp["norm"], cfg.norm_eps)
        aux_out["moe_aux_loss"] = aux_out["moe_aux_loss"] + mtp_aux / max(cfg.num_layers, 1)
        if return_hidden:
            aux_out["mtp_hidden"] = hm
        else:
            aux_out["mtp_logits"] = L.lm_logits(hm, _serving_head(cfg, params), dtype)
    if return_hidden:
        return x, aux_out
    return L.lm_logits(x, _serving_head(cfg, params), dtype), aux_out


def _cache_widths(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The trailing dims of each cache leaf: MLA latents or GQA K/V."""
    if cfg.mla is not None:
        return {"c_kv": (cfg.mla.kv_lora_rank,), "k_rope": (cfg.mla.qk_rope_head_dim,)}
    return {"k": (cfg.num_kv_heads, cfg.hd()), "v": (cfg.num_kv_heads, cfg.hd())}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The dense slot cache: ``(L, batch, max_len, ...)`` per leaf, MLA
    latents ``(.., r)`` and ``(.., rope)`` or GQA K/V ``(.., kv, hd)``."""
    return {name: torch.zeros((cfg.num_layers, batch, max_len, *w), dtype=dtype,
                              device=device)
            for name, w in _cache_widths(cfg).items()}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, device,
                     dtype=torch.bfloat16, slots: int = 1,
                     max_len: Optional[int] = None) -> KV.PagedKVCache:
    """Page-pool cache, ``(L, num_pages, page_size, ...)`` per leaf: MLA
    latents or GQA K/V.  (``slots``/``max_len`` size only slot-addressed
    leaves, which this family has none of.)"""
    del slots, max_len
    return KV.PagedKVCache(
        pool={name: torch.zeros((cfg.num_layers, num_pages, page_size, *w), dtype=dtype,
                                device=device)
              for name, w in _cache_widths(cfg).items()},
        page_size=page_size)


def _serving_top(params: Params) -> Params:
    """The params serving reads, each FSDP leaf outside the layer stack
    gathered once (``layers.gathered_top``; the layers gather their own
    slices): the MTP module, which serving never runs, is left out."""
    return L.gathered_top({k: v for k, v in params.items() if k != "mtp"})


def _prefill_core(cfg: ModelConfig, params: Params, tokens: torch.Tensor, length: int):
    """Bulk prefill compute over a (1, S) prompt.  Returns the logits of
    the last real token (1, V) and the full-prompt rows ``(L, 1, S, ...)``
    per cache leaf."""
    dtype = L.DTYPES[cfg.dtype]
    params = _serving_top(params)
    x = L.embed_lookup(params["embed"], tokens, dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    rows: Dict[str, list] = {name: [] for name in _cache_widths(cfg)}
    for i in range(cfg.num_layers):
        x, _, new = _block_apply(cfg, L.gathered(layer_params(params["blocks"], i)), x,
                                 positions, None, None, dtype, L.DEFAULT_Q_CHUNK,
                                 collect_kv=True)
        for name, arr in new.items():
            rows[name].append(arr)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_logits(x[:, length - 1:length], _serving_head(cfg, params), dtype)
    return logits[:, 0], {name: torch.stack(arrs) for name, arrs in rows.items()}


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
        leaf[:, slot:slot + 1, :arr.shape[2]] = cache_rows(arr, leaf).to(leaf.dtype)
    return logits, cache


def prefill_paged(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  cache: KV.PagedKVCache, pages: torch.Tensor, slot: int,
                  length: int) -> Tuple[torch.Tensor, KV.PagedKVCache]:
    """Paged bulk prefill (exact length), one whole-page write at ``pages``."""
    del slot
    logits, rows = _prefill_core(cfg, params, tokens, length)
    rows = {name: cache_rows(arr, cache.pool[name]) for name, arr in rows.items()}
    return logits, KV.commit_pages(cache, rows, pages)


def _decode_core(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 views: Dict[str, torch.Tensor], pos: torch.Tensor):
    """Decode compute against ``(L, B, S, ...)`` cache views (MLA latents
    or GQA K/V), written in place; token t of row b sits at ``pos[b] + t``.
    Returns (logits (B, T, V), the new-token rows ``(L, B, T, ...)`` per
    leaf).  A multi-token verify (T > 1) routes B*T tokens through the
    dispatch, so drops can differ from T = 1, as in the reference."""
    dtype = L.DTYPES[cfg.dtype]
    b, t = tokens.shape
    params = _serving_top(params)
    x = L.embed_lookup(params["embed"], tokens, dtype)
    positions = L.position_span(pos.to(torch.int32).expand(b), t)
    toks: Dict[str, list] = {name: [] for name in views}
    for i in range(cfg.num_layers):
        x, _, new = _block_apply(cfg, L.gathered(layer_params(params["blocks"], i)), x,
                                 positions, {name: v[i] for name, v in views.items()},
                                 positions, dtype, L.DEFAULT_Q_CHUNK)
        for name, arr in new.items():
            toks[name].append(arr)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_logits(x, _serving_head(cfg, params), dtype)
    return logits, {name: torch.stack(arrs) for name, arrs in toks.items()}


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode step on the dense cache; the attention layers write the new
    rows into the cache leaves in place (rows past max_len are dropped)."""
    pos = pos.to(torch.int32).expand(tokens.shape[0])
    logits, _ = _decode_core(cfg, params, tokens, cache, pos)
    return logits, cache


def decode_paged(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 cache: KV.PagedKVCache, pos: torch.Tensor,
                 block_tables: torch.Tensor) -> Tuple[torch.Tensor, KV.PagedKVCache]:
    """Paged decode step: block-table gathers, attention (MLA absorbed or
    GQA), then the new tokens' rows committed into their pages in place."""
    pos = pos.to(torch.int32).expand(tokens.shape[0])
    views = KV.gather_views(cache, block_tables)
    logits, toks = _decode_core(cfg, params, tokens, views, pos)
    return logits, KV.commit_tokens(cache, toks, block_tables, pos)
