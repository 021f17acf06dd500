"""xLSTM LM (sLSTM + mLSTM blocks, arXiv:2405.04517), in PyTorch.

As the reference (``repro/models/xlstm.py``): every ``slstm_every``-th
block is an sLSTM (scalar memory with recurrent weights: a per-step loop),
all others are mLSTM (matrix memory) on the chunked linear recurrence of
``ssm_common``.  The exponential input gate is a sigmoid; the mLSTM
normalizer rides as an extra value channel (``v' = [v, 1]``, the state
``dk + 1`` wide); blocks are residual pre-norm without FFNs.

The params tree holds a **list**: ``blocks[i]`` is ``{"mlstm": {...}}`` or
``{"slstm": {...}}``, so paths read ``blocks/0/slstm/wz``.  The sLSTM's
recurrent matrices ``rz/ri/rf/ro`` (H, dh, dh) stay dense (the crossbar
predicate leaves them out) and are a ``torch.einsum``, as in the reference.

Decode state is O(1) in the sequence: per mLSTM layer a (B, H, dk, dk+1)
f32 matrix, per sLSTM layer a tuple of three distinct (B, d) f32 tensors
(c, n, h).  Prefill overwrites a slot's whole state with the final state of
a fresh pass; decode advances every slot's state, live or not.

On a mesh the states are split over the slots only (the cache rules give
the mLSTM state ``("batch", None, None, None)``, an sLSTM buffer
``("batch", None)``), so every model rank runs all heads: the N-split
projections (the mLSTM's ``wq/wk/wv/wo/wi/wf``, the sLSTM's ``wz/wi/wf``)
have their outputs gathered (``layers.linear``'s default, whose backward
keeps the input's cotangent whole), ``wout`` and ``wo_g`` are whole (the
list-shaped ``blocks/<i>/...`` counts as scanned, which drops ``wout``'s
leading entry; ``wo_g`` matches no rule), and no leaf splits K, so the
sharded forward is the one-device one.  FSDP leaves are gathered inside
each (remat'd) block, the others once.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import checkpointed
from repro_torch.models import layers as L
from repro_torch.models.ssm_common import (DEFAULT_CHUNK, chunked_linear_recurrence,
                                           recurrence_decode_step)
from repro_torch.models.transformer import (_normal, _serving_head, head_matrix,
                                            with_head_cast)

Params = Dict[str, Any]

__all__ = ["init", "forward", "head_matrix", "init_cache", "prefill", "decode_step",
           "with_head_cast", "mlstm_block", "mlstm_decode", "slstm_block", "slstm_decode"]


def _is_slstm(cfg: ModelConfig, i: int) -> bool:
    return cfg.slstm_every > 0 and i % cfg.slstm_every == 0


def _dense(g: torch.Generator, d_in: int, d_out: int, std: Optional[float] = None):
    return _normal(g, (d_in, d_out), std or d_in ** -0.5, g.device)


def _mlstm_init(g: torch.Generator, cfg: ModelConfig) -> Params:
    d, h, dk = cfg.d_model, cfg.num_heads, cfg.hd()
    return {
        "norm": torch.ones((d,), device=g.device),
        "wq": _dense(g, d, h * dk), "wk": _dense(g, d, h * dk), "wv": _dense(g, d, h * dk),
        "wi": _dense(g, d, h, 0.02), "wf": _dense(g, d, h, 0.02),
        "wo": _dense(g, d, h * dk), "wout": _dense(g, h * dk, d),
        "bf": torch.full((h,), 2.0, device=g.device),   # forget-gate bias: remember
    }


def _mlstm_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, dtype):
    b, s, _ = x.shape
    h, dk = cfg.num_heads, cfg.hd()
    q = L.linear(p, "wq", x, dtype).reshape(b, s, h, dk)
    k = (L.linear(p, "wk", x, dtype).reshape(b, s, h, dk)
         / torch.sqrt(L._f32_scalar(float(dk), x.device)).to(dtype))
    v = L.linear(p, "wv", x, dtype).reshape(b, s, h, dk)
    v_aug = torch.cat([v, torch.ones((b, s, h, 1), dtype=dtype, device=x.device)], dim=-1)
    log_a = F.logsigmoid(L.linear(p, "wf", x, dtype).float() + p["bf"])
    gate = torch.sigmoid(L.linear(p, "wi", x, dtype).float())
    o = torch.sigmoid(L.linear(p, "wo", x, dtype))
    return q, k, v_aug, log_a, gate, o


def _mlstm_finish(p: Params, y_aug: torch.Tensor, o: torch.Tensor, b: int, s: int, dtype):
    # the normalizer channel: num / max(|den|, 1), in the recurrence's
    # output dtype
    num, den = y_aug[..., :-1], y_aug[..., -1:]
    y = num / torch.clamp(den.abs(), min=1.0)
    y = y.reshape(b, s, -1).to(dtype) * o
    return L.linear(p, "wout", y, dtype)


def mlstm_block(p: Params, x: torch.Tensor, cfg: ModelConfig, dtype,
                state: Optional[torch.Tensor] = None, chunk: int = DEFAULT_CHUNK):
    """Full-sequence mLSTM.  Returns (out, final_state)."""
    b, s, _ = x.shape
    xa = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v_aug, log_a, gate, o = _mlstm_qkv(p, xa, cfg, dtype)
    y_aug, fstate = chunked_linear_recurrence(q, k, v_aug, log_a, gate,
                                              init_state=state, chunk=chunk)
    return x + _mlstm_finish(p, y_aug, o, b, s, dtype), fstate


def mlstm_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, dtype, state: torch.Tensor,
                 out: Optional[torch.Tensor] = None):
    """One decode step (x: (B, 1, d)); ``out`` receives the new state."""
    b = x.shape[0]
    xa = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v_aug, log_a, gate, o = _mlstm_qkv(p, xa, cfg, dtype)
    y_aug, new_state = recurrence_decode_step(
        q[:, 0], k[:, 0], v_aug[:, 0], log_a[:, 0], gate[:, 0], state, out=out)
    return x + _mlstm_finish(p, y_aug[:, None], o, b, 1, dtype), new_state


def _slstm_init(g: torch.Generator, cfg: ModelConfig) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    r = lambda: _normal(g, (h, dh, dh), dh ** -0.5, g.device)  # noqa: E731
    return {
        "norm": torch.ones((d,), device=g.device),
        "wz": _dense(g, d, d), "rz": r(),
        "wi": _dense(g, d, d), "ri": r(),
        "wf": _dense(g, d, d), "rf": r(),
        "wo_g": _dense(g, d, d), "ro": r(),
        "wout": _dense(g, d, d),
        "bf": torch.full((d,), 2.0, device=g.device),
    }


_RECURRENT = ("rz", "ri", "rf", "ro")


def _slstm_recurrent(p: Params) -> torch.Tensor:
    """The four recurrent matrices as one (H, dh, 4, dh) f32 operand, made
    once per call: each step then takes one batched matmul for all four
    gates.  f32 whatever the params' dtype, as jnp promotes the f32 state
    against bf16 matrices (the dry run's bf16 params)."""
    return torch.stack([p[k] for k in _RECURRENT], dim=2).float()


def _slstm_cell(r4: torch.Tensor, bf: torch.Tensor, g_in: torch.Tensor, state):
    """One sLSTM step in the heads' layout.  g_in: (B, H, 4, dh), the z/i/f/o
    input projections; state: (c, n, hprev), each (B, H, dh) f32; bf: the
    forget bias (H, dh).  Each gate sums in the reference's order: input,
    recurrent term, then the bias."""
    c, n, hp = state
    z, i, f, o = (g_in + torch.einsum("bhd,hdge->bhge", hp, r4)).unbind(2)
    z, i, o = torch.tanh(z), torch.sigmoid(i), torch.sigmoid(o)
    f = torch.sigmoid(f + bf)
    c = f * c + i * z
    n = f * n + i
    hcur = o * c / torch.clamp(n, min=1.0)
    return (c, n, hcur), hcur


def _slstm_inputs(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The z/i/f/o input projections, (B, S, H, 4, dh) in f32.  They run in
    f32, as the reference's ``L.linear(p, "wz", xa, float32)``: on the card
    the f32 kernel serves them, at M = S in prefill."""
    b, s, d = x.shape
    xa = L.rmsnorm(x, p["norm"], cfg.norm_eps).float()
    heads = (cfg.num_heads, d // cfg.num_heads)
    return torch.stack([L.linear(p, name, xa, torch.float32).reshape(b, s, *heads)
                        for name in ("wz", "wi", "wf", "wo_g")], dim=3)


def slstm_block(p: Params, x: torch.Tensor, cfg: ModelConfig, dtype,
                state: Optional[Tuple[torch.Tensor, ...]] = None):
    """Full-sequence sLSTM, one step at a time.  Returns (out, final_state),
    the state as three (B, d) f32 tensors."""
    b, s, d = x.shape
    pre = _slstm_inputs(p, x, cfg)
    heads = pre.shape[2], pre.shape[4]
    r4, bf = _slstm_recurrent(p), p["bf"].reshape(heads)
    if state is None:
        state = tuple(torch.zeros((b, *heads), dtype=torch.float32, device=x.device)
                      for _ in range(3))
    else:
        state = tuple(t.reshape(b, *heads) for t in state)
    hs = []
    for t in range(s):
        state, hcur = _slstm_cell(r4, bf, pre[:, t], state)
        hs.append(hcur)
    y = L.linear(p, "wout", torch.stack(hs, dim=1).reshape(b, s, d).to(dtype), dtype)
    return x + y, tuple(t.reshape(b, d) for t in state)


def slstm_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, dtype, state):
    """One decode step (x: (B, 1, d)); state: three (B, d) f32 tensors."""
    b, _, d = x.shape
    pre = _slstm_inputs(p, x, cfg)[:, 0]
    heads = pre.shape[1], pre.shape[3]
    new_state, hcur = _slstm_cell(_slstm_recurrent(p), p["bf"].reshape(heads), pre,
                                  tuple(t.reshape(b, *heads) for t in state))
    y = L.linear(p, "wout", hcur.reshape(b, 1, d).to(dtype), dtype)
    return x + y, tuple(t.reshape(b, d) for t in new_state)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random params on the generator's device, shaped and keyed like the
    reference's ``init`` (same distributions; other draws): ``blocks`` is a
    list of per-layer dicts."""
    dev = generator.device
    blocks = [{"slstm": _slstm_init(generator, cfg)} if _is_slstm(cfg, i)
              else {"mlstm": _mlstm_init(generator, cfg)} for i in range(cfg.num_layers)]
    return {
        "embed": _normal(generator, (cfg.vocab_size, cfg.d_model), 0.02, dev),
        "blocks": blocks,
        "final_norm": torch.ones((cfg.d_model,), device=dev),
        "head": _normal(generator, (cfg.d_model, cfg.vocab_size), 0.02, dev),
    }


def _block_fn(cfg: ModelConfig, bp: Params, dtype):
    """The block's full-sequence map; its FSDP leaves are gathered inside,
    so a remat recompute gathers them again."""
    if "slstm" in bp:
        return lambda x: slstm_block(L.gathered(bp["slstm"]), x, cfg, dtype)[0]
    return lambda x: mlstm_block(L.gathered(bp["mlstm"]), x, cfg, dtype)[0]


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            remat: bool = False, q_chunk: int = 0, return_hidden: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  Returns (logits (B, S, V), {}); with
    ``return_hidden`` the final hidden states instead.  ``remat``
    recomputes each block in the backward pass, as the reference's
    ``jax.checkpoint`` per block."""
    del q_chunk
    dtype = L.DTYPES[cfg.dtype]
    params = L.gathered_top(params)
    x = L.embed_lookup(params["embed"], batch["tokens"], dtype)
    for bp in params["blocks"]:
        fn = _block_fn(cfg, bp, dtype)
        if remat and torch.is_grad_enabled():
            x = checkpointed(fn, x)
        else:
            x = fn(x)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, {}
    return L.lm_logits(x, _serving_head(cfg, params), dtype), {}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> Dict[str, Any]:
    """The O(1) recurrent state, f32 whatever ``dtype`` is; ``max_len`` is
    irrelevant (kept for the interface).  An sLSTM layer holds three
    distinct buffers (c, n, h)."""
    del max_len, dtype
    h, dk, d = cfg.num_heads, cfg.hd(), cfg.d_model
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return {f"layer{i}": (tuple(zeros(batch, d) for _ in range(3)) if _is_slstm(cfg, i)
                          else zeros(batch, h, dk, dk + 1))
            for i in range(cfg.num_layers)}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
            slot: int, length: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Bulk prefill of one slot: a full-sequence pass from a fresh state
    (chunked mLSTM, stepped sLSTM), then each layer's final state written
    over the slot's whole state, in place.  tokens: (1, S), NOT padded: the
    recurrent state consumes every token, so the engine prefills this
    family at the exact prompt length (``Model.padded_prefill``).  On a
    mesh ``slot`` is this data rank's index."""
    dtype = L.DTYPES[cfg.dtype]
    params = L.gathered_top(params)
    x = L.embed_lookup(params["embed"], tokens, dtype)
    for i, bp in enumerate(params["blocks"]):
        leaf = cache[f"layer{i}"]
        bp = L.gathered(bp)
        if "slstm" in bp:
            x, fstate = slstm_block(bp["slstm"], x, cfg, dtype)
            for buf, st in zip(leaf, fstate):
                buf[slot].copy_(st[0])
        else:
            x, fstate = mlstm_block(bp["mlstm"], x, cfg, dtype)
            leaf[slot].copy_(fstate[0])
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.lm_logits(x[:, length - 1:length], _serving_head(cfg, params), dtype)
    return logits[:, 0], cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                pos: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step for every slot (tokens (B, 1)); the state carries the
    position, so ``pos`` is unused.  Every layer's state advances in place in
    the cache's buffers."""
    del pos
    dtype = L.DTYPES[cfg.dtype]
    params = L.gathered_top(params)
    x = L.embed_lookup(params["embed"], tokens, dtype)
    for i, bp in enumerate(params["blocks"]):
        key = f"layer{i}"
        bp = L.gathered(bp)
        if "slstm" in bp:
            x, new_state = slstm_decode(bp["slstm"], x, cfg, dtype, cache[key])
            for buf, st in zip(cache[key], new_state):
                buf.copy_(st)
        else:
            x, _ = mlstm_decode(bp["mlstm"], x, cfg, dtype, cache[key], out=cache[key])
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.lm_logits(x, _serving_head(cfg, params), dtype), cache
