"""Plain reference of the decoder-only families the benchmark serves and
trains (qwen2's dense GQA block with QKV bias and a tied head; OLMoE's
MHA block with a routed SwiGLU MoE FFN and an untied head), in float32
PyTorch with TF32 off, written from the published equations and the
configuration's departures (``assumed`` in its file), with no kernel,
cache or batching of the program.

It also states the weight layout the benchmark draws from the seed
(:func:`layout`): the same leaves are handed to the program as its params
tree and re-drawn here, layer by layer, after the program is gone.

FORMS (arXiv:2106.09144 §III): every crossbar matrix is split into
fragments of ``m`` consecutive rows of one column; each fragment keeps the
sign whose entries carry more squared mass (entries of the other sign are
zeroed), and the magnitudes are quantized to ``bits``-bit codes with one
max-abs scale per column.  :func:`forms_project` re-derives that from the
dense weight, as the program's compression does.

``precision="fp8"`` is the control: every product's operands are rounded
to float8 e4m3 (rows of the left operand and columns of the right one
scaled to the format's range first), the precision below the bf16 the
configuration serves in.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

F8_MAX = 448.0


# ---------------------------------------------------------------------------
# the weight layout and its seeded draws
# ---------------------------------------------------------------------------

# a leaf: (path, shape of one layer's slice (of the whole leaf at the top
# level), init, crossbar matrix); init: ("normal", std) or ("one_plus", std)
Leaf = Tuple[str, Tuple[int, ...], Tuple[str, float], bool]


def layout(cfg: Dict) -> Tuple[List[Leaf], List[Leaf]]:
    """(stacked per-layer leaves, top-level leaves) of the params tree."""
    d, h, kv, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    v = cfg["vocab_size"]
    layer: List[Leaf] = [
        ("blocks/norm1", (d,), ("one_plus", 0.02), False),
        ("blocks/norm2", (d,), ("one_plus", 0.02), False),
        ("blocks/attn/wq", (d, h * hd), ("normal", d ** -0.5), True),
        ("blocks/attn/wk", (d, kv * hd), ("normal", d ** -0.5), True),
        ("blocks/attn/wv", (d, kv * hd), ("normal", d ** -0.5), True),
        ("blocks/attn/wo", (h * hd, d), ("normal", (h * hd) ** -0.5), True),
    ]
    if cfg.get("qkv_bias"):
        layer += [("blocks/attn/bq", (h * hd,), ("normal", 0.02), False),
                  ("blocks/attn/bk", (kv * hd,), ("normal", 0.02), False),
                  ("blocks/attn/bv", (kv * hd,), ("normal", 0.02), False)]
    if cfg.get("num_experts"):
        e, f = cfg["num_experts"], cfg["moe_d_ff"]
        layer += [("blocks/moe/router", (d, e), ("normal", 0.02), False),
                  ("blocks/moe/w_gate", (e, d, f), ("normal", d ** -0.5), True),
                  ("blocks/moe/w_up", (e, d, f), ("normal", d ** -0.5), True),
                  ("blocks/moe/w_down", (e, f, d), ("normal", f ** -0.5), True)]
    else:
        f = cfg["d_ff"]
        layer += [("blocks/mlp/gate", (d, f), ("normal", d ** -0.5), True),
                  ("blocks/mlp/up", (d, f), ("normal", d ** -0.5), True),
                  ("blocks/mlp/down", (f, d), ("normal", f ** -0.5), True)]
    top: List[Leaf] = [("embed", (v, d), ("normal", 0.02), False),
                       ("final_norm", (d,), ("one_plus", 0.02), False)]
    if not cfg.get("tie_embeddings"):
        top.append(("head", (d, v), ("normal", 0.02), True))
    return layer, top


def _seed_of(seed: int, path: str, layer: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(path.encode()) * 1000003
            + layer + 1) % (1 << 63)


def draw_into(out: torch.Tensor, seed: int, path: str, layer: int,
              init: Tuple[str, float]) -> torch.Tensor:
    """Fill ``out`` with the leaf's seeded values (one draw per leaf and
    layer, on ``out``'s device)."""
    g = torch.Generator(device=out.device)
    g.manual_seed(_seed_of(seed, path, layer))
    kind, std = init
    out.normal_(0.0, std, generator=g)
    if kind == "one_plus":
        out.add_(1.0)
    return out


def draw(seed: int, path: str, layer: int, shape: Sequence[int],
         init: Tuple[str, float], device) -> torch.Tensor:
    return draw_into(torch.empty(tuple(shape), dtype=torch.float32, device=device),
                     seed, path, layer, init)


def initial_params(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf by path, the block leaves stacked ``(L, ...)`` as the
    program holds them (one draw per leaf and layer)."""
    layer, top = layout(cfg)
    out = {}
    for path, shape, init, _ in layer:
        t = torch.empty((cfg["num_layers"], *shape), dtype=torch.float32, device=device)
        for i in range(cfg["num_layers"]):
            draw_into(t[i], seed, path, i, init)
        out[path] = t
    for path, shape, init, _ in top:
        out[path] = draw(seed, path, 0, shape, init, device)
    return out


# ---------------------------------------------------------------------------
# FORMS projection of one dense matrix
# ---------------------------------------------------------------------------

def forms_project(w: torch.Tensor, m: int, bits: int) -> torch.Tensor:
    """The dense f32 matrix the FORMS codes of ``w`` (K, N) stand for:
    energy-rule fragment signs, the disagreeing entries zeroed, magnitudes
    on a ``bits``-bit grid with one max-abs scale per column."""
    k, n = w.shape
    kp = -(-k // m) * m
    wp = torch.zeros((kp, n), dtype=torch.float32, device=w.device)
    wp[:k] = w
    frags = wp.reshape(kp // m, m, n)
    pos = torch.zeros((kp // m, n), dtype=torch.float32, device=w.device)
    neg = torch.zeros_like(pos)
    for i in range(m):                  # rows added in order, in f32
        r = frags[:, i, :]
        pos = pos + torch.clamp(r, min=0.0) ** 2
        neg = neg + torch.clamp(r, max=0.0) ** 2
    sign = torch.where(pos >= neg, 1.0, -1.0)
    polar = torch.where(frags * sign[:, None, :] >= 0, frags, 0.0).reshape(kp, n)
    levels = (1 << bits) - 1
    scale = torch.clamp(polar.abs().amax(dim=0, keepdim=True), min=1e-12) / levels
    codes = torch.clamp(torch.round(polar / scale), -levels, levels)
    mags = codes.abs()
    grid = sign.repeat_interleave(m, dim=0)
    return (mags * grid * scale)[:k]


def layer_weights(cfg: Dict, seed: int, i: int, device, forms: Optional[Dict]) -> Dict:
    """Layer ``i``'s weights as the reference uses them (crossbar matrices
    through :func:`forms_project` when ``forms`` gives ``m`` and ``bits``)."""
    out = {}
    for path, shape, init, xbar in layout(cfg)[0]:
        t = draw(seed, path, i, shape, init, device)
        if xbar and forms is not None:
            if t.ndim == 3:             # experts: one crossbar matrix each
                t = torch.stack([forms_project(x, forms["m"], forms["bits"]) for x in t])
            else:
                t = forms_project(t, forms["m"], forms["bits"])
        out[path.split("/")[-1]] = t
    return out


def top_weights(cfg: Dict, seed: int, device, forms: Optional[Dict]) -> Dict:
    out = {}
    for path, shape, init, xbar in layout(cfg)[1]:
        t = draw(seed, path, 0, shape, init, device)
        if xbar and forms is not None:
            t = forms_project(t, forms["m"], forms["bits"])
        out[path] = t
    return out


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------

def _f8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with a max-abs scale along ``dim``."""
    s = torch.clamp(t.abs().amax(dim=dim, keepdim=True), min=1e-30) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32, or with fp8 operands for the control (rounded
    in the forward pass; a gradient passes as if they had not been)."""
    if precision == "fp8":
        a = a + (_f8(a.detach(), -1) - a).detach()
        b = b + (_f8(b.detach(), -2) - b).detach()
    return a @ b


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on interleaved pairs (x[..., 2j], x[..., 2j+1]) at
    positions 0..S-1; x: (S, H, hd)."""
    s, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1).reshape(x.shape)


def attention(cfg: Dict, w: Dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    """Causal GQA self-attention over x (S, d)."""
    s = x.shape[0]
    h, kv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q, k, v = mm(x, w["wq"], precision), mm(x, w["wk"], precision), mm(x, w["wv"], precision)
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = rope(q.reshape(s, h, hd), cfg["rope_theta"]).transpose(0, 1)      # (H, S, hd)
    k = rope(k.reshape(s, kv, hd), cfg["rope_theta"]).transpose(0, 1)
    v = v.reshape(s, kv, hd).transpose(0, 1)
    g = h // kv
    k, v = k.repeat_interleave(g, dim=0), v.repeat_interleave(g, dim=0)
    scores = mm(q, k.transpose(1, 2), precision) / math.sqrt(hd)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = mm(probs, v, precision).transpose(0, 1).reshape(s, h * hd)
    return mm(out, w["wo"], precision)


def swiglu(x, gate, up, down, precision):
    return mm(torch.nn.functional.silu(mm(x, gate, precision)) * mm(x, up, precision),
              down, precision)


def moe(cfg: Dict, w: Dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    """Routed SwiGLU experts, every token to its top-k experts (no token is
    dropped); the k gates renormalized to sum to one (``assumed``)."""
    probs = torch.softmax(x @ w["router"], dim=-1)
    gates, idx = torch.topk(probs, cfg["experts_per_token"], dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if len(tok) == 0:
            continue
        out = swiglu(x[tok], w["w_gate"][e], w["w_up"][e], w["w_down"][e], precision)
        y.index_add_(0, tok, out * gates[tok, slot][:, None])
    return y


def block(cfg: Dict, w: Dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    eps = cfg["norm_eps"]
    x = x + attention(cfg, w, rmsnorm(x, w["norm1"], eps), precision)
    hx = rmsnorm(x, w["norm2"], eps)
    if cfg.get("num_experts"):
        return x + moe(cfg, w, hx, precision)
    return x + swiglu(hx, w["gate"], w["up"], w["down"], precision)


def logits_at(cfg: Dict, seed: int, seqs: Sequence[torch.Tensor],
              positions: Sequence[Iterable[int]], *, forms: Optional[Dict],
              precisions: Sequence[str] = ("f32",), device="cuda") -> Dict[str, List]:
    """For each precision, the logits (P_i, V) of each sequence at its
    ``positions``, layer by layer over all sequences (one layer's weights
    drawn at a time, so the reference fits beside nothing else)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            top = top_weights(cfg, seed, device, forms)
            xs = {p: [top["embed"][s.to(device).long()] for s in seqs] for p in precisions}
            for i in range(cfg["num_layers"]):
                w = layer_weights(cfg, seed, i, device, forms)
                for p in precisions:
                    xs[p] = [block(cfg, w, x, p) for x in xs[p]]
                del w
            head = top["embed"].T if cfg.get("tie_embeddings") else top["head"]
            out = {}
            for p in precisions:
                out[p] = []
                for x, pos in zip(xs[p], positions):
                    hx = rmsnorm(x[list(pos)], top["final_norm"], cfg["norm_eps"])
                    out[p].append(mm(hx, head, p))
            return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
