"""Plain reference of the training cell's first steps: the decoder of
``decoder.py`` (float32, TF32 off, each layer recomputed in the backward
pass and the cross-entropy taken in chunks, so a 4k-token sequence fits),
the next-token cross-entropy averaged over every predicted token, the
ADMM penalty ``rho/2 ||W - Z + U||^2`` on every crossbar matrix (Z the
initial weights and U zero until the first Z-update), clipping by the
global norm, and AdamW with a linear warm-up (the configuration's job).

It also re-derives the ADMM Z-update of one matrix (``project``: the
paper's sum rule on fragments of m rows, then a bits-bit grid with one
max-abs scale per column), to judge the program's Z from the program's own
weights."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from port_bench.reference import decoder as D

CE_CHUNK = 1024


def _layer(params: Dict[str, torch.Tensor], cfg: Dict, i: int) -> Dict[str, torch.Tensor]:
    return {path.split("/")[-1]: params[path][i] for path, *_ in D.layout(cfg)[0]}


def _ce_sum(h: torch.Tensor, head: torch.Tensor, targets: torch.Tensor, precision: str):
    logits = D.mm(h, head, precision)
    return (torch.logsumexp(logits, -1) - logits.gather(1, targets[:, None])[:, 0]).sum()


def seq_loss_sum(cfg: Dict, params: Dict, tokens: torch.Tensor, precision: str):
    """Sum of the next-token cross-entropy over one sequence."""
    x = params["embed"][tokens.long()]
    for i in range(cfg["num_layers"]):
        x = checkpoint(lambda x_, i_=i: D.block(cfg, _layer(params, cfg, i_), x_, precision),
                       x, use_reentrant=False)
    h = D.rmsnorm(x[:-1], params["final_norm"], cfg["norm_eps"])
    head = params["embed"].T if cfg.get("tie_embeddings") else params["head"]
    tgt = tokens[1:].long()
    total = 0.0
    for c in range(0, h.shape[0], CE_CHUNK):
        total = total + checkpoint(_ce_sum, h[c:c + CE_CHUNK], head, tgt[c:c + CE_CHUNK],
                                   precision, use_reentrant=False)
    return total


def constrained(cfg: Dict) -> List[str]:
    layer, top = D.layout(cfg)
    return [p for p, _, _, xbar in layer + top if xbar]


def train_steps(cfg: Dict, seed: int, batches: Sequence[torch.Tensor], job: Dict,
                precision: str = "f32", device="cuda") -> Dict:
    """The first ``len(batches)`` steps from the seeded weights: each
    step's loss, each leaf's first gradient norm as AdamW gets it (after
    clipping) and each leaf's change over the steps."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = D.initial_params(cfg, seed, device)
        w0 = {p: t.clone() for p, t in params.items()}
        cons = set(constrained(cfg))
        rho = float(job["admm_rho"])
        m = {p: torch.zeros_like(t) for p, t in params.items()}
        v = {p: torch.zeros_like(t) for p, t in params.items()}
        b1, b2 = float(job["beta1"]), float(job["beta2"])
        losses, g1 = [], {}
        for step, toks in enumerate(batches, start=1):
            for t in params.values():
                t.requires_grad_(True)
            n_tok = toks.shape[0] * (toks.shape[1] - 1)
            loss = 0.0
            for row in toks:
                part = seq_loss_sum(cfg, params, row.to(device), precision) / n_tok
                part.backward()
                loss += float(part.detach())
            with torch.no_grad():
                grads = {}
                for p, t in params.items():
                    g = t.grad
                    if p in cons:
                        diff = t - w0[p]
                        loss += 0.5 * rho * float((diff * diff).sum())
                        g = g + rho * diff
                    grads[p] = g
                    t.grad = None
                    t.requires_grad_(False)
                norm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
                clip = min(1.0, float(job["grad_clip"]) / max(norm, 1e-9))
                lr = float(job["learning_rate"]) * step / max(int(job["warmup_steps"]), 1)
                for p, t in params.items():
                    g = grads[p] * clip
                    if step == 1:
                        g1[p] = float(torch.linalg.vector_norm(g))
                    m[p].mul_(b1).add_((1 - b1) * g)
                    v[p].mul_(b2).add_((1 - b2) * g * g)
                    upd = (m[p] / (1 - b1 ** step)) / (torch.sqrt(v[p] / (1 - b2 ** step))
                                                       + 1e-8)
                    t.sub_(lr * (upd + float(job["weight_decay"]) * t))
            losses.append(loss)
        change = {p: float(torch.linalg.vector_norm(params[p] - w0[p])) for p in params}
        return {"losses": losses, "grad1": g1, "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def project(w: torch.Tensor, m: int, bits: int) -> torch.Tensor:
    """The ADMM Z of one matrix (K, N) with fresh signs: each fragment of
    m rows takes the sign of its sum (rows added in order), entries of the
    other sign are zeroed, and the rest are rounded to a bits-bit grid with
    one max-abs scale per column."""
    k, n = w.shape
    kp = -(-k // m) * m
    wp = torch.zeros((kp, n), dtype=torch.float32, device=w.device)
    wp[:k] = w
    frags = wp.reshape(kp // m, m, n)
    acc = torch.zeros((kp // m, n), dtype=torch.float32, device=w.device)
    for i in range(m):
        acc = acc + frags[:, i, :]
    sign = torch.where(acc >= 0, 1.0, -1.0)
    polar = torch.where(frags * sign[:, None, :] >= 0, frags, 0.0).reshape(kp, n)[:k]
    levels = (1 << bits) - 1
    scale = torch.clamp(polar.abs().amax(dim=0, keepdim=True), min=1e-12) / levels
    return torch.clamp(torch.round(polar / scale), -levels, levels) * scale
