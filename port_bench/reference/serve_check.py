"""The comparison that decides ``correct`` for a served model.

A sample of the finished requests, drawn from the seed with the longest
among them, is run once through the plain reference over each prompt and
its served tokens (teacher-forced: the served tokens are the reference's
input).  At each position that produced a served token, the gap is how far
the served token's reference logit lies below the reference's best logit;
the widest gap over the sample, and the mean gap, are compared with the
cell's limits (the mean separates a lower precision from the program's
rounding where the widest, which one near-tie can set, does not).  The
control reads, at the same positions, the gap of the token that the
reference computed in the lower precision puts first."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Finished = Tuple[np.ndarray, List[int]]      # (prompt ids, served tokens)


def sample(finished: Sequence[Finished], seed: int, n: int, stream: int) -> List[int]:
    """Indices of ``n`` finished requests drawn from the seed, the longest
    (prompt plus served tokens) always among them."""
    if not finished:
        return []
    sizes = [len(p) + len(t) for p, t in finished]
    longest = int(np.argmax(sizes))
    rest = [i for i in range(len(finished)) if i != longest]
    rng = np.random.default_rng([int(seed), stream])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[int(i)] for i in pick)


def gaps(ref, cfg: Dict, seed: int, picked: Sequence[Finished], forms: Dict,
         precisions: Sequence[str] = ("f32",), device="cuda") -> Dict[str, Dict[str, float]]:
    """``{"max": {...}, "mean": {...}}``: the widest and the mean gap of the
    served tokens under ``"f32"``, and for every other precision those of
    the tokens that precision puts first."""
    seqs, positions = [], []
    for prompt, toks in picked:
        seq = np.concatenate([np.asarray(prompt, np.int64), np.asarray(toks[:-1], np.int64)])
        seqs.append(torch.from_numpy(seq))
        n = len(prompt)
        positions.append(range(n - 1, n - 1 + len(toks)))
    out = ref.logits_at(cfg, seed, seqs, positions, forms=forms, precisions=precisions,
                        device=device)
    every: Dict[str, list] = {p: [] for p in precisions}
    for i, (_, toks) in enumerate(picked):
        f32 = out["f32"][i]
        best = f32.max(dim=-1).values
        for p in precisions:
            tok = (torch.tensor(toks, dtype=torch.long, device=f32.device) if p == "f32"
                   else out[p][i].argmax(dim=-1))
            every[p].append(best - f32.gather(1, tok[:, None])[:, 0])
    cat = {p: torch.cat(g) for p, g in every.items()}
    return {"max": {p: float(g.max()) for p, g in cat.items()},
            "mean": {p: float(g.mean()) for p, g in cat.items()}}
