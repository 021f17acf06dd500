"""The training cell's token stream, drawn from the seed: a first-order
Markov language (each token has a few successors drawn from the seed, a
share of tokens replaced by uniform noise), one batch per step, every row
different.  (A copy of the program's ``data/synthetic.lm_batch`` recipe,
drawn with numpy here, so the benchmark makes its own inputs.)"""
from __future__ import annotations

from typing import Dict

import numpy as np

TABLE_STREAM = 3 << 32


def lm_tokens(mix: Dict, vocab: int, seed: int, step: int) -> np.ndarray:
    """(batch, seq_len) int32 tokens of training step ``step``."""
    b, s = int(mix["batch"]), int(mix["seq_len"])
    data = mix["data"]
    k = int(data["successors"])
    table = np.random.default_rng([int(seed), TABLE_STREAM]).integers(0, vocab, (vocab, k))
    rng = np.random.default_rng([int(seed), int(step)])
    tok = rng.integers(0, vocab, b)
    choice = rng.integers(0, k, (b, s))
    noisy = rng.random((b, s)) < float(data["noise"])
    noise = rng.integers(0, vocab, (b, s))
    out = np.empty((b, s), np.int64)
    for t in range(s):
        tok = np.where(noisy[:, t], noise[:, t], table[tok, choice[:, t]])
        out[:, t] = tok
    return out.astype(np.int32)
