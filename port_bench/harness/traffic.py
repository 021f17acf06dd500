"""The general generator of offline request batches, driven by a mix's
parameters: ``batch_requests`` requests per batch, prompt and output
lengths spread evenly over the inclusive ``prompt_len`` and ``out_len``
ranges, and token ids uniform over the vocabulary.

Every batch holds the same set of lengths, put in another order by the
seed, so every seed and every batch does the same work; the seed draws the
order and the token ids.  (The program's ``serving/loadgen.py`` draws
Poisson arrivals and uniform lengths from one ``RandomState``; this is its
offline counterpart, over the model's whole vocabulary.)"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Batch = List[Tuple[np.ndarray, int]]      # (prompt ids int32, max new tokens)

WARM_STREAM = 1 << 32
CHECK_STREAM = 2 << 32


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` lengths spread evenly over [lo, hi] (the midpoints of n equal
    bins, rounded)."""
    return np.rint(lo + (hi - lo) * (np.arange(n) + 0.5) / n).astype(np.int64)


def batch(mix: Dict, vocab: int, seed: int, j: int) -> Batch:
    """Batch ``j`` of the seeded stream."""
    n = int(mix["batch_requests"])
    rng = np.random.default_rng([int(seed), int(j)])
    plens = rng.permutation(spread(*mix["prompt_len"], n))
    olens = rng.permutation(spread(*mix["out_len"], n))
    return [(rng.integers(0, vocab, size=int(p), dtype=np.int64).astype(np.int32), int(o))
            for p, o in zip(plens, olens)]


def warm_batch(mix: Dict, vocab: int, seed: int, bucket) -> Batch:
    """One short request per prefill shape the mix can reach (``bucket``
    maps a prompt length to the length the program prefills), the longest
    first, with a few new tokens each."""
    lo, hi = mix["prompt_len"]
    reps: Dict[int, int] = {}
    for n in range(lo, hi + 1):
        reps[bucket(n)] = n
    if len(reps) > 8:                   # exact-length prefill: both ends
        reps = {lo: lo, hi: hi}
    rng = np.random.default_rng([int(seed), WARM_STREAM])
    return [(rng.integers(0, vocab, size=n, dtype=np.int64).astype(np.int32), 4)
            for n in sorted(reps.values(), reverse=True)]
