"""Deterministic synthetic LM data.

Every batch is a pure function of (seed, step), so a resumed run sees the
batches it would have seen.  The stream embeds learnable structure (a noisy
Markov chain over the vocab with four successors per token) so training
loss measurably decreases.

``_transition_table`` is the reference's numpy code, so the table is the
same.  The draws come from a ``torch.Generator`` seeded from (seed, step),
not from ``jax.random``: the tokens differ from the reference's, and parity
tests feed both packages one batch.  The reference's image stream belongs
with the CNN family and is not ported yet.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator, Union

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class LMStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 1            # Markov order of the synthetic language
    noise: float = 0.1        # fraction of uniform-random tokens


def _transition_table(vocab: int, seed: int) -> np.ndarray:
    """Sparse-ish row-stochastic transition table (deterministic in seed)."""
    rng = np.random.RandomState(seed)
    nexts = rng.randint(0, vocab, size=(vocab, 4))
    return nexts  # each token has 4 plausible successors


@functools.lru_cache(maxsize=4)
def _table(vocab: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(_transition_table(vocab, seed))


def lm_batch(cfg: LMStreamConfig, step: int,
             device: Union[str, torch.device, None] = DEFAULT_DEVICE
             ) -> Dict[str, torch.Tensor]:
    """Batch at a given step: tokens (global_batch, seq_len) int32.

    Drawn on the CPU (so the batch is the same whatever the device) and
    moved to ``device`` once: loading data is set-up, not step time.
    """
    dev = resolve_device(device)
    g = torch.Generator()
    g.manual_seed((cfg.seed * 1_000_003 + step) % (2 ** 63))
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    table = _table(v, cfg.seed)
    tok = torch.randint(0, v, (b,), generator=g)
    choices = torch.randint(0, 4, (b, s), generator=g)
    noise_mask = torch.rand((b, s), generator=g) < cfg.noise
    noise_tok = torch.randint(0, v, (b, s), generator=g)
    seq = torch.empty((b, s), dtype=torch.int64)
    for t in range(s):
        tok = torch.where(noise_mask[:, t], noise_tok[:, t], table[tok, choices[:, t]])
        seq[:, t] = tok
    return {"tokens": seq.to(torch.int32).to(dev)}


def lm_stream(cfg: LMStreamConfig, start_step: int = 0,
              device: Union[str, torch.device, None] = DEFAULT_DEVICE
              ) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield lm_batch(cfg, step, device)
        step += 1
