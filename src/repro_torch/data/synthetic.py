"""Deterministic synthetic data: the LM stream and the CNNs' image stream.

Every batch is a pure function of (seed, step), so a resumed run sees the
batches it would have seen.  The LM stream embeds learnable structure (a
noisy Markov chain over the vocab with four successors per token) so
training loss measurably decreases; the image stream paints a
class-dependent blob into noise, a task a small CNN learns in a few hundred
steps.

``_transition_table`` is the reference's numpy code, so the table is the
same, and the blob is the reference's formula, a pure function of the
labels.  The draws (tokens, labels, noise) come from a ``torch.Generator``
seeded from (seed, step), not from ``jax.random``: they differ from the
reference's, and parity tests feed both packages one batch.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Iterator, Tuple, Union

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


@dataclasses.dataclass(frozen=True)
class ImageStreamConfig:
    image_size: int
    channels: int
    num_classes: int
    batch: int
    seed: int = 0


def class_blob(labels: torch.Tensor, image_size: int, num_classes: int) -> torch.Tensor:
    """The noise-free image of each label, (B, H, W) f32: a Gaussian blob
    centred on a ring at the label's angle (the reference's formula)."""
    size = image_size
    coords = torch.arange(size, dtype=torch.float32, device=labels.device)
    ang = 2 * math.pi * labels.float() / num_classes
    cx = size / 2 + (size / 4) * torch.cos(ang)
    cy = size / 2 + (size / 4) * torch.sin(ang)
    xx = coords[None, :, None] - cx[:, None, None]
    yy = coords[None, None, :] - cy[:, None, None]
    return torch.exp(-(xx ** 2 + yy ** 2) / (2 * (size / 8) ** 2))


def image_batch(cfg: ImageStreamConfig, step: int,
                device: Union[str, torch.device, None] = DEFAULT_DEVICE
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-dependent blob images (B, H, W, C) f32 (NHWC, as the
    reference's) and labels (B,) int32: each class paints its blob, every
    channel the same, plus noise of standard deviation 0.3.

    Labels and noise are drawn on the CPU from a generator seeded from
    (seed + 1, step), as the reference folds ``step`` into ``seed + 1``, and
    the batch is moved to ``device`` once."""
    dev = resolve_device(device)
    g = torch.Generator()
    g.manual_seed(((cfg.seed + 1) * 1_000_003 + step) % (2 ** 63))
    size = cfg.image_size
    labels = torch.randint(0, cfg.num_classes, (cfg.batch,), generator=g)
    noise = 0.3 * torch.randn((cfg.batch, size, size, cfg.channels), generator=g)
    img = class_blob(labels, size, cfg.num_classes)[..., None] + noise
    return img.to(dev), labels.to(torch.int32).to(dev)
