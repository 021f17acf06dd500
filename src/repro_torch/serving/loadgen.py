"""Deterministic open-loop load generator for sustained-load benchmarking
(the JAX package's ``serving/loadgen.py``: the same draws from the same
``RandomState``, so a trace equals the reference's field for field).

The fleet scheduler's whole point is behavior under *sustained* traffic —
FORMS's frames-per-second claim, not single-request latency — and sustained
traffic has to be reproducible to be a benchmark.  This module turns one
seed into one traffic trace: **open-loop** Poisson arrivals (exponential
inter-arrival gaps — arrival times do not depend on service times, so a
slow scheduler faces a growing queue instead of a conveniently throttled
one), a prompt/output length mix, a priority mix, and per-class deadlines,
all drawn from one ``np.random.RandomState(seed)``.  The output is a plain
``List[Request]`` with ``arrival_s``/``priority``/``deadline_ms`` stamped —
feed it straight to ``ServingEngine.run``; the fleet scheduler holds each
request until its arrival time comes due.

``adversarial_len`` plants one giant batch-class prompt mid-trace — the
exact "one giant prompt stalls every active decode" scenario chunked
prefill exists to bound.  ``chip_smoke.py``'s fleet phase runs one trace
through bulk admission and the chunked scheduler and prints each class's
tails.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serving.engine import Request


@dataclasses.dataclass(frozen=True)
class LoadGenConfig:
    """One reproducible traffic trace.

    n_requests / rate / seed: trace length, mean arrival rate (requests per
      second, Poisson — gaps are Exponential(1/rate)), and the seed that
      makes the whole trace (arrivals, lengths, classes, token ids) a pure
      function of the config.
    prompt_len / out_len: inclusive (lo, hi) uniform ranges for prompt and
      output lengths.
    batch_frac: fraction of requests drawn into the ``batch`` class (the
      rest are ``interactive``).
    deadline_ms / batch_deadline_ms: per-class deadlines stamped on each
      request (None = no deadline for that class).
    adversarial_len: 0 = none; otherwise ``adversarial_count`` batch-class
      requests spaced evenly through the trace get prompts this long — the
      decode-stalling worst case.  Repeats (count > 1) turn the stall from
      a one-shot race into a sustained property of the trace, which is what
      a p99 comparison needs.
    vocab: token ids are drawn uniformly from [1, vocab).
    temperature: stamped on every request (0 = greedy, the token-identity
      regime).
    """

    n_requests: int = 32
    rate: float = 100.0
    seed: int = 0
    prompt_len: Tuple[int, int] = (4, 24)
    out_len: Tuple[int, int] = (4, 16)
    batch_frac: float = 0.25
    deadline_ms: Optional[float] = None
    batch_deadline_ms: Optional[float] = None
    adversarial_len: int = 0
    adversarial_count: int = 1
    vocab: int = 64
    temperature: float = 0.0

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, "
                             f"got {self.n_requests}")
        if self.rate <= 0:
            raise ValueError(f"rate must be positive, got {self.rate}")
        for name in ("prompt_len", "out_len"):
            lo, hi = getattr(self, name)
            if not 1 <= lo <= hi:
                raise ValueError(f"{name}=({lo}, {hi}) must satisfy "
                                 f"1 <= lo <= hi")
        if not 0.0 <= self.batch_frac <= 1.0:
            raise ValueError(f"batch_frac must be in [0, 1], "
                             f"got {self.batch_frac}")
        if self.vocab < 2:
            raise ValueError(f"vocab must be >= 2, got {self.vocab}")
        if self.adversarial_len < 0:
            raise ValueError("adversarial_len must be >= 0")
        if self.adversarial_count < 1:
            raise ValueError("adversarial_count must be >= 1")


def generate(cfg: LoadGenConfig) -> List[Request]:
    """The trace: ``n_requests`` Requests sorted by arrival time.

    Everything is drawn from one ``RandomState(seed)`` in a fixed order, so
    two calls with equal configs produce identical traces — the property
    the CI regression gate and the baseline-vs-chunked benchmark both rely
    on (same offered load on both sides of the comparison).
    """
    rng = np.random.RandomState(cfg.seed)
    gaps = rng.exponential(1.0 / cfg.rate, size=cfg.n_requests)
    arrivals = np.cumsum(gaps)
    plens = rng.randint(cfg.prompt_len[0], cfg.prompt_len[1] + 1,
                        size=cfg.n_requests)
    olens = rng.randint(cfg.out_len[0], cfg.out_len[1] + 1,
                        size=cfg.n_requests)
    is_batch = rng.uniform(size=cfg.n_requests) < cfg.batch_frac
    if cfg.adversarial_len:
        # evenly spaced through the trace (deduped if count crowds n)
        k = cfg.adversarial_count
        for idx in sorted({(i + 1) * cfg.n_requests // (k + 1)
                           for i in range(k)}):
            plens[idx] = cfg.adversarial_len
            is_batch[idx] = True
    reqs: List[Request] = []
    for i in range(cfg.n_requests):
        prompt = rng.randint(1, cfg.vocab, size=int(plens[i]),
                             dtype=np.int64).astype(np.int32)
        batch = bool(is_batch[i])
        reqs.append(Request(
            uid=f"load-{i:04d}",
            prompt=prompt,
            max_new_tokens=int(olens[i]),
            temperature=cfg.temperature,
            priority="batch" if batch else "interactive",
            deadline_ms=(cfg.batch_deadline_ms if batch
                         else cfg.deadline_ms),
            arrival_s=float(arrivals[i]),
        ))
    return reqs
