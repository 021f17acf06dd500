"""Batched serving engine: a host-side :class:`Scheduler` driving a
:class:`ModelRunner` over a paged KV cache or the dense slot cache, in
PyTorch.

The reference's hot-path properties carry over:

* **Bulk prefill** — admitting a prompt costs one prefill call (full-prompt
  attention + a one-shot cache write), with prompts padded to power-of-two
  buckets; the MoE family and the recurrent families
  (``Model.padded_prefill`` False) are prefilled at the exact prompt
  length, since pad tokens would take expert capacity or advance the
  recurrent state.
* **In-place caches** — the cache is updated in place (``donate=True``,
  the default); the reference gets the same effect by donating the cache
  into its jitted steps.  ``donate=False`` keeps the reference's meaning:
  every dispatch writes into a fresh copy of the cache and rebinds it, so
  a cache object the caller held before stays as it was.
* **On-device sampling** — greedy and temperature sampling run on the
  device; the host never sees logits.
* **Chunked decode** — ``decode_block`` steps run per host sync: sampled
  tokens stay on the device until one host read per block.
* **Per-slot positions** — every slot owns its cache timeline.

With ``page_size=...`` (the default, 16) the cache is a page pool: the
:class:`Scheduler` admits by free-page budget and shares page-aligned
prompt prefixes through a :class:`~repro_torch.serving.kv_cache.PrefixCache`.
``page_size=0`` (or None) serves on the dense ``(layers, slots, max_len,
...)`` slot cache and admits by free slot.  The recurrent families (xlstm,
zamba: O(1) decode state, ``Model.supports_paged`` False) have no paged
path and serve on the dense slot cache whatever ``page_size`` asks, as in
the reference (``engine.paged`` says which cache serves).
With ``forms=True``/``spec=...`` the engine compresses the weights once
(``repro_torch.forms.compress_tree``) and serves the compressed tree: every
projection runs the polarized-matmul kernel on uint8 magnitudes and int8
fragment signs.  ``zero_skip="block"``/``"compact"`` serves it with input
zero-skipping, and ``zero_skip_stats=True`` measures the decode path's
per-layer input sparsity into ``stats()["sparsity"]``.

With ``slo=SLOConfig(...)`` (paged cache only; refused for the recurrent
families) the engine runs the SLO
fleet scheduler (``serving/sched.py``): chunked prefill under a per-round
token budget through :meth:`ModelRunner.prefill_chunk`, priority classes
with preemption by page eviction, EDF within a class, and TTFT and
inter-token percentiles in ``stats()["slo"]``; requests carry
``priority``, ``deadline_ms`` and ``arrival_s`` for it (the plain
scheduler ignores them).

With ``speculate=True`` on the paged cache the decode round is
self-speculative (``serving/speculate.py``): a low-bit draft derived from
the served weights drafts up to ``draft_k`` tokens and the target verifies
them in one multi-token call, so a round yields 1 to ``draft_k + 1`` tokens
per slot; the scheduler advances each slot by the runner's ``counts``.  On
the dense cache (the recurrent families included) ``speculate=True`` falls
back to the plain runner, as in the reference.

With ``health=HealthConfig(...)`` (compressed trees only) the schedulers
tick the reliability loop (``reliability/health.py``): golden-probe drift
detection at run start and every ``probe_every`` rounds, and re-encoding of
corrupted leaves from the build-time reference copy without dropping a
request; ``engine.inject_faults(FaultModel(...))`` corrupts the live
params, and ``stats()["health"]`` is the scoreboard.  ``stats_every=N``
prints the stat line (pages, prefix hits, acceptance, drift and repairs)
every N decode rounds.

With ``mesh=`` (a ``torch.distributed`` ``DeviceMesh`` from
``launch/mesh.make_mesh``, one process per device) the engine serves as
explicit SPMD: every rank holds the local shards that the reference's
specs give it (``param_shardings``/``cache_shardings``: weights
tensor-parallel over ``model`` and replicated over ``data``, slots or
pages over ``data``, heads or the sequence over ``model``), runs its
kernels on them with the collectives the layouts imply
(``models/layers.py``), and decodes its data rank's slots.  The scheduler
runs identically on every rank: the logits of each step are gathered over
``data`` and every rank samples the whole batch with the same generator,
so the tokens, and with them every scheduling decision, agree everywhere.
A paged pool sharded over ``data`` keeps one free list per data rank
(``PageAllocator(partitions=...)``), so page ids may differ from the
one-device engine's; tokens do not.  Every family serves on a mesh; the
recurrent ones on the dense slot cache, their states split over ``data``
(and Zamba2's SSM heads, conv channels and shared K/V over ``model``).
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed.context import parallel_context, set_shard, shard_of
from repro_torch.forms import (CompressReport, FormsSpec, compress_tree, default_spec,
                               sparsity_stats)
from repro_torch.kernels.sparsity import SparsityMeter
from repro_torch.models.registry import Model
from repro_torch.serving import kv_cache as KV


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    # consumed by the fleet scheduler (serving/sched.py), ignored by the
    # plain Scheduler: priority class ("interactive"/"batch"; "" = the
    # fleet's default), a completion deadline relative to arrival, and an
    # open-loop arrival offset relative to run() start
    priority: str = ""
    deadline_ms: Optional[float] = None
    arrival_s: float = 0.0


@dataclasses.dataclass
class Result:
    """A served request: its tokens; the host ms of its prefill calls;
    ``ttft_ms`` and ``latency_ms``, from its arrival (``run()`` start on the
    plain scheduler, ``arrival_s`` on the fleet) to its first and its last
    token on the host."""
    uid: int
    tokens: List[int]
    prefill_ms: float = 0.0
    ttft_ms: float = 0.0
    latency_ms: float = 0.0


_MIN_BUCKET = 8


def prefill_bucket(n: int, max_len: int) -> int:
    """Padded-prefill bucket of an ``n``-token prompt: a power of two, at
    least 8, at most ``max_len``."""
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return min(b, max_len)

# rotating-window cap on the scheduler's admission log
ADMISSION_LOG_WINDOW = 1024


def host_read(t: torch.Tensor) -> np.ndarray:
    """``t`` copied to the host: a read of the serving path, which waits for
    the device to finish the work queued before it."""
    with obs.span("rt.runner.host_read"):
        return t.cpu().numpy()


def gumbel_argmax(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits`` (B, V) by the Gumbel-max
    trick with ``generator``: on the device, with no host sync."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def sample_on_device(logits: torch.Tensor, temps: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """Greedy/temperature sampling on the device.

    logits: (B, V) f32; temps: (B,) — rows with temp <= 0 take the argmax
    (the first maximal index, as ``jnp.argmax``), others draw from
    softmax(logits / temp) by the Gumbel-max trick with ``generator``.
    """
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = gumbel_argmax(logits / torch.clamp(temps, min=1e-6)[:, None], generator)
    return torch.where(temps > 0.0, sampled, greedy)


def clone_cache(cache: Any) -> Any:
    """A fresh copy of a serving cache (every leaf cloned, layouts kept)."""
    def one(t):
        if isinstance(t, tuple):
            return tuple(one(u) for u in t)
        return set_shard(t.clone(), shard_of(t))
    if isinstance(cache, KV.PagedKVCache):
        return dataclasses.replace(cache, pool={k: one(v) for k, v in cache.pool.items()},
                                   dense={k: one(v) for k, v in cache.dense.items()})
    return {k: one(v) for k, v in cache.items()}


def cache_nbytes(cache: Any) -> int:
    """Device bytes of a paged cache or of the dense cache's leaves (an
    sLSTM layer's leaf is a tuple of three tensors)."""
    if isinstance(cache, KV.PagedKVCache):
        return cache.nbytes()
    return sum(t.numel() * t.element_size() for v in cache.values()
               for t in (v if isinstance(v, tuple) else (v,)))


class ModelRunner:
    """The device side of the engine: params + prefill/decode calls.

    Owns nothing about admission or page bookkeeping: it runs one bulk
    prefill or one decode round (here a ``decode_block``-token chunk; on
    the speculative subclass a draft + verify round of variable yield) on
    the cache it was built with, a :class:`~repro_torch.serving.kv_cache.
    PagedKVCache` or the dense ``{"k", "v"}`` slot cache.
    """

    def __init__(self, model: Model, params: Any, cache: Any, *,
                 max_len: int, spec: Optional[FormsSpec] = None,
                 decode_block: int = 4, rng_seed: int = 0, donate: bool = True,
                 ctx: Optional[Any] = None, slots: int = 0):
        self.model = model
        self.device = model.device
        self.params = model.serving_params(params)
        self.cache = cache
        self.paged = isinstance(cache, KV.PagedKVCache)
        self.spec = spec
        self.decode_block = max(1, int(decode_block))
        self.max_len = int(max_len)
        self.donate = bool(donate)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        # the engine's sparsity meter, installed around decode steps and
        # chunks (bulk prefill is not metered, as in the reference)
        self.meter: Optional[SparsityMeter] = None
        self.chunk_widths: List[int] = []   # the width of every prefill_chunk call
        # on a mesh: this rank decodes its data rank's slots; a page pool
        # sharded over data holds this rank's range of page ids
        self.ctx = ctx
        self.n_data = ctx.axis_size("batch") if ctx is not None else 1
        self.data_rank = ctx.coord("batch") if ctx is not None else 0
        self.slot_share = slots // self.n_data    # the slots of one data rank
        self.page_offset = 0
        if self.paged and ctx is not None:
            pool = next(iter(cache.pool.values()))
            sh = shard_of(pool)
            if sh is not None and sh.spec[1] is not None:
                self.page_offset = self.data_rank * pool.shape[1]

    @property
    def page_size(self) -> int:
        return self.cache.page_size

    def _scope(self, meter: bool = True) -> contextlib.ExitStack:
        """The ambient state of a model call: the spec, the sparsity meter
        and the mesh context."""
        stack = contextlib.ExitStack()
        stack.enter_context(default_spec(self.spec))
        if meter:
            stack.enter_context(sparsity_stats(self.meter))
        stack.enter_context(parallel_context(self.ctx))
        return stack

    def _own_caches(self) -> None:
        """Before a dispatch: with ``donate=False`` the dispatch writes into
        a fresh copy, so the cache the caller held keeps its values."""
        if not self.donate:
            self.cache = clone_cache(self.cache)

    # -- this rank's share of the batch (identity off a mesh) -------------

    def _slot_range(self, b: int) -> slice:
        n = b // self.n_data
        return slice(self.data_rank * n, (self.data_rank + 1) * n)

    def _local(self, a):
        """This data rank's rows of a (slots, ...) tensor or host array."""
        return a if self.n_data == 1 else a[self._slot_range(len(a))]

    def _gathered(self, t: torch.Tensor) -> torch.Tensor:
        """The (slots, ...) tensor whose rows the data ranks hold in turn."""
        return t if self.n_data == 1 else self.ctx.all_gather(t, "batch", 0)

    def _local_pages(self, pages: np.ndarray) -> np.ndarray:
        """Global page ids (block tables, prefill destinations) as this
        rank's local ids; the scratch id maps to the rank's own scratch."""
        if not self.page_offset:
            return pages
        pages = np.asarray(pages)
        return np.where(pages == KV.SCRATCH_PAGE, KV.SCRATCH_PAGE, pages - self.page_offset
                        ).astype(np.int32)

    def _tables(self, block_tables: np.ndarray) -> torch.Tensor:
        return self._to_device(self._local_pages(self._local(block_tables)))

    def bucket_for(self, n: int) -> int:
        """Padded-prefill bucket (power of two, at least 8, at most
        max_len); the exact length for a model without padded prefill."""
        if not self.model.padded_prefill:
            return n
        return prefill_bucket(n, self.max_len)

    def padded_prompt(self, prompt: np.ndarray) -> Tuple[np.ndarray, int]:
        """Normalize + bucket-pad a prompt to its (1, bucket) token buffer:
        the one prompt-shaping rule, which the speculative runner's draft
        prefill reuses."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n = int(prompt.shape[0])
        if not 1 <= n < self.max_len:
            raise ValueError(
                f"prompt length {n} must be in [1, max_len={self.max_len})")
        toks = np.zeros((1, self.bucket_for(n)), np.int32)
        toks[0, :n] = prompt
        return toks, n

    def _to_device(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _prefill_call(self, model: Model, params: Any, cache: Any, toks: torch.Tensor,
                      slot: int, n: int, pages: Optional[np.ndarray]):
        """One bulk prefill of ``model`` into ``cache``: paged at ``pages``,
        or the dense cache's ``slot`` (global ids; mapped to this rank's)."""
        with self._scope(meter=False):
            if self.paged:
                if pages is None:
                    raise ValueError("paged prefill needs a destination-page "
                                     "vector (pages=...)")
                return model.prefill_paged(params, toks, cache,
                                           self._to_device(self._local_pages(pages)),
                                           self._local_slot(slot), n)
            return model.prefill(params, toks, cache, self._local_slot(slot), n)

    def _local_slot(self, slot: int) -> int:
        return slot - self.data_rank * self.slot_share if self.n_data > 1 else slot

    def _owner(self, slot: int) -> int:
        """The data rank that holds ``slot``."""
        return slot // self.slot_share if self.n_data > 1 else 0

    @obs.spanned("rt.runner.prefill")
    @torch.inference_mode()
    def prefill_slot(self, slot: int, prompt: np.ndarray, temperature: float = 0.0,
                     pages: Optional[np.ndarray] = None) -> int:
        """Admit a prompt into ``slot`` with one bulk-prefill call; returns
        the first sampled token.  On the paged cache ``pages`` is the
        destination-page vector covering the bucket (scratch-0 entries skip
        prefix-shared pages).  On a mesh the slot's data rank prefills and
        its logits are broadcast over ``data``, so every rank samples the
        same token from the same generator."""
        toks, n = self.padded_prompt(prompt)
        self._own_caches()
        lg = None
        if self._owner(slot) == self.data_rank:
            obs.count("prefill.tokens", n)
            obs.count("prefill.rows", toks.shape[1])
            logits, self.cache = self._prefill_call(self.model, self.params, self.cache,
                                                    self._to_device(toks), slot, n, pages)
            lg = logits.reshape(1, -1).float()
        if self.n_data > 1:
            if lg is None:
                lg = torch.empty((1, self.model.config.vocab_size), dtype=torch.float32,
                                 device=self.device)
            lg = self.ctx.broadcast(lg, "batch", self._owner(slot))
        temp = self._to_device(np.array([temperature]), torch.float32)
        return int(host_read(sample_on_device(lg, temp, self.generator))[0])

    def chunk_width(self, n: int) -> int:
        """Power-of-two chunk width (at least 8, at most max_len), as the
        reference buckets its compiled chunk variants, for every family:
        the same rows are committed."""
        return prefill_bucket(n, self.max_len)

    @obs.spanned("rt.runner.prefill_chunk")
    @torch.inference_mode()
    def prefill_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                      block_tables: np.ndarray, cols: np.ndarray,
                      temps: np.ndarray) -> np.ndarray:
        """Advance chunked prefill for all slots with one multi-token
        ``decode_paged`` call; returns the (B,) tokens sampled at each
        slot's column ``cols[b]`` (valid only where the chunk reaches the
        prompt's end).  ``tokens``: (B, width) rows starting at cache
        position ``positions[b]``; the rows of ``block_tables`` of slots
        not prefilling must be zero (their commits go to scratch page 0).
        Padded columns commit rows past the prompt's chunk, which are
        rewritten before any mask admits them."""
        if not self.paged:
            raise ValueError("chunked prefill needs the paged cache (page_size=...)")
        self._own_caches()
        tok = self._to_device(self._local(tokens))
        tables = self._tables(block_tables)
        cols_d = self._to_device(self._local(cols)).long()
        with self._scope():
            logits, self.cache = self.model.decode_paged(
                self.params, tok, self.cache, self._to_device(self._local(positions)),
                tables)
            lg = logits[torch.arange(tok.shape[0], device=self.device), cols_d].float()
            out = sample_on_device(self._gathered(lg), self._to_device(temps, torch.float32),
                                   self.generator)
        self.chunk_widths.append(int(tokens.shape[1]))
        return host_read(out)

    def _decode_call(self, tok: torch.Tensor, pos: torch.Tensor,
                     tables: Optional[torch.Tensor]):
        if self.paged:
            return self.model.decode_paged(self.params, tok, self.cache, pos, tables)
        return self.model.decode_step(self.params, tok, self.cache, pos)

    @torch.inference_mode()
    def decode_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                     temps: np.ndarray, block_tables: Optional[np.ndarray] = None
                     ) -> np.ndarray:
        """``decode_block`` decode steps for all slots; returns the
        (decode_block, slots) sampled-token grid with one host read.  The
        host buffers are copied to the device first, so the scheduler may
        mutate them right after."""
        if self.paged and block_tables is None:
            raise ValueError("paged decode needs block_tables")
        self._own_caches()
        tok = self._to_device(self._local(tokens))
        pos = self._to_device(self._local(positions))
        tables = self._tables(block_tables) if self.paged else None
        temps_d = self._to_device(temps, torch.float32)
        out = []
        with self._scope():
            for _ in range(self.decode_block):
                logits, self.cache = self._decode_call(tok[:, None], pos, tables)
                full = sample_on_device(self._gathered(logits[:, 0].float()), temps_d,
                                        self.generator)
                out.append(full)
                tok = self._local(full)
                pos = pos + 1
        obs.count("decode.steps", self.decode_block)
        return host_read(torch.stack(out))

    def decode_round(self, tokens: np.ndarray, positions: np.ndarray,
                     temps: np.ndarray, block_tables: Optional[np.ndarray] = None,
                     active: Optional[List[bool]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One scheduler round: ``(grid, counts)`` — a (tokens_per_round,
        slots) token grid and how many rows of each slot are valid: a fixed
        ``decode_block`` here, 1 + accepted drafts on the speculative
        runner."""
        del active   # every slot decodes the full block on the plain runner
        out = self.decode_chunk(tokens, positions, temps, block_tables)
        return out, np.full(out.shape[1], out.shape[0], np.int32)

    def reset_slot(self, slot: int) -> None:
        """Per-slot runner state reset on (re)admission: nothing here; the
        speculative runner clears the slot's adaptive-K state."""


class Scheduler:
    """The host side of the engine: admission, slot and page bookkeeping,
    and the continuous-batching loop.

    Dense mode (``allocator is None``) admits by free slot.  Paged mode
    admits when a slot is free AND the allocator can reserve
    ``ceil(min(max(bucket, prompt + max_new), max_len) / page_size)`` pages
    (minus prefix-shared ones); pages are reserved up front, so a running
    request is never preempted by pool exhaustion.
    """

    def __init__(self, runner: ModelRunner, *, slots: int, max_len: int,
                 allocator: Optional[KV.PageAllocator] = None,
                 prefix: Optional[KV.PrefixCache] = None,
                 health: Optional[Any] = None, log_every: int = 0):
        self.runner = runner
        self.slots = slots
        self.max_len = max_len
        self.allocator = allocator
        self.prefix = prefix
        self.health = health    # reliability.health.HealthMonitor (or None)
        self.paged = allocator is not None
        self.log_every = int(log_every)  # decode rounds between stat lines
        self.rounds = 0
        self.max_concurrent = 0
        self.admissions: "collections.deque[Tuple[int, Tuple[int, ...]]]" = \
            collections.deque(maxlen=ADMISSION_LOG_WINDOW)
        self.admissions_dropped = 0
        self.last_shared = 0             # prefix pages of the last reservation
        self.block_tables: Optional[np.ndarray] = None
        if self.paged:
            ps = runner.page_size
            self.n_tables = KV.pages_for(max_len, ps)
            if allocator.part_capacity < self.n_tables:
                raise ValueError(
                    f"page pool too small: a max_len={max_len} request needs "
                    f"{self.n_tables} pages, pool holds {allocator.part_capacity} "
                    f"(+1 scratch)"
                    + (f" per data rank" if allocator.partitions > 1 else ""))
            self.block_tables = np.zeros((slots, self.n_tables), np.int32)
            self.slot_pages: List[List[int]] = [[] for _ in range(slots)]

    def _reserve_pages(self, uid: int, slot: int, prompt: np.ndarray,
                       max_new: int, *, shared_cap: Optional[int] = None,
                       rows: Optional[int] = None) -> Optional[np.ndarray]:
        """Reserve every page the request can touch; returns the prefill
        destination-page vector, or None if the free-page budget blocks.
        Prefix-shared pages are refcounted, and their prefill destinations
        are redirected to scratch so shared contents are never rewritten.

        ``shared_cap`` bounds how many prefix pages may be shared (chunked
        admission skips shared positions, so the last prompt token must be
        on an owned page); ``rows`` overrides the reserved-row count
        (chunked admission reserves exactly ``prompt + max_new`` rows).
        ``self.last_shared`` is the shared-page count of this reservation."""
        ps = self.runner.page_size
        n = len(prompt)
        bucket = self.runner.bucket_for(n)
        if rows is None:
            rows = min(max(bucket, n + max_new), self.max_len)
        need = KV.pages_for(rows, ps)
        shared = self.prefix.match(prompt) if self.prefix is not None else []
        if shared_cap is not None:
            shared = shared[:shared_cap]
        part = self._partition(slot)
        if self.allocator.partitions > 1:
            # a slot's pages live on its data rank: share only a leading run
            # of the prefix that is there
            n_here = 0
            while n_here < len(shared) and self.allocator.partition_of(shared[n_here]) == part:
                n_here += 1
            shared = shared[:n_here]
        own = self.allocator.alloc(need - len(shared), part=part)
        if own is None:
            return None
        self.allocator.share(shared)
        pages = shared + own
        self.last_shared = len(shared)
        self.slot_pages[slot] = pages
        self.block_tables[slot] = 0
        self.block_tables[slot, :need] = pages
        if len(self.admissions) == self.admissions.maxlen:
            self.admissions_dropped += 1
        self.admissions.append((uid, tuple(pages)))
        n_bucket_pages = min(KV.pages_for(bucket, ps), need)
        return np.asarray(
            [KV.SCRATCH_PAGE if j < len(shared) else pages[j]
             for j in range(n_bucket_pages)], np.int32)

    def _partition(self, slot: int) -> int:
        """The page partition (data rank) of ``slot``'s pages."""
        return slot // (self.slots // self.allocator.partitions)

    @obs.spanned("rt.sched.release")
    def _release_slot(self, slot: int) -> None:
        if not self.paged:
            return
        freed = self.allocator.release(self.slot_pages[slot])
        if self.prefix is not None:
            self.prefix.evict(freed)
        self.slot_pages[slot] = []
        self.block_tables[slot] = 0   # idle slots read/write scratch only

    @obs.spanned("rt.sched.run")
    def run(self, requests: List[Request]) -> List[Result]:
        """Serve a list of requests with continuous batching over slots."""
        t_run = time.perf_counter()
        queue = list(requests)
        active: List[Optional[Tuple[Request, Result]]] = [None] * self.slots
        done: List[Result] = []
        cur = np.zeros(self.slots, np.int32)        # current token per slot
        slot_pos = np.zeros(self.slots, np.int32)   # next cache write position
        temps = np.zeros(self.slots, np.float32)

        def admit(slot: int) -> None:
            """Admit queued requests into ``slot`` until one survives its
            prefill; a request that does not fit the free-page budget stays
            at the head of the queue."""
            while queue:
                req = queue[0]
                with obs.span("rt.sched.admit", uid=req.uid):
                    prompt = np.asarray(req.prompt, np.int32).reshape(-1)
                    if prompt.shape[0] >= self.max_len:
                        prompt = prompt[-(self.max_len - 1):]
                    pages = None
                    if self.paged:
                        pages = self._reserve_pages(req.uid, slot, prompt,
                                                    req.max_new_tokens)
                        if pages is None:
                            if not any(a is not None for a in active):
                                raise RuntimeError(
                                    "page pool exhausted with no request in "
                                    "flight — pool sizing bug")
                            return
                    queue.pop(0)
                    res = Result(uid=req.uid, tokens=[])
                    t0 = time.perf_counter()
                    first = self.runner.prefill_slot(slot, prompt, req.temperature,
                                                     pages=pages)
                    t1 = time.perf_counter()
                    res.prefill_ms = (t1 - t0) * 1e3
                    res.ttft_ms = res.latency_ms = (t1 - t_run) * 1e3
                    res.tokens.append(first)
                    n_prompt = int(prompt.shape[0])
                    if (len(res.tokens) >= req.max_new_tokens
                            or n_prompt >= self.max_len - 1):
                        self._release_slot(slot)
                        done.append(res)
                        continue
                    if self.prefix is not None:
                        self.prefix.register(prompt, self.slot_pages[slot])
                    cur[slot] = first
                    slot_pos[slot] = n_prompt
                    temps[slot] = req.temperature
                    active[slot] = (req, res)
                    self.runner.reset_slot(slot)
                    self.max_concurrent = max(self.max_concurrent,
                                              sum(a is not None for a in active))
                    return

        def finish(slot: int) -> None:
            done.append(active[slot][1])
            active[slot] = None
            temps[slot] = 0.0
            self._release_slot(slot)
            admit(slot)

        def admit_idle() -> None:
            """Retry admission into every idle slot; stop at the first slot
            that leaves a page-blocked queue head in place."""
            for s in range(self.slots):
                if not queue:
                    return
                if active[s] is None:
                    head = queue[0]
                    admit(s)
                    if queue and queue[0] is head and active[s] is None \
                            and (self.allocator is None or self.allocator.partitions == 1):
                        return

        # health pass before any prefill: faults injected while the engine
        # sat idle are repaired before they can poison KV pages
        if self.health is not None:
            self.health.tick(self.runner, self.rounds)
        admit_idle()
        while any(a is not None for a in active):
            # a round yields a variable number of tokens per slot (a fixed
            # decode_block on the plain runner, 1 + accepted drafts on the
            # speculative one): counts[s] is the only source of truth
            with obs.span("rt.runner.decode_round", round=self.rounds):
                out, counts = self.runner.decode_round(
                    cur, slot_pos, temps, block_tables=self.block_tables,
                    active=[a is not None for a in active])
            now_ms = (time.perf_counter() - t_run) * 1e3
            self.rounds += 1
            for s in range(self.slots):
                a = active[s]
                if a is None:
                    continue
                req, res = a
                budget = min(req.max_new_tokens - len(res.tokens),
                             self.max_len - 1 - int(slot_pos[s]))
                take = min(int(counts[s]), budget)
                res.tokens.extend(int(t) for t in out[:take, s])
                if take >= budget:
                    res.latency_ms = now_ms
                    finish(s)
                else:
                    cur[s] = out[counts[s] - 1, s]
                    slot_pos[s] += int(counts[s])
            # periodic health pass between rounds: in-flight requests keep
            # their slots, pages and positions across a repair; only the
            # runner's params binding changes
            if (self.health is not None and self.health.config.probe_every
                    and self.rounds % self.health.config.probe_every == 0):
                self.health.tick(self.runner, self.rounds)
            self._log_round(sum(a is not None for a in active))
            admit_idle()
        return done

    def _log_round(self, n_active: int) -> None:
        """The periodic stat line, every ``log_every`` decode rounds."""
        if not self.log_every or self.rounds % self.log_every:
            return
        parts = [f"round {self.rounds}", f"active {n_active}/{self.slots}"]
        if self.allocator is not None:
            st = self.allocator.stats()
            parts.append(f"pages {st['used']}/{st['capacity']} "
                         f"(hw {st['high_water']}, shared {st['shared']})")
        if self.prefix is not None:
            parts.append(f"prefix_hits {self.prefix.hits}")
        if hasattr(self.runner, "spec_stats"):
            sp = self.runner.spec_stats()
            parts.append(f"accept {sp['acceptance']:.2f} "
                         f"tok/round {sp['tokens_per_round']:.2f}")
        if self.health is not None:
            parts.append(f"drift {self.health.last_drift:.2e} "
                         f"repairs {self.health.repairs}")
        print("[serve] " + ", ".join(parts), flush=True)


def _check_mesh(dev: torch.device, ctx: Any, batch_slots: int) -> None:
    mesh_dev = ctx.mesh.device_type
    if mesh_dev != dev.type:
        raise ValueError(f"the mesh is on {mesh_dev!r} but the engine on {dev.type!r}")
    d = ctx.axis_size("batch")
    if batch_slots % d:
        raise ValueError(f"batch_slots={batch_slots} does not split over the "
                         f"{d}-way data axes: each data rank decodes its own slots")


class ServingEngine:
    """Continuous-batching engine facade: optional FORMS compression, a
    :class:`ModelRunner` (or the speculative runner) and a
    :class:`Scheduler`, over a paged KV cache (``page_size=...``, the
    default 16) or the dense slot cache (``page_size=0``, and the recurrent
    families whatever ``page_size`` is).

    ``device`` defaults to ``"cuda"`` and must match the model's device;
    without CUDA the caller has to ask for ``"cpu"``.  ``plan={path:
    FormsSpec}`` serves a heterogeneous compressed tree.  ``zero_skip``
    (``"off"``, ``"block"`` or ``"compact"``, with the ``zero_skip_keep``
    budget) and ``zero_skip_stats`` act on the FORMS matmuls and need
    compression on.  ``speculate=True`` serves self-speculatively on the
    paged cache: a ``draft_bits`` draft (``draft_mode`` ``"forms"`` on
    fragments of ``draft_fragment`` rows, by default the target's, or the
    ``"int"`` grid), keeping every ``draft_layer_step``-th layer, drafts up
    to ``draft_k`` tokens per round, with per-slot adaptive K unless
    ``adaptive_k=False``; ``draft_plan={path: FormsSpec}`` gives a forms
    draft per-leaf widths (``forms.autobits.plan_draft_bits``); the dense
    cache falls back to plain decoding.
    ``slo=`` (an ``SLOConfig`` or a dict of its fields) serves with the
    fleet scheduler; it needs the paged cache.  ``health=HealthConfig(...)``
    (compressed trees only) arms the reliability loop on either scheduler;
    ``inject_faults`` corrupts the live params and ``stats()["health"]`` is
    the scoreboard.  ``stats_every=N`` prints the stat line every N decode
    rounds.  ``donate=False`` makes every dispatch write a fresh copy of the
    cache (the one held before stays as it was).  ``mesh=`` serves SPMD on
    a ``DeviceMesh`` (module docstring); ``param_shardings`` and
    ``cache_shardings`` are then the specs the params and caches were
    placed with (None without a mesh).
    """

    def __init__(self, model: Model, params: Any, *, max_len: int = 512,
                 batch_slots: int = 8, forms: bool = False,
                 spec: Optional[FormsSpec] = None,
                 plan: Optional[Dict[str, FormsSpec]] = None,
                 rng_seed: int = 0,
                 decode_block: int = 4,
                 page_size: Optional[int] = 16,
                 num_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE,
                 donate: bool = True,
                 mesh: Optional[Any] = None, speculate: bool = False,
                 draft_k: int = 4, draft_bits: int = 4, draft_mode: str = "forms",
                 draft_plan: Optional[Dict[str, FormsSpec]] = None,
                 draft_fragment: Optional[int] = None, draft_layer_step: int = 1,
                 adaptive_k: bool = True,
                 health: Optional[Any] = None, stats_every: int = 0,
                 zero_skip: Optional[str] = None,
                 zero_skip_keep: float = 0.5, zero_skip_stats: bool = False,
                 slo: Optional[Any] = None):
        dev = resolve_device(device)
        if dev != model.device:
            raise ValueError(f"engine device {dev} differs from the model's "
                             f"{model.device} (build(cfg, device=...))")
        self.ctx = None
        if mesh is not None:
            from repro_torch.distributed.sharding import ParallelContext
            if not hasattr(mesh, "mesh_dim_names"):
                raise TypeError(f"mesh= takes a torch.distributed DeviceMesh "
                                f"(launch/mesh.make_mesh), got {type(mesh).__name__}")
            self.ctx = ParallelContext.for_mesh(mesh)
            _check_mesh(dev, self.ctx, batch_slots)
        if ((zero_skip not in (None, "off")) or zero_skip_stats) \
                and not (forms or spec is not None):
            raise ValueError(
                "zero_skip / zero_skip_stats act on the FORMS matmul path — "
                "enable compression too (forms=True, spec=..., or serve "
                "--forms)")
        if plan is not None and not (forms or spec is not None):
            raise ValueError(
                "plan= is a per-leaf override map over the engine's FORMS "
                "spec — enable compression too (forms=True, spec=..., or "
                "serve --forms)")
        self.model = model
        self.cfg = model.config
        self.device = dev
        self.spec: Optional[FormsSpec] = None
        self.compression_report: Optional[CompressReport] = None
        if forms or spec is not None:
            self.spec = spec if spec is not None else FormsSpec()
            if zero_skip is not None:
                # folded into the spec before compression, so every FORMS
                # matmul of the served tree takes the skip route
                self.spec = dataclasses.replace(self.spec, zero_skip=zero_skip,
                                                zero_skip_keep=zero_skip_keep)
            with torch.inference_mode():
                params, self.compression_report = compress_tree(params, self.spec,
                                                                plan=plan)
        self.max_len = max_len
        self.slots = batch_slots
        # the recurrent families have no paged path: page_size falls back to
        # the dense slot cache, as in the reference
        self.paged = bool(page_size) and model.supports_paged
        self.page_size: Optional[int] = int(page_size) if self.paged else None
        if slo is not None and not self.paged:
            raise ValueError(
                "slo= (the SLO-aware fleet scheduler) schedules pages: chunked "
                "prefill and preemption by page eviction need the paged KV cache "
                "— pass page_size=... and an attention family (recurrent families "
                "have no paged path)")
        # speculation verifies on the paged cache; the dense cache (and so
        # the recurrent families) falls back to the plain runner, as in the
        # reference
        self.speculative = bool(speculate) and self.paged
        self.donate = bool(donate)
        n_data = self.ctx.axis_size("batch") if self.ctx is not None else 1
        allocator = prefix = None
        if self.paged:
            if num_pages is None:
                # every slot can hold a full max_len request (+1 scratch page);
                # on a mesh rounded up to the data size, so the page dim
                # shards instead of replicating
                num_pages = batch_slots * KV.pages_for(max_len, self.page_size) + 1
                num_pages = -(-num_pages // n_data) * n_data
            # a pool sharded over data keeps each data rank's pages apart
            allocator = KV.PageAllocator(num_pages,
                                         partitions=n_data if num_pages % n_data == 0 else 1)
            prefix = KV.PrefixCache(self.page_size) if prefix_cache else None
            cache = model.init_paged_cache(num_pages, self.page_size, batch_slots, max_len)
        else:
            cache = model.init_cache(batch_slots, max_len)
        self.draft_report: Optional[CompressReport] = None
        draft = None
        if self.speculative:
            from repro_torch.serving import speculate as SP
            spec_cfg = SP.SpeculateConfig(
                k=draft_k, bits=draft_bits, mode=draft_mode,
                fragment=(draft_fragment if draft_fragment is not None
                          else (self.spec.m if self.spec is not None else None)),
                layer_step=draft_layer_step, adaptive=adaptive_k)
            # the draft derives from what the target serves (the float
            # projection of the compressed tree when forms is on); the dense
            # leaves are made one at a time; on a mesh the draft comes out
            # placed, each leaf cut as it is made
            with torch.inference_mode():
                draft_model, draft_params, self.draft_report = SP.make_draft(
                    model, params, spec_cfg, ctx=self.ctx, plan=draft_plan)
            draft_cache = draft_model.init_paged_cache(num_pages, self.page_size,
                                                       batch_slots, max_len)
            draft = [draft_model, draft_params, draft_cache]
        self.param_shardings = self.cache_shardings = None
        if self.ctx is not None:
            # weights tensor-parallel over model and replicated over data
            # (fsdp=False: no gathers on the decode path); caches: slots or
            # pages over data, heads (or the sequence) over model.  Each
            # rank keeps its pieces of the global trees.
            from repro_torch.distributed import sharding as shd
            with torch.inference_mode():
                if shd.is_placed(params):
                    # restored straight into the layout (checkpoint.restore(
                    # shardings=...)): served as it is
                    self.param_shardings = shd.placed_shardings(params, self.ctx)
                else:
                    self.param_shardings = shd.params_shardings(params, self.ctx, fsdp=False)
                    params = shd.reshard_state(params, self.param_shardings)
                self.cache_shardings = shd.cache_shardings(cache, self.ctx)
                cache = shd.reshard_state(cache, self.cache_shardings)
                if draft is not None:
                    draft[2] = shd.reshard_state(draft[2],
                                                 shd.cache_shardings(draft[2], self.ctx))
        run_kw = dict(max_len=max_len, spec=self.spec, decode_block=decode_block,
                      rng_seed=rng_seed, donate=donate, ctx=self.ctx, slots=batch_slots)
        if draft is not None:
            self.runner: ModelRunner = SP.SpeculativeRunner(
                model, params, cache, draft_model=draft[0], draft_params=draft[1],
                draft_cache=draft[2], spec_cfg=spec_cfg, **run_kw)
        else:
            self.runner = ModelRunner(model, params, cache, **run_kw)
        # off by default: metering adds a few device ops to every FORMS
        # matmul of every decode step
        self.sparsity_meter: Optional[SparsityMeter] = None
        if zero_skip_stats:
            self.sparsity_meter = SparsityMeter()
            self.runner.meter = self.sparsity_meter
        # the health monitor is built last, over the exact tree the runner
        # serves: its golden logits and reference planes describe the real
        # serving artifact
        self.health = None
        if health is not None:
            from repro_torch.reliability.health import HealthMonitor
            self.health = HealthMonitor(model, self.runner.params, health, spec=self.spec,
                                        ctx=self.ctx)
        if slo is not None:
            from repro_torch.serving.sched import FleetScheduler, SLOConfig
            if isinstance(slo, dict):
                slo = SLOConfig(**slo)
            self.scheduler: Scheduler = FleetScheduler(
                self.runner, slots=batch_slots, max_len=max_len, allocator=allocator,
                prefix=prefix, health=self.health, log_every=stats_every, cfg=slo)
        else:
            self.scheduler = Scheduler(self.runner, slots=batch_slots, max_len=max_len,
                                       allocator=allocator, prefix=prefix,
                                       health=self.health, log_every=stats_every)

    @property
    def params(self) -> Any:
        return self.runner.params

    @property
    def decode_block(self) -> int:
        return self.runner.decode_block

    @property
    def cache(self) -> Any:
        return self.runner.cache

    @property
    def page_allocator(self) -> Optional[KV.PageAllocator]:
        return self.scheduler.allocator

    @property
    def prefix_cache(self) -> Optional[KV.PrefixCache]:
        return self.scheduler.prefix

    def cache_bytes(self) -> int:
        """Persistent device footprint of the serving cache(s), the draft's
        page pool included when speculation is on."""
        n = cache_nbytes(self.runner.cache)
        if self.speculative:
            n += cache_nbytes(self.runner.draft_cache)
        return n

    def stats(self) -> Dict[str, Any]:
        """Serving counters: scheduler occupancy, page-pool occupancy,
        prefix-cache hits, with speculation its acceptance and tokens per
        round, with ``health=`` the ``"health"`` scoreboard, with
        ``zero_skip_stats`` the decode path's measured input sparsity, and
        with the fleet scheduler the ``"slo"`` block (TTFT and inter-token
        percentiles, preemption and deadline-miss counts, queue depths per
        class), as a deep-copied snapshot."""
        out: Dict[str, Any] = {
            "max_concurrent": self.scheduler.max_concurrent,
            "rounds": self.scheduler.rounds,
            "admissions_dropped": self.scheduler.admissions_dropped,
        }
        if self.page_allocator is not None:
            out["pages"] = self.page_allocator.stats()
        if self.prefix_cache is not None:
            out["prefix_hits"] = self.prefix_cache.hits
        if self.speculative:
            out["speculate"] = self.runner.spec_stats()
        if self.health is not None:
            out["health"] = self.health.stats()
        if self.sparsity_meter is not None:
            out["sparsity"] = self.sparsity_meter.summary()
        if hasattr(self.scheduler, "slo_stats"):
            out["slo"] = self.scheduler.slo_stats()
        return copy.deepcopy(out)

    def inject_faults(self, fault: Any, paths: Optional[List[str]] = None) -> Any:
        """Corrupt the live serving params with ``fault`` (a
        ``reliability.faults.FaultModel``); returns the ``FaultReport``.
        The health monitor's golden and reference copies were taken at
        build, before any injection, so a later probe sees exactly the drift
        this corruption causes and repair restores the clean tree."""
        from repro_torch.reliability.faults import inject_tree
        self.runner.params, report = inject_tree(self.runner.params, fault,
                                                 spec=self.spec, paths=paths)
        return report

    def run(self, requests: List[Request]) -> List[Result]:
        return self.scheduler.run(requests)
