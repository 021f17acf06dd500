"""Batched serving engine: a host-side :class:`Scheduler` driving a
:class:`ModelRunner` over a paged KV cache or the dense slot cache, in
PyTorch.

The reference's hot-path properties carry over:

* **Bulk prefill** — admitting a prompt costs one prefill call (full-prompt
  attention + a one-shot cache write), with prompts padded to power-of-two
  buckets.
* **In-place caches** — the cache is updated in place; the reference gets
  the same effect by donating the cache into its jitted steps.
* **On-device sampling** — greedy and temperature sampling run on the
  device; the host never sees logits.
* **Chunked decode** — ``decode_block`` steps run per host sync: sampled
  tokens stay on the device until one host read per block.
* **Per-slot positions** — every slot owns its cache timeline.

With ``page_size=...`` (the default, 16) the cache is a page pool: the
:class:`Scheduler` admits by free-page budget and shares page-aligned
prompt prefixes through a :class:`~repro_torch.serving.kv_cache.PrefixCache`.
``page_size=0`` (or None) serves on the dense ``(layers, slots, max_len,
...)`` slot cache and admits by free slot.
With ``forms=True``/``spec=...`` the engine compresses the weights once
(``repro_torch.forms.compress_tree``) and serves the compressed tree: every
projection runs the polarized-matmul kernel on uint8 magnitudes and int8
fragment signs.  ``zero_skip="block"``/``"compact"`` serves it with input
zero-skipping, and ``zero_skip_stats=True`` measures the decode path's
per-layer input sparsity into ``stats()["sparsity"]``.

With ``slo=SLOConfig(...)`` (paged cache only) the engine runs the SLO
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
the dense cache ``speculate=True`` falls back to the plain runner, as in
the reference.

Not ported yet, and refused rather than ignored: mesh sharding, health
monitoring and per-leaf draft plans (see ROADMAP).
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
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
    uid: int
    tokens: List[int]
    prefill_ms: float = 0.0
    decode_ms: float = 0.0


_MIN_BUCKET = 8

# rotating-window cap on the scheduler's admission log
ADMISSION_LOG_WINDOW = 1024


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


def cache_nbytes(cache: Any) -> int:
    """Device bytes of a paged cache or of the dense cache's leaves."""
    if isinstance(cache, KV.PagedKVCache):
        return cache.nbytes()
    return sum(t.numel() * t.element_size() for t in cache.values())


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
                 decode_block: int = 4, rng_seed: int = 0):
        self.model = model
        self.device = model.device
        self.params = model.serving_params(params)
        self.cache = cache
        self.paged = isinstance(cache, KV.PagedKVCache)
        self.spec = spec
        self.decode_block = max(1, int(decode_block))
        self.max_len = int(max_len)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        # the engine's sparsity meter, installed around decode steps and
        # chunks (bulk prefill is not metered, as in the reference)
        self.meter: Optional[SparsityMeter] = None
        self.chunk_widths: List[int] = []   # the width of every prefill_chunk call

    @property
    def page_size(self) -> int:
        return self.cache.page_size

    def bucket_for(self, n: int) -> int:
        """Padded-prefill bucket (power of two, at least 8, at most max_len)."""
        b = _MIN_BUCKET
        while b < n:
            b *= 2
        return min(b, self.max_len)

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
        or the dense cache's ``slot``."""
        with default_spec(self.spec):
            if self.paged:
                if pages is None:
                    raise ValueError("paged prefill needs a destination-page "
                                     "vector (pages=...)")
                return model.prefill_paged(params, toks, cache, self._to_device(pages),
                                           slot, n)
            return model.prefill(params, toks, cache, slot, n)

    @torch.inference_mode()
    def prefill_slot(self, slot: int, prompt: np.ndarray, temperature: float = 0.0,
                     pages: Optional[np.ndarray] = None) -> int:
        """Admit a prompt into ``slot`` with one bulk-prefill call; returns
        the first sampled token.  On the paged cache ``pages`` is the
        destination-page vector covering the bucket (scratch-0 entries skip
        prefix-shared pages)."""
        toks, n = self.padded_prompt(prompt)
        logits, self.cache = self._prefill_call(self.model, self.params, self.cache,
                                                self._to_device(toks), slot, n, pages)
        lg = logits.reshape(1, -1).float()
        temp = self._to_device(np.array([temperature]), torch.float32)
        return int(sample_on_device(lg, temp, self.generator)[0])

    def chunk_width(self, n: int) -> int:
        """Power-of-two chunk width (at least 8, at most max_len), as the
        reference buckets its compiled chunk variants: the same rows are
        committed."""
        return self.bucket_for(n)

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
        b = tokens.shape[0]
        tok = self._to_device(tokens)
        tables = self._to_device(block_tables)
        cols_d = self._to_device(cols).long()
        with default_spec(self.spec), sparsity_stats(self.meter):
            logits, self.cache = self.model.decode_paged(
                self.params, tok, self.cache, self._to_device(positions), tables)
            lg = logits[torch.arange(b, device=self.device), cols_d].float()
            out = sample_on_device(lg, self._to_device(temps, torch.float32), self.generator)
        self.chunk_widths.append(int(tokens.shape[1]))
        return out.cpu().numpy()

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
        tok = self._to_device(tokens)
        pos = self._to_device(positions)
        tables = self._to_device(block_tables) if self.paged else None
        temps_d = self._to_device(temps, torch.float32)
        out = []
        with default_spec(self.spec), sparsity_stats(self.meter):
            for _ in range(self.decode_block):
                logits, self.cache = self._decode_call(tok[:, None], pos, tables)
                tok = sample_on_device(logits[:, 0].float(), temps_d, self.generator)
                out.append(tok)
                pos = pos + 1
        return torch.stack(out).cpu().numpy()

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
                 prefix: Optional[KV.PrefixCache] = None):
        self.runner = runner
        self.slots = slots
        self.max_len = max_len
        self.allocator = allocator
        self.prefix = prefix
        self.paged = allocator is not None
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
            if allocator.capacity < self.n_tables:
                raise ValueError(
                    f"page pool too small: a max_len={max_len} request needs "
                    f"{self.n_tables} pages, pool holds {allocator.capacity} "
                    f"(+1 scratch)")
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
        own = self.allocator.alloc(need - len(shared))
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

    def _release_slot(self, slot: int) -> None:
        if not self.paged:
            return
        freed = self.allocator.release(self.slot_pages[slot])
        if self.prefix is not None:
            self.prefix.evict(freed)
        self.slot_pages[slot] = []
        self.block_tables[slot] = 0   # idle slots read/write scratch only

    def run(self, requests: List[Request]) -> List[Result]:
        """Serve a list of requests with continuous batching over slots."""
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
                res.prefill_ms = (time.perf_counter() - t0) * 1e3
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
                    if queue and queue[0] is head and active[s] is None:
                        return

        admit_idle()
        while any(a is not None for a in active):
            n_active = sum(a is not None for a in active)
            t0 = time.perf_counter()
            # a round yields a variable number of tokens per slot (a fixed
            # decode_block on the plain runner, 1 + accepted drafts on the
            # speculative one): counts[s] is the only source of truth
            out, counts = self.runner.decode_round(
                cur, slot_pos, temps, block_tables=self.block_tables,
                active=[a is not None for a in active])
            dt = (time.perf_counter() - t0) * 1e3
            self.rounds += 1
            for s in range(self.slots):
                a = active[s]
                if a is None:
                    continue
                req, res = a
                res.decode_ms += dt / max(1, n_active)
                budget = min(req.max_new_tokens - len(res.tokens),
                             self.max_len - 1 - int(slot_pos[s]))
                take = min(int(counts[s]), budget)
                res.tokens.extend(int(t) for t in out[:take, s])
                if take >= budget:
                    finish(s)
                else:
                    cur[s] = out[counts[s] - 1, s]
                    slot_pos[s] += int(counts[s])
            admit_idle()
        return done


def _refuse(name: str, value: Any, default: Any, item: str) -> None:
    if value != default:
        raise NotImplementedError(f"{name}= is not ported yet ({item})")


class ServingEngine:
    """Continuous-batching engine facade: optional FORMS compression, a
    :class:`ModelRunner` (or the speculative runner) and a
    :class:`Scheduler`, over a paged KV cache (``page_size=...``, the
    default 16) or the dense slot cache (``page_size=0``).

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
    ``adaptive_k=False``; the dense cache falls back to plain decoding.
    ``slo=`` (an ``SLOConfig`` or a dict of its fields) serves with the
    fleet scheduler; it needs the paged cache.
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
                 mesh: Optional[Any] = None, speculate: bool = False,
                 draft_k: int = 4, draft_bits: int = 4, draft_mode: str = "forms",
                 draft_plan: Optional[Dict[str, FormsSpec]] = None,
                 draft_fragment: Optional[int] = None, draft_layer_step: int = 1,
                 adaptive_k: bool = True,
                 health: Optional[Any] = None, zero_skip: Optional[str] = None,
                 zero_skip_keep: float = 0.5, zero_skip_stats: bool = False,
                 slo: Optional[Any] = None):
        dev = resolve_device(device)
        if dev != model.device:
            raise ValueError(f"engine device {dev} differs from the model's "
                             f"{model.device} (build(cfg, device=...))")
        _refuse("mesh", mesh, None, "ROADMAP queue 1, item 13")
        _refuse("draft_plan", draft_plan, None,
                "ROADMAP queue 1, item 8: auto mixed precision, forms/autobits.py")
        _refuse("health", health, None, "ROADMAP queue 1, item 9")
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
        self.paged = bool(page_size)
        self.page_size: Optional[int] = int(page_size) if self.paged else None
        if slo is not None and not self.paged:
            raise ValueError(
                "slo= (the SLO-aware fleet scheduler) schedules pages: chunked "
                "prefill and preemption by page eviction need the paged KV cache "
                "— pass page_size=...")
        # speculation verifies on the paged cache; the dense cache falls
        # back to the plain runner, as in the reference
        self.speculative = bool(speculate) and self.paged
        allocator = prefix = None
        if self.paged:
            if num_pages is None:
                # every slot can hold a full max_len request (+1 scratch page)
                num_pages = batch_slots * KV.pages_for(max_len, self.page_size) + 1
            allocator = KV.PageAllocator(num_pages)
            prefix = KV.PrefixCache(self.page_size) if prefix_cache else None
            cache = model.init_paged_cache(num_pages, self.page_size)
        else:
            cache = model.init_cache(batch_slots, max_len)
        self.draft_report: Optional[CompressReport] = None
        if self.speculative:
            from repro_torch.serving import speculate as SP
            spec_cfg = SP.SpeculateConfig(
                k=draft_k, bits=draft_bits, mode=draft_mode,
                fragment=(draft_fragment if draft_fragment is not None
                          else (self.spec.m if self.spec is not None else None)),
                layer_step=draft_layer_step, adaptive=adaptive_k)
            # the draft derives from what the target serves (the float
            # projection of the compressed tree when forms is on); the dense
            # tree made on the way is freed before the draft pool exists
            with torch.inference_mode():
                draft_model, draft_params, self.draft_report = SP.make_draft(
                    model, params, spec_cfg)
            draft_cache = draft_model.init_paged_cache(num_pages, self.page_size)
            self.runner: ModelRunner = SP.SpeculativeRunner(
                model, params, cache, draft_model=draft_model,
                draft_params=draft_params, draft_cache=draft_cache, spec_cfg=spec_cfg,
                max_len=max_len, spec=self.spec, decode_block=decode_block,
                rng_seed=rng_seed)
        else:
            self.runner = ModelRunner(model, params, cache, max_len=max_len,
                                      spec=self.spec, decode_block=decode_block,
                                      rng_seed=rng_seed)
        if slo is not None:
            from repro_torch.serving.sched import FleetScheduler, SLOConfig
            if isinstance(slo, dict):
                slo = SLOConfig(**slo)
            self.scheduler: Scheduler = FleetScheduler(
                self.runner, slots=batch_slots, max_len=max_len, allocator=allocator,
                prefix=prefix, cfg=slo)
        else:
            self.scheduler = Scheduler(self.runner, slots=batch_slots, max_len=max_len,
                                       allocator=allocator, prefix=prefix)
        # off by default: metering adds a few device ops to every FORMS
        # matmul of every decode step
        self.sparsity_meter: Optional[SparsityMeter] = None
        if zero_skip_stats:
            self.sparsity_meter = SparsityMeter()
            self.runner.meter = self.sparsity_meter

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
        round, with ``zero_skip_stats`` the decode path's measured input
        sparsity, and with the fleet scheduler the ``"slo"`` block (TTFT and
        inter-token percentiles, preemption and deadline-miss counts, queue
        depths per class), as a deep-copied snapshot."""
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
        if self.sparsity_meter is not None:
            out["sparsity"] = self.sparsity_meter.summary()
        if hasattr(self.scheduler, "slo_stats"):
            out["slo"] = self.scheduler.slo_stats()
        return copy.deepcopy(out)

    def run(self, requests: List[Request]) -> List[Result]:
        return self.scheduler.run(requests)
