"""Batched serving engine: a host-side :class:`Scheduler` driving a
:class:`ModelRunner` over a paged KV cache, in PyTorch.

The reference's hot-path properties carry over:

* **Bulk prefill** — admitting a prompt costs one prefill call (full-prompt
  attention + a one-shot page write), with prompts padded to power-of-two
  buckets.
* **In-place caches** — the page pool is updated in place; the reference
  gets the same effect by donating the cache into its jitted steps.
* **On-device sampling** — greedy and temperature sampling run on the
  device; the host never sees logits.
* **Chunked decode** — ``decode_block`` steps run per host sync: sampled
  tokens stay on the device until one host read per block.
* **Per-slot positions** — every slot owns its cache timeline.

The :class:`Scheduler` admits by free-page budget and shares page-aligned
prompt prefixes through a :class:`~repro_torch.serving.kv_cache.PrefixCache`.
With ``forms=True``/``spec=...`` the engine compresses the weights once
(``repro_torch.forms.compress_tree``) and serves the compressed tree: every
projection runs the polarized-matmul kernel on uint8 magnitudes and int8
fragment signs.

Not ported yet, and refused rather than ignored: the dense slot cache
(``page_size=0``), mesh sharding, speculative decoding, health monitoring,
the SLO fleet scheduler and zero-skipping (see ROADMAP).
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
from repro_torch.forms import CompressReport, FormsSpec, compress_tree, default_spec
from repro_torch.models.registry import Model
from repro_torch.serving import kv_cache as KV


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0


@dataclasses.dataclass
class Result:
    uid: int
    tokens: List[int]
    prefill_ms: float = 0.0
    decode_ms: float = 0.0


_MIN_BUCKET = 8

# rotating-window cap on the scheduler's admission log
ADMISSION_LOG_WINDOW = 1024


def sample_on_device(logits: torch.Tensor, temps: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """Greedy/temperature sampling on the device.

    logits: (B, V) f32; temps: (B,) — rows with temp <= 0 take the argmax
    (the first maximal index, as ``jnp.argmax``), others draw from
    softmax(logits / temp) by the Gumbel-max trick with ``generator``.
    """
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(temps > 0.0, sampled, greedy)


class ModelRunner:
    """The device side of the engine: params + prefill/decode calls.

    Owns nothing about admission or page bookkeeping: it runs one bulk
    prefill or one ``decode_block``-token decode chunk on its paged cache.
    """

    def __init__(self, model: Model, params: Any, cache: KV.PagedKVCache, *,
                 max_len: int, spec: Optional[FormsSpec] = None,
                 decode_block: int = 4, rng_seed: int = 0):
        self.model = model
        self.device = model.device
        self.params = model.serving_params(params)
        self.cache = cache
        self.spec = spec
        self.decode_block = max(1, int(decode_block))
        self.max_len = int(max_len)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)

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
        """Normalize + bucket-pad a prompt to its (1, bucket) token buffer."""
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

    @torch.inference_mode()
    def prefill_slot(self, slot: int, prompt: np.ndarray, pages: np.ndarray,
                     temperature: float = 0.0) -> int:
        """Admit a prompt into ``slot`` with one bulk-prefill call; returns
        the first sampled token.  ``pages`` is the destination-page vector
        covering the bucket (scratch-0 entries skip prefix-shared pages)."""
        toks, n = self.padded_prompt(prompt)
        with default_spec(self.spec):
            logits, self.cache = self.model.prefill_paged(
                self.params, self._to_device(toks), self.cache,
                self._to_device(pages), slot, n)
        lg = logits.reshape(1, -1).float()
        temp = self._to_device(np.array([temperature]), torch.float32)
        return int(sample_on_device(lg, temp, self.generator)[0])

    @torch.inference_mode()
    def decode_chunk(self, tokens: np.ndarray, positions: np.ndarray,
                     temps: np.ndarray, block_tables: np.ndarray) -> np.ndarray:
        """``decode_block`` decode steps for all slots; returns the
        (decode_block, slots) sampled-token grid with one host read.  The
        host buffers are copied to the device first, so the scheduler may
        mutate them right after."""
        tok = self._to_device(tokens)
        pos = self._to_device(positions)
        tables = self._to_device(block_tables)
        temps_d = self._to_device(temps, torch.float32)
        out = []
        with default_spec(self.spec):
            for _ in range(self.decode_block):
                logits, self.cache = self.model.decode_paged(
                    self.params, tok[:, None], self.cache, pos, tables)
                tok = sample_on_device(logits[:, 0].float(), temps_d, self.generator)
                out.append(tok)
                pos = pos + 1
        return torch.stack(out).cpu().numpy()

    def decode_round(self, tokens: np.ndarray, positions: np.ndarray,
                     temps: np.ndarray, block_tables: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One scheduler round: ``(grid, counts)`` — the (decode_block, slots)
        token grid and how many rows of each slot are valid."""
        out = self.decode_chunk(tokens, positions, temps, block_tables)
        return out, np.full(out.shape[1], out.shape[0], np.int32)


class Scheduler:
    """The host side of the engine: admission by free-page budget, slot and
    page bookkeeping, and the continuous-batching loop.

    A request is admitted when a slot is free AND the allocator can reserve
    ``ceil(min(max(bucket, prompt + max_new), max_len) / page_size)`` pages
    (minus prefix-shared ones); pages are reserved up front, so a running
    request is never preempted by pool exhaustion.
    """

    def __init__(self, runner: ModelRunner, *, slots: int, max_len: int,
                 allocator: KV.PageAllocator, prefix: Optional[KV.PrefixCache] = None):
        self.runner = runner
        self.slots = slots
        self.max_len = max_len
        self.allocator = allocator
        self.prefix = prefix
        self.rounds = 0
        self.max_concurrent = 0
        self.admissions: "collections.deque[Tuple[int, Tuple[int, ...]]]" = \
            collections.deque(maxlen=ADMISSION_LOG_WINDOW)
        self.admissions_dropped = 0
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
                       max_new: int) -> Optional[np.ndarray]:
        """Reserve every page the request can touch; returns the prefill
        destination-page vector, or None if the free-page budget blocks.
        Prefix-shared pages are refcounted, and their prefill destinations
        are redirected to scratch so shared contents are never rewritten."""
        ps = self.runner.page_size
        n = len(prompt)
        bucket = self.runner.bucket_for(n)
        rows = min(max(bucket, n + max_new), self.max_len)
        need = KV.pages_for(rows, ps)
        shared = self.prefix.match(prompt) if self.prefix is not None else []
        own = self.allocator.alloc(need - len(shared))
        if own is None:
            return None
        self.allocator.share(shared)
        pages = shared + own
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
                pages = self._reserve_pages(req.uid, slot, prompt, req.max_new_tokens)
                if pages is None:
                    if not any(a is not None for a in active):
                        raise RuntimeError(
                            "page pool exhausted with no request in "
                            "flight — pool sizing bug")
                    return
                queue.pop(0)
                res = Result(uid=req.uid, tokens=[])
                t0 = time.perf_counter()
                first = self.runner.prefill_slot(slot, prompt, pages, req.temperature)
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
            out, counts = self.runner.decode_round(cur, slot_pos, temps,
                                                   self.block_tables)
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
    :class:`ModelRunner` and a :class:`Scheduler` over a paged KV cache.

    ``device`` defaults to ``"cuda"`` and must match the model's device;
    without CUDA the caller has to ask for ``"cpu"``.  ``plan={path:
    FormsSpec}`` serves a heterogeneous compressed tree.
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
                 health: Optional[Any] = None, zero_skip: Optional[str] = None,
                 zero_skip_stats: bool = False, slo: Optional[Any] = None):
        dev = resolve_device(device)
        if dev != model.device:
            raise ValueError(f"engine device {dev} differs from the model's "
                             f"{model.device} (build(cfg, device=...))")
        if not page_size:
            raise NotImplementedError(
                "the dense slot cache (page_size=0) is not ported yet; serve "
                "with page_size=... (ROADMAP queue 1, item 4)")
        _refuse("mesh", mesh, None, "ROADMAP queue 1, item 13")
        _refuse("speculate", speculate, False, "ROADMAP queue 1, item 6")
        _refuse("health", health, None, "ROADMAP queue 1, item 9")
        _refuse("slo", slo, None, "ROADMAP queue 1, item 7")
        _refuse("zero_skip", zero_skip if zero_skip != "off" else None, None,
                "ROADMAP queue 1, item 5")
        _refuse("zero_skip_stats", zero_skip_stats, False, "ROADMAP queue 1, item 5")
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
            with torch.inference_mode():
                params, self.compression_report = compress_tree(params, self.spec,
                                                                plan=plan)
        self.max_len = max_len
        self.slots = batch_slots
        self.page_size = int(page_size)
        if num_pages is None:
            # every slot can hold a full max_len request (+1 scratch page)
            num_pages = batch_slots * KV.pages_for(max_len, self.page_size) + 1
        allocator = KV.PageAllocator(num_pages)
        prefix = KV.PrefixCache(self.page_size) if prefix_cache else None
        cache = model.init_paged_cache(num_pages, self.page_size)
        self.runner = ModelRunner(model, params, cache, max_len=max_len,
                                  spec=self.spec, decode_block=decode_block,
                                  rng_seed=rng_seed)
        self.scheduler = Scheduler(self.runner, slots=batch_slots, max_len=max_len,
                                   allocator=allocator, prefix=prefix)

    @property
    def params(self) -> Any:
        return self.runner.params

    @property
    def decode_block(self) -> int:
        return self.runner.decode_block

    @property
    def page_allocator(self) -> KV.PageAllocator:
        return self.scheduler.allocator

    @property
    def prefix_cache(self) -> Optional[KV.PrefixCache]:
        return self.scheduler.prefix

    def cache_bytes(self) -> int:
        """Persistent device footprint of the serving cache."""
        return self.runner.cache.nbytes()

    def stats(self) -> Dict[str, Any]:
        """Serving counters: scheduler occupancy, page-pool occupancy and
        prefix-cache hits, as a deep-copied snapshot."""
        out: Dict[str, Any] = {
            "max_concurrent": self.scheduler.max_concurrent,
            "rounds": self.scheduler.rounds,
            "admissions_dropped": self.scheduler.admissions_dropped,
            "pages": self.page_allocator.stats(),
        }
        if self.prefix_cache is not None:
            out["prefix_hits"] = self.prefix_cache.hits
        return copy.deepcopy(out)

    def run(self, requests: List[Request]) -> List[Result]:
        return self.scheduler.run(requests)
