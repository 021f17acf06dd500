"""Paged KV cache: a page pool on the device + host-side page bookkeeping.

Instead of one ``(layers, slots, max_len, ...)`` allocation per cache leaf,
the sequence dim is cut into fixed-size **pages** drawn from a shared pool,
and each slot owns an int32 **block table** mapping its logical page index
to a physical page id.

Device side:

* :class:`PagedKVCache` — the page pools (``(layers, num_pages, page_size,
  ...)`` per leaf), and the leaves that stay slot-addressed beside them
  (whisper's encoder output).
* :func:`gather_views` — block-table gather producing the per-slot
  contiguous ``(layers, slots, cap, ...)`` views decode attention reads.
* :func:`commit_tokens` / :func:`commit_token` / :func:`commit_pages` — the
  decode-step write of new token rows into their pages, and the
  bulk-prefill write of whole pages; :func:`rollback_tokens` zeroes the
  rejected rows of a speculative round.  All update the pool **in place**
  (``index_put_``): the port's counterpart of the reference's donated,
  aliased jit buffers.

Host side (plain Python): :class:`PageAllocator` (free list + refcounts;
page 0 is the reserved scratch page, written but never read) and
:class:`PrefixCache` (page-aligned prompt prefixes -> live page ids).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs

SCRATCH_PAGE = 0


@dataclasses.dataclass
class PagedKVCache:
    """Page-pool serving cache: ``pool`` leaves are ``(layers, num_pages,
    page_size, ...)``, the paged counterparts of the dense cache's
    ``(layers, slots, max_len, ...)`` leaves.  ``dense`` holds the leaves
    that stay slot-addressed, ``(slots, ...)`` (whisper's ``enc_out``;
    empty for the other families): the page functions below read and
    write only the pool, so they carry ``dense`` through unchanged."""

    pool: Dict[str, torch.Tensor]
    page_size: int
    dense: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def num_pages(self) -> int:
        return next(iter(self.pool.values())).shape[1]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (*self.pool.values(), *self.dense.values()))


def pages_for(rows: int, page_size: int) -> int:
    """Number of pages covering ``rows`` cache rows."""
    return -(-rows // page_size)


@obs.spanned("rt.kv.gather")
def gather_views(cache: PagedKVCache, block_tables: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """Per-slot contiguous views of the pool via the block tables.

    ``block_tables``: (slots, n_tables) int physical page ids (scratch-0 for
    unallocated entries).  Returns ``(layers, slots, n_tables * page_size,
    ...)`` tensors.  Advanced indexing copies, so the decode path may write
    its new tokens into these views without touching the pool.
    """
    b, n = block_tables.shape
    idx = block_tables.long()
    out = {}
    for name, pool in cache.pool.items():
        v = pool[:, idx]                          # (L, B, n, ps, ...)
        out[name] = v.reshape(v.shape[0], b, n * cache.page_size, *v.shape[4:])
    return out


def resolve_pages(block_tables: torch.Tensor, grid: torch.Tensor, page_size: int,
                  select: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve a (slots, T) position grid to (page, offset) grids; positions
    past the block table go to the scratch page, never onto a live page.
    ``select`` (bool, the grid's shape) also sends de-selected positions to
    scratch (the rollback's "touch only the rejected rows")."""
    n_tables = block_tables.shape[1]
    bidx = torch.arange(grid.shape[0], device=grid.device)[:, None]
    pidx = torch.div(grid, page_size, rounding_mode="floor")
    live = pidx < n_tables
    if select is not None:
        live = live & select
    page = torch.where(live,
                       block_tables[bidx, pidx.clamp(max=n_tables - 1).long()],
                       torch.full_like(block_tables[bidx, 0], SCRATCH_PAGE))
    return page, grid % page_size


def commit_tokens(cache: PagedKVCache, toks: Dict[str, torch.Tensor],
                  block_tables: torch.Tensor, pos: torch.Tensor) -> PagedKVCache:
    """Write each slot's T new-token rows into their pages, in place.

    ``toks``: per-leaf ``(layers, slots, T, ...)`` rows; ``pos``: (slots,)
    start positions (row t lands at ``pos + t``) or a (slots, T) grid.
    Idle slots and out-of-table positions all land on the scratch page; the
    order of those duplicate writes is unspecified and harmless, because
    scratch is never read.
    """
    t = next(iter(toks.values())).shape[2]
    pos = pos.to(torch.int32)
    grid = (pos[:, None] + torch.arange(t, dtype=torch.int32, device=pos.device)[None, :]
            if pos.ndim == 1 else pos)
    page, off = resolve_pages(block_tables, grid, cache.page_size)
    page, off = page.long(), off.long()
    for name, tok in toks.items():
        pool = cache.pool[name]
        pool[:, page, off] = tok.to(pool.dtype)
    return cache


def commit_token(cache: PagedKVCache, toks: Dict[str, torch.Tensor],
                 block_tables: torch.Tensor, pos: torch.Tensor) -> PagedKVCache:
    """Write each slot's single new-token row into its page, in place.
    ``toks``: per-leaf ``(layers, slots, ...)`` rows; ``pos``: (slots,)
    write positions.  The T=1 view of :func:`commit_tokens`."""
    return commit_tokens(cache, {n: v[:, :, None] for n, v in toks.items()},
                         block_tables, pos.to(torch.int32)[:, None])


def rollback_tokens(cache: PagedKVCache, block_tables: torch.Tensor,
                    pos: torch.Tensor, keep: torch.Tensor, t: int) -> PagedKVCache:
    """Scrub a tentative ``t``-row commit at ``pos .. pos+t-1`` back to
    ``keep`` rows per slot, in place: the rejected rows ``pos+keep ..
    pos+t-1`` are zeroed.  The positional rollback (the scheduler's cursor
    moving back to ``pos + keep``) is already sound, since every decode
    mask admits only ``kpos <= pos`` and every row is rewritten before its
    position enters a mask; this is its auditing form.  Kept rows, and rows
    of other slots, are untouched: their zero-writes go to scratch."""
    pos = pos.to(torch.int32)
    offs = torch.arange(t, dtype=torch.int32, device=pos.device)[None, :]
    page, off = resolve_pages(block_tables, pos[:, None] + offs, cache.page_size,
                              select=offs >= keep.to(torch.int32)[:, None])
    page, off = page.long(), off.long()
    for pool in cache.pool.values():
        pool[:, page, off] = torch.zeros((), dtype=pool.dtype, device=pool.device)
    return cache


def commit_pages(cache: PagedKVCache, leaves: Dict[str, torch.Tensor],
                 pages: torch.Tensor) -> PagedKVCache:
    """Bulk-prefill write of a whole prompt, in place.

    ``leaves``: per-leaf ``(layers, 1, S, ...)`` rows; ``pages``:
    ``(ceil(S / page_size),)`` destination page ids.  Rows are padded to
    whole pages; prefix-shared pages are protected by scratch-0 entries.
    """
    ps = cache.page_size
    idx = pages.long()
    for name, arr in leaves.items():
        l, _, s = arr.shape[:3]
        pad = (-s) % ps
        if pad:
            arr = torch.nn.functional.pad(arr, (0, 0) * (arr.ndim - 3) + (0, pad))
        n = (s + pad) // ps
        tiles = arr.reshape(l, n, ps, *arr.shape[3:])
        pool = cache.pool[name]
        pool[:, idx] = tiles.to(pool.dtype)
    return cache


# ---------------------------------------------------------------------------
# host-side bookkeeping (scheduler state — plain Python)
# ---------------------------------------------------------------------------


class PageAllocator:
    """Free list + refcounts over the page pool (host side).

    Page 0 (:data:`SCRATCH_PAGE`) is reserved and pinned; usable capacity is
    ``num_pages - 1``.  Shared (prefix-cache) pages are refcounted — a page
    returns to the free list only when its last holder releases it.

    ``partitions=D`` (a page pool sharded over D data ranks) cuts the pool
    into D equal ranges, one per data rank, each with its own free list and
    its own scratch page (the range's first page, which is the rank's local
    page 0): a slot's pages must live on the rank that decodes it, so
    :meth:`alloc` takes the partition.
    """

    def __init__(self, num_pages: int, partitions: int = 1):
        if partitions < 1 or num_pages % partitions:
            raise ValueError(f"num_pages={num_pages} does not split into "
                             f"{partitions} equal partitions")
        self.partitions = partitions
        self.per_part = num_pages // partitions
        if self.per_part < 2:
            raise ValueError(f"num_pages={num_pages} must be >= 2 per partition "
                             "(page 0 of each is the reserved scratch page)")
        self.num_pages = num_pages
        self._refs = np.zeros(num_pages, np.int32)
        self._refs[::self.per_part] = 1
        # pop() hands out low page ids first (stable tests/debugging)
        self._free: List[List[int]] = [
            list(range((q + 1) * self.per_part - 1, q * self.per_part, -1))
            for q in range(partitions)]
        self.high_water = 0          # peak pages simultaneously in use
        # lifetime accounting (eviction/restore churn shows up here: a
        # preempted-then-resumed request allocates its pages twice)
        self.total_allocated = 0     # pages handed out over the lifetime
        self.total_freed = 0         # pages returned to the free list
        self.failed_allocs = 0       # alloc() calls refused for lack of pages

    @property
    def capacity(self) -> int:
        return self.num_pages - self.partitions

    @property
    def part_capacity(self) -> int:
        """Usable pages of one partition (what one slot can ever hold)."""
        return self.per_part - 1

    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def used_pages(self) -> int:
        return self.capacity - self.free_pages

    def partition_of(self, page: int) -> int:
        return page // self.per_part

    def stats(self) -> Dict[str, int]:
        """Pool occupancy snapshot: capacity, free/used pages, pages held by
        more than one request (prefix sharing), and the high-water mark of
        simultaneous use (surfaced through ``ServingEngine.stats()`` and the
        serve CLI's periodic log line)."""
        live = np.ones(self.num_pages, bool)
        live[::self.per_part] = False
        return {
            "capacity": self.capacity,
            "free": self.free_pages,
            "used": self.used_pages,
            "shared": int((self._refs[live] > 1).sum()),
            "high_water": self.high_water,
            "total_allocated": self.total_allocated,
            "total_freed": self.total_freed,
            "failed_allocs": self.failed_allocs,
        }

    def alloc(self, n: int, part: int = 0) -> Optional[List[int]]:
        """Allocate ``n`` pages of partition ``part`` (refcount 1 each), or
        None if short."""
        free = self._free[part]
        if n > len(free):
            self.failed_allocs += 1
            return None
        pages = [free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.total_allocated += n
        self.high_water = max(self.high_water, self.used_pages)
        return pages

    def share(self, pages: Iterable[int]) -> None:
        """Take an additional reference on already-live pages."""
        for p in pages:
            if self._refs[p] <= 0:
                raise ValueError(f"page {p} is not live")
            self._refs[p] += 1

    def release(self, pages: Iterable[int]) -> List[int]:
        """Drop one reference per page; returns the pages actually freed."""
        freed = []
        for p in pages:
            if p % self.per_part == SCRATCH_PAGE:
                continue
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free[self.partition_of(p)].append(p)
                freed.append(p)
            elif self._refs[p] < 0:
                raise ValueError(f"page {p} released more times than held")
        self.total_freed += len(freed)
        return freed


class PrefixCache:
    """Page-aligned prompt-prefix registry: token prefix -> live page ids.

    Only FULL pages are shared — the divergent tail of a prompt always gets
    fresh pages, so a shared page is never written after registration (the
    sharer's first write position is ``>= len(prompt) >= shared_pages *
    page_size``).  Entries are dropped as soon as any of their pages is
    freed, so the registry never resurrects recycled pages; sharing
    therefore requires an overlapping live request (no eviction policy to
    tune).  Exact reuse relies on deterministic prefill: identical prefix
    tokens produce identical K/V rows.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._entries: Dict[bytes, List[int]] = {}
        self.hits = 0
        self.evictions = 0           # entries dropped because a page freed

    @staticmethod
    def _key(tokens: np.ndarray) -> bytes:
        return np.ascontiguousarray(tokens, np.int32).tobytes()

    def match(self, prompt: np.ndarray) -> List[int]:
        """Page ids of the longest registered full-page prefix of ``prompt``."""
        n_full = len(prompt) // self.page_size
        for i in range(n_full, 0, -1):
            pages = self._entries.get(self._key(prompt[: i * self.page_size]))
            if pages is not None:
                self.hits += 1
                return list(pages)
        return []

    def register(self, prompt: np.ndarray, pages: List[int]) -> None:
        """Register every full-page prefix of ``prompt`` (pages[:i] covers
        tokens[:i * page_size])."""
        for i in range(1, len(prompt) // self.page_size + 1):
            self._entries[self._key(prompt[: i * self.page_size])] = \
                list(pages[:i])

    def evict(self, freed: Iterable[int]) -> None:
        """Drop every entry that references a freed page."""
        freed = set(freed)
        if freed:
            before = len(self._entries)
            self._entries = {k: v for k, v in self._entries.items()
                             if not freed.intersection(v)}
            self.evictions += before - len(self._entries)

    def stats(self) -> Dict[str, int]:
        """Registry snapshot: live entries, lifetime hits and evictions."""
        return {"entries": len(self._entries), "hits": self.hits,
                "evictions": self.evictions}
