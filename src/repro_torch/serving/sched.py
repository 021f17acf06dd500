"""SLO-aware fleet scheduler: chunked prefill, priorities, preemption, in
PyTorch (the JAX package's ``serving/sched.py``, held to it on the CPU).

The plain :class:`~repro_torch.serving.engine.Scheduler` admits by
free-page budget only: one long prompt's bulk prefill runs while every
active decode slot waits, there are no priorities or deadlines, and
nothing measures tail latency under sustained traffic.
:class:`FleetScheduler` runs in rounds:

* **Chunked prefill** -- a prompt is prefilled in page-aligned chunks
  interleaved with decode rounds under a per-round token budget
  (``SLOConfig.step_token_budget``), through one multi-token
  ``decode_paged`` call per round
  (:meth:`~repro_torch.serving.engine.ModelRunner.prefill_chunk`), so a
  round's stall is bounded by the budget, not by the longest prompt.
  Prefix-shared pages are skipped outright.
* **Priority classes and preemption by page eviction** -- ``interactive``
  beats ``batch``; when a higher-priority arrival cannot admit, a
  strictly-lower-priority slot is evicted: its pages return to the
  allocator (refcounts protect shared pages), its generated tokens stay in
  its ``Result``, and on resume it re-prefills ``prompt + generated``.
  Greedy decoding is Markovian in those tokens, so the resumed request
  goes on with the uninterrupted run's tokens.
* **Deadlines, EDF within a priority class** -- arrived requests admit in
  (priority, earliest deadline, arrival) order; a completion past its
  deadline counts a miss for its class.  ``engine.stats()["slo"]`` holds
  TTFT and inter-token p50/p99 over rotating windows, preemption and
  deadline-miss counts and queue depths, per class.

Chunked prefill commits the rows bulk prefill commits (K/V row ``p``
depends on tokens ``<= p``; padded chunk columns land on rows that are
rewritten before a mask admits them; the first generated token samples
from the last prompt position's logits), so on the CPU greedy tokens equal
bulk admission's.  On the card a chunk's projections run at M = slots x
width (the tensor-core route) and its attention reads the paged cache, so
logits differ from bulk prefill's in the last bits and greedy tokens may
part at a near-tie (``chip_smoke.py`` measures the difference).  Times come
from ``time.perf_counter()`` on the host, as in the reference.  The health
monitor ticks at run start and every ``probe_every`` rounds, and the stat
line (``stats_every``) adds the queue depths, preemptions, misses and
chunks, as in the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.serving.engine import ModelRunner, Request, Result, Scheduler

PRIORITIES = ("interactive", "batch")   # admission order: left beats right


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Static policy of one fleet-scheduler instance.

    prefill_chunk: target prompt tokens prefilled per slot per round,
      rounded up to whole pages (page-aligned chunks); 0 = whole-prompt
      bulk admission (the pre-fleet behavior, kept as the instrumented
      baseline the load benchmark compares against).
    step_token_budget: per-round token budget shared by decode and chunked
      prefill — decode demand is charged first, prefill chunks consume the
      remainder (the highest-priority prefilling slot always advances by
      at least one page per round, so admission can never starve);
      0 = unbounded.
    default_priority / default_deadline_ms: applied to requests that leave
      ``Request.priority`` / ``Request.deadline_ms`` unset.
    preempt: allow eviction of strictly-lower-priority slots when a
      higher-priority arrival cannot admit.
    window: rotating sample window per latency series (TTFT, inter-token;
      per class) — old samples roll off and are counted, not kept.
    """

    prefill_chunk: int = 32
    step_token_budget: int = 128
    default_priority: str = "interactive"
    default_deadline_ms: Optional[float] = None
    preempt: bool = True
    window: int = 4096

    def __post_init__(self):
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {self.prefill_chunk}")
        if self.step_token_budget < 0:
            raise ValueError(f"step_token_budget must be >= 0, "
                             f"got {self.step_token_budget}")
        if self.default_priority not in PRIORITIES:
            raise ValueError(
                f"default_priority must be one of {PRIORITIES}, "
                f"got {self.default_priority!r}")
        if self.default_deadline_ms is not None \
                and self.default_deadline_ms <= 0:
            raise ValueError("default_deadline_ms must be positive")
        if self.window < 2:
            raise ValueError(f"window must be >= 2, got {self.window}")


@dataclasses.dataclass
class _Entry:
    """One queued (or preempted-and-requeued) request."""

    req: Request
    res: Result
    prompt: np.ndarray            # truncated original prompt
    prio: int
    arrival: float                # run-relative seconds
    deadline: Optional[float]     # run-relative absolute deadline
    ttft_done: bool = False
    preempted: int = 0

    def order_key(self):
        """EDF within priority; FIFO breaks deadline ties."""
        d = self.deadline if self.deadline is not None else float("inf")
        return (self.prio, d, self.arrival, self.req.uid)

    def resume_prompt(self) -> np.ndarray:
        """Original prompt + every token generated before the eviction —
        greedy decode is Markovian in these, so re-prefilling them restores
        the request exactly."""
        if not self.res.tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.res.tokens, np.int32)])


@dataclasses.dataclass
class _SlotRun:
    """Host state of one occupied slot."""

    entry: _Entry
    prompt: np.ndarray            # the admitted (possibly resumed) prompt
    n_prompt: int
    filled: int                   # prompt tokens resident in the cache
    phase: str                    # "prefill" | "decode"
    last_emit: float


class _Window:
    """Rotating latency-sample window (milliseconds) with a drop counter."""

    def __init__(self, cap: int):
        self.samples: "collections.deque[float]" = collections.deque(
            maxlen=cap)
        self.dropped = 0

    def add(self, ms: float, n: int = 1) -> None:
        for _ in range(n):
            if len(self.samples) == self.samples.maxlen:
                self.dropped += 1
            self.samples.append(ms)

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {"p50": 0.0, "p99": 0.0, "n": 0}
        arr = np.asarray(self.samples, np.float64)
        return {"p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99)),
                "n": int(arr.size) + self.dropped}


class FleetScheduler(Scheduler):
    """A :class:`~repro_torch.serving.engine.Scheduler` whose run loop is round-
    based: admissions (EDF within priority, preemption-by-page-eviction),
    one chunked-prefill dispatch, one decode round — all under a per-round
    token budget.  Requires the paged cache (the engine enforces it)."""

    def __init__(self, runner: ModelRunner, *, cfg: Optional[SLOConfig] = None,
                 **kw):
        super().__init__(runner, **kw)
        if not self.paged:
            raise ValueError("the fleet scheduler needs the paged cache")
        self.cfg = cfg if cfg is not None else SLOConfig()
        ps = runner.page_size
        # page-aligned chunk: admission skips prefix-shared pages and every
        # chunk boundary stays a page boundary until the final partial chunk
        self.chunk = (-(-self.cfg.prefill_chunk // ps) * ps
                      if self.cfg.prefill_chunk else 0)
        self.reset_slo_stats()

    def reset_slo_stats(self) -> None:
        """Zero the latency windows and SLO counters.  Windows accumulate
        across ``run()`` calls by design (a fleet serves forever); the load
        benchmark calls this between its warmup pass and the measured
        trace, so the tails measure scheduling rather than tracing."""
        self.preemptions = 0
        self.resumes = 0
        self.deadline_misses = 0
        self.completed = 0
        self.chunk_calls = 0
        self.chunk_tokens = 0
        w = self.cfg.window
        self._ttft = {p: _Window(w) for p in PRIORITIES}
        self._itl = {p: _Window(w) for p in PRIORITIES}
        self._class = {p: {"completed": 0, "deadline_misses": 0,
                           "preemptions": 0, "queue_peak": 0}
                       for p in PRIORITIES}
        self._queue_depth = {p: 0 for p in PRIORITIES}

    # ------------------------------------------------------------------
    # request -> entry
    # ------------------------------------------------------------------

    def _make_entry(self, req: Request) -> _Entry:
        prio_name = req.priority or self.cfg.default_priority
        if prio_name not in PRIORITIES:
            raise ValueError(f"request {req.uid}: priority must be one of "
                             f"{PRIORITIES}, got {req.priority!r}")
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.shape[0] >= self.max_len:
            prompt = prompt[-(self.max_len - 1):]
        deadline_ms = (req.deadline_ms if req.deadline_ms is not None
                       else self.cfg.default_deadline_ms)
        arrival = max(0.0, float(req.arrival_s))
        return _Entry(
            req=req, res=Result(uid=req.uid, tokens=[]), prompt=prompt,
            prio=PRIORITIES.index(prio_name), arrival=arrival,
            deadline=(arrival + deadline_ms / 1e3
                      if deadline_ms is not None else None))

    # ------------------------------------------------------------------
    # the round loop
    # ------------------------------------------------------------------

    @obs.spanned("rt.sched.run")
    def run(self, requests: List[Request]) -> List[Result]:
        self._t0 = time.perf_counter()
        queue: List[_Entry] = [self._make_entry(r) for r in requests]
        runs: List[Optional[_SlotRun]] = [None] * self.slots
        done: List[Result] = []
        cur = np.zeros(self.slots, np.int32)
        slot_pos = np.zeros(self.slots, np.int32)
        temps = np.zeros(self.slots, np.float32)
        state = dict(queue=queue, runs=runs, done=done, cur=cur,
                     slot_pos=slot_pos, temps=temps)

        if self.health is not None:
            self.health.tick(self.runner, self.rounds)

        while queue or any(r is not None for r in runs):
            now = self._now()
            if all(r is None for r in runs) \
                    and not any(e.arrival <= now for e in queue):
                # open-loop idle: nothing resident, nothing due — sleep to
                # the next arrival instead of spinning
                time.sleep(max(0.0, min(e.arrival for e in queue) - now))
                continue
            self._admit(state)
            self._sample_queue_depth(queue)
            budget = self.cfg.step_token_budget or 1 << 30
            per_slot = (self.runner.k_max + 1
                        if hasattr(self.runner, "k_max")
                        else self.runner.decode_block)
            n_dec = sum(1 for r in runs
                        if r is not None and r.phase == "decode")
            self._prefill_round(state, max(0, budget - n_dec * per_slot))
            self._decode_round(state)
            self.rounds += 1
            if (self.health is not None and self.health.config.probe_every
                    and self.rounds % self.health.config.probe_every == 0):
                self.health.tick(self.runner, self.rounds)
            self._log_round(sum(r is not None for r in runs))
        return done

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    # ------------------------------------------------------------------
    # admission + preemption
    # ------------------------------------------------------------------

    def _sample_queue_depth(self, queue: List[_Entry]) -> None:
        now = self._now()
        for p in PRIORITIES:
            i = PRIORITIES.index(p)
            depth = sum(1 for e in queue
                        if e.prio == i and e.arrival <= now)
            self._queue_depth[p] = depth
            self._class[p]["queue_peak"] = max(
                self._class[p]["queue_peak"], depth)

    def _admit(self, state: Dict[str, Any]) -> None:
        """Admit arrived entries in (priority, deadline) order; evict
        strictly-lower-priority slots when the head cannot fit and
        preemption is enabled."""
        queue, runs = state["queue"], state["runs"]
        while True:
            now = self._now()
            arrived = sorted((e for e in queue if e.arrival <= now),
                             key=_Entry.order_key)
            if not arrived:
                return
            head = arrived[0]
            slot = next((s for s in range(self.slots) if runs[s] is None),
                        None)
            started = False
            if slot is not None:
                with obs.span("rt.sched.admit", uid=head.req.uid):
                    started = self._start(state, slot, head)
            if started:
                queue.remove(head)
                continue
            victim = self._pick_victim(runs, head)
            if self.cfg.preempt and victim is not None:
                self._preempt(state, victim)
                continue
            if slot is not None and not any(r is not None for r in runs):
                raise RuntimeError(
                    "page pool exhausted with no request in flight — "
                    "pool sizing bug")
            return

    def _pick_victim(self, runs: List[Optional[_SlotRun]],
                     head: _Entry) -> Optional[int]:
        """The strictly-lower-priority slot to evict for ``head``: lowest
        class first, then latest deadline, then least progress (cheapest
        re-prefill)."""
        cands = [s for s, r in enumerate(runs)
                 if r is not None and r.entry.prio > head.prio]
        if not cands:
            return None
        def key(s):
            r = runs[s]
            d = (r.entry.deadline if r.entry.deadline is not None
                 else float("inf"))
            return (r.entry.prio, d, -(r.filled + len(r.entry.res.tokens)))
        return max(cands, key=key)

    def _preempt(self, state: Dict[str, Any], slot: int) -> None:
        """Evict ``slot``: pages back to the allocator (refcounts protect
        prefix-shared pages), generated prefix retained host-side in the
        entry's Result, entry requeued for EDF re-admission."""
        runs, temps = state["runs"], state["temps"]
        st = runs[slot]
        st.entry.preempted += 1
        self.preemptions += 1
        self._class[PRIORITIES[st.entry.prio]]["preemptions"] += 1
        self._release_slot(slot)
        runs[slot] = None
        temps[slot] = 0.0
        state["queue"].append(st.entry)

    def _start(self, state: Dict[str, Any], slot: int, entry: _Entry) -> bool:
        """Reserve pages and begin (or bulk-perform) the prefill of
        ``entry`` in ``slot``; False when the free-page budget blocks."""
        runs = state["runs"]
        prompt = entry.resume_prompt()
        if prompt.shape[0] >= self.max_len:
            # a resumed prefix can outgrow the window like an oversized
            # prompt does: keep the most recent context-window's worth
            prompt = prompt[-(self.max_len - 1):]
        n = int(prompt.shape[0])
        max_new = entry.req.max_new_tokens - len(entry.res.tokens)
        if entry.res.tokens:
            self.resumes += 1
        if not self.chunk:
            return self._start_bulk(state, slot, entry, prompt, max_new)
        # chunked admission: reserve exactly prompt+budget rows and skip
        # prefix-shared pages outright — but never the page holding the
        # last prompt token (its logits seed the first generated token, so
        # that position must be computed, on an owned page)
        pages = self._reserve_pages(
            entry.req.uid, slot, prompt, max_new,
            shared_cap=(n - 1) // self.runner.page_size,
            rows=min(n + max_new, self.max_len))
        if pages is None:
            return False
        runs[slot] = _SlotRun(entry=entry, prompt=prompt, n_prompt=n,
                              filled=self.last_shared * self.runner.page_size,
                              phase="prefill", last_emit=self._now())
        self.max_concurrent = max(self.max_concurrent,
                                  sum(r is not None for r in runs))
        return True

    def _start_bulk(self, state: Dict[str, Any], slot: int, entry: _Entry,
                    prompt: np.ndarray, max_new: int) -> bool:
        """Whole-prompt admission (prefill_chunk=0): the pre-fleet bulk
        path with fleet instrumentation — the baseline the sustained-load
        benchmark compares chunking against."""
        runs = state["runs"]
        pages = self._reserve_pages(entry.req.uid, slot, prompt, max_new)
        if pages is None:
            return False
        t0 = time.perf_counter()
        first = self.runner.prefill_slot(slot, prompt, entry.req.temperature,
                                         pages=pages)
        entry.res.prefill_ms += (time.perf_counter() - t0) * 1e3
        runs[slot] = _SlotRun(entry=entry, prompt=prompt,
                              n_prompt=int(prompt.shape[0]),
                              filled=int(prompt.shape[0]), phase="prefill",
                              last_emit=self._now())
        self.max_concurrent = max(self.max_concurrent,
                                  sum(r is not None for r in runs))
        self._first_token(state, slot, first)
        return True

    # ------------------------------------------------------------------
    # chunked prefill rounds
    # ------------------------------------------------------------------

    def _prefill_round(self, state: Dict[str, Any], budget: int) -> None:
        """Advance every prefilling slot by one granted chunk in ONE
        batched ``prefill_chunk`` dispatch.  Grants follow admission order;
        the first (highest-priority) slot always advances by at least one
        page — budget bounds the stall, never causes starvation."""
        runs = state["runs"]
        prefs = sorted(
            (s for s in range(self.slots)
             if runs[s] is not None and runs[s].phase == "prefill"),
            key=lambda s: runs[s].entry.order_key())
        if not prefs:
            return
        ps = self.runner.page_size
        grants: Dict[int, int] = {}
        left = budget
        for s in prefs:
            rem = runs[s].n_prompt - runs[s].filled
            floor = min(rem, ps) if not grants else 0
            take = min(rem, self.chunk, max(left, floor))
            if take <= 0:
                continue
            grants[s] = take
            left -= take
        if not grants:
            return
        t0 = time.perf_counter()
        width = self.runner.chunk_width(max(grants.values()))
        toks = np.zeros((self.slots, width), np.int32)
        pos = np.zeros(self.slots, np.int32)
        cols = np.zeros(self.slots, np.int32)
        temps_c = np.zeros(self.slots, np.float32)
        tables = np.zeros_like(self.block_tables)
        for s, take in grants.items():
            st = runs[s]
            toks[s, :take] = st.prompt[st.filled:st.filled + take]
            pos[s] = st.filled
            cols[s] = take - 1
            temps_c[s] = st.entry.req.temperature
            tables[s] = self.block_tables[s]
        tok = self.runner.prefill_chunk(toks, pos, tables, cols, temps_c)
        dt = (time.perf_counter() - t0) * 1e3
        self.chunk_calls += 1
        self.chunk_tokens += sum(grants.values())
        for s, take in grants.items():
            st = runs[s]
            st.filled += take
            st.entry.res.prefill_ms += dt / len(grants)
            if st.filled >= st.n_prompt:
                self._first_token(state, s, int(tok[s]))

    def _first_token(self, state: Dict[str, Any], slot: int,
                     tok: int) -> None:
        """Prefill completed for ``slot``: record TTFT, register the
        prefix, emit the first generated token, and either transition to
        decode or finish outright (budget/window exhausted)."""
        runs, cur = state["runs"], state["cur"]
        slot_pos, temps = state["slot_pos"], state["temps"]
        st = runs[slot]
        e = st.entry
        now = self._now()
        e.res.tokens.append(tok)
        if not e.ttft_done:
            e.ttft_done = True
            e.res.ttft_ms = (now - e.arrival) * 1e3
            self._ttft[PRIORITIES[e.prio]].add(e.res.ttft_ms)
        st.last_emit = now
        if (len(e.res.tokens) >= e.req.max_new_tokens
                or st.n_prompt >= self.max_len - 1):
            self._finish(state, slot)
            return
        if self.prefix is not None:
            self.prefix.register(st.prompt, self.slot_pages[slot])
        st.phase = "decode"
        cur[slot] = tok
        slot_pos[slot] = st.n_prompt
        temps[slot] = e.req.temperature
        self.runner.reset_slot(slot)

    # ------------------------------------------------------------------
    # decode rounds
    # ------------------------------------------------------------------

    def _decode_round(self, state: Dict[str, Any]) -> None:
        runs, cur = state["runs"], state["cur"]
        slot_pos, temps = state["slot_pos"], state["temps"]
        decoding = [s for s in range(self.slots)
                    if runs[s] is not None and runs[s].phase == "decode"]
        if not decoding:
            return
        # non-decoding slots (idle OR mid-prefill) get zeroed table rows:
        # their garbage commits land in scratch instead of on the prefill
        # rows already resident in their pages
        mask = np.zeros(self.slots, bool)
        mask[decoding] = True
        tables = np.where(mask[:, None], self.block_tables, 0)
        with obs.span("rt.runner.decode_round", round=self.rounds):
            out, counts = self.runner.decode_round(
                cur, slot_pos, temps, block_tables=tables,
                active=list(mask))
        now = self._now()
        for s in decoding:
            st = runs[s]
            e = st.entry
            budget = min(e.req.max_new_tokens - len(e.res.tokens),
                         self.max_len - 1 - int(slot_pos[s]))
            take = min(int(counts[s]), budget)
            e.res.tokens.extend(int(t) for t in out[:take, s])
            if take > 0:
                self._itl[PRIORITIES[e.prio]].add(
                    (now - st.last_emit) * 1e3 / take, n=take)
                st.last_emit = now
            if take >= budget:
                self._finish(state, s)
            else:
                cur[s] = out[counts[s] - 1, s]
                slot_pos[s] += int(counts[s])

    def _finish(self, state: Dict[str, Any], slot: int) -> None:
        runs, temps = state["runs"], state["temps"]
        st = runs[slot]
        e = st.entry
        self._release_slot(slot)
        runs[slot] = None
        temps[slot] = 0.0
        e.res.latency_ms = (self._now() - e.arrival) * 1e3
        state["done"].append(e.res)
        self.completed += 1
        cls = self._class[PRIORITIES[e.prio]]
        cls["completed"] += 1
        if e.deadline is not None and self._now() > e.deadline:
            self.deadline_misses += 1
            cls["deadline_misses"] += 1

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    def slo_stats(self) -> Dict[str, Any]:
        """The ``engine.stats()["slo"]`` block: latency percentiles over
        the rotating windows, preemption/deadline/queue counters — overall
        and per priority class."""
        merged_ttft = _Window(2 * self.cfg.window)
        merged_itl = _Window(2 * self.cfg.window)
        for p in PRIORITIES:
            merged_ttft.samples.extend(self._ttft[p].samples)
            merged_ttft.dropped += self._ttft[p].dropped
            merged_itl.samples.extend(self._itl[p].samples)
            merged_itl.dropped += self._itl[p].dropped
        out: Dict[str, Any] = {
            "ttft_ms": merged_ttft.summary(),
            "inter_token_ms": merged_itl.summary(),
            "completed": self.completed,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "deadline_misses": self.deadline_misses,
            "chunked_prefill": {"calls": self.chunk_calls,
                                "tokens": self.chunk_tokens},
            "window_dropped": sum(w.dropped for w in
                                  list(self._ttft.values())
                                  + list(self._itl.values())),
            "per_class": {},
        }
        for p in PRIORITIES:
            out["per_class"][p] = {
                "ttft_ms": self._ttft[p].summary(),
                "inter_token_ms": self._itl[p].summary(),
                "queue_depth": self._queue_depth[p],
                **self._class[p],
            }
        return out

    def _log_round(self, n_active: int) -> None:
        if not self.log_every or self.rounds % self.log_every:
            return
        super()._log_round(n_active)
        depths = ", ".join(f"{p} q={self._queue_depth[p]}"
                           for p in PRIORITIES)
        print(f"[serve]   slo: {depths}, preempt {self.preemptions}, "
              f"miss {self.deadline_misses}, "
              f"chunks {self.chunk_calls}/{self.chunk_tokens}tok",
              flush=True)
