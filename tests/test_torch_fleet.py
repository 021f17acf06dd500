"""PyTorch port vs the JAX package: the SLO fleet scheduler and its load
generator.

Both packages serve the reduced qwen2 of ``torch_parity_util`` from the
same bridged weights (float32, paged cache).  The port's load generator
gives the reference's trace field for field; the port's chunked fleet
gives the reference fleet's greedy tokens, admission order and counts
(completions, preemptions, resumes, deadline misses, chunk calls and
tokens), and its bulk admission and plain scheduler the same tokens.
Preemption is made deterministic by a virtual clock (``_now`` counts
rounds) in both packages, so their whole ``slo_stats()`` must agree.  The
reference's own cases of ``tests/test_serving_fleet.py`` are mirrored on
the port.  The reference's own tests of its compositions with speculation
and zero-skip do not pass on every CPU, so the port's compositions are
held against the port's own bulk admission.
"""
import collections

import numpy as np
import pytest

from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.loadgen import LoadGenConfig as JLoadGenConfig
from repro.serving.loadgen import generate as jgenerate
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.loadgen import LoadGenConfig, generate
from repro_torch.serving.sched import SLOConfig

from torch_parity_util import models, shared_codes

COMMON = dict(max_len=64, batch_slots=2, page_size=4)


def _tokens(results):
    return {r.uid: list(r.tokens) for r in results}


def _port(**kw):
    tm, tp = models()[2:]
    return ServingEngine(tm, tp, device="cpu", **{**COMMON, **kw})


def _ref(**kw):
    jm, jp = models()[:2]
    return JEngine(jm, jp, **{**COMMON, **kw})


def _mixed(cls, n=3, new=5):
    """Prompts straddling the chunk size (shorter, equal, longer)."""
    return [cls(uid=i, prompt=(np.arange(1 + i, 4 + i * 4) % 64).astype(np.int32),
                max_new_tokens=new) for i in range(n)]


def _virtual_clock(engine, dt=0.01):
    """Make the fleet's clock count rounds (``dt`` seconds each), from 0."""
    sched = engine.scheduler
    sched.rounds = 0
    sched._now = lambda: sched.rounds * dt


def _counts(slo):
    return ({k: slo[k] for k in ("completed", "preemptions", "resumes", "deadline_misses")},
            slo["chunked_prefill"],
            {c: {k: v[k] for k in ("completed", "deadline_misses", "preemptions")}
             for c, v in slo["per_class"].items()})


# ---------------------------------------------------------------------------
# the load generator
# ---------------------------------------------------------------------------

TRACES = {
    "default": {},
    "deadlines-adversarial": dict(n_requests=16, rate=50.0, seed=3, batch_frac=0.3,
                                  deadline_ms=800.0, batch_deadline_ms=5000.0,
                                  adversarial_len=40),
    "three-giants": dict(n_requests=20, rate=100.0, seed=0, prompt_len=(2, 8),
                         out_len=(3, 6), adversarial_len=50, adversarial_count=3, vocab=32),
    "chip-smoke": dict(n_requests=24, seed=0, prompt_len=(16, 64), out_len=(8, 16),
                       batch_frac=0.25, adversarial_len=192, adversarial_count=2,
                       vocab=151936, rate=3.7),
}


@pytest.mark.parametrize("trace", list(TRACES))
def test_loadgen_trace_equals_the_reference(trace):
    got = generate(LoadGenConfig(**TRACES[trace]))
    want = jgenerate(JLoadGenConfig(**TRACES[trace]))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.uid, a.max_new_tokens, a.temperature, a.priority, a.deadline_ms,
                a.arrival_s) == (b.uid, b.max_new_tokens, b.temperature, b.priority,
                                 b.deadline_ms, b.arrival_s)
        assert a.prompt.dtype == b.prompt.dtype
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_loadgen_validation():
    for kw, what in ((dict(n_requests=0), "n_requests"), (dict(rate=0.0), "rate"),
                     (dict(prompt_len=(5, 2)), "prompt_len"), (dict(batch_frac=1.5), "batch_frac"),
                     (dict(vocab=1), "vocab"), (dict(adversarial_len=-1), "adversarial_len"),
                     (dict(adversarial_count=0), "adversarial_count")):
        with pytest.raises(ValueError, match=what):
            LoadGenConfig(**kw)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def _zero_arrival_trace(cls):
    """A loadgen trace with every arrival at 0: both classes, unmeetable
    interactive deadlines and lax batch ones, prompts past the chunk."""
    reqs = generate(LoadGenConfig(n_requests=6, seed=4, prompt_len=(3, 13), out_len=(3, 7),
                                  batch_frac=0.5, deadline_ms=0.001, batch_deadline_ms=6e5,
                                  vocab=256))
    return [cls(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                priority=r.priority, deadline_ms=r.deadline_ms) for r in reqs]


def _decode_logits(prompt, tokens, chunked):
    """The T=1 decode logits over ``tokens`` after ``prompt`` was admitted
    by bulk prefill or by chunks of 4 (width 8), in one slot."""
    import torch
    eng = _port(batch_slots=1)
    r, n = eng.runner, len(prompt)
    tables = np.arange(1, eng.scheduler.n_tables + 1, dtype=np.int32)[None]
    if chunked:
        for start in range(0, n, 4):
            take = min(4, n - start)
            toks = np.zeros((1, r.chunk_width(take)), np.int32)
            toks[0, :take] = prompt[start:start + take]
            r.prefill_chunk(toks, np.array([start], np.int32), tables,
                            np.array([take - 1], np.int32), np.zeros(1, np.float32))
    else:
        r.prefill_slot(0, prompt, pages=tables[0, :r.bucket_for(n) // 4])
    rows = []
    with torch.inference_mode():
        t_tables = torch.from_numpy(tables)
        for i, t in enumerate(tokens[:-1]):
            lg, r.cache = r.model.decode_paged(r.params, torch.tensor([[t]]), r.cache,
                                               torch.tensor([n + i]), t_tables)
            rows.append(lg[0, 0].float())
    return torch.stack(rows)


def _same_or_near_tie(prompt, want, got):
    """``got`` equals ``want`` or first parts from it at a near-tie: the
    plain path's top-2 margin there lies below the measured logit
    difference of chunked and bulk admission of ``prompt``."""
    import torch
    if got == want:
        return
    assert len(got) == len(want)
    i = next(j for j, (x, y) in enumerate(zip(want, got)) if x != y)
    diff = float((_decode_logits(prompt, want, True)
                  - _decode_logits(prompt, want, False)).abs().max())
    tm, tp = models()[2:]
    with torch.inference_mode():
        seq = torch.tensor([list(prompt) + want[:i]])
        top2 = torch.topk(tm.forward(tm.serving_params(tp), {"tokens": seq})[0][0, -1], 2)
    margin = float(top2.values[0] - top2.values[1])
    assert margin < diff, (i, margin, diff)


def test_chunked_fleet_matches_reference_and_bulk_admission():
    """The port's chunked fleet gives the reference fleet's tokens, order
    and counts exactly; bulk admission gives the plain scheduler's.  Chunked
    and bulk admission may part at a near-tie, in both packages: a chunk
    attends to its own K/V rows as the cache holds them (bf16), bulk prefill
    to the f32 rows.  Where they part, the plain path's top-2 margin lies
    below the measured logit difference of the two admissions."""
    import torch
    slo = {"prefill_chunk": 4, "step_token_budget": 12}
    je = _ref(slo=slo)
    te = _port(slo=slo)
    want = _tokens(je.run(_zero_arrival_trace(JRequest)))
    got = _tokens(te.run(_zero_arrival_trace(Request)))
    assert got == want
    assert list(te.scheduler.admissions) == list(je.scheduler.admissions)
    assert _counts(te.stats()["slo"]) == _counts(je.stats()["slo"])
    slo_t = te.stats()["slo"]
    assert slo_t["deadline_misses"] == slo_t["per_class"]["interactive"]["completed"] > 0
    assert slo_t["chunked_prefill"]["tokens"] == sum(
        len(r.prompt) for r in _zero_arrival_trace(Request))
    assert set(te.runner.chunk_widths) <= {8}
    bulk = _port(slo={"prefill_chunk": 0, "step_token_budget": 0})
    bulk_tokens = _tokens(bulk.run(_zero_arrival_trace(Request)))
    assert bulk.stats()["slo"]["chunked_prefill"]["calls"] == 0
    assert bulk_tokens == _tokens(_port().run(_zero_arrival_trace(Request)))
    assert bulk_tokens == _tokens(_ref(slo={"prefill_chunk": 0, "step_token_budget": 0})
                                  .run(_zero_arrival_trace(JRequest)))
    for r in _zero_arrival_trace(Request):
        _same_or_near_tie(r.prompt, bulk_tokens[r.uid], got[r.uid])


def _preempt_trace(cls, arrival=0.03):
    return [cls(uid="b0", prompt=np.arange(1, 6), max_new_tokens=24, priority="batch"),
            cls(uid="b1", prompt=np.arange(7, 14), max_new_tokens=20, priority="batch",
                deadline_ms=60.0),
            cls(uid="i0", prompt=np.array([5, 6, 7]), max_new_tokens=4,
                priority="interactive", deadline_ms=40.0, arrival_s=arrival)]


def test_preemption_on_a_virtual_clock_matches_reference():
    """An interactive arrival evicts a batch slot; the evicted request
    resumes by re-prefilling prompt + generated and ends with the tokens of
    its uninterrupted run.  With the clock counting rounds in both packages
    every SLO number agrees, latencies included."""
    slo = {"prefill_chunk": 4, "step_token_budget": 12}
    je, te = _ref(slo=slo), _port(slo=slo)
    _virtual_clock(je)
    _virtual_clock(te)
    want = _tokens(je.run(_preempt_trace(JRequest)))
    got = _tokens(te.run(_preempt_trace(Request)))
    assert got == want
    plain = _tokens(_port(batch_slots=3).run(_preempt_trace(Request)))
    for r in _preempt_trace(Request):
        _same_or_near_tie(r.prompt, plain[r.uid], got[r.uid])
    st_t, st_j = te.stats()["slo"], je.stats()["slo"]
    assert st_t == st_j
    assert st_t["preemptions"] >= 1 and st_t["resumes"] >= 1
    assert st_t["per_class"]["batch"]["preemptions"] >= 1
    assert list(te.scheduler.admissions) == list(je.scheduler.admissions)
    pages = te.page_allocator.stats()
    assert pages == je.page_allocator.stats()
    assert pages["used"] == 0 and pages["total_freed"] == pages["total_allocated"]
    assert pages["total_allocated"] > pages["high_water"]


@pytest.mark.parametrize("chunk", [0, 4], ids=["bulk", "chunked"])
def test_preempt_resume_token_identity(chunk):
    """The reference's case on the port, in bulk and chunked admission:
    one slot, so the interactive arrival must evict the batch request."""
    reqs = lambda: [  # noqa: E731
        Request(uid="long", prompt=np.arange(1, 5), max_new_tokens=40, priority="batch"),
        Request(uid="int", prompt=np.array([5, 6, 7]), max_new_tokens=4,
                priority="interactive", arrival_s=0.05)]
    want = _tokens(_port().run(reqs()))
    fleet = _port(batch_slots=1, slo={"prefill_chunk": chunk, "step_token_budget": 4})
    _virtual_clock(fleet)
    got = _tokens(fleet.run(reqs()))
    for r in reqs():
        _same_or_near_tie(r.prompt, want[r.uid], got[r.uid])
    slo = fleet.stats()["slo"]
    assert slo["preemptions"] >= 1 and slo["resumes"] >= 1


def test_prefix_cache_chunks_skip_shared_pages():
    """Chunked admission skips prefix-shared pages (the sharer's 2 shared
    pages never go through a chunk), as in the reference."""
    shared = np.arange(1, 9).astype(np.int32)

    def reqs(cls):
        return [cls(uid="holder", prompt=np.concatenate([shared, [20]]), max_new_tokens=30),
                cls(uid="filler", prompt=np.array([9, 8]), max_new_tokens=20),
                cls(uid="sharer", prompt=np.concatenate([shared, [21]]), max_new_tokens=5)]

    want = _tokens(_port(prefix_cache=True).run(reqs(Request)))
    je = _ref(prefix_cache=True, slo={"prefill_chunk": 4})
    te = _port(prefix_cache=True, slo={"prefill_chunk": 4})
    got = _tokens(te.run(reqs(Request)))
    assert _tokens(je.run(reqs(JRequest))) == got
    for r in reqs(Request):
        _same_or_near_tie(r.prompt, want[r.uid], got[r.uid])
    assert te.prefix_cache.hits == je.prefix_cache.hits >= 1
    total = sum(len(r.prompt) for r in reqs(Request))
    assert te.stats()["slo"]["chunked_prefill"] == je.stats()["slo"]["chunked_prefill"]
    assert te.stats()["slo"]["chunked_prefill"]["tokens"] == total - 8


# ---------------------------------------------------------------------------
# the port alone: the reference's cases
# ---------------------------------------------------------------------------


def test_bulk_mode_matches_base():
    want = _tokens(_port().run(_mixed(Request)))
    fleet = _port(slo={"prefill_chunk": 0, "step_token_budget": 0, "preempt": False})
    assert _tokens(fleet.run(_mixed(Request))) == want
    slo = fleet.stats()["slo"]
    assert slo["chunked_prefill"]["calls"] == 0
    assert slo["completed"] == 3 and slo["ttft_ms"]["n"] == 3


def test_chunk_commits_the_bulk_rows_and_leaves_other_slots_alone():
    """One (2, 8) chunk of a 6-token prompt in slot 0, slot 1's table row
    zeroed: the first token equals bulk prefill's, the K/V rows of the
    prompt equal bulk prefill's, and slot 1's pages are untouched."""
    import torch
    fleet = _port(slo={"prefill_chunk": 8})
    runner = fleet.runner
    prompt = np.array([11, 22, 33, 44, 55, 66], np.int32)
    base = _port()
    pages = np.array([1, 2], np.int32)
    first = base.runner.prefill_slot(0, prompt, pages=pages)
    for leaf in runner.cache.pool.values():
        leaf[:, 3:5] = 7.0                           # slot 1's pages, as a marker
    tables = np.zeros((2, fleet.scheduler.n_tables), np.int32)
    tables[0, :2] = [1, 2]
    toks = np.zeros((2, runner.chunk_width(6)), np.int32)
    toks[0, :6] = prompt
    tok = runner.prefill_chunk(toks, np.zeros(2, np.int32), tables,
                               np.array([5, 0], np.int32), np.zeros(2, np.float32))
    assert int(tok[0]) == first
    assert runner.chunk_widths == [8]
    for name, leaf in runner.cache.pool.items():
        want = base.runner.cache.pool[name]
        rows = leaf[:, 1:3].reshape(leaf.shape[0], 8, *leaf.shape[3:])[:, :6]
        rows_b = want[:, 1:3].reshape(want.shape[0], 8, *want.shape[3:])[:, :6]
        torch.testing.assert_close(rows.float(), rows_b.float(), rtol=1e-2, atol=1e-2)
        assert bool((leaf[:, 3:5] == 7.0).all())


def test_interactive_admits_before_batch():
    fleet = _port(batch_slots=1, slo={"prefill_chunk": 4})
    fleet.run([Request(uid="b", prompt=np.array([9, 8, 7]), max_new_tokens=4, priority="batch"),
               Request(uid="i", prompt=np.array([1, 2, 3]), max_new_tokens=4,
                       priority="interactive")])
    assert [uid for uid, _ in fleet.scheduler.admissions] == ["i", "b"]
    pc = fleet.stats()["slo"]["per_class"]
    assert pc["interactive"]["completed"] == 1 and pc["batch"]["completed"] == 1


def test_edf_within_priority_class():
    fleet = _port(batch_slots=1, slo={"prefill_chunk": 4})
    fleet.run([Request(uid="lax", prompt=np.array([1, 2, 3]), max_new_tokens=4,
                       deadline_ms=60_000.0),
               Request(uid="tight", prompt=np.array([4, 5, 6]), max_new_tokens=4,
                       deadline_ms=500.0)])
    assert [uid for uid, _ in fleet.scheduler.admissions] == ["tight", "lax"]


def test_deadline_misses_counted_per_class():
    fleet = _port(slo={"prefill_chunk": 4})
    fleet.run([Request(uid="doomed", prompt=np.array([1, 2, 3]), max_new_tokens=4,
                       deadline_ms=0.001),
               Request(uid="fine", prompt=np.array([4, 5, 6]), max_new_tokens=4,
                       deadline_ms=60_000.0, priority="batch")])
    slo = fleet.stats()["slo"]
    assert slo["completed"] == 2 and slo["deadline_misses"] == 1
    assert slo["per_class"]["interactive"]["deadline_misses"] == 1
    assert slo["per_class"]["batch"]["deadline_misses"] == 0


def test_default_priority_and_deadline_applied():
    fleet = _port(slo={"prefill_chunk": 4, "default_priority": "batch",
                       "default_deadline_ms": 0.001})
    fleet.run([Request(uid=0, prompt=np.array([1, 2, 3]), max_new_tokens=4)])
    pc = fleet.stats()["slo"]["per_class"]
    assert pc["batch"]["completed"] == 1 and pc["batch"]["deadline_misses"] == 1
    assert pc["interactive"]["completed"] == 0


def test_unknown_priority_rejected():
    fleet = _port(slo={"prefill_chunk": 4})
    with pytest.raises(ValueError, match="priority"):
        fleet.run([Request(uid=0, prompt=np.array([1, 2]), max_new_tokens=2,
                           priority="realtime")])


def test_slo_config_validation():
    for kw, what in ((dict(prefill_chunk=-1), "prefill_chunk"),
                     (dict(step_token_budget=-8), "step_token_budget"),
                     (dict(default_priority="urgent"), "default_priority"),
                     (dict(default_deadline_ms=0.0), "default_deadline_ms"),
                     (dict(window=1), "window")):
        with pytest.raises(ValueError, match=what):
            SLOConfig(**kw)


def test_fleet_requires_the_paged_cache():
    with pytest.raises(ValueError, match="paged"):
        _port(page_size=0, slo={"prefill_chunk": 4})


def test_stats_returns_deep_copied_snapshots():
    fleet = _port(slo={"prefill_chunk": 4})
    fleet.run(_mixed(Request))
    st = fleet.stats()
    st["pages"]["free"] = -999
    st["slo"]["per_class"]["interactive"]["completed"] = -999
    st["slo"]["chunked_prefill"]["calls"] = -999
    again = fleet.stats()
    assert again["pages"]["free"] != -999
    assert again["slo"]["per_class"]["interactive"]["completed"] != -999
    assert again["slo"]["chunked_prefill"]["calls"] != -999


def test_admission_log_rotates_and_counts_drops():
    fleet = _port(slo={"prefill_chunk": 4})
    fleet.scheduler.admissions = collections.deque(maxlen=2)
    fleet.run([Request(uid=i, prompt=np.array([1 + i, 2]), max_new_tokens=2)
               for i in range(5)])
    assert len(fleet.scheduler.admissions) == 2
    assert fleet.stats()["admissions_dropped"] == 3


def test_latency_windows_rotate_and_count_drops():
    fleet = _port(slo={"prefill_chunk": 4, "window": 2})
    fleet.run(_mixed(Request, n=4))
    slo = fleet.stats()["slo"]
    assert slo["window_dropped"] > 0
    assert slo["ttft_ms"]["n"] == 4
    assert slo["inter_token_ms"]["n"] > 2


def test_reset_slo_stats_zeroes_counters_and_windows():
    fleet = _port(slo={"prefill_chunk": 4})
    fleet.run(_mixed(Request))
    assert fleet.stats()["slo"]["completed"] == 3
    fleet.scheduler.reset_slo_stats()
    slo = fleet.stats()["slo"]
    assert slo["completed"] == 0 and slo["ttft_ms"]["n"] == 0
    assert slo["inter_token_ms"]["n"] == 0 and slo["window_dropped"] == 0
    assert len(fleet.run(_mixed(Request, n=1))) == 1


def _long_reqs():
    return [Request(uid=i, prompt=np.arange(1 + i, 12 + i), max_new_tokens=6)
            for i in range(4)]


@pytest.mark.parametrize("what", ["speculate", "zero_skip"])
def test_fleet_composes_with_speculate_and_zero_skip(what):
    """Chunked admission under speculation (the draft pool advances chunk
    for chunk) and under block zero-skip gives the port's bulk admission's
    tokens (the reference's own compositions are not the yardstick here:
    its tests of them do not pass on every CPU)."""
    tm = models()[2]
    _, tc = shared_codes()
    kw = (dict(speculate=True, draft_k=3) if what == "speculate"
          else dict(zero_skip="block"))
    mk = lambda slo: ServingEngine(tm, tc, device="cpu", forms=True, slo=slo,  # noqa: E731
                                   **{**COMMON, **kw})
    bulk = mk({"prefill_chunk": 0, "step_token_budget": 0})
    want = _tokens(bulk.run(_long_reqs()))
    fleet = mk({"prefill_chunk": 4, "step_token_budget": 16})
    assert _tokens(fleet.run(_long_reqs())) == want
    assert fleet.stats()["slo"]["chunked_prefill"]["calls"] > 0
    if what == "speculate":
        assert fleet.stats()["speculate"]["rounds"] > 0
        # the draft pool went through the same chunks as the target's
        assert fleet.runner.chunk_widths and set(fleet.runner.chunk_widths) <= {8, 16}


def test_loadgen_trace_serves_end_to_end():
    cfg = LoadGenConfig(n_requests=6, rate=300.0, seed=1, prompt_len=(2, 6), out_len=(2, 4),
                        deadline_ms=5000.0, vocab=64)
    fleet = _port(slo={"prefill_chunk": 4, "step_token_budget": 8})
    results = fleet.run(generate(cfg))
    assert {r.uid: len(r.tokens) for r in results} == \
        {r.uid: r.max_new_tokens for r in generate(cfg)}
    assert fleet.stats()["slo"]["completed"] == 6


def test_launcher_fleet_flags(capsys):
    tserve.main(["--reduced", "--device", "cpu", "--loadgen",
                 "n=6,rate=200,adversarial=20,out-hi=6", "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert "loadgen: 6 requests" in out and "slo: ttft p50" in out
    assert "slo[interactive]" in out and "slo[batch]" in out
    with pytest.raises(SystemExit, match="page-size 0"):
        tserve.main(["--reduced", "--device", "cpu", "--page-size", "0",
                     "--deadline-ms", "100"])
    with pytest.raises(SystemExit, match="prompt-len"):
        tserve.main(["--reduced", "--device", "cpu", "--loadgen", "n=2",
                     "--prompt-len", "4"])
    with pytest.raises(SystemExit, match="unknown key"):
        tserve.main(["--reduced", "--device", "cpu", "--loadgen", "n=2,burst=3"])
