"""The port's tracer (``repro_torch.obs``) on tiny engines on the CPU:
spans off by default and leaving the tokens alone, exact parent links and
self times, the counters of a run against what the run did, spans on the
profiler's clock, the MoE rebuild's bytes, the per-request stamps on both
schedulers, and the Chrome export."""
import functools
import json
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_reduced
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.serving.engine import Request, ServingEngine

SLOTS, BLOCK = 2, 4


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every case starts and ends with spans off and none recorded."""
    obs.disable()
    obs.drain()
    yield
    obs.disable()
    obs.drain()


@pytest.fixture(scope="module")
def qwen():
    cfg = get_reduced("qwen2-1.5b")
    model = registry.build(cfg, device="cpu")
    return model, model.init(0)


def _engine(model, params, **kw):
    return ServingEngine(model, params, device="cpu", forms=True, max_len=64,
                         batch_slots=SLOTS, page_size=8, decode_block=BLOCK, **kw)


def _requests(n=4, new=6, vocab=50):
    return [Request(uid=i, prompt=(np.arange(3 + 5 * i) * 7 + i) % vocab, max_new_tokens=new)
            for i in range(n)]


@obs.spanned("rt.e")
def recurse(n):                                         # one span, however deep
    return recurse(n - 1) if n else 0


def test_spans_are_off_by_default_and_leave_the_tokens_alone(qwen):
    off = _engine(*qwen).run(_requests())
    spans, _ = obs.drain()
    assert spans == [] and obs.span("rt.x") is obs.span("rt.y")    # the shared null context
    obs.enable()
    on = _engine(*qwen).run(_requests())
    obs.disable()
    spans, _ = obs.drain()
    assert {s.name for s in spans} >= {"rt.sched.run", "rt.sched.admit", "rt.runner.prefill",
                                       "rt.runner.decode_round", "rt.runner.host_read",
                                       "rt.forms.mm", "rt.attn.prefill", "rt.attn.decode",
                                       "rt.kv.gather", "rt.sched.release"}
    assert [(r.uid, r.tokens) for r in on] == [(r.uid, r.tokens) for r in off]


def test_spanned_functions_are_wrapped_only_while_spans_are_on(monkeypatch):
    """Off, a spanned function is itself (no wrapper to pay for); on, a
    wrapper stands in its module or class, around any wrapper another tool
    put there, and off again the attribute holds what it held."""
    plain, run, spanned = ops.polarized_matmul, ServingEngine.run, recurse
    calls = []

    @functools.wraps(spanned)
    def foreign(n):
        calls.append(n)
        return spanned(n)

    mod = sys.modules[__name__]
    monkeypatch.setattr(mod, "recurse", foreign)
    obs.enable()
    assert ops.polarized_matmul is not plain and ops.polarized_matmul.__wrapped__ is plain
    assert mod.recurse.__wrapped__ is foreign and ServingEngine.run is run   # not spanned
    mod.recurse(2)
    obs.disable()
    assert ops.polarized_matmul is plain and mod.recurse is foreign
    spans, _ = obs.drain()
    assert [(s.name, s.parent) for s in spans] == [("rt.e", -1)] and calls == [2, 1, 0]


def test_parent_links_self_times_and_ids_are_exact(monkeypatch):
    clock = iter(range(0, 10_000, 10))                  # every read 10 ns later
    monkeypatch.setattr(obs.time, "perf_counter_ns", lambda: next(clock))

    obs.enable()                                        # anchor read at 0
    with obs.span("rt.a", uid=7):                       # 10 .. 80
        with obs.span("rt.b"):                          # 20 .. 50
            with obs.span("rt.c"):                      # 30 .. 40
                pass
        with obs.span("rt.b"):                          # 60 .. 70
            pass
    with obs.span("rt.d"):                              # 90 .. 120
        recurse(3)                                      # 100 .. 110, inside rt.d
    ns = {k: (round(t * 1e9), round(own * 1e9)) for k, (t, own) in obs.self_times().items()}
    assert ns == {"rt.a": (70, 30), "rt.b": (40, 30), "rt.c": (10, 10), "rt.d": (30, 20),
                  "rt.e": (10, 10)}
    spans, _ = obs.drain()
    assert [(s.name, s.parent) for s in spans] == [("rt.a", -1), ("rt.b", 0), ("rt.c", 1),
                                                  ("rt.b", 0), ("rt.d", -1), ("rt.e", 4)]
    # the request's id reaches every span under its span; the others have none
    assert [s.attrs for s in spans] == [{"uid": 7}] * 4 + [{}, {}]
    epoch0 = spans[0].start_ns - 10                     # the anchor's epoch time
    assert [(s.start_ns - epoch0, s.end_ns - epoch0) for s in spans] == [
        (10, 80), (20, 50), (30, 40), (60, 70), (90, 120), (100, 110)]
    assert obs.self_times() == {}


def test_counters_of_a_run_are_what_it_did(qwen):
    eng = _engine(*qwen)
    reqs = _requests()
    before = obs.counters()
    obs.enable()
    results = eng.run(reqs)
    obs.disable()
    spans, after = obs.drain()
    got = {k: v - before.get(k, 0) for k, v in after.items()}
    rounds = eng.stats()["rounds"]
    assert rounds > 0
    assert got["decode.steps"] == rounds * BLOCK
    assert got["prefill.tokens"] == sum(len(r.prompt) for r in reqs)
    assert got["prefill.rows"] == sum(eng.runner.bucket_for(len(r.prompt)) for r in reqs)
    assert got["prefill.rows"] > got["prefill.tokens"]
    assert len(results) == len(reqs)
    # each round's span carries the scheduler's round number, and the run's
    # host reads are spans: one ending each round, one each prefill
    assert [s.attrs["round"] for s in spans
            if s.name == "rt.runner.decode_round"] == list(range(rounds))
    reads = [spans[s.parent].name for s in spans if s.name == "rt.runner.host_read"]
    assert sorted(reads) == (["rt.runner.decode_round"] * rounds
                             + ["rt.runner.prefill"] * len(reqs))
    # the kernels' launch counts, read from their wrappers (the plain
    # versions run on the CPU and launch nothing)
    assert got["kernel.polarized_matmul"] == 0 and "kernel.admm_polarize" in got


def test_spans_lie_within_a_millisecond_of_the_profilers_ranges(qwen):
    """Each span's edges are read just before the profiler's range opens
    and closes, so every span starts and ends at most a little before its
    range.  Where the OS takes the CPU from the thread between the two
    reads (a loaded box: 4-24 ms, whole scheduler ticks, measured), that
    pause adds to the distance, so 95% of the spans are held to 1 ms and
    at most 1% (at least one) may lie farther."""
    eng = _engine(*qwen)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("warm-up"):
                pass
            eng.run(_requests(n=3, new=5))
    finally:
        obs.disable()
        torch.set_num_threads(threads)
    spans, _ = obs.drain()
    ranges = {}
    for e in sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns()):
        if e.name().startswith("rt."):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    assert len(spans) > 50
    # the same spans, one each
    assert sorted(s.name for s in spans) == sorted(n for n, r in ranges.items() for _ in r)
    far = []
    for s in sorted(spans, key=lambda s: s.start_ns):     # the i-th span of a name is
        start, end = ranges[s.name].pop(0)                 # the i-th range of the name
        assert start - s.start_ns > -50_000 and end - s.end_ns > -50_000, s
        assert s.end_ns > start, s
        far.append(max(start - s.start_ns, end - s.end_ns))
    assert np.median(far) < 1e5 and np.quantile(far, 0.95) < 1e6, sorted(far)[-8:]
    assert sum(f > 1e6 for f in far) <= max(1, len(far) // 100), sorted(far)[-8:]


def test_moe_rebuild_bytes_are_the_reckoned_expert_bytes():
    cfg = get_reduced("olmoe-1b-7b")
    model = registry.build(cfg, device="cpu")
    eng = _engine(model, model.init(0))
    reqs = _requests(n=3, new=5)
    before = obs.counters()
    eng.run(reqs)
    got = {k: v - before.get(k, 0) for k, v in obs.counters().items()}
    calls = len(reqs) + got["decode.steps"]         # exact-length prefills + decode steps
    per_call = (cfg.num_layers * 3 * cfg.num_experts * cfg.d_model * cfg.moe_d_ff
                * L.DTYPES[cfg.dtype].itemsize)
    assert got["moe.rebuild_bytes"] == per_call * calls
    assert got["prefill.rows"] == got["prefill.tokens"]


@pytest.mark.parametrize("fleet", [False, True], ids=["plain", "fleet"])
def test_time_to_first_token_and_latency_on_both_schedulers(qwen, fleet):
    slo = {"prefill_chunk": 8, "step_token_budget": 32} if fleet else None
    eng = _engine(*qwen, slo=slo)
    t0 = time.perf_counter()
    results = eng.run(_requests())
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert len(results) == 4
    for r in results:
        assert 0 < r.ttft_ms <= r.latency_ms <= wall_ms, r
        assert r.prefill_ms > 0 and not hasattr(r, "decode_ms")
    if fleet:      # the fleet's TTFT window holds the same stamps
        assert sorted(eng.scheduler._ttft["interactive"].samples) == sorted(
            r.ttft_ms for r in results)


def test_write_chrome_gives_json_on_the_epoch_clock(qwen, tmp_path):
    obs.enable()
    _engine(*qwen).run(_requests(n=2, new=3))
    obs.disable()
    path = tmp_path / "trace.json"
    n = obs.write_chrome(str(path))
    doc = json.loads(path.read_text())
    ev = doc["traceEvents"]
    assert n == len(ev) > 10 and obs.drain()[0] == []
    now_us = time.time_ns() / 1e3
    assert all(now_us - 600e6 < e["ts"] <= now_us and e["dur"] >= 0 and e["ph"] == "X"
               for e in ev)
    top = [e for e in ev if e["name"] == "rt.sched.run"]
    assert len(top) == 1 and top[0]["args"]["parent"] == -1
    assert doc["counters"]["decode.steps"] > 0
