"""The program's own spans and counters (``spans/program.py``, one traced
call after the window) and the per-layer metrics that read them: a tiny
traced run of each serving cell on the CPU reads a number for each while
its window runs with the tracer off, and a program without the tracer adds
nothing."""
import time
import types

import pytest

from port_bench.harness import spec as S
from port_bench.harness.spans import Spans, span_module
from port_bench.tests.tiny import tiny_cell

NEW = {"qwen2-1.5b.longprompt": ("decode_host_ms.longprompt", "sched_self_share.longprompt",
                                 "prefill_pad_share.longprompt"),
       "olmoe-1b-7b.decode": ("decode_host_ms.decode", "sched_self_share.decode",
                              "moe_rebuild_gb_per_call.decode")}


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_tiny_traced_run_reads_each_new_metric(name):
    cell = tiny_cell(name)
    assert set(NEW[name]) <= {m["name"] for m in cell.per_layer}
    assert "program" in cell.span_names()
    drv = S.driver(cell.traffic["driver"])
    m = drv.measure(cell, 2 ** 31 + 57, 0.3, True, time.perf_counter(), device="cpu")
    assert m.correct, m.checks
    got = {n: cell.reader(n).read(m) for n in NEW[name]}
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
    # the window ran with the tracer off: its copies hold no program span or
    # counter; one call ran with it on, after the window
    assert not any(k.startswith("rt.") for k in m.host_s) and "decode.steps" not in m.counters
    assert m.spans.counters["calls.rt.sched.run"] == 1 and "last_batch" not in m.spans.state
    # the program's spans sit around the benchmark's own wrappers of the same calls
    assert all(m.spans.counters[f"calls.rt.{n}"] > 0
               for n in ("runner.prefill", "forms.mm", "attn.decode"))
    mix = name.rsplit(".", 1)[1]
    # the issuing is a part of the round; on the CPU a host read waits for
    # nothing, so it is nearly all of it
    round_ms = 1e3 * m.spans.host_s["rt.runner.decode_round"] / m.spans.counters["decode.steps"]
    assert 0.5 * round_ms < got[f"decode_host_ms.{mix}"] <= round_ms
    assert got[f"sched_self_share.{mix}"] < 100
    if mix == "longprompt":
        assert 0 < got["prefill_pad_share.longprompt"] < 100     # prompts padded to buckets
    else:
        assert got["moe_rebuild_gb_per_call.decode"] > 0


def test_the_readers_on_recorded_spans_and_counters():
    cell = S.load_cell("qwen2-1.5b.longprompt")
    spans = types.SimpleNamespace(
        host_s={"rt.runner.decode_round": 3.0,
                "rt.runner.decode_round/rt.runner.host_read": 2.0,
                "rt.sched.run": 10.0, "rt.sched.run.self": 0.5, "rt.sched.admit.self": 0.25,
                "rt.runner.prefill.self": 9.0},
        counters={"decode.steps": 100, "prefill.tokens": 750, "prefill.rows": 1000,
                  "calls.rt.runner.prefill": 4, "moe.rebuild_bytes": 208e9})
    m = types.SimpleNamespace(cell=cell, window_s=30.0, host_s={}, counters={}, spans=spans)
    read = {n: S.metric_reader(n).read for n in ("decode_host_ms.x", "sched_self_share.x",
                                                 "prefill_pad_share.x",
                                                 "moe_rebuild_gb_per_call.x")}
    assert read["decode_host_ms.x"](m) == pytest.approx(10.0)
    assert read["sched_self_share.x"](m) == pytest.approx(7.5)
    assert read["prefill_pad_share.x"](m) == pytest.approx(25.0)
    assert read["moe_rebuild_gb_per_call.x"](m) == pytest.approx(2.0)
    untraced = types.SimpleNamespace(cell=cell, window_s=30.0, host_s={}, counters={},
                                     spans=None)
    empty = types.SimpleNamespace(cell=cell, window_s=30.0, host_s={}, counters={},
                                  spans=types.SimpleNamespace(host_s={}, counters={}))
    assert all(r(untraced) is None and r(empty) is None for r in read.values())


class _Engine:
    def run(self, requests):
        raise AssertionError("served")


def test_a_program_without_the_tracer_adds_nothing(monkeypatch):
    last = span_module("last_batch", S.BENCH_DIR)
    mod = span_module("program", S.BENCH_DIR)
    monkeypatch.setattr(mod, "_obs", lambda: None)
    sp = Spans()
    engine = _Engine()
    with sp.record():                           # the profiled call leaves nothing
        last.before(sp, engine, [])
    assert sp.state == {}
    last.before(sp, engine, [])
    assert sp.state["last_batch"][0]() is engine      # held weakly
    mod.before(sp, sp)
    assert dict(sp.host_s) == {} and dict(sp.counters) == {} and sp.state == {}
