"""The trace reading and the per-layer metric readers on recorded events."""
import types

import pytest

from port_bench.harness import spec as S
from port_bench.harness import yardstick as Y
from port_bench.harness.spans import Spans
from port_bench.harness.trace import Events, merge, read

import numpy as np


# a prefill range with one polarized matmul inside it, a host sync, then a
# decode round; kernels by (correlation id, start, end, name), launched by
# the host call of the same correlation id (nanoseconds)
EVENTS = Events(
    kernels=[(9, 90, 95, "fill"),                   # the forms call's markers ...
             (1, 100, 220, "polarized_matmul_tc_kernel<64, true>"),   # no launch
             (8, 225, 230, "fill"),                 # ... around the ctypes kernel
             (2, 200, 300, "gemm"),                 # overlaps the first
             (3, 700, 750, "elementwise"),
             (4, 900, 950, "elementwise"),
             (5, 960, 970, "orphan")],              # no launch, in no call's span
    launches={9: 15, 8: 55, 2: 70, 3: 650, 4: 850},
    ranges=[("pb.prefill_slot", 0, 450), ("pb.forms_mm", 10, 60),
            ("pb.decode_round", 600, 1000)],
    ops=[(400, 520, "aten::item"), (600, 1000, "aten::stack")])


def test_merge_unions_overlaps():
    iv = np.array([[5, 7], [0, 2], [1, 3], [7, 8]], dtype=float)
    assert merge(iv).tolist() == [[0, 3], [5, 8]]


def test_read_busy_ranges_ops_and_gaps():
    r = read(EVENTS, wall_s=1e-6, ranges=("pb.prefill_slot", "pb.forms_mm",
                                          "pb.decode_round", "pb.moe"))
    # 90-95, 100-300, 700-750, 900-950, 960-970
    assert r.busy_s == pytest.approx(315e-9)
    assert r.idle_share == pytest.approx(0.685)
    # a kernel counts in every range whose call's device span holds it: the
    # ctypes kernel between the forms call's markers, the gemm in prefill
    # only; the orphan after the decode round's last launched kernel in none
    assert r.range_device_s == pytest.approx({"pb.prefill_slot": 230e-9,
                                              "pb.forms_mm": 130e-9,
                                              "pb.decode_round": 100e-9, "pb.moe": 0.0})
    assert r.device_ops[0] == ("polarized_matmul_tc_kernel<64, true>", pytest.approx(120e-9))
    labels = dict(r.idle_gaps)
    # 750-900 and 950-960 in the decode round
    assert labels["pb.decode_round (all gaps)"] == pytest.approx(160e-9)
    # 300-700: its middle (500) lies after prefill_slot ended (450)
    assert labels["host outside the runner (all gaps)"] == pytest.approx(400e-9)
    assert labels["gap under aten::item"] == pytest.approx(400e-9)


def _measurement(cell_name, **kw):
    cell = S.load_cell(cell_name)
    base = dict(cell=cell, host_s={}, counters={}, trace=None, spans=Spans(), window_s=10.0,
                served=[])
    base.update(kw)
    return types.SimpleNamespace(**base)


def reader(name):
    return S.metric_reader(name).read


def test_host_span_readers():
    m = _measurement("qwen2-1.5b.longprompt",
                     host_s={"pb.prefill_slot": 4.0, "pb.decode_round": 5.0},
                     counters={"prefill_tokens": 8000, "decode_steps": 100})
    assert reader("sched_host_share.longprompt")(m) == pytest.approx(10.0)
    assert reader("prefill_ms_per_ktok.longprompt")(m) == pytest.approx(500.0)
    assert reader("decode_step_ms.longprompt")(m) == pytest.approx(50.0)
    empty = _measurement("qwen2-1.5b.longprompt")
    for name in ("sched_host_share.longprompt", "prefill_ms_per_ktok.longprompt",
                 "decode_step_ms.longprompt", "attn_roofline.longprompt",
                 "idle_share.longprompt"):
        assert reader(name)(empty) is None


def test_roofline_readers_on_recorded_work():
    sp = Spans()
    with sp.record():
        sp._work["pb.forms_mm"].append(Y.forms_mm_work(4096, 1536, 8960, 2, 1, 8))
        sp._work["pb.attn_prefill"].append(Y.causal_attention_work(1, 4096, 12, 2, 128))
    f, b = Y.forms_mm_work(4096, 1536, 8960, 2, 1, 8)
    ideal = Y.ideal_s(f, b)
    trace = types.SimpleNamespace(range_device_s={"pb.forms_mm": 2 * ideal,
                                                  "pb.attn_prefill": 1e-3,
                                                  "pb.attn_decode": 0.0},
                                  wall_s=1.0, idle_share=0.25)
    m = _measurement("qwen2-1.5b.longprompt", spans=sp, trace=trace)
    assert reader("forms_mm_roofline.longprompt")(m) == pytest.approx(50.0)
    fa, ba = Y.causal_attention_work(1, 4096, 12, 2, 128)
    assert reader("attn_roofline.longprompt")(m) == pytest.approx(100 * Y.ideal_s(fa, ba) / 1e-3)
    assert reader("moe_roofline.decode")(m) is None      # no MoE work recorded
    assert reader("idle_share.longprompt")(m) == pytest.approx(25.0)


def test_mfu_readers():
    m = _measurement("qwen2-1.5b.longprompt", served=[(2048, 32)] * 10, window_s=2.0)
    want = 100 * Y.serve_model_flops(m.cell.port, m.served) / 2.0 / Y.PEAK_FLOPS
    assert reader("mfu.longprompt")(m) == pytest.approx(want)
    t = _measurement("qwen2-1.5b.admm-train", steps=5, window_s=10.0,
                     counters={"z_updates": 2}, host_s={"pb.z_update": 0.1})
    want = 100 * 5 * Y.train_model_flops(t.cell.port, 4, 4096) / 10.0 / Y.PEAK_FLOPS
    assert reader("mfu.train")(t) == pytest.approx(want)
    assert reader("z_update_ms.train")(t) == pytest.approx(50.0)
