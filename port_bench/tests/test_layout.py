"""The harness finds a cell's parts by name: a new cell, configuration,
traffic mix, per-layer metric and span need new files and entries only."""
import json
import shutil
import time

from port_bench.harness import spec as S
from port_bench.tests.tiny import tiny_cell

SPAN = '''"""Each page reservation of the scheduler's admission."""
TARGET = "repro_torch.serving.engine:Scheduler._reserve_pages"


def after(spans, out, *args, **kw):
    spans.counters["page_reservations"] += 1
'''

METRIC = '''"""Page reservations in the traced run's window."""
SPANS = ("reserve_pages",)


def read(m):
    return m.counters.get("page_reservations") or None
'''


def test_a_new_cell_needs_only_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(S.ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((S.ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "port_bench").rglob("*") if p.is_file()}

    pb = root / "port_bench"
    cfg = json.loads((pb / "configs" / "qwen2-1.5b.json").read_text())
    cfg["name"] = "other-model"
    (pb / "configs" / "other-model.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "longprompt.json").read_text())
    mix["prompt_len"] = [64, 512]
    (pb / "traffic" / "chat.json").write_text(json.dumps(mix))
    (pb / "limits" / "other-model.chat.json").write_text(
        json.dumps({"check": {"sample_requests": 4}, "served_logit_gap_max": 0.5}))
    (pb / "spans" / "reserve_pages.py").write_text(SPAN)
    (pb / "metrics" / "reservations.chat.py").write_text(METRIC)
    bench["configs"].append({"name": "other-model", "source": "x",
                             "file": "port_bench/configs/other-model.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "other-model.chat", "config": "other-model",
                               "traffic": "chat", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "serve_tok_s.chat", "unit": "tokens/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["other-model.chat"]})
    for name, reader in (("reservations.chat", "new"), ("attn_roofline.chat", "shared")):
        bench["per_layer"].append({"name": name, "unit": "%", "better": "higher",
                                   "source": "program_span", "layer": reader,
                                   "moves": "serve_tok_s.chat",
                                   "workloads": ["other-model.chat"]})

    cell = S.load_cell("other-model.chat", bench=bench, root=root)
    assert cell.traffic["prompt_len"] == [64, 512]
    assert cell.config["name"] == "other-model"
    assert cell.limits["served_logit_gap_max"] == 0.5
    assert [m["name"] for m in cell.per_layer] == ["reservations.chat", "attn_roofline.chat"]
    assert {m["name"] for m in cell.end_to_end} == {"serve_tok_s.chat", "peak_mem_gb",
                                                     "setup_s"}
    # the new metric reads its own span; a metric named <quantity>.<mix>
    # finds the quantity's reader
    assert cell.span_names() == ["reserve_pages", "attn_prefill", "attn_decode"]

    # a traced run of the new cell (tiny, on the CPU) installs the new span
    # and the new metric reads it
    tiny = tiny_cell("other-model.chat", model="qwen2-1.5b", bench=bench, root=root)
    drv = S.driver(tiny.traffic["driver"])
    m = drv.measure(tiny, 2 ** 31 + 11, 0.2, True, time.perf_counter(), device="cpu")
    assert m.correct, m.checks
    assert tiny.reader("reservations.chat").read(m) >= m.attempted - 6
    assert "pb.reserve_pages" in m.trace.range_device_s
    old = {p: p.read_bytes() for p in before}
    assert old == before                         # nothing that was there changed


def test_every_cell_of_the_benchmark_has_its_files():
    bench = json.loads((S.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = S.load_cell(w["name"])
        assert S.driver(cell.traffic["driver"]).measure
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert cell.reader(m["name"]).read
        assert {"setup_s", "peak_mem_gb"} <= {m["name"] for m in cell.end_to_end}
        for name in cell.span_names():
            assert (cell.bench_dir / "spans" / f"{name}.py").exists()
