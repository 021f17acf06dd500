"""The harness end to end on the CPU at tiny sizes: it measures and judges,
and refuses to report device metrics (or anything) without a card."""
import ast
import json
import pathlib
import subprocess
import sys
import time

import pytest

from port_bench.harness import env
from port_bench.harness import spec as S
from port_bench.tests.tiny import tiny_cell

BENCH = S.BENCH_DIR


@pytest.mark.parametrize("name", ["qwen2-1.5b.longprompt", "olmoe-1b-7b.decode",
                                  "qwen2-1.5b.admm-train"])
def test_a_tiny_run_on_the_cpu_is_correct_and_reports_nothing(name):
    sys.path.insert(0, str(S.ROOT))
    import port_bench.run as R

    cell = tiny_cell(name)
    drv = S.driver(cell.traffic["driver"])
    m = drv.measure(cell, 2 ** 31 + 99, 0.3, True, time.perf_counter(), device="cpu")
    assert m.correct, m.checks
    assert m.failed == 0 and m.attempted > 0
    for d in cell.per_layer:
        v = cell.reader(d["name"]).read(m)
        assert v is None or v >= 0, d["name"]
    with pytest.raises(RuntimeError, match="come from a card"):
        R.report(cell, drv, m, True)


def test_the_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "qwen2-1.5b.longprompt", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=S.ROOT,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_command_refuses_with_only_the_benchmark_files(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(S.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "qwen2-1.5b.longprompt", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in env.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch.serving", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert env.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.serving", object())
    assert env.forbidden_modules() == ["repro"]


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_import_neither_jax_nor_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = [(p.name, m) for p in files for m in _imports(p)
           if m.split(".")[0] in env.FORBIDDEN]
    assert bad == []
    ref = [(p.name, m) for p in (BENCH / "reference").glob("*.py") for m in _imports(p)
           if m.split(".")[0] == "repro_torch"]
    assert ref == []


def test_a_run_loads_no_module_of_jax_or_the_jax_package():
    code = f"""
import sys, time, json
sys.path[:0] = [{str(S.ROOT)!r}, {str(S.ROOT / 'src')!r}]
import port_bench.run
from port_bench.harness import env, spec
from port_bench.tests.tiny import tiny_cell
for name in ("qwen2-1.5b.longprompt", "olmoe-1b-7b.decode", "qwen2-1.5b.admm-train"):
    cell = tiny_cell(name)
    for d in cell.per_layer:
        cell.reader(d["name"])
    spec.driver(cell.traffic["driver"]).measure(cell, 3, 0.1, False, time.perf_counter(),
                                                device="cpu")
print(json.dumps([env.forbidden_modules(), "repro_torch" in sys.modules]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=S.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], True]
