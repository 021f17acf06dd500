"""Finding a cell's parts by name: ``BENCHMARK.json`` names the cell's
configuration and traffic mix; each lives in a file of its own
(``configs/<config>.json``, ``traffic/<traffic>.json``), the mix names its
driver (``drivers/<driver>.py``), each per-layer metric has its reader
(``metrics/<metric>.py``), and the cell's correctness limits sit in
``limits/<cell>.json``.  Adding any of them adds files and edits none."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
from typing import Any, Dict, List, Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]          # configs/<config>.json
    traffic: Dict[str, Any]         # traffic/<traffic>.json
    limits: Dict[str, Any]          # limits/<cell>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: pathlib.Path = BENCH_DIR

    @property
    def port(self) -> Dict[str, Any]:
        """The program's model configuration fields."""
        return self.config["port"]

    def reader(self, name: str):
        return metric_reader(name, self.bench_dir)

    def span_names(self) -> List[str]:
        """The spans that the cell's per-layer metrics read, each once."""
        out: List[str] = []
        for m in self.per_layer:
            out += [s for s in getattr(self.reader(m["name"]), "SPANS", ()) if s not in out]
        return out


def _json(path: pathlib.Path) -> Dict[str, Any]:
    return json.loads(path.read_text())


def _applies(metric: Dict[str, Any], cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", None) is None or metric["moves"] in e2e_names


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None,
              root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench if bench is not None else _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, e2e_names)]
    bench_dir = root / BENCH_DIR.name
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(root / cfg["file"]),
                traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits=_json(bench_dir / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)


def driver(name: str):
    return importlib.import_module(f"port_bench.drivers.{name}")


def reference(config: Dict[str, Any]):
    return importlib.import_module(f"port_bench.reference.{config['reference']}")


def quantity(name: str) -> str:
    """What a metric named ``<quantity>.<cells>`` measures."""
    return name.split(".")[0]


def metric_reader(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """``metrics/<name>.py``, else ``metrics/<quantity>.py`` (names may
    hold dots, so loaded by path)."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.exists():
        path = bench_dir / "metrics" / f"{quantity(name)}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
