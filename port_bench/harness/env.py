"""The run's environment and its result line.

Caches stay inside the checkout at fixed paths (the kernels' nvcc builds
already go to ``build/repro_torch_kernels``, a path the program fixes
there); a run needs the cards its cell asks for and refuses to report
otherwise; no module of JAX or of the JAX package may be loaded when the
result is printed."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional

from port_bench.harness import spec
from port_bench.harness.spec import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare() -> None:
    """Fixed cache directories inside the checkout, for every library the
    run could compile with."""
    build = ROOT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton_cache"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(build / sub))
    os.environ.setdefault("USE_FLAX", "0")


def require_cuda(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card and reports "
                         "nothing without one")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} present")


def open_cell(name: str):
    """The entry's set-up: cache directories, the cell ``name`` with its
    driver, and the cards it needs (the card is named on standard
    error)."""
    prepare()
    cell = spec.load_cell(name)
    require_cuda(cell.chips)
    print(f"card: {card()}", file=sys.stderr, flush=True)
    return cell, spec.driver(cell.traffic["driver"])


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_block(chips: int, memory_peak_bytes: int,
                 busy_s: Optional[float] = None, window_s: Optional[float] = None
                 ) -> Dict[str, Any]:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("device metrics come from a card; this run has none")
    out: Dict[str, Any] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                           "count": chips, "memory_peak_bytes": int(memory_peak_bytes)}
    if busy_s is not None:
        out["busy_s"] = busy_s
        out["window_s"] = window_s
    return out


def emit(result: Dict[str, Any], checks: List[Dict[str, Any]]) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, and the result as the last line of standard output
    with the checks under the last key."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    print(json.dumps(line, allow_nan=False), flush=True)
