"""Time the port's ReRAM fault injector on the host, where its time goes.

The injector (``repro_torch.reliability.faults``) is host numpy: it draws
the reference's random numbers in the reference's order (sequential per
leaf) and does its float64 arithmetic on a thread pool.  This script
times, on the machine it runs on:

1. the numpy operations of the walk, per element, on one chunk
   (``CHUNK_CELLS`` float64 values), on one thread and on as many threads
   as the pool has: ``standard_normal(out=)``, ``random(out=)``, ``exp``,
   an in-place multiply, ``clip`` and the plane sum (``tensordot`` of 4
   planes);
2. ``inject_leaf`` on one stacked MLP leaf of full-width qwen2-1.5b
   (28 x 1536 x 8960 uint8 codes, 1.54 G cells) at zero noise and at
   sigma = 0.1, binary;
3. ``inject_tree`` on all 7 of qwen2-1.5b's stacked leaves (5.24 G cells)
   at zero noise and at sigma = 0.1, binary, with the host's peak RSS.

The codes are random (seed 0); the leaves live on the CPU, so no card is
needed, and the numbers describe the host the command runs on.  About 45
GB of host memory at the peak.

    PYTHONPATH=src python tools/time_fault_injection.py [--skip-tree]

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import resource
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.forms import FormsLinearParams  # noqa: E402
from repro_torch.reliability import faults as F  # noqa: E402

# qwen2-1.5b's stacked leaves: (L, K, N)
LEAVES = {"blocks/attn/wk": (28, 1536, 256), "blocks/attn/wo": (28, 1536, 1536),
          "blocks/attn/wq": (28, 1536, 1536), "blocks/attn/wv": (28, 1536, 256),
          "blocks/mlp/down": (28, 8960, 1536), "blocks/mlp/gate": (28, 1536, 8960),
          "blocks/mlp/up": (28, 1536, 8960)}


def per_element_ns(fn, n: int, threads: int, reps: int = 5) -> float:
    """Wall ns per element of ``fn(i)`` run ``reps`` times on each of
    ``threads`` threads at once (each on its own arrays)."""
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        list(pool.map(fn, range(threads)))
        t = time.perf_counter()
        for _ in range(reps):
            list(pool.map(fn, range(threads)))
        return (time.perf_counter() - t) / (reps * threads * n) * 1e9


def op_table(threads: int) -> dict:
    n = F.CHUNK_CELLS
    rngs = [np.random.default_rng(i) for i in range(threads)]
    a = [np.random.default_rng(100 + i).random(n) * 3 for i in range(threads)]
    b = [np.empty(n) for _ in range(threads)]
    planes = [np.random.default_rng(200 + i).random((4, n // 4)) * 3 for i in range(threads)]
    w = np.array([1.0, 4.0, 16.0, 64.0])
    ops = {
        "standard_normal": lambda i: rngs[i].standard_normal(out=b[i]),
        "random": lambda i: rngs[i].random(out=b[i]),
        "exp": lambda i: np.exp(a[i], out=b[i]),
        "multiply": lambda i: np.multiply(a[i], 1.0001, out=b[i]),
        "clip": lambda i: np.clip(a[i], 0.0, 3.0, out=b[i]),
        "tensordot_4_planes": lambda i: np.tensordot(w, planes[i], axes=1),
    }
    return {name: {"1_thread": per_element_ns(fn, n, 1),
                   f"{threads}_threads": per_element_ns(fn, n, threads)}
            for name, fn in ops.items()}


def leaf(shape, seed: int) -> FormsLinearParams:
    rng = np.random.default_rng(seed)
    L, K, N = shape
    return FormsLinearParams(
        mags=torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)),
        signs=torch.ones((L, K // 8, N), dtype=torch.int8),
        scale=torch.ones((L, 1, N)), k=K, m=8)


def timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-tree", action="store_true",
                    help="time the operations and one leaf only")
    args = ap.parse_args()
    threads = max(1, os.cpu_count() or 1)
    out = {"cpus": threads, "numpy": np.__version__, "chunk_cells": F.CHUNK_CELLS,
           "ns_per_element": op_table(threads)}
    up = leaf(LEAVES["blocks/mlp/up"], 0)
    for name, fault in (("zero", F.FaultModel()), ("sigma", F.FaultModel(sigma=0.1))):
        (_, st), sec = timed(lambda: F.inject_leaf(up, fault, "blocks/mlp/up"))
        out[f"leaf_{name}_s"] = sec
        out[f"leaf_{name}_ns_per_cell"] = sec / st.cells * 1e9
    del up
    if not args.skip_tree:
        tree = {"blocks": {}}
        for i, (path, shape) in enumerate(LEAVES.items()):
            _, group, name = path.split("/")
            tree["blocks"].setdefault(group, {})[name] = leaf(shape, i)
        for name, fault in (("zero", F.FaultModel()), ("sigma", F.FaultModel(sigma=0.1))):
            (_, rep), sec = timed(lambda: F.inject_tree(tree, fault))
            out[f"tree_{name}_s"] = sec
            out[f"tree_cells"] = sum(s.cells for s in rep.leaves.values())
    out["host_peak_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
