"""Render a dry-run artifact directory as markdown tables.

  python -m repro_torch.analysis.report <dir>

Cells that are not ``ok`` are skipped, as the JAX package's report skips
them; ``summary_stats`` also lists the cells over the card's HBM.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List


def load_artifacts(out_dir: str) -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def markdown_table(rows: List[Dict], mesh: str = "single") -> str:
    header = ("| arch | shape | kind | compute (ms) | memory (ms) | "
              "collective (ms) | bottleneck | step (ms) | MFU | useful "
              "| HBM/chip (GiB) |\n"
              "|---|---|---|---:|---:|---:|---|---:|---:|---:|---:|\n")
    lines = [header]
    for d in rows:
        if d.get("mesh") != mesh or d.get("status") != "ok":
            continue
        r = d["roofline"]
        mem = d.get("memory_analysis", {})
        hbm = (float(mem.get("argument_size") or 0)
               + float(mem.get("temp_size") or 0)) / 2**30
        lines.append(
            f"| {d['arch']} | {d['shape']} | {d['kind']} "
            f"| {r['compute_s']*1e3:.1f} | {r['memory_s']*1e3:.1f} "
            f"| {r['collective_s']*1e3:.1f} | {r['bottleneck']} "
            f"| {r['step_time_s']*1e3:.1f} | {r['mfu']*100:.1f}% "
            f"| {r['useful_flops_fraction']*100:.0f}% | {hbm:.1f} |\n")
    return "".join(lines)


def summary_stats(rows: List[Dict], mesh: str = "single") -> Dict:
    ok = [d for d in rows if d.get("mesh") == mesh and d.get("status") == "ok"]
    bn: Dict[str, int] = {}
    for d in ok:
        bn[d["roofline"]["bottleneck"]] = bn.get(d["roofline"]["bottleneck"], 0) + 1
    return {"cells": len(ok), "bottlenecks": bn,
            "total_compile_s": sum(d["compile_s"] for d in ok),
            "over_hbm": sorted(f"{d['arch']} x {d['shape']}" for d in ok
                               if d.get("memory_analysis", {}).get("fits_hbm") is False)}


if __name__ == "__main__":
    import sys
    out = sys.argv[1] if len(sys.argv) > 1 else "artifacts/dryrun_final"
    rows = load_artifacts(out)
    for mesh in ("single", "multi"):
        print(f"\n## mesh = {mesh}\n")
        print(markdown_table(rows, mesh))
        print(summary_stats(rows, mesh))
