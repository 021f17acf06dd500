"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy time and a
breakdown.  The run needs the CUDA cards its cell asks for, and judges the
outputs of its window against the plain reference (``correct``)."""
import time

T0 = time.perf_counter()      # set-up is counted from the process's start

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def report(cell, drv, m, trace: bool) -> dict:
    """The result line's keys from a driver's measurement."""
    from port_bench.harness import env, spec

    metrics = {}
    if trace:
        for d in cell.per_layer:
            v = cell.reader(d["name"]).read(m)
            if v is not None:
                metrics[d["name"]] = {"value": v, "unit": d["unit"]}
    else:
        values = drv.end_to_end(m)
        for d in cell.end_to_end:
            metrics[d["name"]] = {"value": values[spec.quantity(d["name"])],
                                  "unit": d["unit"]}
    peak = max(m.peak_setup or 0, m.peak_window or 0)
    busy = m.trace.busy_s if trace else None
    wall = m.trace.wall_s if trace else None
    out = {"correct": m.correct, "attempted": m.attempted, "failed": m.failed,
           "metrics": metrics, "device": env.device_block(cell.chips, peak, busy, wall)}
    if trace:
        out["breakdown"] = {"device_ops": [list(x) for x in m.trace.device_ops],
                            "idle_gaps": [list(x) for x in m.trace.idle_gaps]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from port_bench.harness import env
    cell, drv = env.open_cell(args.workload)
    m = drv.measure(cell, args.seed, args.seconds, bool(args.trace), T0)
    result = report(cell, drv, m, bool(args.trace))
    bad = env.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    env.emit(result, m.checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
