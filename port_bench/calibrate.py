"""Readings for a cell's correctness limits: the program's compared numbers
and the control's (the reference in the precision below the served one),
or a planted fault's, on several seeds in one process, each seed a whole
set-up and a short window.  Prints one JSON line per seed.

    python3 port_bench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 8

``tests/test_control.py`` reads the control through :func:`readings`."""
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def readings(cell, seeds, seconds, precisions=("f32", "fp8"), device="cuda"):
    """For each seed, (the driver's measurement, its JSON line)."""
    import torch

    from port_bench.harness import spec

    drv = spec.driver(cell.traffic["driver"])
    for seed in seeds:
        t0 = time.perf_counter()
        m = drv.measure(cell, seed, seconds, False, t0, device=device,
                        precisions=tuple(precisions))
        line = {"workload": cell.name, "seed": seed, "readings": m.readings,
                "checks": m.checks, "attempted": m.attempted, "failed": m.failed,
                "e2e": drv.end_to_end(m) if m.peak_window is not None else None,
                "total_s": time.perf_counter() - t0}
        yield m, line
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--precisions", default="f32,fp8",
                    help="f32 (the program), fp8 (the control), half (a planted fault)")
    args = ap.parse_args(argv)

    from port_bench.harness import env
    cell, _ = env.open_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    for _, line in readings(cell, seeds, args.seconds, args.precisions.split(",")):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
