"""Time the polarized matmul of a checkout at qwen2-1.5b's projection
shapes, so two commits can be compared on one card.

At M=4 (the slice's four serving slots) and each of the layer's four
projection shapes (1536x1536, 1536x256, 1536x8960, 8960x1536; uint8 codes,
m=8), it times ``repro_torch.kernels.polarized_matmul.polarized_matmul`` on
f32 x and on bf16 x (the route the served decode takes: whatever the
checkout does with bf16 x is part of the time), and
``polarized_matmul_skip`` on both with every other 256-row K slice of x
zero.  Each time is the median CUDA-event time of 30 calls, the L2 flushed
before each; the inputs come from a seeded generator, so two checkouts get
the same operands.  Each result is first held to the plain version (within
1e-4 of its largest entry) and each skip result equal to the dense one bit
for bit.  ``--root`` names the checkout whose ``src/`` is imported (by
default the one holding this script).  Needs one CUDA card.

``--rows`` takes other M (comma-separated; default 4, the above).  At any
other M it times the tensor-core kernel on bf16 x, called directly
(``polarized_matmul_tc``, and ``polarized_matmul_tc_skip`` with every other
K slice dead: ``tc``, ``tc_skip50``), the route on bf16 x (``bf16``:
whichever kernel the checkout picks at that M), each held as above, and
one bf16 ``torch.matmul`` with the pre-folded weight (``library``), a
yardstick timed and not held (it rounds its output to bf16).

    python tools/time_decode_matmul.py --root /path/to/other/checkout
    python tools/time_decode_matmul.py --rows 16,20,32,64

Prints one JSON line per M: the card, the root, per shape the milliseconds
of each case, and their sums per layer (1536x1536 and 1536x256 twice, the
other two as the layer calls them: 2 and 1).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

# (K, N) -> calls per qwen2-1.5b layer
SHAPES = {(1536, 1536): 2, (1536, 256): 2, (1536, 8960): 2, (8960, 1536): 1}
REPS = 30


def timed_ms(fn, flush) -> float:
    """Median CUDA-event time of ``fn``, the L2 flushed before each call and
    a spin kernel queued ahead, so the interval holds device time only."""
    import torch
    fn()
    times = []
    for _ in range(REPS):
        flush()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cases(M, x, mags, signs, pm):
    """(name, function, x, dense) of each timed case at M: the decode cases
    at M = 4, the tensor-core ones at any other M; ``dense`` is the function
    a skip case must equal bit for bit, else None."""
    import torch
    half = x.clone()
    for k in range(1, -(-x.shape[1] // 256), 2):
        half[:, k * 256:(k + 1) * 256] = 0.0
    xb, hb = x.to(torch.bfloat16), half.to(torch.bfloat16)
    if M == 4:
        return [("f32", pm.polarized_matmul, x, None), ("bf16", pm.polarized_matmul, xb, None),
                ("f32_skip50", pm.polarized_matmul_skip, half, pm.polarized_matmul),
                ("bf16_skip50", pm.polarized_matmul_skip, hb, pm.polarized_matmul)]
    # exact in bf16: codes <= 255 and signs +-1
    w = (mags.float() * signs.float().repeat_interleave(8, dim=0)).to(torch.bfloat16)
    return [("tc", pm.polarized_matmul_tc, xb, None),
            ("tc_skip50", pm.polarized_matmul_tc_skip, hb, pm.polarized_matmul_tc),
            ("bf16", pm.polarized_matmul, xb, None),
            ("library", lambda a, _m, _s, sc, _k: torch.matmul(a, w) * sc, xb, None)]


def time_rows(M, pm, plain, flush):
    """Every case of M at every shape, each held to the plain version first."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = []
    for (K, N) in SHAPES:
        x = torch.randn((M, K), generator=gen, device="cuda")
        mags = torch.randint(0, 256, (K, N), generator=gen, device="cuda").to(torch.uint8)
        signs = (torch.randint(0, 2, (K // 8, N), generator=gen, device="cuda") * 2 - 1
                 ).to(torch.int8)
        scale = torch.rand((1, N), generator=gen, device="cuda") * 1e-2 + 1e-3
        rec = {"K": K, "N": N}
        for name, fn, xs, dense in cases(M, x, mags, signs, pm):
            got = fn(xs, mags, signs, scale, 8)
            want = plain(xs, mags, signs, scale, 8)
            err = float((got - want).abs().max()) / float(want.abs().max())
            if name != "library" and not err <= 1e-4:
                raise AssertionError(f"{K}x{N} M={M} {name}: {err} from the plain version")
            if dense is not None and not torch.equal(got, dense(xs, mags, signs, scale, 8)):
                raise AssertionError(f"{K}x{N} M={M} {name}: skip differs from dense")
            rec[name + "_ms"] = timed_ms(lambda: fn(xs, mags, signs, scale, 8), flush)
        shapes.append(rec)
    return shapes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[1])
    ap.add_argument("--rows", default="4",
                    help="comma-separated M: 4 times the decode cases, any other M the "
                         "tensor-core kernel (default: 4)")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))

    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the kernel runs only on one", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.kernels.ref import ref_polarized_matmul_fast

    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    for M in (int(r) for r in args.rows.split(",")):
        shapes = time_rows(M, pm, ref_polarized_matmul_fast, flush)
        keys = [k for k in shapes[0] if k.endswith("_ms")]
        print(json.dumps({"card": smi.strip().splitlines()[0] if smi.strip() else None,
                          "root": str(root), "M": M, "shapes": shapes,
                          "per_layer": {k: sum(r[k] * SHAPES[r["K"], r["N"]] for r in shapes)
                                        for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
