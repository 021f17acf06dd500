"""Time the bit-serial crossbar kernel of a checkout on the fidelity path's
operands, so two commits can be compared on one card.

It builds layer 0 of full-width qwen2-1.5b (one layer; ReLU, 50% fragment
sparsity and random weights from seed 0, as ``chip_smoke.py``'s zero-skip
phase builds it), compresses it with FORMS (m=8, 8 bits, 2-bit cells),
takes the 64 activation rows of ``chip_smoke.py``'s fidelity phase (the
rmsnorm of the embeddings of the first 16 tokens of its four prompts),
quantizes them to 16-bit codes and times
``repro_torch.kernels.bitserial_crossbar.bitserial_crossbar`` on wq, wk, wv,
gate and up at an ideal and a 4-bit ADC (median of CUDA-event times, L2
flushed before each launch).  Each result is first held equal to the plain
version.  ``--root`` names the checkout whose ``src/`` is imported (by
default the one holding this script).  Needs one CUDA card.

    python tools/time_bitserial.py --root /path/to/other/checkout
    python tools/time_bitserial.py

Prints one JSON line: the card, the root, and per leaf and in sum the
kernel's milliseconds at each ADC.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys

LEAVES = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("mlp", "gate"), ("mlp", "up"))
REPS = 30


def timed_ms(fn, flush) -> float:
    """Median CUDA-event time of ``fn``, the L2 flushed before each launch
    and a spin kernel queued ahead, so the interval holds device time only."""
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the kernel runs only on one", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.quantization import quantize_activations, slice_to_cells
    from repro_torch.forms import FormsSpec, compress_tree
    from repro_torch.kernels.bitserial_crossbar import bitserial_crossbar
    from repro_torch.kernels.ref import ref_bitserial_crossbar
    from repro_torch.models import layers as L
    from repro_torch.models.registry import build
    from repro_torch.models.transformer import layer_params

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), mlp_act="relu", act_sparsity=0.5,
                              act_fragment=8, num_layers=1)
    model = build(cfg, device="cuda")
    with torch.inference_mode():
        tree, _ = compress_tree(model.init(0), FormsSpec(m=8, bits=8, rule="energy"))
    spec = FormsSpec(m=8, bits=8, input_bits=16)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(16, 65)) for _ in range(4)]
    toks = torch.tensor([int(t) for p in prompts for t in p[:16]], device="cuda")
    bp = layer_params(tree["blocks"], 0)
    emb = L.embed_lookup(tree["embed"], toks, torch.float32)
    acts = {"attn": L.rmsnorm(emb, bp["norm1"], cfg.norm_eps),
            "mlp": L.rmsnorm(emb, bp["norm2"], cfg.norm_eps)}
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    leaves = []
    for grp, name in LEAVES:
        leaf = bp[grp][name]
        codes, _ = quantize_activations(acts[grp], spec.input_bits)
        codes = codes.to(torch.int32)
        cells = slice_to_cells(leaf.mags, spec.quant).to(torch.uint8)
        rec = {"leaf": name, "M": codes.shape[0], "K": leaf.k, "N": leaf.n}
        for adc_bits, key in ((None, "ideal_ms"), (4, "adc4_ms")):
            run = lambda: bitserial_crossbar(codes, cells, leaf.signs, m=8, input_bits=16,
                                             cell_bits=2, adc_bits=adc_bits)
            acc, _ = run()
            want, _ = ref_bitserial_crossbar(codes, cells, leaf.signs, 8, 16, 2,
                                             adc_bits=adc_bits)
            if not torch.equal(acc, want):
                raise AssertionError(f"{name}, adc_bits={adc_bits}: the kernel disagrees "
                                     f"with the plain version")
            rec[key] = timed_ms(run, lambda: scrub.zero_())
        leaves.append(rec)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": smi.strip().splitlines()[0] if smi.strip() else None,
                      "root": str(root), "leaves": leaves,
                      "ideal_ms": sum(r["ideal_ms"] for r in leaves),
                      "adc4_ms": sum(r["adc4_ms"] for r in leaves)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
