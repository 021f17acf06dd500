"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name and power limit;
2. build   — the CUDA kernels, built from ``src/repro_torch/kernels/csrc``;
3. kernel  — the polarized-matmul kernel against its plain PyTorch version
             at every full-width qwen2-1.5b projection shape, at M=4
             (decode) and M=64 (prefill), with CUDA-event times of the
             kernel, the plain version and one library call, beside the
             card's bound;
4. small   — a reduced qwen2 served on the card and on the CPU: prefill
             logits agree (the CPU runs the plain versions);
5. slice   — full-width qwen2-1.5b (random weights from a seed), compressed
             by FORMS and served through ``ServingEngine``: every request
             returns its tokens, the kernel's launch count is 196 per model
             call, and three timed runs give the same tokens; each run's
             decode ms per step beside the step's byte bound;
6. kernels — one JSON object summarising every kernel of the main path.

Then the card's ``nvidia-smi`` line and, last, ``{"ok": true, ...}``.  Any
failure raises and the script exits non-zero; without CUDA it exits 1 and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores: the
                               # kernel's contract keeps f32 products
REL_TOL = 1e-4                 # both sides sum in f32, in different orders
DECODE_M, PREFILL_M = 4, 64
# qwen2-1.5b projections per layer: (K, N) -> calls per layer
LAYER_SHAPES = {(1536, 1536): 2, (1536, 256): 2, (1536, 8960): 2, (8960, 1536): 1}
SLICE_RUNS = 3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def timed_ms(fn, flush, reps: int = 30) -> float:
    """Median CUDA-event device time of ``fn`` with the L2 cache flushed
    before every launch (a decode step streams ~1.5 GB of weights, so the
    real caller finds them cold).  A spin kernel queued ahead keeps the card
    busy while the host enqueues the events and ``fn``, so the interval
    holds device time only, not the wrapper's host overhead."""
    import torch
    fn()
    times = []
    for _ in range(reps):
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


def bound(M: int, K: int, N: int, mag_bytes: int, m: int = 8):
    nbytes = M * K * 4 + K * N * mag_bytes + (K // m) * N + N * 4 + M * N * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K * N / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_inputs(gen, M, K, N, m=8, mag_dtype=None, levels=256):
    import torch
    mag_dtype = mag_dtype or torch.uint8
    x = torch.randn((M, K), generator=gen, device="cuda")
    mags = torch.randint(0, levels, (K, N), generator=gen, device="cuda").to(mag_dtype)
    signs = (torch.randint(0, 2, (K // m, N), generator=gen, device="cuda") * 2 - 1
             ).to(torch.int8)
    scale = torch.rand((1, N), generator=gen, device="cuda") * 1e-2 + 1e-3
    return x, mags, signs, scale


def phase_kernels():
    import torch
    from repro_torch.kernels.polarized_matmul import polarized_matmul
    from repro_torch.kernels.ref import ref_polarized_matmul_fast

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()
    rows = []
    worst_abs = worst_rel = 0.0

    def check(label, M, K, N, mag_dtype=None, levels=256, time_it=False):
        nonlocal worst_abs, worst_rel
        x, mags, signs, scale = kernel_inputs(gen, M, K, N, mag_dtype=mag_dtype,
                                              levels=levels)
        got = polarized_matmul(x, mags, signs, scale, 8)
        again = polarized_matmul(x, mags, signs, scale, 8)
        want = ref_polarized_matmul_fast(x, mags, signs, scale, 8)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{label} M={M} K={K} N={N}: two launches differ")
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel_err)
        rec = {"case": label, "M": M, "K": K, "N": N, "mags": str(mags.dtype),
               "max_abs_err": abs_err, "max_rel_err": rel_err}
        if time_it:
            w = (mags.float() * signs.float().repeat_interleave(8, dim=0))
            rec["kernel_ms"] = timed_ms(lambda: polarized_matmul(x, mags, signs, scale, 8), flush)
            rec["plain_ms"] = timed_ms(lambda: ref_polarized_matmul_fast(x, mags, signs, scale, 8), flush)
            rec["library_ms"] = timed_ms(lambda: torch.matmul(x, w), flush)
            rec["bound_ms"], rec["bound_by"] = bound(M, K, N, mags.element_size())
        emit("kernel", **rec)
        if not rel_err <= REL_TOL:
            raise AssertionError(f"kernel disagrees with its plain version: {rec}")
        return rec

    for M in (DECODE_M, PREFILL_M):
        for (K, N) in LAYER_SHAPES:
            rows.append(check("qwen2-1.5b", M, K, N, time_it=True))
    check("int32 mags (bits > 8)", DECODE_M, 1536, 1536, mag_dtype=torch.int32, levels=1024)
    check("ragged edges", 7, 1544, 250)
    check("ragged edges, prefill", 67, 264, 1030)
    return rows, worst_abs, worst_rel


def per_layer(rows, M, key):
    return sum(r[key] * LAYER_SHAPES[(r["K"], r["N"])] for r in rows if r["M"] == M)


def phase_small():
    """A reduced qwen2 (f32) compressed by FORMS: prefill logits on the card
    (the kernel) against the CPU (the plain versions), same codes."""
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.forms import FormsLinearParams, FormsSpec, compress_tree
    from repro_torch.models.registry import build

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, FormsLinearParams):
            return dataclasses.replace(tree, mags=tree.mags.to(dev),
                                       signs=tree.signs.to(dev), scale=tree.scale.to(dev))
        return tree.to(dev)

    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), dtype="float32")
    params, _ = compress_tree(build(cfg, device="cpu").init(0), FormsSpec(m=8, bits=8))
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 16)))
    out = {}
    for dev in ("cpu", "cuda"):
        model = build(cfg, device=dev)
        cache = model.init_paged_cache(3, 8)
        with torch.inference_mode():
            logits, _ = model.prefill_paged(to(params, dev), toks.to(dev), cache,
                                            torch.tensor([1, 2], device=dev), 0, 16)
        out[dev] = logits.float().cpu()
    err = float((out["cpu"] - out["cuda"]).abs().max())
    top = float(out["cpu"].abs().max())
    emit("small", arch=cfg.name, max_abs_err=err, max_logit=top,
         argmax_equal=bool(out["cpu"].argmax() == out["cuda"].argmax()))
    if not (torch.isfinite(out["cuda"]).all() and err <= 1e-4 * max(top, 1.0)):
        raise AssertionError(f"card and CPU logits disagree: {err} (max |logit| {top})")


def phase_slice():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.forms import FormsSpec
    from repro_torch.kernels.polarized_matmul import polarized_matmul
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config("qwen2-1.5b")
    model = build(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(0)
    engine = ServingEngine(model, params, spec=FormsSpec(m=8, bits=8, rule="energy"),
                           page_size=16, batch_slots=4, max_len=256, decode_block=4,
                           device="cuda")
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(16, 65)) for _ in range(4)]
    n_new = 16

    def run():
        reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
        rounds0 = engine.scheduler.rounds
        polarized_matmul.launches = 0
        t = time.perf_counter()
        results = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = polarized_matmul.launches
        steps = (engine.scheduler.rounds - rounds0) * engine.decode_block
        return results, launches, len(results) + steps, wall, steps

    runs = [run() for _ in range(SLICE_RUNS)]
    tokens = [{r.uid: r.tokens for r in res} for res, *_ in runs]
    for (results, launches, calls, wall, _), toks in zip(runs, tokens):
        for uid, t in toks.items():
            if len(t) != n_new or not all(0 <= v < cfg.vocab_size for v in t):
                raise AssertionError(f"request {uid} returned {t}")
        per_call = 7 * cfg.num_layers
        if launches != per_call * calls:
            raise AssertionError(f"polarized_matmul launched {launches} times for "
                                 f"{calls} model calls; expected {per_call} per call")
    if any(t != tokens[0] for t in tokens):
        raise AssertionError(f"the runs gave other tokens: {tokens}")
    # a decode step reads every FORMS plane and the bf16 tied head once (the
    # KV pages it gathers, tens of MB, are left out)
    rep = engine.compression_report
    step_bytes = rep.bytes_compressed + engine.params["head_cast"].nbytes
    step_ms = []
    tok_s = []
    for results, _, _, _, steps in runs:
        decode_ms = sum(r.decode_ms for r in results)   # the rounds' wall time
        step_ms.append(decode_ms / steps)
        tok_s.append(sum(len(r.tokens) - 1 for r in results) / decode_ms * 1e3)
    results, launches, calls, wall, steps = runs[-1]
    emit("slice", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, compression=rep.summary(),
         setup_s=setup_s, prompt_lens=[len(p) for p in prompts],
         prefill_ms=[r.prefill_ms for r in results],
         mean_prefill_ms=float(np.mean([r.prefill_ms for r in results])),
         decode_steps=steps, decode_step_ms=step_ms,
         decode_step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
         decode_step_bytes=step_bytes, decode_tok_s=tok_s, wall_s=wall,
         model_calls=calls, kernel_launches=launches,
         launches_per_call=launches // calls, pages=engine.stats()["pages"],
         tokens=tokens[-1], peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    profile_decode(engine, prompts)
    return launches


def profile_decode(engine, prompts) -> None:
    """Trace one more run with ``torch.profiler``: device time by kernel, the
    busiest host ops, and the card's idle share over the run's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Request

    reqs = [Request(uid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_attr = ("self_device_time_total"
                if hasattr(prof.key_averages()[0], "self_device_time_total")
                else "self_cuda_time_total")
    ka = prof.key_averages()
    # device-side events only (kernels, memsets, copies); the aten:: rows
    # repeat their kernels' time
    kernels = sorted((e for e in ka if getattr(e, dev_attr) > 0
                      and str(e.device_type).endswith("CUDA")),
                     key=lambda e: -getattr(e, dev_attr))
    device_ms = sum(getattr(e, dev_attr) for e in kernels) / 1e3
    host = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:12]
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    emit("profile", wall_ms=wall_ms, device_busy_ms=device_ms,
         device_idle_share=1 - device_ms / wall_ms, kernel_launches=launches,
         top_device=[{"name": e.key[:80], "ms": getattr(e, dev_attr) / 1e3,
                      "count": e.count} for e in kernels[:15]],
         top_host=[{"name": e.key[:80], "self_ms": e.self_cpu_time_total / 1e3,
                    "count": e.count} for e in host])


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 1
    import repro_torch.kernels.build  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build(["polarized_matmul"])
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: v["ptxas"] for k, v in build.BUILD_LOG.items()})

    rows, worst_abs, worst_rel = phase_kernels()
    phase_small()
    launches = phase_slice()

    kernels = {"kernels": [{
        "name": "polarized_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/polarized_matmul.cu",
        "replaces": "src/repro/kernels/polarized_matmul.py:45",
        "launches": launches, "max_abs_err": worst_abs, "max_rel_err": worst_rel,
        "ms": per_layer(rows, DECODE_M, "kernel_ms"),
        "plain_ms": per_layer(rows, DECODE_M, "plain_ms"),
        "bound_ms": per_layer(rows, DECODE_M, "bound_ms"),
        "bound_by": "bytes",
        "library_ms": per_layer(rows, DECODE_M, "library_ms"),
        "per": "the 7 projections of one qwen2-1.5b layer at decode, M=4",
    }]}
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
