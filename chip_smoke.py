"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py [--trace-speculate]

Phases, each printing JSON lines:

1. device    — the card's name and power limit;
2. build     — the CUDA kernels, built from ``src/repro_torch/kernels/csrc``
               (one nvcc per source, all started together);
3. kernel    — the f32 polarized-matmul kernel against its plain PyTorch
               version at every full-width qwen2-1.5b projection shape, at
               M=1, 4, 8 and 64, int32 codes and ragged edges: two launches
               equal bit for bit and, below TC_MIN_ROWS, bf16 x (one launch,
               widened in the kernel) equal bit for bit to the f32 launch on
               x.float(); timed at M=4 (f32 and bf16 x, beside the f32 and
               bf16 library calls, the bounds and the achieved TB/s) and at
               M=64 (f32 x); then the tensor-core kernel on bf16 x at M=16,
               32, 64 and 256 and a ragged shape (two launches equal bit for
               bit), timed at M=32 and 64 beside the f32 and bf16 library
               calls and its bf16 bound; and the M crossover of the two
               kernels on bf16 x at M=1 to 64, with the least M at which the
               tensor-core kernel wins (TC_MIN_ROWS);
4. skip      — the block-skip launches at the same shapes with 0%, 50% and
               100% of the K slices of x zero: equal to the dense launch
               bit for bit, timed at 50% (f32 x at M=4 and 64, bf16 x at
               M=4 on the f32 kernel and at M=64 on the tensor-core kernel);
               fragment compaction at M=1 and 4, where it engages and where
               it falls back, its output equal bit for bit to the launch the
               device flag chose;
5. bitserial — the bit-serial crossbar kernel (int8 tensor cores) at M=4
               and full-width shapes, 16-bit inputs, ideal and 4-bit ADCs,
               each timed beside its grid and MMA count; then m=40, cells
               past 2^cell_bits - 1, 5 cells of 4 bits and a result that
               wraps int32: acc and eic equal to the plain version exactly;
6. small     — a reduced qwen2 (f32 activations, so the f32 kernels) on
               the card and on the CPU: prefill logits agree (the CPU runs
               the plain versions), and zero_skip="block" gives the card's
               dense logits bit for bit;
7. slice     — full-width qwen2-1.5b (random weights from a seed), compressed
               by FORMS and served through ``ServingEngine``: every request
               returns its tokens, the kernels' launch counts are 196 per
               model call (the tensor-core kernel at prefill, the f32 one at
               decode, as the route picks by M), and three timed runs give
               the same tokens; each
               run's decode ms per step beside the step's byte bound; then
               the route check: the same requests with the route forced to
               the f32 kernel give the same greedy tokens (or differ only at
               a near-tie), with the largest prefill-logit difference;
8. speculate — the slice's target served self-speculatively (a 4-bit FORMS
               draft of its weights on its fragments, full depth, K=4,
               adaptive K): two greedy runs agree; the token rule: their
               tokens equal the plain engine's or part first at a near-tie
               below the measured threshold (the largest logit difference
               of the target's decode at T=1 and T=kk+1), and every emitted
               token, teacher-forced on the target's plain decode, lies
               within that threshold of its row's largest logit; the
               kernels' launches equal those reckoned from the recorded
               round widths, one round runs with host syncs forbidden, a
               temperature run repeats from its seed; an int-grid draft (8
               bits, every other layer) and the dense slot cache under the
               same token rule; acceptance, tokens per round, ms per emitted
               token beside the plain engine's, peak memory; the verify's
               projections at M = 8, 12, 16 and 20 held against the plain
               version and timed beside it, the bf16 library call and the
               bound; with ``--trace-speculate``, one speculative run traced
               (device busy vs idle);
9. fleet     — the SLO fleet scheduler on the slice's model and engine
               settings: the seeded open-loop trace of 24 requests (16-64
               token prompts, two of 192, a quarter batch class) served with
               every arrival at 0 on the plain scheduler (its capacity), then
               at 0.8 of that rate with bulk admission and with chunked
               prefill (32-token chunks, 128-token round budget): per class
               TTFT and inter-token p50/p99, preemptions, deadline misses,
               wall, tok/s, chunk widths; a preemption case (four batch
               requests, then an interactive one); the speculative fleet (a
               4-bit draft, K=4, chunked admission) on 8 requests.  Every
               request's tokens equal the plain engine's or part first at a
               near-tie below the measured logit difference of bulk prefill
               and the fleet's admissions (chunks, resumes), every token
               within it under teacher forcing; each run's launches equal
               the reckoning from its recorded prefills, chunks and rounds;
10. checkpoint_serve — the slice's compressed tree saved with its spec,
               rebuilt from the meta and a fresh init, restored onto the card
               and served: bit for bit, the slice's tokens exactly; save and
               restore ms, bytes on disk against the f32 tree's;
11. zero_skip — the same model with ReLU and 50% fragment sparsity, one tree
               compressed once, served with zero_skip off, block and compact:
               block gives off's tokens through the skip kernel, compact's
               tokens are compared, one compact decode call runs with host
               syncs forbidden; the batch-union dead share of the decode
               activations (M=4) in m-row fragments and in 256-row slices;
12. fidelity — ``forms.apply_simulated`` on layer 0's wq/wk/wv/gate/up of
               that tree: the bit-serial kernel against its plain version,
               mean EIC and cycle savings; then the kernel alone on each
               leaf's M=64 operands, exact at ideal and 4-bit ADCs, timed;
13. polarize — the fragment-polarization kernel of the ADMM Z-update
               against its plain version at the seven stacked full-width
               qwen2-1.5b leaves, both sign rules, bit for bit (a case with
               zero-sum fragments, -0.0 and NaN too), with CUDA-event times
               of the kernel and the plain version beside the byte bound;
14. train_small — a reduced qwen2 (f32) trained two steps plus one fresh
               Z-update on the card and on the CPU from the same params:
               losses agree, every Z leaf is polarized;
15. train    — full-width qwen2-1.5b (random weights from a seed) trained
               through ``repro_torch.training`` with ADMM: 6 steps of 8 x
               256 tokens, Z-updates after steps 2 (fresh), 4 (fresh, sign
               refresh) and 6 (frozen); per-step ms, tokens/s, peak memory,
               Z-update ms, the kernel's launches (14) and every Z leaf's
               violation (0); one traced step and one step with host syncs
               forbidden;
16. checkpoint — checkpointed ADMM training of qwen2-1.5b at full width,
               depth cut to 2 layers, the train phase's settings: run A (4
               steps) twice, run B (2 steps, ``save_async`` after the step-2
               Z-update, restored into a fresh template, 2 more): restored ==
               saved bit for bit, B's params equal A's (or within A's own
               repeat difference), the polarization kernel 7 times per fresh
               Z-update; save/restore ms and GB/s; B's params compressed,
               saved, restored and served with the tokens served from memory;
17. total    — the script's seconds so far;
18. kernels  — one JSON object summarising every kernel of the main paths.

Then the card's ``nvidia-smi`` line and, last, ``{"ok": true, ...}``.  Any
failure raises and the script exits non-zero; without CUDA it exits 1 and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores: the
                               # f32 kernel's contract keeps f32 products
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
INT8_OPS = 1979e12             # H100 SXM int8 tensor cores, dense: the least
                               # time any design could take for integer MACs
REL_TOL = 1e-4                 # both sides sum in f32, in different orders
DECODE_M, PREFILL_M = 4, 64
# bf16 x on the tensor-core route: checked at these M, timed at the last two
TC_CHECK_M, TC_TIMED_M = (16, 256), (32, 64)
CROSSOVER_M = (1, 2, 4, 8, 16, 32, 64)
# qwen2-1.5b projections per layer: (K, N) -> calls per layer
LAYER_SHAPES = {(1536, 1536): 2, (1536, 256): 2, (1536, 8960): 2, (8960, 1536): 1}
SLICE_RUNS = 3
# the speculate phase: the draft's K, and the verify's M = 4 slots x (kk+1)
SPEC_K = 4
VERIFY_M = (8, 12, 16, 20)
# the bit-serial kernel's shapes (M=4) and the zero-skip slice's model
BITSERIAL_SHAPES = [(1536, 1536), (1536, 8960), (8960, 1536)]
SPARSE = dict(mlp_act="relu", act_sparsity=0.5, act_fragment=8)
# the stacked crossbar leaves of qwen2-1.5b that the ADMM Z-update projects
# (L, K, N), in the order the Z-update visits them
ADMM_LEAVES = {"blocks/attn/wk": (28, 1536, 256), "blocks/attn/wo": (28, 1536, 1536),
               "blocks/attn/wq": (28, 1536, 1536), "blocks/attn/wv": (28, 1536, 256),
               "blocks/mlp/down": (28, 8960, 1536), "blocks/mlp/gate": (28, 1536, 8960),
               "blocks/mlp/up": (28, 1536, 8960)}
TRAIN = dict(seq_len=256, global_batch=8, steps=6)


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


def bound_bytes(M: int, K: int, N: int, mag_bytes: int, m: int = 8, x_bytes: int = 4) -> int:
    """The f32 kernel's bytes: x, the codes, the signs, scale and y, once each."""
    return M * K * x_bytes + K * N * mag_bytes + (K // m) * N + N * 4 + M * N * 4


def ops_rate(mag_bytes: int, x_bytes: int) -> float:
    """The peak rate of the function, whichever kernel serves it: bf16 x on
    uint8 codes is exact in bf16 (codes <= 255, signs +-1), so its products
    run at the bf16 tensor-core rate; f32 x, or int32 codes, keep f32."""
    return BF16_FLOPS if x_bytes == 2 and mag_bytes == 1 else F32_FLOPS


def bound(M: int, K: int, N: int, mag_bytes: int, m: int = 8, x_bytes: int = 4):
    t_bytes = bound_bytes(M, K, N, mag_bytes, m, x_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K * N / ops_rate(mag_bytes, x_bytes) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_tc(M: int, K: int, N: int, m: int = 8, live_rows=None):
    """The bf16 product's bound: bf16 x, uint8 codes, int8 signs, f32 scale
    and y, each once, over HBM; its MACs at the bf16 tensor-core rate.
    ``live_rows`` counts only the code rows a skip launch reads."""
    rows = K if live_rows is None else live_rows
    nbytes = M * K * 2 + rows * N + -(-rows // m) * N + N * 4 + M * N * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * rows * N / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_inputs(gen, M, K, N, m=8, mag_dtype=None, levels=256, x_dtype=None):
    import torch
    mag_dtype = mag_dtype or torch.uint8
    x = torch.randn((M, K), generator=gen, device="cuda").to(x_dtype or torch.float32)
    mags = torch.randint(0, levels, (K, N), generator=gen, device="cuda").to(mag_dtype)
    signs = (torch.randint(0, 2, (K // m, N), generator=gen, device="cuda") * 2 - 1
             ).to(torch.int8)
    scale = torch.rand((1, N), generator=gen, device="cuda") * 1e-2 + 1e-3
    return x, mags, signs, scale


def phase_kernels():
    """The f32 kernel against its plain version at every full-width
    projection shape: two launches equal bit for bit, and, on bf16 x below
    TC_MIN_ROWS, the bf16 launch (one launch, x widened in the kernel) equal
    bit for bit to the f32 launch on x.float().  Timed at M=4 (f32 and bf16
    x, beside the f32 and bf16 library calls, the bounds and the achieved
    TB/s) and at M=64 (f32 x)."""
    import torch
    from repro_torch.kernels import polarized_matmul as pm
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
        group, splits = pm.decode_split(M, N, K, torch.cuda.get_device_properties(0)
                                        .multi_processor_count)
        rec = {"case": label, "M": M, "K": K, "N": N, "mags": str(mags.dtype),
               "grid": [-(-N // pm._BN), -(-M // pm.tile_rows(M)), splits], "group": group,
               "max_abs_err": abs_err, "max_rel_err": rel_err}
        xb = x.to(torch.bfloat16)
        if not pm.uses_tensor_cores(xb.dtype, mags.dtype, "cuda", M):
            # bf16 x straight into the kernel: one launch, the f32 launch's bits
            before = polarized_matmul.launches
            got_b = polarized_matmul(xb, mags, signs, scale, 8)
            took = polarized_matmul.launches - before
            rec["bf16_equals_widened"] = torch.equal(
                got_b, polarized_matmul(xb.float(), mags, signs, scale, 8))
            if took != 1 or not rec["bf16_equals_widened"]:
                raise AssertionError(f"bf16 x: {took} launches, equal to the f32 launch on "
                                     f"the widened x: {rec['bf16_equals_widened']}")
        if time_it:
            w = (mags.float() * signs.float().repeat_interleave(8, dim=0))
            rec["kernel_ms"] = timed_ms(lambda: polarized_matmul(x, mags, signs, scale, 8), flush)
            rec["plain_ms"] = timed_ms(lambda: ref_polarized_matmul_fast(x, mags, signs, scale, 8), flush)
            rec["library_ms"] = timed_ms(lambda: torch.matmul(x, w), flush)
            rec["bound_ms"], rec["bound_by"] = bound(M, K, N, mags.element_size())
            rec["tb_s"] = bound_bytes(M, K, N, mags.element_size()) / rec["kernel_ms"] / 1e9
            if "bf16_equals_widened" in rec:
                wb = w.to(torch.bfloat16)   # exact: codes <= 255 and signs +-1
                rec["bf16_ms"] = timed_ms(lambda: polarized_matmul(xb, mags, signs, scale, 8), flush)
                rec["bf16_plain_ms"] = timed_ms(
                    lambda: ref_polarized_matmul_fast(xb, mags, signs, scale, 8), flush)
                rec["bf16_library_ms"] = timed_ms(lambda: torch.matmul(xb, wb), flush)
                rec["bf16_bound_ms"], _ = bound(M, K, N, mags.element_size(), x_bytes=2)
                rec["bf16_tb_s"] = (bound_bytes(M, K, N, mags.element_size(), x_bytes=2)
                                    / rec["bf16_ms"] / 1e9)
        emit("kernel", **rec)
        if not rel_err <= REL_TOL:
            raise AssertionError(f"kernel disagrees with its plain version: {rec}")
        return rec

    for M in (DECODE_M, PREFILL_M):
        for (K, N) in LAYER_SHAPES:
            rows.append(check("qwen2-1.5b", M, K, N, time_it=True))
    for M in (1, 8):
        for (K, N) in LAYER_SHAPES:
            check("qwen2-1.5b", M, K, N)
    check("int32 mags (bits > 8)", DECODE_M, 1536, 1536, mag_dtype=torch.int32, levels=1024)
    check("int32 mags (bits > 8)", 8, 8960, 1536, mag_dtype=torch.int32, levels=1024)
    check("ragged edges", 7, 1544, 250)
    check("ragged edges, prefill", 67, 264, 1030)
    return rows, worst_abs, worst_rel


def phase_kernels_tc():
    """The tensor-core kernel on bf16 x through the route of
    ``pm.polarized_matmul``: against the plain version within REL_TOL, two
    launches equal bit for bit, at M=16, 32, 64 and 256 and a ragged shape;
    timed at M=32 and 64 beside the f32 and bf16 library calls.  Then the
    crossover: both kernels on bf16 x at M=4..64, summed per layer."""
    import torch
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.kernels.ref import ref_polarized_matmul_fast

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()
    rows = []
    worst_abs = worst_rel = 0.0

    def check(label, M, K, N, time_it=False):
        nonlocal worst_abs, worst_rel
        x, mags, signs, scale = kernel_inputs(gen, M, K, N, x_dtype=torch.bfloat16)
        before = pm.polarized_matmul_tc.launches
        got = pm.polarized_matmul(x, mags, signs, scale, 8)
        again = pm.polarized_matmul(x, mags, signs, scale, 8)
        took = pm.polarized_matmul_tc.launches - before
        want = ref_polarized_matmul_fast(x, mags, signs, scale, 8)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{label} M={M} K={K} N={N}: two launches differ")
        if took != 2:
            raise AssertionError(f"{label} M={M}: the route launched the tensor-core "
                                 f"kernel {took} times for 2 calls")
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel_err)
        group = pm.tc_group(M, N, K, torch.cuda.get_device_properties(0).multi_processor_count)
        rec = {"case": label, "M": M, "K": K, "N": N, "x": "bfloat16",
               "grid": [-(-N // pm._TC_BN), -(-M // pm._TC_BM), -(-(-(-K // pm._KC)) // group)],
               "max_abs_err": abs_err, "max_rel_err": rel_err}
        if time_it:
            xf = x.float()
            w = mags.float() * signs.float().repeat_interleave(8, dim=0)
            wb = w.to(torch.bfloat16)   # exact: codes <= 255 and signs +-1
            rec["kernel_ms"] = timed_ms(lambda: pm.polarized_matmul(x, mags, signs, scale, 8), flush)
            rec["plain_ms"] = timed_ms(lambda: ref_polarized_matmul_fast(x, mags, signs, scale, 8), flush)
            rec["library_f32_ms"] = timed_ms(lambda: torch.matmul(xf, w), flush)
            rec["library_ms"] = timed_ms(lambda: torch.matmul(x, wb), flush)
            rec["bound_ms"], rec["bound_by"] = bound_tc(M, K, N)
        emit("kernel_tc", **rec)
        if not rel_err <= REL_TOL:
            raise AssertionError(f"the tensor-core kernel disagrees with its plain version: {rec}")
        return rec

    for M in TC_CHECK_M + TC_TIMED_M:
        for (K, N) in LAYER_SHAPES:
            rec = check("qwen2-1.5b", M, K, N, time_it=M in TC_TIMED_M)
            if M in TC_TIMED_M:
                rows.append(rec)
    check("ragged edges, prefill", 67, 264, 1030)
    # the timing method's own floor: a spin kernel of 0 cycles, timed as
    # every kernel here is (every per-layer sum holds 7 of these)
    floor_ms = timed_ms(lambda: torch.cuda._sleep(0), flush)
    emit("timing_floor", ms=floor_ms)

    crossover = []
    route = pm.uses_tensor_cores
    for M in CROSSOVER_M:
        rec = {"M": M, "tc_ms": 0.0, "f32_ms": 0.0, "f32_kernel_ms": 0.0,
               "route": "tc" if route(torch.bfloat16, torch.uint8, "cuda", M) else "f32"}
        for (K, N), calls in LAYER_SHAPES.items():
            x, mags, signs, scale = kernel_inputs(gen, M, K, N, x_dtype=torch.bfloat16)
            rec["tc_ms"] += calls * timed_ms(
                lambda: pm.polarized_matmul_tc(x, mags, signs, scale, 8), flush)
            # the f32 route on bf16 x (forced here at every M, the route
            # patched as route_check does): one launch that widens x in the
            # kernel; f32_kernel_ms is the same kernel on f32 x
            xf = x.float()
            pm.uses_tensor_cores = lambda *args: False
            try:
                rec["f32_ms"] += calls * timed_ms(
                    lambda: pm.polarized_matmul(x, mags, signs, scale, 8), flush)
            finally:
                pm.uses_tensor_cores = route
            rec["f32_kernel_ms"] += calls * timed_ms(
                lambda: pm.polarized_matmul(xf, mags, signs, scale, 8), flush)
        emit("crossover", per="the 7 projections of one qwen2-1.5b layer, bf16 x", **rec)
        crossover.append(rec)
    # TC_MIN_ROWS is the least M at which the tensor-core route wins
    wins = [r["M"] for r in crossover if r["tc_ms"] < r["f32_ms"]]
    emit("crossover_min_rows", measured=wins[0] if wins else None, TC_MIN_ROWS=pm.TC_MIN_ROWS)
    return rows, worst_abs, worst_rel, crossover, floor_ms


def route_split(per_call, prefill_rows, steps, slots):
    """The launches a bf16 FORMS model's prefills (M = each prompt's bucket)
    and decode steps (M = slots) make on the [f32, tensor-core] kernels."""
    import torch
    from repro_torch.kernels import polarized_matmul as pm
    out = [0, 0]
    for M in prefill_rows + [slots] * steps:
        out[pm.uses_tensor_cores(torch.bfloat16, torch.uint8, "cuda", M)] += per_call
    return out


def per_layer(rows, M, key):
    return sum(r[key] * LAYER_SHAPES[(r["K"], r["N"])] for r in rows if r["M"] == M)


def _wrappers():
    from repro_torch.kernels import admm_polarize as ap
    from repro_torch.kernels import bitserial_crossbar as bx
    from repro_torch.kernels import polarized_matmul as pm
    return {"polarized_matmul": pm.polarized_matmul,
            "polarized_matmul_skip": pm.polarized_matmul_skip,
            "polarized_matmul_tc": pm.polarized_matmul_tc,
            "polarized_matmul_tc_skip": pm.polarized_matmul_tc_skip,
            "bitserial_crossbar": bx.bitserial_crossbar,
            "admm_polarize": ap.admm_polarize}


def launch_counts():
    """Every kernel wrapper's launch count, by kernel name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_counts() -> None:
    """Set every kernel's launch count to 0, just before a path is driven."""
    for fn in _wrappers().values():
        fn.launches = 0


def dead_slices(x, frac: float):
    """x with none (0), every other (0.5) or all (1) of its K slices of the
    kernel's tiling set to zero, in place."""
    from repro_torch.kernels.polarized_matmul import _KC
    S = -(-x.shape[1] // _KC)
    dead = [] if frac == 0 else range(S) if frac == 1 else range(1, S, 2)
    for k in dead:
        x[:, k * _KC:(k + 1) * _KC] = 0.0
    return x


def live_rows(mask, K: int) -> int:
    """The code rows a skip launch reads: a K slice's, when any row tile is
    live in it."""
    from repro_torch.kernels.polarized_matmul import _KC
    live = mask.any(dim=0).tolist()
    return sum(min(_KC, K - k * _KC) for k, on in enumerate(live) if on)


def skip_bound(mask, M: int, K: int, N: int, mag_bytes: int, m: int = 8, x_bytes: int = 4):
    """The skip launch's bound for this mask: a K slice's weights are read
    when any row tile is live in it; x, y, scale and the mask once."""
    rows = live_rows(mask, K)
    nbytes = (M * K * x_bytes + M * N * 4 + N * 4 + mask.numel() * 4
              + rows * N * mag_bytes + -(-rows // m) * N)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * rows * N / ops_rate(mag_bytes, x_bytes) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_skip():
    """Kernel #2: the block-skip launch equals the dense one bit for bit at
    0/50/100% dead K slices, timed at 50%, on the f32 kernel (f32 x at M=4
    and 64, bf16 x at M=4) and on the tensor-core kernel (bf16 x at M=64,
    its 64-row tiles); then fragment compaction.  Returns the f32 kernel's
    timed rows on f32 x, on bf16 x, the tensor-core kernel's, and the worst
    error."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.kernels.ref import ref_polarized_matmul_fast, ref_polarized_matmul_skip

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()
    rows, bf16_rows, tc_rows = [], [], []
    worst = 0.0
    for M, x_dtype in ((DECODE_M, torch.float32), (DECODE_M, torch.bfloat16),
                       (PREFILL_M, torch.float32), (PREFILL_M, torch.bfloat16)):
        tc = pm.uses_tensor_cores(x_dtype, torch.uint8, "cuda", M)
        counter = pm.polarized_matmul_tc_skip if tc else pm.polarized_matmul_skip
        bm = pm.tile_rows(M, tc)
        for (K, N) in LAYER_SHAPES:
            x0, mags, signs, scale = kernel_inputs(gen, M, K, N, x_dtype=x_dtype)
            for frac in (0.0, 0.5, 1.0):
                x = dead_slices(x0.clone(), frac)
                mask = pm.tile_mask(x, mags.dtype)
                dense = pm.polarized_matmul(x, mags, signs, scale, 8)
                before = counter.launches
                skip = pm.polarized_matmul_skip(x, mags, signs, scale, 8, mask=mask)
                took = counter.launches - before
                want = ref_polarized_matmul_skip(x, mags, signs, scale, mask, 8, bm, pm._KC)
                torch.cuda.synchronize()
                equal = torch.equal(skip, dense)
                abs_err = float((skip - want).abs().max())
                top = float(want.abs().max())
                rec = {"M": M, "K": K, "N": N, "x": str(x_dtype).split(".")[-1],
                       "kernel": "tc" if tc else "f32", "tile_rows": bm,
                       "dead_tiles": float(1 - mask.float().mean()),
                       "equal_dense": equal, "max_abs_err": abs_err}
                if frac == 0.5:
                    w = mags.float() * signs.float().repeat_interleave(8, dim=0)
                    xf = x.float()
                    rec["kernel_ms"] = timed_ms(
                        lambda: pm.polarized_matmul_skip(x, mags, signs, scale, 8, mask=mask), flush)
                    rec["dense_ms"] = timed_ms(lambda: pm.polarized_matmul(x, mags, signs, scale, 8), flush)
                    rec["plain_ms"] = timed_ms(lambda: ref_polarized_matmul_skip(
                        x, mags, signs, scale, mask, 8, bm, pm._KC), flush)
                    rec["library_ms"] = timed_ms(lambda: torch.matmul(xf, w), flush)
                    if x_dtype == torch.bfloat16:
                        wb = w.to(torch.bfloat16)
                        rec["library_f32_ms"] = rec["library_ms"]
                        rec["library_ms"] = timed_ms(lambda: torch.matmul(x, wb), flush)
                    if tc:
                        rec["bound_ms"], rec["bound_by"] = bound_tc(
                            M, K, N, live_rows=live_rows(mask, K))
                        tc_rows.append(rec)
                    else:
                        rec["bound_ms"], rec["bound_by"] = skip_bound(
                            mask, M, K, N, 1, x_bytes=x.element_size())
                        (rows if x_dtype == torch.float32 else bf16_rows).append(rec)
                emit("skip", **rec)
                if took != 1:
                    raise AssertionError(f"the skip call did not launch its kernel once: {rec}")
                if not equal:
                    raise AssertionError(f"the skip launch differs from the dense one: {rec}")
                if top and abs_err > REL_TOL * top:
                    raise AssertionError(f"the skip launch disagrees with its plain version: {rec}")
                worst = max(worst, abs_err)

    # fragment compaction (kernel #1 on gathered operands, gated on the card):
    # the branch the device flag took shows in the bits, since the gathered
    # product sums in another order than the full one
    K, N = 8960, 1536
    _, mags, signs, scale = kernel_inputs(gen, 1, K, N)
    for M, x_dtype in ((1, torch.float32), (DECODE_M, torch.float32),
                       (PREFILL_M, torch.bfloat16)):
        for engage in (True, False):
            x = torch.randn((M, K), generator=gen, device="cuda").to(x_dtype)
            if engage:   # 70% of the fragments dead in every row: the union too
                live = torch.rand((K // 8,), generator=gen, device="cuda") >= 0.7
                x = x * live.repeat_interleave(8).to(x_dtype)
            xg, mg, sg, n_live, keep = ops.gather_live_fragments(x, mags, signs, 8, 0.5)
            y = ops.polarized_matmul(x, mags, signs, scale, m=8, zero_skip="compact",
                                     zero_skip_keep=0.5)
            full = pm.polarized_matmul(x, mags, signs, scale, 8)
            gathered = pm.polarized_matmul(xg, mg, sg, scale, 8)
            want = ref_polarized_matmul_fast(x, mags, signs, scale, 8)
            torch.cuda.synchronize()
            rel = float((y - want).abs().max()) / float(want.abs().max())
            took = {(True, False): "compact", (False, True): "full"}.get(
                (torch.equal(y, gathered), torch.equal(y, full)), "neither")
            rec = {"M": M, "K": K, "N": N, "x": str(x_dtype).split(".")[-1],
                   "live_fragments": int(n_live), "keep": keep,
                   "engages": int(n_live) <= keep, "branch": took, "max_rel_err": rel,
                   "compact_ms": timed_ms(lambda: ops.polarized_matmul(
                       x, mags, signs, scale, m=8, zero_skip="compact", zero_skip_keep=0.5), flush),
                   "dense_ms": timed_ms(lambda: pm.polarized_matmul(x, mags, signs, scale, 8), flush)}
            emit("compact", **rec)
            if rec["engages"] != engage or not rel <= REL_TOL:
                raise AssertionError(f"compaction disagrees with the plain version: {rec}")
            if took != ("compact" if engage else "full"):
                raise AssertionError(f"compaction took the wrong launch: {rec}")
    return rows, bf16_rows, tc_rows, worst


def bitserial_bound(M: int, K: int, N: int, bits: int = 16, C: int = 4, m: int = 8):
    """Operations: M*K*N*bits*C bit-plane multiply-adds (2 ops each) over the
    card's int8 tensor-core rate, the fastest integer MACs it has; bytes: x,
    the uint8 cell planes, signs, acc and eic, each once."""
    t_ops = 2 * M * K * N * bits * C / INT8_OPS * 1e3
    nbytes = M * K * 4 + C * K * N + (K // m) * N + M * N * 4 + M * (K // m) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bitserial_check(label, x, cells, signs, adc_bits, *, m=8, bits=16, cell_bits=2,
                    mags=None, time_it=False, flush=None):
    """One case of kernel #3 against its plain version: acc and eic equal
    exactly, and with an ideal ADC and ``mags`` (the codes the cells slice)
    acc equal to the exact integer product; timed with its launch plan when
    ``time_it`` (and with an ideal ADC, one float64 ``torch.matmul`` of the
    codes and signed weights as the library yardstick)."""
    import torch
    from repro_torch.core.zeroskip import fragment_eic
    from repro_torch.kernels import bitserial_crossbar as bx
    from repro_torch.kernels.ref import ref_bitserial_crossbar, ref_exact_int_matmul

    kw = dict(m=m, input_bits=bits, cell_bits=cell_bits, adc_bits=adc_bits)
    acc, eic = bx.bitserial_crossbar(x, cells, signs, **kw)
    want, _ = ref_bitserial_crossbar(x, cells, signs, m, bits, cell_bits, adc_bits=adc_bits)
    want_eic = fragment_eic(x, m, bits)
    torch.cuda.synchronize()
    M, K = x.shape
    C, _, N = cells.shape
    rec = {"case": label, "M": M, "K": K, "N": N, "m": m, "C": C, "cell_bits": cell_bits,
           "cell_max": int(cells.max()), "adc_bits": adc_bits,
           "acc_equal": torch.equal(acc, want), "eic_equal": torch.equal(eic, want_eic),
           "max_abs_err": float((acc.double() - want.double()).abs().max())}
    if adc_bits is None and mags is not None:
        rec["exact_equal"] = torch.equal(acc, ref_exact_int_matmul(x, mags, signs, m))
    if time_it:
        plan = bx.plan(M, N, K, C, m=m, input_bits=bits, cell_bits=cell_bits,
                       adc_bits=adc_bits)
        rec["grid"], rec["mmas"], rec["clips"] = plan["grid"], plan["mmas"], plan["clips"]
        rec["kernel_ms"] = timed_ms(lambda: bx.bitserial_crossbar(x, cells, signs, **kw), flush)
        rec["plain_ms"] = timed_ms(lambda: ref_bitserial_crossbar(
            x, cells, signs, m, bits, cell_bits, adc_bits=adc_bits), flush)
        rec["library_ms"] = None   # no PyTorch call clips per fragment
        if adc_bits is None and mags is not None:
            # with an ideal ADC acc is the integer product (wrapped to
            # int32), which one float64 matmul computes exactly below 2^53
            xd = x.double()
            wd = mags.double() * signs.double().repeat_interleave(m, dim=0)
            lib = torch.matmul(xd, wd)
            rec["library_equal"] = bool(((lib.long() - acc.long()) % 2 ** 32 == 0).all())
            rec["library_ms"] = timed_ms(lambda: torch.matmul(xd, wd), flush)
        rec["bound_ms"], rec["bound_by"] = bitserial_bound(M, K, N, bits, C, m)
    if not (rec["acc_equal"] and rec["eic_equal"] and rec.get("exact_equal", True)
            and rec.get("library_equal", True)):
        raise AssertionError(f"the bit-serial kernel disagrees with its plain version: {rec}")
    return rec


def phase_bitserial():
    """Kernel #3 at M=4 and the three full-width shapes, ideal and 4-bit
    ADCs, each timed with its grid and MMA count: acc and eic equal to the
    plain version exactly (and acc to the exact integer product with an
    ideal ADC); then m=40, cells read whole past 2^cell_bits - 1, 20 weight
    bits and a result that wraps int32.  Returns the ideal and the 4-bit
    rows."""
    import torch
    from repro_torch.core.quantization import QuantSpec, slice_to_cells

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()
    M, bits = DECODE_M, 16
    ideal_rows, adc4_rows = [], []

    def operands(K, N, m):
        x = torch.randint(0, 2 ** bits, (M, K), generator=gen, device="cuda").to(torch.int32)
        live = torch.rand((M, K // m), generator=gen, device="cuda") >= 0.25
        x = x * live.repeat_interleave(m, dim=1)
        mags = torch.randint(0, 256, (K, N), generator=gen, device="cuda").to(torch.uint8)
        signs = (torch.randint(0, 2, (K // m, N), generator=gen, device="cuda") * 2 - 1
                 ).to(torch.int8)
        cells = slice_to_cells(mags, QuantSpec(bits=8, cell_bits=2)).to(torch.uint8)
        return x, mags, cells, signs

    for (K, N) in BITSERIAL_SHAPES:
        x, mags, cells, signs = operands(K, N, 8)
        for adc_bits, rows in ((None, ideal_rows), (4, adc4_rows)):
            rec = bitserial_check("qwen2-1.5b", x, cells, signs, adc_bits, mags=mags,
                                  time_it=True, flush=flush)
            emit("bitserial", **rec)
            rows.append(rec)
    # a fragment of 40 inputs (its sums span two k32 chunks), cells read
    # whole (0..255 with cell_bits = 2), and 5 cells of 4 bits (20 weight bits)
    x, mags, cells, signs = operands(1520, 1536, 40)
    for adc_bits in (None, 4):
        emit("bitserial", **bitserial_check("m=40", x, cells, signs, adc_bits, m=40,
                                            mags=mags))
    x, mags, _, signs = operands(1536, 1536, 8)
    wide = torch.randint(0, 256, (4, 1536, 1536), generator=gen, device="cuda").to(torch.uint8)
    for adc_bits in (None, 7):
        emit("bitserial", **bitserial_check("cells past 2^cell_bits - 1", x, wide, signs,
                                            adc_bits))
    planes = torch.randint(0, 16, (5, 1536, 1536), generator=gen, device="cuda").to(torch.uint8)
    for adc_bits in (None, 5):
        emit("bitserial", **bitserial_check("5 cells of 4 bits", x, planes, signs, adc_bits,
                                            cell_bits=4))
    # every input at its top code, every weight 255, every sign +1: the sum,
    # 8960 * 65535 * 255, is far past 2^31 and wraps
    K, N = 8960, 1536
    x = torch.full((M, K), 2 ** bits - 1, dtype=torch.int32, device="cuda")
    mags = torch.full((K, N), 255, dtype=torch.uint8, device="cuda")
    signs = torch.ones((K // 8, N), dtype=torch.int8, device="cuda")
    cells = slice_to_cells(mags, QuantSpec(bits=8, cell_bits=2)).to(torch.uint8)
    emit("bitserial", **bitserial_check("wraps int32", x, cells, signs, None, mags=mags))
    return ideal_rows, adc4_rows


def slice_prompts(cfg):
    """The slice's four prompts of 16-64 tokens, from ``RandomState(0)``."""
    import numpy as np
    rng = np.random.RandomState(0)
    return [rng.randint(0, cfg.vocab_size, size=rng.randint(16, 65)) for _ in range(4)]


def phase_small():
    """A reduced qwen2 (f32) compressed by FORMS: prefill logits on the card
    (the kernel) against the CPU (the plain versions), same codes."""
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.forms import FormsLinearParams, FormsSpec, compress_tree, default_spec
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
    counts = {}
    for dev, zero_skip in (("cpu", "off"), ("cuda", "off"), ("cuda", "block")):
        model = build(cfg, device=dev)
        cache = model.init_paged_cache(3, 8)
        reset_counts()
        with torch.inference_mode(), default_spec(FormsSpec(m=8, bits=8, zero_skip=zero_skip)):
            logits, _ = model.prefill_paged(to(params, dev), toks.to(dev), cache,
                                            torch.tensor([1, 2], device=dev), 0, 16)
        out[dev, zero_skip] = logits.float().cpu()
        counts.update({k: v for k, v in launch_counts().items() if v})
    cpu, card = out["cpu", "off"], out["cuda", "off"]
    err = float((cpu - card).abs().max())
    top = float(cpu.abs().max())
    block_equal = torch.equal(out["cuda", "block"], card)
    emit("small", arch=cfg.name, max_abs_err=err, max_logit=top,
         argmax_equal=bool(cpu.argmax() == card.argmax()), block_equals_off=block_equal,
         launches=counts)
    if not (torch.isfinite(card).all() and err <= 1e-4 * max(top, 1.0)):
        raise AssertionError(f"card and CPU logits disagree: {err} (max |logit| {top})")
    per_call = 7 * cfg.num_layers
    if not block_equal or counts != {"polarized_matmul": per_call,
                                     "polarized_matmul_skip": per_call}:
        raise AssertionError(f"the f32 kernels' prefill: block equal {block_equal}, {counts}")
    return counts


def phase_slice():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.forms import FormsSpec
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
    prompts = slice_prompts(cfg)
    n_new = 16

    def run():
        reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
        rounds0 = engine.scheduler.rounds
        reset_counts()
        t = time.perf_counter()
        results = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launch_counts()
        launches = {k: counts[k] for k in ("polarized_matmul", "polarized_matmul_tc")}
        steps = (engine.scheduler.rounds - rounds0) * engine.decode_block
        return results, launches, len(results) + steps, wall, steps

    runs = [run() for _ in range(SLICE_RUNS)]
    tokens = [{r.uid: r.tokens for r in res} for res, *_ in runs]
    per_call = 7 * cfg.num_layers
    buckets = [engine.runner.bucket_for(len(p)) for p in prompts]
    for (results, launches, calls, wall, steps), toks in zip(runs, tokens):
        for uid, t in toks.items():
            if len(t) != n_new or not all(0 <= v < cfg.vocab_size for v in t):
                raise AssertionError(f"request {uid} returned {t}")
        f32, tc = route_split(per_call, buckets, steps, engine.slots)
        want = {"polarized_matmul": f32, "polarized_matmul_tc": tc}
        if launches != want:
            raise AssertionError(f"the kernels launched {launches} times for "
                                 f"{len(results)} prefills and {steps} decode steps; "
                                 f"expected {want}")
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
         mean_prefill_ms_runs=[float(np.mean([r.prefill_ms for r in res]))
                               for res, *_ in runs],
         decode_steps=steps, decode_step_ms=step_ms,
         decode_step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
         decode_step_bytes=step_bytes, decode_tok_s=tok_s, wall_s=wall,
         model_calls=calls, kernel_launches=launches,
         launches_per_call=sum(launches.values()) / calls, pages=engine.stats()["pages"],
         tokens=tokens[-1], peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    profile_decode(engine, prompts)
    route_check(cfg, engine, prompts, tokens[0], n_new)
    return launches, engine, tokens[0]


def target_logits(engine, seq):
    """The served target's full-sequence logits (S, V) of one token list."""
    import torch
    from repro_torch.forms import default_spec
    with torch.inference_mode(), default_spec(engine.runner.spec):
        ids = torch.tensor(seq, device="cuda")[None]
        return engine.runner.model.forward(engine.params, {"tokens": ids})[0][0].float()


def first_divergence(engine, prompts, want, got):
    """Where two greedy token sets first part (the earliest step over the
    requests), with the served target's top-2 logit margin there; None when
    they are equal."""
    import torch
    firsts = [(uid, next(i for i, (a, b) in enumerate(zip(want[uid], got[uid])) if a != b))
              for uid in want if want[uid] != got[uid]]
    if not firsts:
        return None
    uid, i = min(firsts, key=lambda u: u[1])
    top2 = torch.topk(target_logits(engine, list(prompts[uid]) + want[uid][:i])[-1], 2).values
    return {"uid": uid, "step": i, "want_token": want[uid][i], "got_token": got[uid][i],
            "top2_margin": float(top2[0] - top2[1])}


def route_check(cfg, engine, prompts, tokens, n_new) -> None:
    """The same requests served with the route forced to the f32 kernel
    (``uses_tensor_cores`` patched here, not a flag): the greedy tokens must
    equal the tensor-core route's, or differ first at a near-tie -- a top-2
    logit margin below the largest prefill-logit difference of the routes."""
    import torch
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.serving.engine import Request

    def logits_of(seq):
        return target_logits(engine, seq)

    route = pm.uses_tensor_cores
    pm.uses_tensor_cores = lambda *args: False
    try:
        reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
        reset_counts()
        f32_tokens = {r.uid: r.tokens for r in engine.run(reqs)}
        f32_counts = launch_counts()
        f32_logits = [logits_of(list(p)) for p in prompts]
    finally:
        pm.uses_tensor_cores = route
    tc_logits = [logits_of(list(p)) for p in prompts]
    diff = max(float((a - b).abs().max()) for a, b in zip(tc_logits, f32_logits))
    top = max(float(b.abs().max()) for b in f32_logits)
    divergence = first_divergence(engine, prompts, tokens, f32_tokens)
    emit("route_check", tokens_equal=tokens == f32_tokens, max_prefill_logit_diff=diff,
         max_abs_logit=top, first_divergence=divergence,
         f32_route_launches={k: v for k, v in f32_counts.items() if v})
    if f32_counts["polarized_matmul_tc"] or not f32_counts["polarized_matmul"]:
        raise AssertionError(f"the forced f32 route launched {f32_counts}")
    if divergence is not None and not divergence["top2_margin"] < diff:
        raise AssertionError(f"the tensor-core route changed a greedy token away from a "
                             f"near-tie: {divergence}, logit difference {diff}")


def prefilled(engine, prompts):
    """A fresh paged cache holding the prompts, one slot each, prefilled as
    the served target prefills them (its bucket, its route): (cache,
    tables, positions, the first token's logits (slots, V)).  Runs under
    the caller's inference mode and spec."""
    import torch
    from repro_torch.serving import kv_cache as KV

    r = engine.runner
    model, params, ps = r.model, r.params, r.page_size
    slots, n_tables = len(prompts), KV.pages_for(r.max_len, r.page_size)
    cache = model.init_paged_cache(slots * n_tables + 1, ps)
    tables = torch.arange(1, slots * n_tables + 1, dtype=torch.int32,
                          device="cuda").reshape(slots, n_tables)
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device="cuda")
    first = []
    for s, p in enumerate(prompts):
        toks, n = r.padded_prompt(p)
        logits, cache = model.prefill_paged(params, torch.tensor(toks, device="cuda"), cache,
                                            tables[s, :KV.pages_for(toks.shape[1], ps)], s, n)
        first.append(logits[0])
    return cache, tables, pos, torch.stack(first)


def verify_threshold(engine, prompts, tokens, widths):
    """The largest |logit difference| between the target's ``decode_paged``
    at T=1 (M = slots, the f32 route) and at T=kk+1 (M = slots x (kk+1),
    the route ``uses_tensor_cores`` picks) over the same positions of one
    cache state: the prompts prefilled, then the plain engine's greedy
    tokens.  Returns the worst and the worst per width."""
    import torch
    from repro_torch.forms import default_spec
    from repro_torch.serving import kv_cache as KV

    r = engine.runner
    model, params = r.model, r.params
    seq = torch.tensor([tokens[i][:max(widths) + 1] for i in range(len(prompts))],
                       device="cuda")
    per = {}
    with torch.inference_mode(), default_spec(r.spec):
        cache, tables, pos, _ = prefilled(engine, prompts)

        def fork():
            return KV.PagedKVCache(pool={k: v.clone() for k, v in cache.pool.items()},
                                   page_size=cache.page_size)

        for kk in widths:
            ver = seq[:, :kk + 1]
            wide, _ = model.decode_paged(params, ver, fork(), pos, tables)
            one, c = [], fork()
            for t in range(kk + 1):
                lg, c = model.decode_paged(params, ver[:, t:t + 1], c, pos + t, tables)
                one.append(lg[:, 0])
            per[kk] = float((wide.float() - torch.stack(one, dim=1).float()).abs().max())
    return max(per.values()), per


def forced_logits(engine, admitted, seq):
    """The logits of every row of ``seq`` (B, T) teacher-forced after an
    admission (``prefilled`` or ``chunk_prefilled`` output): the first
    logits, then T-1 decode steps at M = slots.  (B, T, V), f32."""
    import torch
    r = engine.runner
    cache, tables, pos, first = admitted
    rows = [first]
    for t in range(seq.shape[1] - 1):
        lg, cache = r.model.decode_paged(r.params, seq[:, t:t + 1], cache, pos + t, tables)
        rows.append(lg[:, 0])
    return torch.stack(rows, dim=1).float()


def teacher_forced_margins(engine, prompts, tokens):
    """Every emitted greedy token under teacher forcing on the served
    target's plain path (its prefill, then T=1 ``decode_paged`` steps at
    M = slots over ``tokens``): each token's margin, its row's largest
    logit less its own, as a (requests, tokens) tensor.  The plain engine's
    own tokens have margin 0."""
    import torch
    from repro_torch.forms import default_spec

    seq = torch.tensor([tokens[i] for i in range(len(prompts))], device="cuda")
    with torch.inference_mode(), default_spec(engine.runner.spec):
        logits = forced_logits(engine, prefilled(engine, prompts), seq)
        picked = logits.gather(2, seq[..., None].long())[..., 0]
        return (logits.amax(dim=-1) - picked).cpu()


def verify_shapes(gen, flush):
    """The verify's seven projections per layer at M = slots x (kk+1) = 8,
    12, 16 and 20 on bf16 x, through the route ``uses_tensor_cores`` picks:
    two launches equal bit for bit and held against the plain version
    within REL_TOL at every shape, then each timed beside the plain
    version, the bf16 ``torch.matmul`` of the pre-folded weight and the
    function's bound (bf16 x on uint8 codes: the tensor-core rate, whichever
    kernel serves it); summed per layer."""
    import torch
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.kernels.ref import ref_polarized_matmul_fast

    rows = []
    for M in VERIFY_M:
        tc = pm.uses_tensor_cores(torch.bfloat16, torch.uint8, "cuda", M)
        rec = {"M": M, "route": "tc" if tc else "f32", "kernel_ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0, "max_rel_err": 0.0}
        bound_by = set()
        for (K, N), calls in LAYER_SHAPES.items():
            x, mags, signs, scale = kernel_inputs(gen, M, K, N, x_dtype=torch.bfloat16)
            got = pm.polarized_matmul(x, mags, signs, scale, 8)
            again = pm.polarized_matmul(x, mags, signs, scale, 8)
            want = ref_polarized_matmul_fast(x, mags, signs, scale, 8)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"verify M={M} K={K} N={N}: two launches differ")
            abs_err = float((got - want).abs().max())
            rel_err = abs_err / float(want.abs().max())
            rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
            rec["max_rel_err"] = max(rec["max_rel_err"], rel_err)
            if not rel_err <= REL_TOL:
                raise AssertionError(f"verify M={M} K={K} N={N} ({rec['route']} route): the "
                                     f"kernel disagrees with its plain version by {rel_err}")
            wb = (mags.float() * signs.float().repeat_interleave(8, dim=0)).to(torch.bfloat16)
            rec["kernel_ms"] += calls * timed_ms(
                lambda: pm.polarized_matmul(x, mags, signs, scale, 8), flush)
            rec["plain_ms"] += calls * timed_ms(
                lambda: ref_polarized_matmul_fast(x, mags, signs, scale, 8), flush)
            rec["library_ms"] += calls * timed_ms(lambda: torch.matmul(x, wb), flush)
            b, by = bound_tc(M, K, N)
            rec["bound_ms"] += calls * b
            bound_by.add(by)
        rec["bound_by"] = bound_by.pop() if len(bound_by) == 1 else "mixed"
        emit("verify_shape", per="the 7 projections of one qwen2-1.5b layer, bf16 x", **rec)
        rows.append(rec)
    return rows


def phase_speculate(model, cfg, prompts, plain_engine, plain_tokens, trace=False):
    """Self-speculative serving of the slice's target (its compressed tree,
    4 slots, page 16) with a 4-bit FORMS draft on the target's fragments,
    full depth, K=4, adaptive K.  Checks: two greedy runs agree and pass
    the token rule (``token_rule``: a near-tie below the measured threshold
    of verify_threshold where they first part from the plain tokens, and
    every token within it under teacher forcing), the launches equal those
    reckoned from the round widths, one round runs with host syncs
    forbidden, a temperature run repeats from its seed, an int-grid draft
    (8 bits, every other layer) launches no FORMS kernel for the draft, and
    it and the dense slot cache pass the token rule; then the verify
    shapes, checked and timed; ``trace`` adds one traced speculative run.
    Returns the greedy run's launches and the verify rows."""
    import numpy as np
    import torch
    from repro_torch.forms import FormsSpec
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.serving.engine import Request, ServingEngine

    spec = FormsSpec(m=8, bits=8, rule="energy")
    tree = {k: v for k, v in plain_engine.params.items() if k != "head_cast"}
    per_call = 7 * cfg.num_layers
    n_new = 16
    common = dict(spec=spec, batch_slots=4, max_len=256, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServingEngine(model, tree, page_size=16, speculate=True, draft_k=SPEC_K,
                           draft_bits=4, draft_mode="forms", **common)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runner = engine.runner
    buckets = [runner.bucket_for(len(p)) for p in prompts]

    def expected(widths, draft_layers):
        """[f32, tensor-core] launches: two prefills per admission (the
        draft's only with FORMS draft layers), kk + 1 draft calls at M =
        slots and one verify at M = slots x (kk+1) per round."""
        out = [2 * n for n in route_split(per_call, buckets, 0, 4)] if draft_layers \
            else route_split(per_call, buckets, 0, 4)
        for kk in widths:
            out[0] += (kk + 1) * 7 * draft_layers
            out[pm.uses_tensor_cores(torch.bfloat16, torch.uint8, "cuda", 4 * (kk + 1))] += \
                per_call
        return out

    def serve(eng, temperature=0.0, seed=None):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new, temperature=temperature)
                for i, p in enumerate(prompts)]
        if seed is not None:
            eng.runner.generator.manual_seed(seed)
        widths0 = len(getattr(eng.runner, "round_widths", []))
        rounds0 = eng.scheduler.rounds
        tallies = ("drafted", "accepted", "emitted", "participations")
        tally0 = [getattr(eng.runner, k, 0) for k in tallies]
        reset_counts()
        t = time.perf_counter()
        results = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launch_counts()
        toks = {r.uid: r.tokens for r in results}
        for uid, tk in toks.items():
            if len(tk) != n_new or not all(0 <= v < cfg.vocab_size for v in tk):
                raise AssertionError(f"request {uid} returned {tk}")
        decode_ms = sum(r.decode_ms for r in results)
        emitted = sum(len(r.tokens) - 1 for r in results)
        drafted, accepted, yielded, slot_rounds = (getattr(eng.runner, k, 0) - t0
                                                   for k, t0 in zip(tallies, tally0))
        spec = {"acceptance": accepted / max(1, drafted),
                "tokens_per_round": yielded / max(1, slot_rounds)} if eng.speculative else {}
        return {"tokens": toks, "wall_s": wall, **spec,
                "wall_ms_per_token": wall * 1e3 / sum(len(r.tokens) for r in results),
                "decode_ms_per_token": decode_ms / emitted,
                "mean_prefill_ms": float(np.mean([r.prefill_ms for r in results])),
                "rounds": eng.scheduler.rounds - rounds0,
                "widths": list(getattr(eng.runner, "round_widths", []))[widths0:],
                "launches": {k: counts[k] for k in ("polarized_matmul", "polarized_matmul_tc")}}

    threshold, per_width = verify_threshold(engine, prompts, plain_tokens, (1, 2, 3, 4))

    def token_rule(eng, got, label):
        """The first divergence from the plain tokens lies at a near-tie, and
        every emitted token, teacher-forced on the target's plain path, lies
        within the threshold of its row's largest logit."""
        div = first_divergence(eng, prompts, plain_tokens, got)
        if div is not None and not div["top2_margin"] < threshold:
            raise AssertionError(f"{label}: a greedy token parted from the plain engine's "
                                 f"away from a near-tie: {div}, threshold {threshold}")
        margins = teacher_forced_margins(plain_engine, prompts, got)
        misses = int((margins > threshold).sum())
        if misses:
            raise AssertionError(f"{label}: {misses} of {margins.numel()} emitted tokens lie "
                                 f"more than {threshold} below their row's largest logit "
                                 f"under teacher forcing: {margins.tolist()}")
        return {"divergence": div, "teacher_forced_tokens": margins.numel(),
                "teacher_forced_misses": misses,
                "teacher_forced_max_margin": float(margins.max())}

    def check_launches(run, draft_layers, label):
        want = expected(run["widths"], draft_layers)
        got = [run["launches"]["polarized_matmul"], run["launches"]["polarized_matmul_tc"]]
        run["launches_expected"] = want
        if got != want:
            raise AssertionError(f"{label}: the kernels launched {got} times, the round widths "
                                 f"{run['widths']} give {want}")

    plain = [serve(plain_engine)]
    spec_runs = [serve(engine), serve(engine)]
    plain.append(serve(plain_engine))
    stats = engine.stats()["speculate"]
    if spec_runs[0]["tokens"] != spec_runs[1]["tokens"]:
        raise AssertionError("two greedy speculative runs gave other tokens")
    if any(p["tokens"] != plain_tokens for p in plain):
        raise AssertionError("the plain engine's tokens moved since the slice phase")
    for run in spec_runs:
        check_launches(run, cfg.num_layers, "speculate")
    plain_rule = token_rule(plain_engine, plain_tokens, "plain")
    spec_rule = token_rule(engine, spec_runs[0]["tokens"], "speculate")

    # one round with every host sync an error, on device inputs (idle
    # tables: every row goes to scratch)
    tok = torch.zeros((4,), dtype=torch.int32, device="cuda")
    tables = torch.zeros((4, engine.scheduler.n_tables), dtype=torch.int32, device="cuda")
    k_el = torch.full((4,), SPEC_K, dtype=torch.int32, device="cuda")
    temps = torch.zeros((4,), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, n_emit = runner.speculate_round(SPEC_K, tok, tok, tables, k_el, temps)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sync_free = {"grid_shape": list(out.shape), "counts": n_emit.tolist()}
    if list(out.shape) != [4, SPEC_K + 1] or not ((n_emit >= 1) & (n_emit <= SPEC_K + 1)).all():
        raise AssertionError(f"the sync-free round returned {sync_free}")

    if trace:
        profile_decode(engine, prompts, "profile_speculate")
    temp_runs = [serve(engine, temperature=1.0, seed=11), serve(engine, temperature=1.0, seed=11)]
    if temp_runs[0]["tokens"] != temp_runs[1]["tokens"]:
        raise AssertionError("two temperature runs from one seed gave other tokens")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    engine_bytes = engine.cache_bytes()
    del engine, runner
    torch.cuda.empty_cache()

    int_engine = ServingEngine(model, tree, page_size=16, speculate=True, draft_k=SPEC_K,
                               draft_bits=8, draft_mode="int", draft_layer_step=2, **common)
    int_run = serve(int_engine)
    int_layers = int_engine.runner.draft_model.config.num_layers
    int_stats = int_engine.stats()["speculate"]
    check_launches(int_run, 0, "int draft")
    int_rule = token_rule(int_engine, int_run["tokens"], "int draft")
    del int_engine
    torch.cuda.empty_cache()

    dense_engine = ServingEngine(model, tree, page_size=0, decode_block=4, **common)
    dense_run = serve(dense_engine)
    steps = dense_run["rounds"] * dense_engine.decode_block
    dense_want = route_split(per_call, buckets, steps, 4)
    dense_got = [dense_run["launches"]["polarized_matmul"],
                 dense_run["launches"]["polarized_matmul_tc"]]
    dense_rule = token_rule(dense_engine, dense_run["tokens"], "dense cache")
    dense_bytes = dense_engine.cache_bytes()
    del dense_engine
    torch.cuda.empty_cache()
    if dense_got != dense_want:
        raise AssertionError(f"the dense cache's run launched {dense_got}, expected {dense_want}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    shapes = verify_shapes(gen, lambda: scrub.zero_())
    del scrub

    def brief(run):
        return {k: v for k, v in run.items() if k != "tokens"}

    emit("speculate", arch=cfg.name, layers=cfg.num_layers, draft="forms, 4 bits, m=8, "
         "full depth", k=SPEC_K, adaptive_k=True, build_s=build_s,
         build_peak_mem_gb=build_peak_gb, peak_mem_gb=peak_gb, cache_bytes=engine_bytes,
         spec_stats=stats, threshold=threshold, threshold_per_width=per_width,
         tokens_equal_plain=spec_runs[0]["tokens"] == plain_tokens, token_rule=spec_rule,
         plain_token_rule=plain_rule,
         runs=[brief(r) for r in spec_runs], plain_runs=[brief(r) for r in plain],
         sync_free_round=sync_free,
         temperature_runs_equal=True, temperature_runs=[brief(r) for r in temp_runs],
         int_draft={"layers": int_layers, "bits": 8, "spec_stats": int_stats,
                    "tokens_equal_plain": int_run["tokens"] == plain_tokens,
                    "token_rule": int_rule, **brief(int_run)},
         dense_cache={"tokens_equal_plain": dense_run["tokens"] == plain_tokens,
                      "token_rule": dense_rule, "cache_bytes": dense_bytes,
                      "launches_expected": dense_want, **brief(dense_run)},
         tokens=spec_runs[0]["tokens"])
    return spec_runs[0]["launches"], shapes


# --------------------------------------------------------------------------
# the fleet phase: the SLO fleet scheduler under the seeded open-loop load
# --------------------------------------------------------------------------

FLEET_TRACE = dict(n_requests=24, seed=0, prompt_len=(16, 64), out_len=(8, 16),
                   batch_frac=0.25, adversarial_len=192, adversarial_count=2, temperature=0.0)
FLEET_LOAD = 0.8            # the open-loop rate, as a share of the measured capacity
FLEET_SPEC_REQUESTS = 8     # requests of the trace served by the speculative fleet
RESUME_AT = 8               # the resume point of the threshold's resumed path


def chunk_prefilled(engine, prompts, chunk: int = 32):
    """As :func:`prefilled`, but the prompts admitted together in chunks of
    ``chunk`` tokens, one multi-token ``decode_paged`` over all slots per
    round at the fleet's pow2 widths (M = slots x width): (cache, tables,
    positions, each prompt's first-token logits)."""
    import torch
    from repro_torch.serving import kv_cache as KV

    r = engine.runner
    model, params, ps = r.model, r.params, r.page_size
    slots, n_tables = len(prompts), KV.pages_for(r.max_len, r.page_size)
    cache = model.init_paged_cache(slots * n_tables + 1, ps)
    tables = torch.arange(1, slots * n_tables + 1, dtype=torch.int32,
                          device="cuda").reshape(slots, n_tables)
    filled = [0] * slots
    first = [None] * slots
    while any(f < len(p) for f, p in zip(filled, prompts)):
        takes = [min(chunk, len(p) - f) for f, p in zip(filled, prompts)]
        width = r.chunk_width(max(takes))
        toks = torch.zeros((slots, width), dtype=torch.int32, device="cuda")
        live = torch.zeros((slots, 1), dtype=torch.int32, device="cuda")
        for s, (p, f, t) in enumerate(zip(prompts, filled, takes)):
            if t:
                toks[s, :t] = torch.as_tensor(p[f:f + t], device="cuda")
                live[s] = 1
        pos = torch.tensor(filled, dtype=torch.int32, device="cuda")
        logits, cache = model.decode_paged(params, toks, cache, pos, tables * live)
        for s, t in enumerate(takes):
            if t:
                filled[s] += t
                if filled[s] == len(prompts[s]):
                    first[s] = logits[s, t - 1]
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device="cuda")
    return cache, tables, pos, torch.stack(first)


def fleet_threshold(engine, prompts, tokens):
    """The largest |logit difference| between the plain path (bulk prefill,
    then T=1 decode over the plain greedy tokens) and the admissions the
    fleet makes instead: chunks of 32 (M = slots x width), and a resume
    that re-prefills prompt + the first RESUME_AT tokens, in bulk and in
    chunks.  Returns the worst and the worst per admission."""
    import torch
    from repro_torch.forms import default_spec

    seq = torch.tensor([tokens[i] for i in range(len(prompts))], device="cuda")
    per = {}
    with torch.inference_mode(), default_spec(engine.runner.spec):
        plain = forced_logits(engine, prefilled(engine, prompts), seq)
        per["chunked"] = float((forced_logits(engine, chunk_prefilled(engine, prompts), seq)
                                - plain).abs().max())
        resumed = [list(p) + tokens[i][:RESUME_AT] for i, p in enumerate(prompts)]
        for name, admit in (("resume_bulk", prefilled), ("resume_chunked", chunk_prefilled)):
            per[name] = float((forced_logits(engine, admit(engine, resumed), seq[:, RESUME_AT:])
                               - plain[:, RESUME_AT:]).abs().max())
    return max(per.values()), per


def forced_margins(engine, prompts, token_lists):
    """:func:`teacher_forced_margins` of requests of any lengths, four at a
    time (M = 4 slots, as the plain engine decodes); short ones are padded
    and the padding is not counted.  One tensor per request."""
    out = []
    for g in range(0, len(prompts), 4):
        ps = list(prompts[g:g + 4])
        ts = [list(t) for t in token_lists[g:g + 4]]
        n = len(ps)
        ps += [ps[0]] * (4 - n)
        ts += [ts[0]] * (4 - n)
        width = max(len(t) for t in ts)
        margins = teacher_forced_margins(engine, ps, [t + [t[-1]] * (width - len(t)) for t in ts])
        out += [margins[i, :len(ts[i])] for i in range(n)]
    return out


def fleet_rule(engine, reqs, want, got, threshold, label):
    """The token rule of the fleet runs, per request: ``got`` equals
    ``want`` (the plain engine's tokens), or first parts from it where the
    plain path's top-2 margin is below ``threshold``, and every token of
    ``got``, teacher-forced on the plain path, lies within ``threshold`` of
    its row's largest logit."""
    import torch
    by_uid = {r.uid: r for r in reqs}
    parted = [uid for uid in got if got[uid] != want[uid]]
    divergences = []
    for uid in parted:
        a, b = want[uid], got[uid]
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        if len(a) != len(b):
            raise AssertionError(f"{label}: request {uid} returned {len(b)} tokens, "
                                 f"the plain engine {len(a)}")
        top2 = torch.topk(target_logits(engine, list(by_uid[uid].prompt) + a[:i])[-1], 2).values
        div = {"uid": uid, "step": i, "want_token": a[i], "got_token": b[i],
               "top2_margin": float(top2[0] - top2[1])}
        divergences.append(div)
        if not div["top2_margin"] < threshold:
            raise AssertionError(f"{label}: a greedy token parted from the plain engine's away "
                                 f"from a near-tie: {div}, threshold {threshold}")
    misses, worst = 0, 0.0
    if parted:
        margins = forced_margins(engine, [by_uid[u].prompt for u in parted],
                                 [got[u] for u in parted])
        misses = sum(int((m > threshold).sum()) for m in margins)
        worst = max(float(m.max()) for m in margins)
        if misses:
            raise AssertionError(f"{label}: {misses} teacher-forced tokens lie more than "
                                 f"{threshold} below their row's largest logit")
    return {"requests": len(got), "parted": len(parted), "divergences": divergences,
            "teacher_forced_misses": misses, "teacher_forced_max_margin": worst}


def recorded(runner):
    """Record on ``runner`` the bulk prefill buckets and the decode rounds
    of the runs that follow (``runner.chunk_widths`` records the chunks)."""
    log = {"prefill_buckets": [], "decode_rounds": 0}
    prefill_slot, decode_round = runner.prefill_slot, runner.decode_round

    def rec_prefill(slot, prompt, *a, **k):
        log["prefill_buckets"].append(runner.bucket_for(len(prompt)))
        return prefill_slot(slot, prompt, *a, **k)

    def rec_round(*a, **k):
        log["decode_rounds"] += 1
        return decode_round(*a, **k)

    runner.prefill_slot, runner.decode_round = rec_prefill, rec_round
    return log


def fleet_reckoning(per_call, slots, decode_block, log, chunk_widths, round_widths=None):
    """[f32, tensor-core] launches of a fleet run, from what it recorded:
    a bulk prefill at M = bucket, a chunk at M = slots x width, a plain
    decode round of ``decode_block`` calls at M = slots.  On the
    speculative runner every admission and chunk runs twice (target and
    FORMS draft) and a round of width kk runs kk + 1 draft calls at M =
    slots and a verify at M = slots x (kk + 1)."""
    rows = log["prefill_buckets"] + [slots * w for w in chunk_widths]
    if round_widths is None:
        return route_split(per_call, rows, log["decode_rounds"] * decode_block, slots)
    admitted = route_split(2 * per_call, rows, 0, slots)
    rounds = route_split(per_call, [slots * (kk + 1) for kk in round_widths],
                         sum(kk + 1 for kk in round_widths), slots)
    return [a + b for a, b in zip(admitted, rounds)]


def phase_fleet(plain_engine, plain_tokens):
    """The SLO fleet scheduler on the slice-1 model and engine settings.
    Capacity: the trace with every arrival at 0 on the plain scheduler;
    then one open-loop trace at FLEET_LOAD of it served with bulk admission
    and with chunked prefill (SLOConfig defaults), a preemption case, and
    the speculative fleet with chunked admission.  Every request's tokens
    pass the token rule against the plain engine's, with the threshold
    measured here (``fleet_threshold``, plus ``verify_threshold`` for the
    speculative fleet); each run's launches equal the reckoning from its
    recorded prefills, chunk widths and rounds.  Returns the chunked run's
    launches and their reckoning."""
    import numpy as np
    import torch
    from repro_torch.forms import FormsSpec
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.loadgen import LoadGenConfig, generate
    from repro_torch.serving.sched import SLOConfig

    model, cfg = plain_engine.model, plain_engine.cfg
    spec = FormsSpec(m=8, bits=8, rule="energy")
    tree = {k: v for k, v in plain_engine.params.items() if k != "head_cast"}
    per_call = 7 * cfg.num_layers
    common = dict(spec=spec, page_size=16, batch_slots=4, max_len=256, decode_block=4,
                  device="cuda")
    prompts = slice_prompts(cfg)
    threshold, per_admission = fleet_threshold(plain_engine, prompts, plain_tokens)

    def trace(rate, zero_arrivals=False):
        reqs = generate(LoadGenConfig(vocab=cfg.vocab_size, rate=rate, **FLEET_TRACE))
        if zero_arrivals:
            reqs = [dataclasses.replace(r, arrival_s=0.0) for r in reqs]
        return reqs

    def serve(eng, reqs):
        log = recorded(eng.runner)
        widths0 = len(eng.runner.chunk_widths)
        rounds0 = len(getattr(eng.runner, "round_widths", []))
        if hasattr(eng.scheduler, "reset_slo_stats"):
            eng.scheduler.reset_slo_stats()
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        results = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launch_counts()
        del eng.runner.prefill_slot, eng.runner.decode_round      # drop the recorders
        toks = {r.uid: list(r.tokens) for r in results}
        want_len = {r.uid: r.max_new_tokens for r in reqs}
        for uid, tk in toks.items():
            if len(tk) != want_len[uid] or not all(0 <= v < cfg.vocab_size for v in tk):
                raise AssertionError(f"request {uid} returned {tk}")
        if set(toks) != set(want_len):
            raise AssertionError(f"requests {set(want_len) - set(toks)} never completed")
        chunks = list(eng.runner.chunk_widths)[widths0:]
        rounds = list(getattr(eng.runner, "round_widths", []))[rounds0:]
        want = fleet_reckoning(per_call, eng.slots, eng.decode_block, log, chunks,
                               rounds if eng.speculative else None)
        got = [counts["polarized_matmul"], counts["polarized_matmul_tc"]]
        rec = {"wall_s": wall, "requests": len(results),
               "tokens": sum(len(t) for t in toks.values()),
               "tok_s": sum(len(t) for t in toks.values()) / wall,
               "bulk_prefills": len(log["prefill_buckets"]), "chunk_widths": chunks,
               "decode_rounds": log["decode_rounds"], "launches": got,
               "launches_expected": want}
        if eng.speculative:
            rec["round_widths"] = rounds
        if "slo" in eng.stats():
            s = eng.stats()["slo"]
            rec["slo"] = {k: s[k] for k in ("ttft_ms", "inter_token_ms", "completed",
                                            "preemptions", "resumes", "deadline_misses",
                                            "chunked_prefill")}
            rec["slo"]["per_class"] = {
                c: {k: v[k] for k in ("ttft_ms", "inter_token_ms", "completed",
                                      "deadline_misses", "preemptions", "queue_peak")}
                for c, v in s["per_class"].items()}
        if got != want:
            raise AssertionError(f"the fleet run launched {got}, its recorded prefills, "
                                 f"chunks and rounds give {want}: {rec}")
        return toks, rec

    capacity_reqs = trace(1.0, zero_arrivals=True)
    plain_toks, capacity = serve(plain_engine, capacity_reqs)
    rate = FLEET_LOAD * capacity["requests"] / capacity["wall_s"]
    reqs = trace(rate)
    runs = {"capacity": capacity}
    toks = {}
    for name, slo in (("bulk", SLOConfig(prefill_chunk=0)), ("chunked", SLOConfig())):
        eng = ServingEngine(model, tree, slo=slo, **common)
        toks[name], runs[name] = serve(eng, reqs)
        runs[name]["token_rule"] = fleet_rule(plain_engine, reqs, plain_toks, toks[name],
                                              threshold, name)
        del eng
        torch.cuda.empty_cache()
    fleet_launches = (runs["chunked"]["launches"], runs["chunked"]["launches_expected"])

    # preemption: four batch requests fill the slots (12 decode rounds
    # each), an interactive one arrives 4 rounds in (a round's time from
    # the capacity run)
    round_s = capacity["wall_s"] / capacity["decode_rounds"]
    rng = np.random.RandomState(5)
    pre_reqs = [Request(uid=f"batch-{i}", prompt=p, max_new_tokens=48, priority="batch")
                for i, p in enumerate(prompts)]
    pre_reqs.append(Request(uid="interactive", prompt=rng.randint(0, cfg.vocab_size, 40),
                            max_new_tokens=16, priority="interactive", arrival_s=4 * round_s))
    pre_want, runs["preempt_plain"] = serve(plain_engine, pre_reqs)
    eng = ServingEngine(model, tree, slo=SLOConfig(), **common)
    pre_got, runs["preempt"] = serve(eng, pre_reqs)
    del eng
    torch.cuda.empty_cache()
    if runs["preempt"]["slo"]["preemptions"] < 1 or runs["preempt"]["slo"]["resumes"] < 1:
        raise AssertionError(f"the interactive arrival preempted nothing: {runs['preempt']}")
    runs["preempt"]["token_rule"] = fleet_rule(plain_engine, pre_reqs, pre_want, pre_got,
                                               threshold, "preempt")

    # the speculative fleet: chunked admission advances the draft's pool too
    eng = ServingEngine(model, tree, slo=SLOConfig(), speculate=True, draft_k=SPEC_K,
                        draft_bits=4, draft_mode="forms", **common)
    spec_threshold, _ = verify_threshold(eng, prompts, plain_tokens, (1, 2, 3, 4))
    spec_reqs = reqs[:FLEET_SPEC_REQUESTS]
    spec_got, runs["speculate"] = serve(eng, spec_reqs)
    runs["speculate"]["spec_stats"] = eng.stats()["speculate"]
    del eng
    torch.cuda.empty_cache()
    runs["speculate"]["token_rule"] = fleet_rule(
        plain_engine, spec_reqs, {r.uid: toks["chunked"][r.uid] for r in spec_reqs},
        spec_got, threshold + spec_threshold, "speculative fleet")
    emit("fleet", arch=cfg.name, layers=cfg.num_layers, trace=FLEET_TRACE,
         capacity_req_s=capacity["requests"] / capacity["wall_s"], rate_req_s=rate,
         prompt_lens=[len(r.prompt) for r in reqs], threshold=threshold,
         threshold_per_admission=per_admission, speculate_threshold=spec_threshold,
         runs=runs)
    return fleet_launches


# --------------------------------------------------------------------------
# the checkpoint phases: served checkpoints and checkpointed ADMM training
# --------------------------------------------------------------------------

CKPT_LAYERS = 2            # the training checkpoint's depth (full width)
CKPT_STEPS = 4             # run A's steps; run B saves after step 2


def dir_bytes(path) -> int:
    """Bytes of the files under ``path``."""
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*") if f.is_file())


def need_disk(path, nbytes: int) -> None:
    """Fail, never skip, when ``path`` has less than ``nbytes`` free."""
    free = shutil.disk_usage(path).free
    if free < nbytes:
        raise AssertionError(f"{path} has {free / 1e9:.1f} GB free, the checkpoint phase "
                             f"writes {nbytes / 1e9:.1f} GB")


def phase_checkpoint_serve(plain_engine, plain_tokens, root):
    """The slice-1 compressed serving tree (full depth) saved with its spec,
    read back through ``read_meta`` -> ``spec_from_meta`` -> a fresh init
    (seed 1) compressed as the template -> ``restore`` onto the card, and
    served: the greedy tokens equal ``phase_slice``'s exactly, the launches
    the route's reckoning."""
    import torch
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core import paths
    from repro_torch.forms import FormsSpec, compress_tree, spec_from_meta
    from repro_torch.serving.engine import Request, ServingEngine

    model, cfg = plain_engine.model, plain_engine.cfg
    spec = FormsSpec(m=8, bits=8, rule="energy")
    tree = {k: v for k, v in plain_engine.params.items() if k != "head_cast"}
    nbytes = sum(x.numel() * x.element_size() for x in ckpt.tree_leaves(tree))
    need_disk(root, int(1.2 * nbytes))
    path = str(pathlib.Path(root) / "serve")
    torch.cuda.synchronize()
    t = time.perf_counter()
    ckpt.save(path, tree, step=0, extra_meta=dataclasses.asdict(spec))
    save_s = time.perf_counter() - t
    disk = dir_bytes(path)
    spec2 = spec_from_meta(ckpt.read_meta(path)["extra"])
    with torch.inference_mode():
        template, _ = compress_tree(model.init(1), spec2)
    torch.cuda.synchronize()
    t = time.perf_counter()
    restored, _ = ckpt.restore(path, template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    del template
    equal = all(torch.equal(a, b) and a.dtype == b.dtype and a.device.type == "cuda"
                for a, b in zip(ckpt.tree_leaves(restored), ckpt.tree_leaves(tree)))
    engine = ServingEngine(model, restored, spec=spec2, page_size=16, batch_slots=4,
                           max_len=256, decode_block=4, device="cuda")
    prompts = slice_prompts(cfg)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)]
    rounds0 = engine.scheduler.rounds
    reset_counts()
    got = {r.uid: r.tokens for r in engine.run(reqs)}
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = [counts["polarized_matmul"], counts["polarized_matmul_tc"]]
    want = route_split(7 * cfg.num_layers, [engine.runner.bucket_for(len(p)) for p in prompts],
                       (engine.scheduler.rounds - rounds0) * engine.decode_block, 4)
    # the f32 tree this one compresses: the compressed leaves' dense bytes
    # and the leaves left dense (f32 already)
    f32_bytes = plain_engine.compression_report.bytes_dense + sum(
        x.numel() * x.element_size() for x in paths.leaves(tree) if isinstance(x, torch.Tensor))
    emit("checkpoint_serve", arch=cfg.name, layers=cfg.num_layers, spec=spec2 == spec,
         leaves=len(ckpt.tree_leaves(tree)), tree_bytes=nbytes, bytes_on_disk=disk,
         f32_tree_bytes=f32_bytes, save_ms=save_s * 1e3, restore_ms=restore_s * 1e3,
         save_gb_s=disk / save_s / 1e9, restore_gb_s=disk / restore_s / 1e9,
         restored_equal=equal, tokens_equal_slice=got == plain_tokens, launches=launches,
         launches_expected=want)
    del engine, restored
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError("the restored serving tree differs from the saved one")
    if got != plain_tokens:
        raise AssertionError(f"the restored tree served {got}, the slice {plain_tokens}")
    if launches != want:
        raise AssertionError(f"the restored tree's run launched {launches}, expected {want}")
    return launches


def fresh_z_updates(tcfg, first: int, last: int, had_signs: bool) -> int:
    """The fresh Z-updates (one polarization launch per stacked leaf) that
    steps first+1 .. last make: the first one ever, and every
    ``admm_sign_refresh_every``-th."""
    n = 0
    for s in range(first + 1, last + 1):
        if s % tcfg.admm_update_every:
            continue
        z = s // tcfg.admm_update_every
        if z % max(tcfg.admm_sign_refresh_every, 1) == 0 or not had_signs:
            n += 1
        had_signs = True
    return n


def phase_checkpoint(root):
    """Checkpointed ADMM training at full width, depth cut to CKPT_LAYERS,
    with the train phase's settings.  Run A takes CKPT_STEPS steps, twice
    (does a run repeat bit for bit on the card?); run B takes 2 steps, is
    saved by ``save_async`` after the step-2 Z-update (and by ``save_sync``
    for its time), restored into a fresh template (equal to the saved state
    bit for bit) and takes the rest.  B's final params must equal A's bit
    for bit when A repeats, else lie within A's own repeat difference.  The
    polarization kernel launches 7 times per fresh Z-update.  Then B's
    params are compressed, saved, restored and served: the tokens equal
    those of the same tree served from memory."""
    import torch
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    from repro_torch.forms import FormsSpec, compress_tree, spec_from_meta
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.training import train_loop

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=CKPT_LAYERS)
    model = build(cfg, device="cuda")
    tcfg = train_config(total_steps=CKPT_STEPS)
    ds = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                        global_batch=TRAIN["global_batch"], seed=0)
    batches = [lm_batch(ds, i, "cuda") for i in range(CKPT_STEPS)]

    def run(state, table, first, last):
        step = train_loop.make_train_step(model, tcfg, table)
        for i in range(first, last):
            state, _ = step(state, batches[i])
            state = train_loop.maybe_admm_update(state, table, tcfg, i + 1)
        torch.cuda.synchronize()
        return state

    def max_diff(a, b):
        return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))

    def run_a():
        state, table = train_loop.init_train_state(model, tcfg)
        reset_counts()
        state = run(state, table, 0, CKPT_STEPS)
        launches = launch_counts()["admm_polarize"]
        params = [x.clone() for x in ckpt.tree_leaves(state.params)]
        return params, launches

    a, a_launches = run_a()
    a2, _ = run_a()
    repeat_diff = max_diff(a, a2)
    deterministic = False
    if repeat_diff != 0.0:
        # a run that does not repeat: try PyTorch's deterministic kernels
        torch.use_deterministic_algorithms(True, warn_only=True)
        deterministic = True
        a, a_launches = run_a()
        a2, _ = run_a()
        repeat_diff = max_diff(a, a2)
    del a2

    state, table = train_loop.init_train_state(model, tcfg)
    reset_counts()
    state = run(state, table, 0, 2)
    b1_launches = launch_counts()["admm_polarize"]
    state_bytes = sum(x.numel() * x.element_size() for x in ckpt.tree_leaves(state)
                      if isinstance(x, torch.Tensor))
    need_disk(root, int(2.2 * state_bytes))
    # the synchronous save first (for its time): each save re-seeds the
    # state's generator, and the async one is restored below
    sync_path = str(pathlib.Path(root) / "train_sync")
    t = time.perf_counter()
    ckpt.save(sync_path, state, 2)
    sync_s = time.perf_counter() - t
    shutil.rmtree(sync_path)
    mgr = ckpt.CheckpointManager(str(pathlib.Path(root) / "train"), keep=1)
    t = time.perf_counter()
    mgr.save_async(state, 2)
    async_return_s = time.perf_counter() - t
    mgr.wait()
    async_s = time.perf_counter() - t
    disk = dir_bytes(mgr.path)
    saved = [x for x in ckpt.tree_leaves(state) if isinstance(x, torch.Tensor)]
    fresh, _ = train_loop.init_train_state(model, tcfg, seed=5)
    template = train_loop.restore_template(fresh, table, tcfg, 2)
    del fresh
    torch.cuda.synchronize()
    t = time.perf_counter()
    restored, start = mgr.restore_latest(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    del template
    got = [x for x in ckpt.tree_leaves(restored) if isinstance(x, torch.Tensor)]
    restored_equal = (start == 2 and len(got) == len(saved)
                      and all(x.dtype == y.dtype and x.device.type == "cuda"
                              and torch.equal(x, y) for x, y in zip(got, saved))
                      and restored.rng.initial_seed() == state.rng.initial_seed())
    del state, saved, got
    torch.cuda.empty_cache()
    reset_counts()
    restored = run(restored, table, 2, CKPT_STEPS)
    b2_launches = launch_counts()["admm_polarize"]
    resume_diff = max_diff(ckpt.tree_leaves(restored.params), a)
    if deterministic:
        torch.use_deterministic_algorithms(False)
    n_leaves = len(table)
    launches_want = {"a": n_leaves * fresh_z_updates(tcfg, 0, CKPT_STEPS, False),
                     "b_before_save": n_leaves * fresh_z_updates(tcfg, 0, 2, False),
                     "b_after_restore": n_leaves * fresh_z_updates(tcfg, 2, CKPT_STEPS, True)}
    launches_got = {"a": a_launches, "b_before_save": b1_launches,
                    "b_after_restore": b2_launches}

    # B's trained params compressed, saved, restored and served
    spec = FormsSpec(m=8, bits=8, rule="sum")
    with torch.inference_mode():
        tree, _ = compress_tree(restored.params, spec)
    del restored, a
    torch.cuda.empty_cache()
    spath = str(pathlib.Path(root) / "trained_serve")
    ckpt.save(spath, tree, CKPT_STEPS, extra_meta=dataclasses.asdict(spec))
    spec2 = spec_from_meta(ckpt.read_meta(spath)["extra"])
    with torch.inference_mode():
        template, _ = compress_tree(model.init(1), spec2)
    served, _ = ckpt.restore(spath, template)
    del template
    prompts = slice_prompts(cfg)

    def serve(t):
        eng = ServingEngine(model, t, spec=spec2, page_size=16, batch_slots=4, max_len=256,
                            decode_block=4, device="cuda")
        return {r.uid: r.tokens for r in eng.run(
            [Request(uid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)])}

    reset_counts()
    mem_tokens = serve(tree)
    serve_launches = launch_counts()
    disk_tokens = serve(served)
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "reduced": {"num_layers": CKPT_LAYERS},
           "steps": CKPT_STEPS, "seq_len": TRAIN["seq_len"],
           "global_batch": TRAIN["global_batch"], "state_bytes": state_bytes,
           "bytes_on_disk": disk, "async_save_return_ms": async_return_s * 1e3,
           "async_save_ms": async_s * 1e3, "sync_save_ms": sync_s * 1e3,
           "restore_ms": restore_s * 1e3, "sync_save_gb_s": disk / sync_s / 1e9,
           "async_save_gb_s": disk / async_s / 1e9, "restore_gb_s": disk / restore_s / 1e9,
           "restored_equal": restored_equal, "deterministic_algorithms": deterministic,
           "repeat_max_diff": repeat_diff, "resume_max_diff": resume_diff,
           "admm_polarize_launches": launches_got,
           "admm_polarize_launches_expected": launches_want,
           "trained_served_tokens_equal": mem_tokens == disk_tokens,
           "trained_serve_launches": {k: v for k, v in serve_launches.items() if v}}
    emit("checkpoint", **rec)
    shutil.rmtree(spath)
    if not restored_equal:
        raise AssertionError("the restored train state differs from the saved one")
    if not resume_diff <= repeat_diff:
        raise AssertionError(f"the resumed run ends {resume_diff} from run A, whose own "
                             f"repeat differs by {repeat_diff}")
    if launches_got != launches_want:
        raise AssertionError(f"the polarization kernel launched {launches_got}, the fresh "
                             f"Z-updates give {launches_want}")
    if mem_tokens != disk_tokens:
        raise AssertionError(f"the restored trained tree served {disk_tokens}, from memory "
                             f"{mem_tokens}")
    return launches_got["a"] + launches_got["b_before_save"] + launches_got["b_after_restore"]


def phase_zero_skip():
    """Full-width qwen2-1.5b with ReLU and 50% fragment sparsity, compressed
    once and served with zero_skip off, block and compact (in the order
    off, block, compact, compact, block, off), then once more in block mode
    with the sparsity meter on.  Returns the compressed tree, the prompts
    and the skip kernels' launches in the first block run (the f32 kernel's
    at decode, the tensor-core kernel's at prefill)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.forms import FormsSpec, compress_tree, default_spec
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.kernels import sparsity
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), **SPARSE)
    model = build(cfg, device="cuda")
    spec = FormsSpec(m=8, bits=8, rule="energy")
    with torch.inference_mode():
        tree, rep = compress_tree(model.init(0), spec)
    prompts = slice_prompts(cfg)
    n_new = 16
    per_call = 7 * cfg.num_layers
    engines = {mode: ServingEngine(model, tree, spec=spec, zero_skip=mode.split("+")[0],
                                   zero_skip_keep=0.5, zero_skip_stats=mode.endswith("+stats"),
                                   page_size=16, batch_slots=4, max_len=256, decode_block=4,
                                   device="cuda")
               for mode in ("off", "block", "compact", "block+stats")}
    tile_mask = pm._tile_mask
    dead = {}

    def count(key, n_dead, n):
        dead[key] = dead.get(key, 0) + n_dead
        dead[key + "_of"] = dead.get(key + "_of", 0) + n

    def counting_mask(x, bm):
        """The skip wrappers' mask, also counting on the device the down
        projection's (K = d_ff) dead tiles (64-row tiles at prefill, 4-row
        ones at decode) and, at decode (M = the 4 slots), the batch-union
        dead share of m-row fragments and of 256-row slices, for the down
        projection and for every projection."""
        mask = tile_mask(x, bm)
        down = x.shape[1] == cfg.d_ff
        if down:
            count("tiles", (mask == 0).sum(), mask.numel())
        if x.shape[0] == DECODE_M:
            frags = (~sparsity.fragment_occupancy(x, spec.m)).sum()
            for key in ("all", "down") if down else ("all",):
                count("decode_fragments_" + key, frags, x.shape[1] // spec.m)
                count("decode_slices_" + key, (mask == 0).sum(), mask.numel())
        return mask

    def run(mode):
        engine = engines[mode]
        rounds0 = engine.scheduler.rounds
        reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
        if mode.endswith("+stats"):
            pm._tile_mask = counting_mask
        reset_counts()
        try:
            t = time.perf_counter()
            results = engine.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            pm._tile_mask = tile_mask
        counts = launch_counts()
        steps = (engine.scheduler.rounds - rounds0) * engine.decode_block
        calls = len(results) + steps
        want = route_split(per_call, [engine.runner.bucket_for(len(p)) for p in prompts],
                           steps, engine.slots)
        skips = [counts["polarized_matmul_skip"], counts["polarized_matmul_tc_skip"]]
        if mode.startswith("block") and (skips != want or counts["polarized_matmul"]
                                         or counts["polarized_matmul_tc"]):
            raise AssertionError(f"block mode did not run every projection through the "
                                 f"skip kernel: {counts}, {calls} model calls")
        return {"tokens": {r.uid: r.tokens for r in results}, "wall_s": wall,
                "decode_steps": steps, "model_calls": calls,
                "decode_step_ms": sum(r.decode_ms for r in results) / steps,
                "mean_prefill_ms": sum(r.prefill_ms for r in results) / len(results),
                "launches": counts}

    timed = {mode: [] for mode in engines}
    for mode in ("off", "block", "compact", "compact", "block", "off", "block+stats"):
        timed[mode].append(run(mode))
    runs = {mode: {"decode_step_ms": [r["decode_step_ms"] for r in rs],
                   "mean_prefill_ms": [r["mean_prefill_ms"] for r in rs],
                   "model_calls": rs[0]["model_calls"], "launches": rs[0]["launches"]}
            for mode, rs in timed.items()}
    sp = engines["block+stats"].stats()["sparsity"]
    runs["block+stats"].update(
        fragment_sparsity={t: v["fragment_sparsity"] for t, v in sp["layers"].items()},
        elem_sparsity={t: v["elem_sparsity"] for t, v in sp["layers"].items()},
        down_dead_tile_share=int(dead["tiles"]) / dead["tiles_of"],
        decode_dead_share={f"{unit}_{key}": int(dead[f"decode_{unit}_{key}"])
                           / dead[f"decode_{unit}_{key}_of"]
                           for unit in ("fragments", "slices") for key in ("down", "all")})
    runs["compact"]["sync_free_decode_call"] = sync_free_decode(model, engines["compact"])
    del engines
    torch.cuda.empty_cache()
    tokens = {mode: [r["tokens"] for r in rs] for mode, rs in timed.items()}
    off = tokens["off"][0]
    if any(t != off for t in tokens["off"] + tokens["block"] + tokens["block+stats"]):
        raise AssertionError("zero_skip='block' (or a second off run) changed the tokens")
    if tokens["compact"][0] != tokens["compact"][1]:
        raise AssertionError("two compact runs gave other tokens")
    block, compact = tokens["block"][0], tokens["compact"][0]
    for toks in off.values():
        if len(toks) != n_new or not all(0 <= v < cfg.vocab_size for v in toks):
            raise AssertionError(f"a request returned {toks}")
    same = sum(a == b for uid in off for a, b in zip(off[uid], compact[uid]))
    first = [(uid, next(i for i, (a, b) in enumerate(zip(off[uid], compact[uid])) if a != b))
             for uid in off if off[uid] != compact[uid]]
    divergence = None
    if first:   # the off model's top-2 logit margin where compact first differs
        uid, i = min(first, key=lambda u: u[1])
        seq = torch.tensor(list(prompts[uid]) + off[uid][:i], device="cuda")[None]
        with torch.inference_mode(), default_spec(spec):
            logits = model.forward(tree, {"tokens": seq})[0][0, -1].float()
        top2 = torch.topk(logits, 2).values
        divergence = {"uid": uid, "step": i, "off_token": off[uid][i],
                      "compact_token": compact[uid][i],
                      "top2_margin": float(top2[0] - top2[1]),
                      "gap_to_compact_token": float(logits[off[uid][i]]
                                                    - logits[compact[uid][i]])}
    emit("zero_skip", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         d_ff=cfg.d_ff, compression=rep.summary(),
         block_equals_off=block == off, compact_tokens_equal_off=same,
         tokens_total=sum(len(t) for t in off.values()), compact_divergence=divergence,
         runs=runs)
    return tree, cfg, prompts, runs["block"]["launches"]


def sync_free_decode(model, engine) -> dict:
    """One compact decode model call with every host sync an error: the
    fragment compaction's branch must stay on the device."""
    import torch
    from repro_torch.forms import default_spec

    r = engine.runner
    slots = engine.slots
    tok = torch.zeros((slots, 1), dtype=torch.int32, device="cuda")
    pos = torch.zeros((slots,), dtype=torch.int32, device="cuda")
    tables = torch.zeros((slots, engine.scheduler.n_tables), dtype=torch.int32, device="cuda")
    kernels = ("polarized_matmul", "polarized_matmul_tc")
    before = sum(launch_counts()[k] for k in kernels)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode(), default_spec(r.spec):
            logits, r.cache = model.decode_paged(r.params, tok, r.cache, pos, tables)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not torch.isfinite(logits).all():
        raise AssertionError("the compact decode call gave non-finite logits")
    return {"logits_shape": list(logits.shape),
            "polarized_matmul_launches": sum(launch_counts()[k] for k in kernels) - before}


def phase_fidelity(tree, cfg, prompts):
    """``forms.apply_simulated`` on layer 0's wq/wk/wv/gate/up at full
    width: the bit-serial kernel against its plain version, exactly, and
    the EIC statistics of the activations; then the kernel alone on the
    same M=64 operands, held exactly at ideal and 4-bit ADCs and timed.
    Returns the path's launches and the timed sums over the five leaves."""
    import torch
    from repro_torch.core.quantization import quantize_activations, slice_to_cells
    from repro_torch.core.zeroskip import eic_stats, fragment_eic
    from repro_torch.forms import FormsSpec, apply, apply_simulated
    from repro_torch.kernels.ref import ref_bitserial_crossbar
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import layer_params

    spec = FormsSpec(m=8, bits=8, input_bits=16)
    bp = layer_params(tree["blocks"], 0)
    toks = torch.tensor([int(t) for p in prompts for t in p[:16]], device="cuda")
    emb = L.embed_lookup(tree["embed"], toks, torch.float32)
    acts = {"attn": L.rmsnorm(emb, bp["norm1"], cfg.norm_eps),
            "mlp": L.rmsnorm(emb, bp["norm2"], cfg.norm_eps)}
    reset_counts()
    with torch.inference_mode():
        outs = {name: apply_simulated(bp[grp][name], acts[grp], spec)
                for grp, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                                  ("mlp", "gate"), ("mlp", "up"))}
    torch.cuda.synchronize()
    launches = launch_counts()["bitserial_crossbar"]
    recs = {}
    for grp, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("mlp", "gate"),
                      ("mlp", "up")):
        leaf, x = bp[grp][name], acts[grp]
        y, eic, x_scale = outs[name]
        codes, _ = quantize_activations(x, spec.input_bits)
        cells = slice_to_cells(leaf.mags, spec.quant)
        acc, _ = ref_bitserial_crossbar(codes, cells, leaf.signs, 8, 16, 2)
        want_y = acc.float() * x_scale * leaf.scale
        dense = apply(leaf, x.clamp(min=0.0))   # the simulator streams x >= 0 only
        st = eic_stats(codes, 8, 16)
        recs[name] = {"rows": x.shape[0], "K": leaf.k, "N": leaf.n,
                      "y_equal_plain": torch.equal(y, want_y),
                      "eic_equal_plain": torch.equal(eic, fragment_eic(codes, 8, 16)),
                      "rel_err_vs_float": float((y - dense).norm() / dense.norm()),
                      "mean_eic": st.mean_eic, "cycle_savings": st.savings}
        if not (recs[name]["y_equal_plain"] and recs[name]["eic_equal_plain"]):
            raise AssertionError(f"{name}: the bit-serial kernel disagrees: {recs[name]}")
    emit("fidelity", launches=launches, leaves=recs,
         mean_eic=sum(r["mean_eic"] for r in recs.values()) / len(recs),
         cycle_savings=sum(r["cycle_savings"] for r in recs.values()) / len(recs))
    if launches != len(recs):
        raise AssertionError(f"apply_simulated launched the kernel {launches} times")
    # the kernel alone on each leaf's operands as the path gives them (M=64,
    # 16-bit codes), timed, with the 4-bit ADC case held exactly too
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    timed = []
    for grp, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("mlp", "gate"),
                      ("mlp", "up")):
        leaf = bp[grp][name]
        codes, _ = quantize_activations(acts[grp], spec.input_bits)
        codes = codes.to(torch.int32)
        cells = slice_to_cells(leaf.mags, spec.quant).to(torch.uint8)
        for adc_bits in (None, 4):
            rec = bitserial_check(f"fidelity {name}", codes, cells, leaf.signs, adc_bits,
                                  mags=leaf.mags, time_it=adc_bits is None,
                                  flush=lambda: scrub.zero_())
            if adc_bits is None:
                timed.append(rec)
    row = {k: sum(r[k] for r in timed) for k in ("kernel_ms", "plain_ms", "library_ms",
                                                  "bound_ms")}
    emit("fidelity_kernel", rows=timed[0]["M"], leaves=[
        {k: r[k] for k in ("case", "K", "N", "grid", "mmas", "kernel_ms", "plain_ms",
                           "library_ms", "bound_ms", "bound_by")} for r in timed], **row)
    return launches, row


def polarize_bound(shape, m: int = 8):
    """Bytes: v read once, the projection written once, one f32 sign per
    fragment; operations: about five per element (the energy rule's square,
    add and compare, the keep test), at the f32 rate.  Bytes win by far."""
    n = 1
    for d in shape:
        n *= d
    nbytes = n * 4 + n * 4 + (n // m) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 5 * n / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_polarize():
    """Kernel #4 at the seven stacked full-width leaves, both rules: equal to
    the plain version bit for bit; times for the ``sum`` rule (the ADMM
    default); and a case with zero-sum fragments, -0.0 and NaN."""
    import torch
    from repro_torch.kernels.admm_polarize import admm_polarize
    from repro_torch.kernels.ref import ref_admm_polarize

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()
    rows = []

    def same(a, b):
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        return torch.equal(a.view(bits), b.view(bits))

    for path, shape in ADMM_LEAVES.items():
        v = torch.randn(shape, generator=gen, device="cuda")
        rec = {"leaf": path, "shape": list(shape)}
        for rule in ("sum", "energy"):
            out, signs = admm_polarize(v, m=8, rule=rule)
            want, want_s = ref_admm_polarize(v, 8, rule)
            torch.cuda.synchronize()
            rec[f"{rule}_equal"] = same(out, want) and torch.equal(signs, want_s)
            rec[f"{rule}_max_abs_err"] = max(float((out - want).abs().max()),
                                             float((signs - want_s).abs().max()))
            del out, signs, want, want_s
        rec["kernel_ms"] = timed_ms(lambda: admm_polarize(v, m=8, rule="sum"), flush, reps=10)
        rec["plain_ms"] = timed_ms(lambda: ref_admm_polarize(v, 8, "sum"), flush, reps=5)
        rec["bound_ms"], rec["bound_by"] = polarize_bound(shape)
        emit("polarize", **rec)
        if not (rec["sum_equal"] and rec["energy_equal"]):
            raise AssertionError(f"the polarization kernel disagrees with its plain version: {rec}")
        rows.append(rec)
        del v
        torch.cuda.empty_cache()
    # the comparisons as the reference writes them: a fragment summing to 0
    # elects +1, -0.0 is kept, a NaN elects -1 and is zeroed; f32 and bf16
    v = torch.randn((3, 64, 300), generator=gen, device="cuda")
    v[:, :8, 0] = torch.tensor([0.5, -0.5] * 4, device="cuda")
    v[:, :8, 1] = -0.0
    v[:, 9, 2] = float("nan")
    for dtype in (torch.float32, torch.bfloat16):
        for rule in ("sum", "energy"):
            x = v.to(dtype)
            out, signs = admm_polarize(x, m=8, rule=rule)
            want, want_s = ref_admm_polarize(x, 8, rule)
            torch.cuda.synchronize()
            rec = {"case": "edges", "dtype": str(dtype), "rule": rule,
                   "equal": same(out, want) and torch.equal(signs, want_s),
                   "zero_sum_sign": float(signs[0, 0, 0]),
                   "neg_zero_kept": bool(torch.signbit(out[0, :8, 1].float()).all()),
                   "nan_sign": float(signs[0, 1, 2]),
                   "nan_left": bool(torch.isnan(out).any())}
            emit("polarize", **rec)
            if not (rec["equal"] and rec["zero_sum_sign"] == 1.0 and rec["neg_zero_kept"]
                    and rec["nan_sign"] == -1.0 and not rec["nan_left"]):
                raise AssertionError(f"the polarization kernel's edge cases: {rec}")
    return rows


def train_config(**kw):
    from repro_torch.configs.base import TrainConfig
    base = dict(learning_rate=3e-4, warmup_steps=2, total_steps=100, remat=True,
                admm_enabled=True, admm_update_every=2, admm_sign_refresh_every=2)
    base.update(kw)
    return TrainConfig(**base)


def phase_train_small():
    """A reduced qwen2 (f32) trained two steps plus a fresh Z-update on the
    card (the kernel) and on the CPU (the plain versions) from the same
    params and batches: losses agree within 1e-4, every Z leaf polarized."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core import polarization as P
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    from repro_torch.models.registry import build
    from repro_torch.training import train_loop

    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), dtype="float32")
    tcfg = train_config(learning_rate=1e-3)
    params = build(cfg, device="cpu").init(0)
    ds = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    out = {}
    for dev in ("cpu", "cuda"):
        model = build(cfg, device=dev)
        # a copy per device: the optimizer updates the params in place
        state, table = train_loop.init_train_state(model, tcfg, params=_tree_to(params, dev))
        step = train_loop.make_train_step(model, tcfg, table)
        reset_counts()
        losses = []
        for i in range(2):
            state, metrics = step(state, lm_batch(ds, i, dev))
            state = train_loop.maybe_admm_update(state, table, tcfg, i + 1)
            losses.append(float(metrics["loss"]))
        polarized = all(bool(P.is_polarized(st.z[j], 8)) for st in state.admm.values()
                        for j in range(st.z.shape[0]))
        out[dev] = {"losses": losses, "polarized": polarized,
                    "launches": launch_counts()["admm_polarize"]}
    err = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"]["losses"], out["cpu"]["losses"]))
    emit("train_small", arch=cfg.name, runs=out, max_rel_loss_err=err)
    if not (err <= 1e-4 and out["cuda"]["polarized"] and out["cpu"]["polarized"]
            and out["cuda"]["launches"] == 7):
        raise AssertionError(f"the reduced train run on the card disagrees: {out}")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


def phase_train():
    """Full-width qwen2-1.5b through ``repro_torch.training``: 6 steps of
    ADMM training, then one traced step and one with host syncs forbidden.
    Returns the kernel's launches on the path and the Z-update times."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import paths
    from repro_torch.core import polarization as P
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    from repro_torch.models.registry import build
    from repro_torch.training import train_loop

    cfg = get_config("qwen2-1.5b")
    model = build(cfg, device="cuda")
    tcfg = train_config(total_steps=TRAIN["steps"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, table = train_loop.init_train_state(model, tcfg)
    step = train_loop.make_train_step(model, tcfg, table)
    ds = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                        global_batch=TRAIN["global_batch"], seed=0)
    batches = [lm_batch(ds, i, "cuda") for i in range(TRAIN["steps"] + 2)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tokens = TRAIN["seq_len"] * TRAIN["global_batch"]

    reset_counts()
    step_ms, z_ms, losses, gnorms = [], {}, [], []
    for i in range(TRAIN["steps"]):
        t = time.perf_counter()
        state, metrics = step(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(metrics["loss"])
        gnorms.append(metrics["grad_norm"])
        t = time.perf_counter()
        state = train_loop.maybe_admm_update(state, table, tcfg, i + 1)
        torch.cuda.synchronize()
        if (i + 1) % tcfg.admm_update_every == 0:
            z_ms[i + 1] = (time.perf_counter() - t) * 1e3
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    viol = {p: float(P.polarization_violation(st.z, 8).max()) for p, st in state.admm.items()}
    steady = step_ms[1:]
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": sum(
               t.numel() for t in paths.leaves(state.params)),
           "seq_len": TRAIN["seq_len"], "global_batch": TRAIN["global_batch"],
           "dtype": cfg.dtype, "remat": tcfg.remat, "moment_dtype": tcfg.moment_dtype,
           "setup_s": setup_s, "losses": losses, "grad_norms": [float(g) for g in gnorms],
           "step_ms": step_ms, "mean_step_ms_after_first": float(np.mean(steady)),
           "tokens_per_s": tokens / (float(np.mean(steady)) / 1e3),
           "z_update_ms": z_ms, "admm_polarize_launches": launches["admm_polarize"],
           "other_kernel_launches": {k: v for k, v in launches.items() if k != "admm_polarize"},
           "z_violation": viol, "peak_mem_gb": peak_gb}
    state, rec["profile"] = profile_train_step(step, state, batches[TRAIN["steps"]])
    rec["sync_free_step"] = sync_free_train_step(step, state, batches[TRAIN["steps"] + 1])
    emit("train", **rec)
    if not (11.5 <= losses[0] <= 13.0 and all(np.isfinite(losses))):
        raise AssertionError(f"train losses out of range: {losses}")
    if launches["admm_polarize"] != 14:
        raise AssertionError(f"the Z-updates launched the polarization kernel "
                             f"{launches['admm_polarize']} times, expected 14")
    if any(v != 0.0 for v in viol.values()):
        raise AssertionError(f"a Z leaf is not polarized: {viol}")
    return launches["admm_polarize"]


def profile_train_step(step, state, batch):
    """One train step under ``torch.profiler``; returns the new state and
    the step's device busy vs idle over its wall time, device time by
    kernel and host launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    dev_attr = ("self_device_time_total" if hasattr(ka[0], "self_device_time_total")
                else "self_cuda_time_total")
    kernels = sorted((e for e in ka if getattr(e, dev_attr) > 0
                      and str(e.device_type).endswith("CUDA")),
                     key=lambda e: -getattr(e, dev_attr))
    device_ms = sum(getattr(e, dev_attr) for e in kernels) / 1e3
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    host = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:10]
    return state, {
        "wall_ms": wall_ms, "device_busy_ms": device_ms,
        "device_idle_share": 1 - device_ms / wall_ms, "kernel_launches": launches,
        "top_device": [{"name": e.key[:80], "ms": getattr(e, dev_attr) / 1e3,
                        "count": e.count} for e in kernels[:15]],
        "top_host": [{"name": e.key[:80], "self_ms": e.self_cpu_time_total / 1e3,
                      "count": e.count} for e in host]}


def sync_free_train_step(step, state, batch) -> dict:
    """One train step with every host sync an error; nothing of its result
    is read inside."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"the sync-free step gave loss {loss}")
    return {"loss": loss, "host_enqueue_ms": enqueue_ms}


def profile_decode(engine, prompts, phase: str = "profile") -> None:
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
    # the two polarized-matmul kernels by name (the tensor-core one serves
    # the prefills, the f32 one the decode steps)
    pmm = {name: {"ms": sum(getattr(e, dev_attr) for e in kernels if name + "<" in e.key)
                  / 1e3, "count": sum(e.count for e in kernels if name + "<" in e.key)}
           for name in ("polarized_matmul_tc_kernel", "polarized_matmul_kernel")}
    emit(phase, wall_ms=wall_ms, device_busy_ms=device_ms,
         device_idle_share=1 - device_ms / wall_ms, kernel_launches=launches,
         polarized_matmul_device=pmm,
         top_device=[{"name": e.key[:80], "ms": getattr(e, dev_attr) / 1e3,
                      "count": e.count} for e in kernels[:15]],
         top_host=[{"name": e.key[:80], "self_ms": e.self_cpu_time_total / 1e3,
                    "count": e.count} for e in host])


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-speculate", action="store_true",
                    help="trace one more speculative run with torch.profiler")
    args = ap.parse_args()
    t_start = time.perf_counter()
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
    build.build(["polarized_matmul", "polarized_matmul_tc", "bitserial_crossbar",
                 "admm_polarize"])
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: v["ptxas"] for k, v in build.BUILD_LOG.items()})

    rows, worst_abs, worst_rel = phase_kernels()
    tc_rows, tc_abs, tc_rel, crossover, floor_ms = phase_kernels_tc()
    skip_rows, skip_bf16_rows, tc_skip_rows, skip_err = phase_skip()
    bit_rows, bit_adc4_rows = phase_bitserial()
    pol_rows = phase_polarize()
    small_launches = phase_small()
    phase_train_small()
    launches, slice_engine, slice_tokens = phase_slice()
    torch.cuda.empty_cache()
    spec_launches, verify_rows = phase_speculate(slice_engine.model, slice_engine.cfg,
                                                 slice_prompts(slice_engine.cfg), slice_engine,
                                                 slice_tokens, trace=args.trace_speculate)
    torch.cuda.empty_cache()
    fleet_launches = phase_fleet(slice_engine, slice_tokens)
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt_serve_launches = phase_checkpoint_serve(slice_engine, slice_tokens, ckpt_root)
        del slice_engine
        torch.cuda.empty_cache()
        tree, cfg, prompts, skip_launches = phase_zero_skip()
        bit_launches, fidelity_row = phase_fidelity(tree, cfg, prompts)
        del tree          # the serving trees go before the training state comes
        torch.cuda.empty_cache()
        pol_launches = phase_train()
        torch.cuda.empty_cache()
        ckpt_pol_launches = phase_checkpoint(ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    # the f32 kernels serve what the tensor-core route does not take (f32
    # activations, int32 codes): their path is the reduced f32 model's
    # prefill where the bf16 slice leaves them no launch
    small = "the reduced f32 qwen2's prefill on the card (phase small)"
    f32_path = {"polarized_matmul": (launches["polarized_matmul"], "the slice-1 run")
                if launches["polarized_matmul"] else (small_launches["polarized_matmul"], small),
                "polarized_matmul_skip": (skip_launches["polarized_matmul_skip"], "the block run")
                if skip_launches["polarized_matmul_skip"]
                else (small_launches["polarized_matmul_skip"], small)}
    if not (launches["polarized_matmul_tc"] and skip_launches["polarized_matmul_tc_skip"]
            and all(n for n, _ in f32_path.values()) and bit_launches and pol_launches
            and all(spec_launches.values()) and all(fleet_launches[0])
            and all(ckpt_serve_launches) and ckpt_pol_launches):
        raise AssertionError("a kernel of a path was never launched on it")

    def total(rows, key):
        return sum(r[key] for r in rows)

    def bound_by(rows):
        """What bounds the summed rows: their one answer, or "mixed"."""
        by = {r["bound_by"] for r in rows}
        return by.pop() if len(by) == 1 else "mixed"

    kernels = {"kernels": [{
        "name": "polarized_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/polarized_matmul.cu",
        "replaces": "src/repro/kernels/polarized_matmul.py:45",
        "launches": f32_path["polarized_matmul"][0],
        "launches_path": f32_path["polarized_matmul"][1],
        "max_abs_err": worst_abs, "max_rel_err": worst_rel,
        "ms": per_layer(rows, DECODE_M, "kernel_ms"),
        "plain_ms": per_layer(rows, DECODE_M, "plain_ms"),
        "bound_ms": per_layer(rows, DECODE_M, "bound_ms"),
        "bound_by": bound_by([r for r in rows if r["M"] == DECODE_M]),
        "library_ms": per_layer(rows, DECODE_M, "library_ms"),
        "bf16_x": {k: per_layer(rows, DECODE_M, "bf16_" + k)
                   for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "speculate_launches": spec_launches["polarized_matmul"],
        "fleet_launches": fleet_launches[0][0],
        "fleet_launches_expected": fleet_launches[1][0],
        "checkpoint_serve_launches": ckpt_serve_launches[0],
        "verify": [r for r in verify_rows if r["route"] == "f32"],
        "per": "the 7 projections of one qwen2-1.5b layer at M=4, f32 x (bf16_x: the same "
               "on bf16 x, widened in the kernel, as the served decode gives it; its "
               "library_ms is one bf16 torch.matmul with the pre-folded bf16 weight; "
               "verify: the speculative verify's M on bf16 x that this route takes); "
               "speculate_launches: the first greedy speculative run's; fleet_launches: "
               "the chunked fleet run's (expected: reckoned from its recorded prefills, "
               "chunk widths and rounds); checkpoint_serve_launches: the restored "
               "serving checkpoint's run",
    }, {
        "name": "polarized_matmul_skip", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/polarized_matmul.cu",
        "replaces": "src/repro/kernels/polarized_matmul.py:68",
        "launches": f32_path["polarized_matmul_skip"][0],
        "launches_path": f32_path["polarized_matmul_skip"][1],
        "max_abs_err": skip_err,
        "ms": per_layer(skip_rows, DECODE_M, "kernel_ms"),
        "plain_ms": per_layer(skip_rows, DECODE_M, "plain_ms"),
        "bound_ms": per_layer(skip_rows, DECODE_M, "bound_ms"),
        "bound_by": bound_by([r for r in skip_rows if r["M"] == DECODE_M]),
        "library_ms": per_layer(skip_rows, DECODE_M, "library_ms"),
        "bf16_x": {k: per_layer(skip_bf16_rows, DECODE_M, k) for k in
                   ("kernel_ms", "dense_ms", "plain_ms", "bound_ms", "library_ms")},
        "per": "the 7 projections of one qwen2-1.5b layer at M=4, f32 x, every other "
               "K slice of x zero (bf16_x: the same on bf16 x)",
    }, {
        "name": "bitserial_crossbar", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitserial_crossbar.cu",
        "replaces": "src/repro/kernels/bitserial_crossbar.py:43",
        "launches": bit_launches,
        "max_abs_err": max(r["max_abs_err"] for r in bit_rows + bit_adc4_rows),
        "ms": total(bit_rows, "kernel_ms"), "plain_ms": total(bit_rows, "plain_ms"),
        "bound_ms": total(bit_rows, "bound_ms"), "bound_by": bound_by(bit_rows),
        "library_ms": total(bit_rows, "library_ms"),
        "adc4_ms": total(bit_adc4_rows, "kernel_ms"),
        "adc4_plain_ms": total(bit_adc4_rows, "plain_ms"),
        "fidelity_m64": fidelity_row,
        "library_note": "one float64 torch.matmul of the codes and the signed "
                        "weights: the exact integer product of the ideal ADC",
        "per": "M=4 at 1536x1536, 1536x8960 and 8960x1536, 16-bit inputs, ideal ADC "
               "(adc4_ms: the same with a 4-bit ADC; fidelity_m64: the five leaves of "
               "the fidelity path at M=64, ideal ADC)",
    }, {
        "name": "admm_polarize", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/admm_polarize.cu",
        "replaces": "src/repro/kernels/admm_polarize.py:26",
        "launches": pol_launches,
        "checkpoint_launches": ckpt_pol_launches,
        "max_abs_err": max(max(r["sum_max_abs_err"], r["energy_max_abs_err"]) for r in pol_rows),
        "ms": total(pol_rows, "kernel_ms"), "plain_ms": total(pol_rows, "plain_ms"),
        "bound_ms": total(pol_rows, "bound_ms"), "bound_by": bound_by(pol_rows),
        "library_ms": None,
        "library_note": "no single PyTorch call elects a sign per fragment and zeroes "
                        "the entries that disagree with it",
        "per": "one fresh Z-update of qwen2-1.5b: its 7 stacked leaves (1.31 G f32 "
               "elements), m=8, sum rule; launches: the train run's; checkpoint_launches: "
               "the checkpoint phase's runs A, B before the save and B after the restore",
    }, {
        "name": "polarized_matmul_tc", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/polarized_matmul_tc.cu",
        "replaces": "src/repro/kernels/polarized_matmul.py:45 and :68 (bf16 x, uint8 "
                    "codes, M >= TC_MIN_ROWS)",
        "launches": launches["polarized_matmul_tc"],
        "skip_launches": skip_launches["polarized_matmul_tc_skip"],
        "speculate_launches": spec_launches["polarized_matmul_tc"],
        "fleet_launches": fleet_launches[0][1],
        "fleet_launches_expected": fleet_launches[1][1],
        "checkpoint_serve_launches": ckpt_serve_launches[1],
        "verify": [r for r in verify_rows if r["route"] == "tc"],
        "max_abs_err": tc_abs, "max_rel_err": tc_rel,
        "ms": per_layer(tc_rows, PREFILL_M, "kernel_ms"),
        "plain_ms": per_layer(tc_rows, PREFILL_M, "plain_ms"),
        "bound_ms": per_layer(tc_rows, PREFILL_M, "bound_ms"),
        "bound_by": bound_by([r for r in tc_rows if r["M"] == PREFILL_M]),
        "library_ms": per_layer(tc_rows, PREFILL_M, "library_ms"),
        "library_f32_ms": per_layer(tc_rows, PREFILL_M, "library_f32_ms"),
        "f32_kernel_ms": per_layer(rows, PREFILL_M, "kernel_ms"),
        "m32": {k: per_layer(tc_rows, 32, k) for k in
                ("kernel_ms", "plain_ms", "bound_ms", "library_ms", "library_f32_ms")},
        "skip_ms": per_layer(tc_skip_rows, PREFILL_M, "kernel_ms"),
        "skip_bound_ms": per_layer(tc_skip_rows, PREFILL_M, "bound_ms"),
        "crossover": [{k: r[k] for k in ("M", "tc_ms", "f32_ms", "f32_kernel_ms", "route")}
                      for r in crossover],
        "timing_floor_ms": floor_ms,
        "library_note": "library_ms: one bf16 torch.matmul of x and the pre-folded bf16 "
                        "weight; library_f32_ms: the f32 one (TF32 off); f32_kernel_ms: "
                        "polarized_matmul.cu on f32 x",
        "per": "the 7 projections of one qwen2-1.5b layer at prefill, M=64, bf16 x; "
               "launches: the slice-1 run's; skip_launches: the block run's; "
               "speculate_launches: the first greedy speculative run's; fleet_launches: "
               "the chunked fleet run's (chunks at M = 4 slots x width); "
               "checkpoint_serve_launches: the restored serving checkpoint's run; verify: "
               "the speculative verify's M that this route takes",
    }]}
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
