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
               M=64 (f32 x); then the tensor-core kernel on bf16 x at M=4,
               8, 16, 20, 32, 64 and 256 (called directly; through the route
               where it takes it) and a ragged shape (two launches equal bit
               for bit), timed per layer at each M beside the f32 and bf16
               library calls, its bf16 bound and its TB/s; whisper-small's
               cross k/v at M=1,024; the narrow-N row (both routes at M=64,
               N = 1-128, with the least N at which the tensor-core kernel
               wins: TC_MIN_COLS); the host microseconds per call of its
               wrapper and of its C entry; and the M crossover of the two
               kernels on bf16 x at M=1 to 64, with the least M at which the
               tensor-core kernel wins (TC_MIN_ROWS);
   kernel_bits — kernel #1 on 2-, 4- and 6-bit codes (the auto-bits
               widths, still uint8) on bf16 x, qwen2-1.5b's 7 projections:
               held against the plain version at every M the auto-bits path
               gives them (prefill buckets, decode, verify and calibration
               rows), timed per layer at M=4 and 64 beside the bf16 library
               call and the bound; every projection shape of
               h2o-danube-1.8b held at every M its served run gives it,
               qwen1.5-4b's and yi-9b's at M=4 and 64; the untied heads
               (K x N = 2560 x 32000, 2560 x 151936, 4096 x 64000, and
               qwen2's 1536 x 151936 for scale) held at M=1 and 4, timed at
               M=4;
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
7b. mesh    — the slice served through ``ServingEngine(mesh=...)`` on a
               world of one over NCCL (``launch/mesh.make_mesh``, data=1,
               model=1; NCCL takes one rank per card): the slice's tokens
               bit for bit and its launch counts, decode ms per step beside
               the plain engine's; kernels #1 and #2 (block mask) held and
               timed at every local shard shape that model = 2, 4 and 8
               give the slice's seven projections and its vocab-sharded
               head (N/tp columns, or Kp/tp rows for o/down), at M=4 and
               M=64 on bf16 x; while the world is up, mesh_speculate: the
               slice's tree saved and restored straight into its layout
               (``restore(shardings=params_shardings(...))``) and served
               with ``speculate=True`` at the speculate phase's settings
               beside a plain speculative engine, in turns: tokens bit for
               bit, #1/#2 launches equal, the drafts code for code, each
               draft's build seconds and peak device memory; and
               mesh_block: the slice served with ``zero_skip="block"`` on
               the mesh beside a plain block engine: the slice's tokens,
               every projection through the skip kernels as reckoned; then
               ``serve --forms --mesh data=1,model=1`` in a subprocess and
               its ``mesh:`` line;
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
10b. autobits — ``forms/autobits`` on the slice's full-width weights
               (FormsSpec(m=8, bits=8), AutoBitsConfig(), budget 0.05):
               Fisher and per-width compress / decompress ms, timed on their
               own; the sweep, whose one kernel is compress_tree's
               polarization (once per layer matrix and width), its launches
               reckoned; back-off rounds (from the measured NLLs that the
               validation's launches count), the plan's histogram,
               predicted and measured dNLL, the ReRAM ADC-event model's
               speedup (a model number, not card time), FLOP coverage, peak
               memory, the validation forwards' launches reckoned; the
               slice's requests on the mixed tree beside the uniform 8-bit
               tree (decode and prefill ms, launches reckoned), the
               launcher's parity block against the matched-budget uniform
               width, and the --auto-draft speculative run (acceptance,
               tokens per slot-round beside the uniform 4-bit draft's, the
               speculate phase's token rule, launches from the round widths);
10c. dense_configs — full-width h2o-danube-1.8b with --forms on the paged
               cache, the untied FORMS head at N = 32000: 4 requests of 16
               tokens with zero_skip off and block, equal tokens, launches
               reckoned (the head at M=1 per prefill, M=4 per decode step),
               decode and prefill ms;
10d. reliability — ``reliability/*`` on the slice's engine and tree
               (HealthConfig(probe_every=4)): zero-noise injection into the
               attention leaves (a cut of the whole tree, printed) under
               binary and vecom (the slice's tokens, every
               probe's drift exactly 0); stuck cells on two named leaves
               before the run (the first tick flags exactly those two, the
               repair's drift at most the threshold, the slice's tokens);
               a chaos fault at round 2 with probes every 2 rounds (every
               request completes, a repair logged); variation sigma=0.1,
               rho=0.6 on the same leaves, binary then vecom, without the
               monitor (codes changed and mean |dcode|, vecom below binary,
               greedy agreement reported); one stats_every line; each run's
               launches reckoned with its probes (M=8); probe ms, scan s,
               repair ms, each injection's s and the host's peak RSS;
10e. moe      — full-width olmoe-1b-7b (16 layers, 64 experts top-8,
               moe_d_ff 1024, vocab 50304, untied head; random weights from
               seed 0) compressed (one polarization per (layer, expert)
               matrix, reckoned) and served on the paged cache with
               exact-length prefill, the slice's requests twice (the same
               tokens): decode and prefill ms, launches reckoned (the
               router stays dense), peak memory; kernel #1 held at every
               (shape, M) of the run, timed at M=4; kernel #4 bit for bit
               at the expert, attention and head matrices, timed per
               (layer, expert);
10f. mla      — full-width deepseek-v3 (d_model 7168, 128 heads, MLA q_lora
               1536 / kv_lora 512, one shared and routed experts top-8 of
               moe_d_ff 2048, vocab 129280, untied head, MTP), depth cut to 4
               layers and routed experts to 16 (printed), compressed
               (polarizations reckoned) and served on the paged cache at
               exact length, the slice's requests twice (the same tokens),
               then on the dense slot cache: decode ms beside the step's
               byte bound, prefill ms, peak memory, launches reckoned (kv_up
               is rebuilt by the absorbed decode, not launched); with no
               token dropped, the engine's absorbed decode logits
               teacher-forced against the expanded forward; the tree served
               again through ``ServingEngine(mesh=...)`` on a world of one
               (mesh_mla: the plain engine's tokens, or a first parting at
               a near-tie below the bf16 check's logit difference, and its
               launches); #1 held at every (shape, M) of the run, timed at
               M=4; #4 bit for bit at each matrix shape, timed;
10g. whisper  — full-width whisper-small (12 + 12 layers, d_model 768,
               vocab 51865, tied head) compressed and served on the paged
               cache against the engine's zero encoder context, twice (the
               same tokens), launches reckoned (the cross k/v at M = slots x
               max_len on the tensor-core route); the model at f32: encode
               written into enc_out, prefill against stepwise decode, card
               against CPU; the tree on a world of one (mesh_whisper: the
               tokens exactly, the launches); #1 held at every (shape, M)
               of the run, #4 bit for bit at its shapes;
10g'. mesh_shards — #1 and #2 (every other K slice dead) held and timed
               at every local shard shape that model = 2, 4 and 8 give
               deepseek-v3's q_up, kv_up, wo and shared expert,
               whisper-small's attention, cross attention and MLP,
               xlstm-350m's N-split projections (the mLSTM's wi/wf at N = 2
               and 1, the sLSTM's on f32 x) and zamba2-2.7b's shared block,
               at M=4 and 64 on bf16 x, and whisper's cross k/v at M = 4 x
               256;
10h. xlstm    — full-width xlstm-350m (24 blocks: 21 mLSTM on the chunked
               linear recurrence, 3 sLSTM stepped token by token; d_model
               1024, vocab 50304, untied head), not cut, compressed (163
               polarizations reckoned) and served with page_size=16 asked
               for: the engine falls back to the dense slot cache (its
               O(1) state has no paged path), the slice's 4 prompts at
               exact length, twice (the same tokens): decode ms beside the
               step's byte bound (codes read once, the state read and
               written), prefill ms, peak memory, #1 launches reckoned from
               the config and the tree (163 per step; the sLSTM's inputs on
               f32 x take the f32 kernel at every M); the model at f32 on
               the same tree: prefill vs stepwise decode, card vs CPU, and
               forward at S=256 in two chunks vs one; #1 held at every
               (shape, M, x dtype), N = 4 (wi/wf) included, timed at M=4;
               #4 bit for bit at its three shapes, timed; the tree on a
               world of one (mesh_xlstm: the plain engine's tokens and
               launches, decode ms beside the plain engine's);
10i. zamba    — full-width zamba2-2.7b (54 Mamba2 blocks in 9 groups, the
               shared attention block after each; vocab 32000), not cut,
               served as xlstm (116 polarizations, 172 #1 launches per
               step; mesh_zamba as mesh_xlstm); the model check on the
               full-width model cut to 6 layers (one group); #1 and #4 held
               and timed at its six matrix shapes;
10j. cnn      — the paper's CNN pipeline (``launch/cnn_pipeline``): on
               ``tiny_cnn()`` at the reference's step counts (m=4), trained
               and evaluated on the card with ``tests/test_system.py``'s
               thresholds, each phase's ms and images/s, launches reckoned;
               then LeNet-5, VGG-16 and ResNet-18 at their published widths,
               not cut (random weights from seed 0, batch 64): 1 pretrain
               step, 2 ADMM SGD steps ending in one fresh Z-update (timed),
               project_hard, 1 fine-tune step; #4 bit for bit at every conv
               and FC matrix (sum rule, K padded), timed; compress_tree;
               the compressed forward against the decompressed one and, at
               batch 4, against the CPU; #1 held at every FC (shape, M),
               timed at M=64 beside the f32 torch.matmul and the bound;
               apply_simulated on every FC leaf, #3 exact and timed; the
               mean EIC and the paper's ReRAM model numbers (not card
               times);
10k. vlm      — full-width phi-3-vision-4.2b (32 layers, d_model 3072, MHA,
               vocab 32064, untied head), random weights from seed 0,
               compressed (225 polarizations reckoned) and served text-only
               on the paged cache with the slice's settings, twice (the same
               tokens), launches reckoned; the f32 model cut to 2 layers at
               full width: forward on 1,024 patch positions + 16 tokens,
               card vs CPU on the hidden states; #1 held at every (shape, M)
               of the run, timed at M=4;
11. zero_skip — the same model with ReLU and 50% fragment sparsity, one tree
               compressed once, served with zero_skip off, block and compact:
               block gives off's tokens through the skip kernel, compact's
               tokens are compared, one compact decode call runs with host
               syncs forbidden; the batch-union dead share of the decode
               activations (M=4) in m-row fragments and in 256-row slices;
12. fidelity — ``forms.apply_simulated`` on layer 0's wq/wk/wv/gate/up of
               that tree: the bit-serial kernel against its plain version,
               mean EIC and cycle savings; then the kernel alone on each
               leaf's M=64 operands, exact at ideal and 4-bit ADCs, timed; then
               the perfmodel line: the paper's ReRAM model (forms_throughput,
               table_v, fps_speedup) at the measured mean EIC beside the
               published Table V rows, model numbers and not card times;
13. polarize — the fragment-polarization kernel of the ADMM Z-update
               against its plain version at the seven stacked full-width
               qwen2-1.5b leaves, both sign rules, bit for bit (a case with
               zero-sum fragments, -0.0 and NaN too), with CUDA-event times
               of the kernel and the plain version beside the byte bound;
               and at the one-matrix calls compress_tree makes (energy rule,
               qwen2-1.5b's and h2o-danube-1.8b's matrices, its head too),
               bit for bit, timed per qwen2 layer;
14. train_small — a reduced qwen2 (f32) trained two steps plus one fresh
               Z-update on the card and on the CPU from the same params:
               losses agree, every Z leaf is polarized;
14b. train_moe — a reduced deepseek-v3 (MLA + MTP) and a reduced olmoe
               (f32), two steps each on the card and on the CPU: losses
               agree, and carry the load-balance and MTP terms;
14c. train_recurrent — reduced xlstm-350m and zamba2-2.7b (f32), two steps
               each on the card and on the CPU: losses agree;
15. train    — full-width qwen2-1.5b (random weights from a seed) trained
               through ``repro_torch.training`` with ADMM: 6 steps of 8 x
               256 tokens, Z-updates after steps 2 (fresh), 4 (fresh, sign
               refresh) and 6 (frozen); per-step ms, tokens/s, peak memory,
               Z-update ms, the kernel's launches (14) and every Z leaf's
               violation (0); one traced step and one step with host syncs
               forbidden;
15b. mesh_train — the train phase's first 4 steps through the same step
               over a live mesh (``make_train_step(ctx=)``, the state placed
               with ``fsdp=True`` specs) on a world of one over NCCL: losses and
               gradient norms equal to the train phase's within 1e-6
               relative, the kernel's launches equal, every Z leaf's
               violation 0; kernel #4 at one local shard of each stacked
               leaf under ``params_shardings(fsdp=True)`` at data x model =
               2x2, 4x2 and 8x1, every shard's output, signs and quantized
               Z (the column scale max-reduced over the shards that split
               K) equal to the whole leaf's slice bit for bit, timed beside
               the byte bound and the launch floor; then ``train --reduced
               --mesh-data 1 --mesh-model 1`` and its ``mesh:`` line;
15b'. mesh_train_whisper, mesh_train_mla, mesh_train_xlstm,
               mesh_train_zamba — full-width whisper-small and xlstm-350m,
               deepseek-v3 and zamba2-2.7b (int8 moments: full width) at
               the deepest cut whose state, gradients and step transients
               (reckoned on fake tensors) leave ~10 GB of the card
               (printed): 2 ADMM steps (a fresh Z-update after
               each) plain and through the sharded step on a world of one,
               under deterministic algorithms, equal bit for bit (losses,
               gradient norms, every param and Z leaf's sum), #4 launched
               once per constrained leaf per Z-update in both; #4 bit for
               bit at every training shard of their stacked leaves at
               2x2, 4x2 and 8x1, timed;
15c. dryrun  — the dry run's analysis held against the card: full-width
               qwen2-1.5b on a world of one (data=1, model=1), a decode step
               at batch 16 on an 8,192-token cache, a prefill at 1 x 8,192
               and a train step at 8 x 1,024 (f32 moments), each built and
               traced on fake CUDA tensors by ``launch/dryrun``'s own
               functions (the card's allocation unchanged), then run on the
               card: FLOPs within 1% of the trace's, the inputs' bytes within
               1% of the argument bytes, the peak within 10% or 0.5 GB of the
               prediction, the step ms beside the roofline's (not gated);
               then ``dryrun --arch qwen2-1.5b --mesh single`` in this process
               (three production cells on fake CUDA tensors): no allocation,
               no kernel launch;
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
import gc
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
# the tensor-core kernel on bf16 x: held and timed per layer at these M
# (called directly, whichever route the M takes)
TC_TIMED_M = (4, 8, 16, 20, 32, 64, 256)
CROSSOVER_M = (1, 2, 4, 8, 16, 32, 64)
# the narrow-N row: both routes at M = 64 on xlstm-350m's K (its mLSTM
# wi/wf are 1024 x 4, and 1024 x 2 and x 1 on a 2- or 4-way model axis)
NARROW_K, NARROW_N = 1024, (1, 2, 4, 16, 32, 64, 128)
# whisper-small's cross k/v over 4 slots x max_len 256
WHISPER_KV = (1024, 768, 768)
# host time per call: this many calls after a synchronize
HOST_CALLS = 1000
# qwen2-1.5b projections per layer: (K, N) -> calls per layer
LAYER_SHAPES = {(1536, 1536): 2, (1536, 256): 2, (1536, 8960): 2, (8960, 1536): 1}
# the narrowest of them (k and v): every projection of a call of the
# slice's model takes the route this width takes
SLICE_COLS = min(N for _, N in LAYER_SHAPES)
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


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line of ``phase``; ``t_s`` is the script's seconds so far."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.perf_counter() - T_START, 3)}), flush=True)


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
        if not pm.uses_tensor_cores(xb.dtype, mags.dtype, "cuda", M, N):
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
    """The tensor-core kernel on bf16 x: held against the plain version
    within REL_TOL, two launches equal bit for bit, at every qwen2-1.5b
    projection at each of TC_TIMED_M (called directly) and timed there per
    layer beside the f32 and bf16 library calls and its bf16 bound; through
    the route at the M it takes (the route launches it) and at a ragged
    shape; whisper-small's cross k/v at M=1,024; the narrow-N row (both
    routes at M=64, N = 1 .. 128); the host microseconds per call of the
    wrapper and of the C entry alone (its tensor maps included).  Then the
    crossover: both kernels on bf16 x at M=1..64, summed per layer."""
    import torch
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.kernels.ref import ref_polarized_matmul_fast

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()
    rows = []
    worst_abs = worst_rel = 0.0
    route = pm.uses_tensor_cores

    def f32_route(fn):
        """``fn()`` with the route forced to the f32 kernel (patched here, as
        route_check does, not a flag)."""
        pm.uses_tensor_cores = lambda *args: False
        try:
            return fn()
        finally:
            pm.uses_tensor_cores = route

    def check(label, M, K, N, time_it=False, direct=False):
        nonlocal worst_abs, worst_rel
        x, mags, signs, scale = kernel_inputs(gen, M, K, N, x_dtype=torch.bfloat16)
        fn = pm.polarized_matmul_tc if direct else pm.polarized_matmul
        before = pm.polarized_matmul_tc.launches
        got = fn(x, mags, signs, scale, 8)
        again = fn(x, mags, signs, scale, 8)
        took = pm.polarized_matmul_tc.launches - before
        want = ref_polarized_matmul_fast(x, mags, signs, scale, 8)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{label} M={M} K={K} N={N}: two launches differ")
        if took != 2:
            raise AssertionError(f"{label} M={M} N={N}: the route launched the tensor-core "
                                 f"kernel {took} times for 2 calls")
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel_err)
        cluster = pm.tc_group(M, N, K, torch.cuda.get_device_properties(0).multi_processor_count)
        rec = {"case": label, "M": M, "K": K, "N": N, "x": "bfloat16",
               "route": "tc" if route(x.dtype, mags.dtype, "cuda", M, N) else "f32",
               "grid": [-(-N // pm._TC_BN), -(-M // pm.tc_tokens(M)), cluster],
               "cluster": cluster, "max_abs_err": abs_err, "max_rel_err": rel_err}
        if time_it:
            xf = x.float()
            w = mags.float() * signs.float().repeat_interleave(8, dim=0)
            wb = w.to(torch.bfloat16)   # exact: codes <= 255 and signs +-1
            rec["kernel_ms"] = timed_ms(lambda: pm.polarized_matmul_tc(x, mags, signs, scale, 8),
                                        flush)
            rec["plain_ms"] = timed_ms(lambda: ref_polarized_matmul_fast(x, mags, signs, scale, 8), flush)
            rec["library_f32_ms"] = timed_ms(lambda: torch.matmul(xf, w), flush)
            rec["library_ms"] = timed_ms(lambda: torch.matmul(x, wb), flush)
            rec["bound_ms"], rec["bound_by"] = bound_tc(M, K, N)
            nbytes = M * K * 2 + K * N + K // 8 * N + N * 4 + M * N * 4
            rec["tb_s"] = nbytes / rec["kernel_ms"] / 1e9
        emit("kernel_tc", **rec)
        if not rel_err <= REL_TOL:
            raise AssertionError(f"the tensor-core kernel disagrees with its plain version: {rec}")
        return rec

    for M in TC_TIMED_M:
        for (K, N) in LAYER_SHAPES:
            rows.append(check("qwen2-1.5b", M, K, N, time_it=True, direct=True))
            if route(torch.bfloat16, torch.uint8, "cuda", M, N):
                check("qwen2-1.5b, the route", M, K, N)
    check("ragged edges, prefill", 67, 264, 1030)
    whisper = check("whisper-small cross k/v", *WHISPER_KV, time_it=True)
    # the timing method's own floor: a spin kernel of 0 cycles, timed as
    # every kernel here is (every per-layer sum holds 7 of these)
    floor_ms = timed_ms(lambda: torch.cuda._sleep(0), flush)
    emit("timing_floor", ms=floor_ms)

    # the narrow-N row: each route at M = 64; TC_MIN_COLS is the least N at
    # which the tensor-core kernel is faster
    narrow = []
    for N in NARROW_N:
        x, mags, signs, scale = kernel_inputs(gen, PREFILL_M, NARROW_K, N, x_dtype=torch.bfloat16)
        want = ref_polarized_matmul_fast(x, mags, signs, scale, 8)
        for got in (pm.polarized_matmul_tc(x, mags, signs, scale, 8),
                    f32_route(lambda: pm.polarized_matmul(x, mags, signs, scale, 8))):
            if not float((got - want).abs().max()) <= REL_TOL * float(want.abs().max()):
                raise AssertionError(f"narrow N={N}: a route disagrees with the plain version")
        wb = (mags.float() * signs.float().repeat_interleave(8, dim=0)).to(torch.bfloat16)
        rec = {"M": PREFILL_M, "K": NARROW_K, "N": N,
               "tc_ms": timed_ms(lambda: pm.polarized_matmul_tc(x, mags, signs, scale, 8), flush),
               "f32_ms": f32_route(lambda: timed_ms(
                   lambda: pm.polarized_matmul(x, mags, signs, scale, 8), flush)),
               "library_ms": timed_ms(lambda: torch.matmul(x, wb), flush),
               "route": "tc" if route(x.dtype, mags.dtype, "cuda", PREFILL_M, N) else "f32"}
        emit("narrow_n", **rec)
        narrow.append(rec)
    wins = [r["N"] for r in narrow if r["tc_ms"] < r["f32_ms"]]
    emit("narrow_min_cols", measured=wins[0] if wins else None, TC_MIN_COLS=pm.TC_MIN_COLS)

    # host time per call, after a synchronize: the wrapper, and its C entry
    # alone with the arguments made once (the entry encodes three tensor
    # maps and launches)
    host = {}
    for M in (16, PREFILL_M):
        x, mags, signs, scale = kernel_inputs(gen, M, 1536, 1536, x_dtype=torch.bfloat16)
        y = torch.empty((M, 1536), device="cuda")
        entry = pm._tc_entry()
        args = [x.data_ptr(), mags.data_ptr(), signs.data_ptr(), scale.data_ptr(), None, None,
                y.data_ptr(), M, 1536, 1536, 8, 1, pm.tc_group(M, 1536, 1536, 132),
                torch.cuda.current_stream().cuda_stream]
        if entry(*args) != 0:
            raise AssertionError("the tensor-core C entry refused its launch")
        for name, call in (("wrapper_us", lambda: pm.polarized_matmul_tc(x, mags, signs, scale, 8)),
                           ("entry_us", lambda: entry(*args))):
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                call()
            host[f"M{M}_{name}"] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
            torch.cuda.synchronize()
    emit("tc_host", per="one call at 1536x1536, host clock over 1,000 calls after a "
                        "synchronize", **host)

    crossover = []
    for M in CROSSOVER_M:
        rec = {"M": M, "tc_ms": 0.0, "f32_ms": 0.0, "f32_kernel_ms": 0.0,
               "route": "tc" if route(torch.bfloat16, torch.uint8, "cuda", M, SLICE_COLS)
               else "f32"}
        for (K, N), calls in LAYER_SHAPES.items():
            x, mags, signs, scale = kernel_inputs(gen, M, K, N, x_dtype=torch.bfloat16)
            rec["tc_ms"] += calls * timed_ms(
                lambda: pm.polarized_matmul_tc(x, mags, signs, scale, 8), flush)
            # the f32 route on bf16 x (forced here at every M): one launch
            # that widens x in the kernel; f32_kernel_ms is the same kernel
            # on f32 x
            xf = x.float()
            rec["f32_ms"] += calls * f32_route(lambda: timed_ms(
                lambda: pm.polarized_matmul(x, mags, signs, scale, 8), flush))
            rec["f32_kernel_ms"] += calls * timed_ms(
                lambda: pm.polarized_matmul(xf, mags, signs, scale, 8), flush)
        emit("crossover", per="the 7 projections of one qwen2-1.5b layer, bf16 x", **rec)
        crossover.append(rec)
    # TC_MIN_ROWS is the least M at which the tensor-core route wins
    wins = [r["M"] for r in crossover if r["tc_ms"] < r["f32_ms"]]
    emit("crossover_min_rows", measured=wins[0] if wins else None, TC_MIN_ROWS=pm.TC_MIN_ROWS)
    return rows, worst_abs, worst_rel, crossover, floor_ms, {
        "whisper_m1024": whisper, "narrow_n": narrow, "host": host}


def route_split(per_call, prefill_rows, steps, slots, cols):
    """The launches a bf16 FORMS model's prefills (M = each prompt's bucket)
    and decode steps (M = slots) make on the [f32, tensor-core] kernels.
    ``cols`` is the narrowest output width of a call's projections: when it
    is at least TC_MIN_COLS, every projection of the call takes the route
    that M gives (a narrower one is reckoned apart, as the xlstm phase does)."""
    import torch
    from repro_torch.kernels import polarized_matmul as pm
    if cols < pm.TC_MIN_COLS:
        raise AssertionError(f"a projection of {cols} columns leaves the tensor cores at "
                             f"every M: reckon it apart")
    out = [0, 0]
    for M in prefill_rows + [slots] * steps:
        out[pm.uses_tensor_cores(torch.bfloat16, torch.uint8, "cuda", M, cols)] += per_call
    return out


def narrowest(tree) -> int:
    """The narrowest output width of a compressed tree's FORMS leaves."""
    from repro_torch.forms import compressed_paths
    return min(leaf.mags.shape[-1] for leaf in compressed_paths(tree).values())


def wide_route(cols):
    """``route(M, N=cols)``: 1 where bf16 x on uint8 codes at (M, N) takes
    the tensor-core kernel, else 0 (the [f32, tc] index), for a model whose
    narrowest projection has ``cols`` columns: at least TC_MIN_COLS, so that
    all of a call's projections route alike unless N is named."""
    import torch
    from repro_torch.kernels import polarized_matmul as pm
    if cols < pm.TC_MIN_COLS:
        raise AssertionError(f"a projection of {cols} columns leaves the tensor cores at "
                             f"every M: reckon it apart")
    return lambda M, N=cols: int(pm.uses_tensor_cores(torch.bfloat16, torch.uint8, "cuda",
                                                      M, N))


def bound_by(rows):
    """What bounds the summed rows: their one answer, or "mixed"."""
    by = {r["bound_by"] for r in rows}
    return by.pop() if len(by) == 1 else "mixed"


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


def run_timed(eng, reqs):
    """``eng.run(reqs)``, the device synchronized after it: the results, the
    wall seconds, and the host ms of the run's decode rounds, the wall less
    the requests' prefills (``Result.prefill_ms``)."""
    import torch
    t = time.perf_counter()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return results, wall, wall * 1e3 - sum(r.prefill_ms for r in results)


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
        tc = pm.uses_tensor_cores(x_dtype, torch.uint8, "cuda", M, SLICE_COLS)
        counter = pm.polarized_matmul_tc_skip if tc else pm.polarized_matmul_skip
        bm = pm.tile_rows(M, tc)
        for (K, N) in LAYER_SHAPES:
            x0, mags, signs, scale = kernel_inputs(gen, M, K, N, x_dtype=x_dtype)
            for frac in (0.0, 0.5, 1.0):
                x = dead_slices(x0.clone(), frac)
                mask = pm.tile_mask(x, mags.dtype, N)
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
        results, wall, decode_ms = run_timed(engine, reqs)
        counts = launch_counts()
        launches = {k: counts[k] for k in ("polarized_matmul", "polarized_matmul_tc")}
        steps = (engine.scheduler.rounds - rounds0) * engine.decode_block
        return results, launches, len(results) + steps, wall, steps, decode_ms

    runs = [run() for _ in range(SLICE_RUNS)]
    tokens = [{r.uid: r.tokens for r in res} for res, *_ in runs]
    per_call = 7 * cfg.num_layers
    buckets = [engine.runner.bucket_for(len(p)) for p in prompts]
    for (results, launches, calls, wall, steps, _), toks in zip(runs, tokens):
        for uid, t in toks.items():
            if len(t) != n_new or not all(0 <= v < cfg.vocab_size for v in t):
                raise AssertionError(f"request {uid} returned {t}")
        f32, tc = route_split(per_call, buckets, steps, engine.slots, SLICE_COLS)
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
    for results, _, _, _, steps, decode_ms in runs:
        step_ms.append(decode_ms / steps)
        tok_s.append(sum(len(r.tokens) - 1 for r in results) / decode_ms * 1e3)
    results, launches, calls, wall, steps, _ = runs[-1]
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


# the local shard shapes of the slice's projections on a model axis of tp:
# (name, K, N, how the spec cuts it) -- q/k/v/gate/up and the tied head
# (vocab 151936) by columns, o/down by whole-fragment rows
SHARD_TP = (2, 4, 8)
SHARD_PROJ = (("q", 1536, 1536, "n"), ("k/v", 1536, 256, "n"), ("o", 1536, 1536, "k"),
              ("gate/up", 1536, 8960, "n"), ("down", 8960, 1536, "k"),
              ("head", 1536, 151936, "n"))


def held_skip(gen, M, K, N, flush, x_dtype=None):
    """Kernel #2 at (M, K, N) on bf16 x (or ``x_dtype``) with every other K
    slice dead: two launches equal bit for bit, equal to the dense launch,
    held against the plain version within REL_TOL, and timed beside it, the
    ``torch.matmul`` of the pre-folded weight in x's dtype and the bound."""
    import torch
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.kernels.ref import ref_polarized_matmul_skip

    x, mags, signs, scale = kernel_inputs(gen, M, K, N, x_dtype=x_dtype or torch.bfloat16)
    x = dead_slices(x, 0.5)
    tc = pm.uses_tensor_cores(x.dtype, mags.dtype, "cuda", M, N)
    bm = pm.tile_rows(M, tc)
    mask = pm.tile_mask(x, mags.dtype, N)
    got = pm.polarized_matmul_skip(x, mags, signs, scale, 8, mask=mask)
    again = pm.polarized_matmul_skip(x, mags, signs, scale, 8, mask=mask)
    dense = pm.polarized_matmul(x, mags, signs, scale, 8)
    want = ref_polarized_matmul_skip(x, mags, signs, scale, mask, 8, bm, pm._KC)
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rec = {"M": M, "K": K, "N": N, "x": str(x.dtype).removeprefix("torch."),
           "route": "tc" if tc else "f32",
           "max_abs_err": abs_err, "max_rel_err": abs_err / float(want.abs().max())}
    if not (torch.equal(got, again) and torch.equal(got, dense)):
        raise AssertionError(f"the skip launches differ (from each other or dense): {rec}")
    if not rec["max_rel_err"] <= REL_TOL:
        raise AssertionError(f"kernel #2 disagrees with its plain version: {rec}")
    wb = (mags.float() * signs.float().repeat_interleave(8, dim=0)).to(x.dtype)
    rec["kernel_ms"] = timed_ms(lambda: pm.polarized_matmul_skip(x, mags, signs, scale, 8,
                                                                 mask=mask), flush)
    rec["plain_ms"] = timed_ms(lambda: ref_polarized_matmul_skip(x, mags, signs, scale, mask,
                                                                 8, bm, pm._KC), flush)
    rec["library_ms"] = timed_ms(lambda: torch.matmul(x, wb), flush)
    if tc:
        rec["bound_ms"], rec["bound_by"] = bound_tc(M, K, N, live_rows=live_rows(mask, K))
    else:
        rec["bound_ms"], rec["bound_by"] = skip_bound(mask, M, K, N, 1,
                                                      x_bytes=x.element_size())
    return rec


def phase_mesh(plain_engine, plain_tokens):
    """Serving on a device mesh: the slice's tree served by
    ``ServingEngine(mesh=make_mesh(MeshConfig(data=1, model=1)))`` on a
    world of one over NCCL gives the plain engine's tokens and launches;
    kernels #1 and #2 held and timed at every local shard shape of
    ``SHARD_TP``; the launcher's mesh line.  Returns the mesh run's launches
    and the shard rows of #1 and #2."""
    import os
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import MeshConfig
    from repro_torch.forms import FormsSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = plain_engine.cfg
    prompts = slice_prompts(cfg)
    n_new = 16
    t0 = time.perf_counter()
    mesh = make_mesh(MeshConfig(data=1, model=1), device="cuda")
    init_s = time.perf_counter() - t0
    # the slice's compressed tree, shared (the served head copy is made again)
    params = {k: v for k, v in plain_engine.params.items() if k != "head_cast"}
    engine = ServingEngine(plain_engine.model, params, spec=FormsSpec(m=8, bits=8, rule="energy"),
                           page_size=16, batch_slots=4, max_len=256, decode_block=4,
                           device="cuda", mesh=mesh)

    def run(eng):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
        rounds0 = eng.scheduler.rounds
        reset_counts()
        results, _, decode_ms = run_timed(eng, reqs)
        counts = launch_counts()
        steps = (eng.scheduler.rounds - rounds0) * eng.decode_block
        return ({r.uid: r.tokens for r in results},
                {k: counts[k] for k in ("polarized_matmul", "polarized_matmul_tc")},
                decode_ms / steps)

    order = [("plain", plain_engine), ("mesh", engine), ("mesh", engine), ("plain", plain_engine)]
    got = [(name, *run(eng)) for name, eng in order]
    for name, toks, launches, _ in got:
        if toks != plain_tokens:
            raise AssertionError(f"the {name} engine's tokens differ from the slice's: "
                                 f"{toks} vs {plain_tokens}")
    mesh_launches = got[1][2]
    if any(g[2] != mesh_launches for g in got):
        raise AssertionError(f"launches differ between the plain and the mesh engine: {got}")
    per_call = 7 * cfg.num_layers
    buckets = [engine.runner.bucket_for(len(p)) for p in prompts]
    steps = engine.scheduler.rounds // 2 * engine.decode_block
    step_ms = {name: [g[3] for g in got if g[0] == name] for name in ("plain", "mesh")}
    del engine
    torch.cuda.empty_cache()
    new_runs = {"speculate": mesh_speculate(plain_engine, mesh, prompts),
                "block": mesh_block(plain_engine, mesh, prompts, plain_tokens)}
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = shard_rows("mesh_kernel", SHARD_PROJ, gen, lambda: scrub.zero_())

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2-1.5b", "--forms",
         "--mesh", "data=1,model=1", "--requests", "4", "--max-new-tokens", "8"],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(ROOT))
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("mesh: ")), None)
    want_line = "mesh: {'data': 1, 'model': 1} over 1 devices, 0 param leaves sharded"
    if proc.returncode != 0 or line != want_line:
        raise AssertionError(f"serve --mesh: rc {proc.returncode}, line {line!r}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    emit("mesh", arch=cfg.name, mesh={"data": 1, "model": 1}, backend="nccl",
         world=1, init_s=init_s, decode_steps=steps, decode_step_ms=step_ms,
         decode_step_ms_mean={k: float(np.mean(v)) for k, v in step_ms.items()},
         launches=mesh_launches,
         launches_expected=dict(zip(("polarized_matmul", "polarized_matmul_tc"),
                                    route_split(per_call, buckets, steps, 4, SLICE_COLS))),
         tokens_equal=True, serve_line=line, serve_s=time.perf_counter() - t0,
         nvidia_smi=nvidia_smi_line(),
         shard_rows={k: len(v) for k, v in rows.items()})
    return mesh_launches, rows, new_runs


def in_turns(plain, mesh, prompts):
    """``served`` runs of two engines in turns (plain, mesh, mesh, plain):
    ``{"plain": [run, run], "mesh": [run, run]}``, first runs first."""
    out = {"plain": [], "mesh": []}
    for name, eng in (("plain", plain), ("mesh", mesh), ("mesh", mesh), ("plain", plain)):
        out[name].append(served(eng, prompts))
    return out


def mesh_speculate(plain_engine, mesh, prompts):
    """Speculative serving on ``mesh`` from a tree restored straight into
    its layout: the slice's tree saved, restored with
    ``shardings=params_shardings(tree, ctx, fsdp=False)`` (every FORMS leaf
    placed) and served with ``speculate=True`` at the speculate phase's
    settings (4-bit FORMS draft, K=SPEC_K), beside a plain speculative
    engine on the same tree, in turns.  Both draft leaf by leaf, the mesh
    engine gathering and placing each leaf of the placed tree; on a world
    of one both give the same draft (checked code for code) and run the
    same kernels, so the greedy tokens of each pair of runs are equal bit
    for bit and so are the #1/#2 launches.  Each route's ``make_draft`` is
    timed alone, with the device's peak allocation over it.  Returns the
    mesh engine's first run's launches."""
    import torch
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.distributed import sharding as shd
    from repro_torch.forms import FormsSpec, compressed_paths
    from repro_torch.serving import speculate as SP
    from repro_torch.serving.engine import ServingEngine

    tree = {k: v for k, v in plain_engine.params.items() if k != "head_cast"}
    ctx = shd.ParallelContext.for_mesh(mesh)
    nbytes = sum(x.numel() * x.element_size() for x in ckpt.tree_leaves(tree))
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        need_disk(root, int(1.2 * nbytes))
        path = str(pathlib.Path(root) / "serve")
        t = time.perf_counter()
        ckpt.save(path, tree, step=0)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        restored, _ = ckpt.restore(path, tree,
                                   shardings=shd.params_shardings(tree, ctx, fsdp=False))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not shd.is_placed(restored):
        raise AssertionError("the restore with shardings gave a tree that is not placed")

    common = dict(spec=FormsSpec(m=8, bits=8, rule="energy"), page_size=16, batch_slots=4,
                  max_len=256, device="cuda", speculate=True, draft_k=SPEC_K, draft_bits=4,
                  draft_mode="forms")
    # each draft build alone, as the engines below make it: the restored
    # tree on the mesh's context (gathered and placed leaf by leaf), the
    # whole tree without one
    draft_cfg = SP.SpeculateConfig(k=SPEC_K, bits=4, mode="forms", fragment=8)
    builds = {}
    for name, params, on in (("mesh", restored, ctx), ("plain", tree, None)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        with torch.inference_mode():
            built = SP.make_draft(plain_engine.model, params, draft_cfg, ctx=on)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        builds[name] = {"seconds": time.perf_counter() - t, "allocated_before_gb": before / 1e9,
                        "peak_gb": peak / 1e9, "peak_over_before_gb": (peak - before) / 1e9}
        del built
    plain = ServingEngine(plain_engine.model, tree, **common)
    eng = ServingEngine(plain_engine.model, restored, **common, mesh=mesh)
    mine, theirs = (compressed_paths(e.runner.draft_params) for e in (eng, plain))
    draft_equal = mine.keys() == theirs.keys() and all(
        torch.equal(getattr(mine[k], f), getattr(theirs[k], f))
        for k in mine for f in ("mags", "signs", "scale"))
    runs = in_turns(plain, eng, prompts)
    keys = ("polarized_matmul", "polarized_matmul_tc")

    def brief(r):
        emitted = sum(len(x.tokens) - 1 for x in r["results"])
        return {"wall_s": r["wall_s"], "mean_prefill_ms": r["mean_prefill_ms"],
                "decode_ms_per_token": r["decode_ms"] / emitted,
                "launches": {k: r["counts"][k] for k in keys}}

    report = {name: [brief(r) for r in rs] for name, rs in runs.items()}
    emit("mesh_speculate", arch=plain_engine.cfg.name, mesh={"data": 1, "model": 1},
         draft="forms, 4 bits, m=8, full depth", k=SPEC_K, tree_bytes=nbytes,
         save_s=save_s, restore_s=restore_s, placed=True,
         draft_leaves=len(mine), draft_equal=draft_equal, draft_build=builds,
         runs=report, spec_stats=eng.stats()["speculate"],
         tokens_equal=all(r["tokens"] == runs["plain"][0]["tokens"]
                          for rs in runs.values() for r in rs),
         nvidia_smi=nvidia_smi_line())
    if not draft_equal:
        raise AssertionError("the draft built from the restored layout differs from the "
                             "plain engine's")
    for i in range(2):
        p, m = runs["plain"][i], runs["mesh"][i]
        if m["tokens"] != p["tokens"] or p["tokens"] != runs["plain"][0]["tokens"]:
            raise AssertionError(f"run {i}: the restored mesh engine's speculative tokens "
                                 f"{m['tokens']} differ from the plain one's {p['tokens']}")
        if report["mesh"][i]["launches"] != report["plain"][i]["launches"]:
            raise AssertionError(f"run {i}: launches differ: {report}")
    del eng, plain, restored
    torch.cuda.empty_cache()
    return report["mesh"][0]["launches"]


def mesh_block(plain_engine, mesh, prompts, plain_tokens):
    """The slice's tree served with ``zero_skip="block"`` on ``mesh`` and on
    a plain engine, in turns: every run gives the slice's plain tokens
    (block equals off at the same tiling) and runs every projection
    through the skip kernels, as many launches as the zero_skip phase's
    reckoning and the plain block engine's.  Returns the mesh engine's
    first run's skip launches."""
    import torch
    from repro_torch.forms import FormsSpec
    from repro_torch.serving.engine import ServingEngine

    cfg = plain_engine.cfg
    tree = {k: v for k, v in plain_engine.params.items() if k != "head_cast"}
    common = dict(spec=FormsSpec(m=8, bits=8, rule="energy"), zero_skip="block",
                  page_size=16, batch_slots=4, max_len=256, decode_block=4, device="cuda")
    plain = ServingEngine(plain_engine.model, tree, **common)
    eng = ServingEngine(plain_engine.model, tree, **common, mesh=mesh)
    runs = in_turns(plain, eng, prompts)
    keys = ("polarized_matmul_skip", "polarized_matmul_tc_skip")
    buckets = [eng.runner.bucket_for(len(p)) for p in prompts]
    report = {name: [{"wall_s": r["wall_s"], "decode_step_ms": r["decode_step_ms"],
                      "mean_prefill_ms": r["mean_prefill_ms"],
                      "launches": {k: r["counts"][k] for k in keys},
                      "launches_expected": dict(zip(keys, route_split(
                          7 * cfg.num_layers, buckets, r["decode_steps"], 4, SLICE_COLS))),
                      "dense_launches": r["counts"]["polarized_matmul"]
                      + r["counts"]["polarized_matmul_tc"]} for r in rs]
              for name, rs in runs.items()}
    emit("mesh_block", arch=cfg.name, mesh={"data": 1, "model": 1}, zero_skip="block",
         runs=report,
         tokens_equal_slice=all(r["tokens"] == plain_tokens for rs in runs.values() for r in rs),
         nvidia_smi=nvidia_smi_line())
    for name, rs in runs.items():
        for r, rep in zip(rs, report[name]):
            if r["tokens"] != plain_tokens:
                raise AssertionError(f"the {name} block engine served {r['tokens']}, the "
                                     f"slice {plain_tokens}")
            if rep["launches"] != rep["launches_expected"] or rep["dense_launches"]:
                raise AssertionError(f"the {name} block run did not launch as reckoned: {rep}")
    if [r["launches"] for r in report["mesh"]] != [r["launches"] for r in report["plain"]]:
        raise AssertionError(f"the mesh and plain block engines launched otherwise: {report}")
    del eng, plain
    torch.cuda.empty_cache()
    return report["mesh"][0]["launches"]


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
    12, 16 and 20 on bf16 x, through the route ``uses_tensor_cores`` picks
    (``layer_row``: held and timed, summed per layer)."""
    rows = []
    for M in VERIFY_M:
        rec = layer_row(gen, M, flush)
        emit("verify_shape", per="the 7 projections of one qwen2-1.5b layer, bf16 x", **rec)
        rows.append(rec)
    return rows


def spec_reckoning(per_call, buckets, widths, draft_layers, cols, slots=4):
    """[f32, tensor-core] launches of a speculative run: two prefills per
    admission (the draft's only with FORMS draft layers), kk + 1 draft calls
    at M = slots and one verify at M = slots x (kk+1) per round (``cols``:
    as route_split's)."""
    import torch
    from repro_torch.kernels import polarized_matmul as pm
    out = [2 * n for n in route_split(per_call, buckets, 0, slots, cols)] if draft_layers \
        else route_split(per_call, buckets, 0, slots, cols)
    for kk in widths:
        out[pm.uses_tensor_cores(torch.bfloat16, torch.uint8, "cuda", slots, cols)] += \
            (kk + 1) * 7 * draft_layers
        out[pm.uses_tensor_cores(torch.bfloat16, torch.uint8, "cuda", slots * (kk + 1),
                                 cols)] += per_call
    return out


def speculative_token_rule(plain_engine, eng, prompts, plain_tokens, got, threshold, label):
    """The first divergence of ``got`` from the plain tokens lies at a
    near-tie, and every emitted token, teacher-forced on the plain engine's
    path, lies within the threshold of its row's largest logit."""
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
        results, wall, decode_ms = run_timed(eng, reqs)
        counts = launch_counts()
        toks = {r.uid: r.tokens for r in results}
        for uid, tk in toks.items():
            if len(tk) != n_new or not all(0 <= v < cfg.vocab_size for v in tk):
                raise AssertionError(f"request {uid} returned {tk}")
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
        return speculative_token_rule(plain_engine, eng, prompts, plain_tokens, got,
                                      threshold, label)

    def check_launches(run, draft_layers, label):
        want = spec_reckoning(per_call, buckets, run["widths"], draft_layers, SLICE_COLS)
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
    dense_want = route_split(per_call, buckets, steps, 4, SLICE_COLS)
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
    uniform_draft = {k: spec_runs[0][k] for k in ("acceptance", "tokens_per_round",
                                                  "decode_ms_per_token")}
    return spec_runs[0]["launches"], shapes, uniform_draft


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


def fleet_reckoning(per_call, slots, decode_block, log, chunk_widths, round_widths=None,
                    cols=SLICE_COLS):
    """[f32, tensor-core] launches of a fleet run, from what it recorded:
    a bulk prefill at M = bucket, a chunk at M = slots x width, a plain
    decode round of ``decode_block`` calls at M = slots.  On the
    speculative runner every admission and chunk runs twice (target and
    FORMS draft) and a round of width kk runs kk + 1 draft calls at M =
    slots and a verify at M = slots x (kk + 1).  ``cols``: as route_split's
    (the fleet serves the slice's model)."""
    rows = log["prefill_buckets"] + [slots * w for w in chunk_widths]
    if round_widths is None:
        return route_split(per_call, rows, log["decode_rounds"] * decode_block, slots, cols)
    admitted = route_split(2 * per_call, rows, 0, slots, cols)
    rounds = route_split(per_call, [slots * (kk + 1) for kk in round_widths],
                         sum(kk + 1 for kk in round_widths), slots, cols)
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
        gc.collect()
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
                       (engine.scheduler.rounds - rounds0) * engine.decode_block, 4, SLICE_COLS)
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
            results, wall, decode_ms = run_timed(engine, reqs)
        finally:
            pm._tile_mask = tile_mask
        counts = launch_counts()
        steps = (engine.scheduler.rounds - rounds0) * engine.decode_block
        calls = len(results) + steps
        want = route_split(per_call, [engine.runner.bucket_for(len(p)) for p in prompts],
                           steps, engine.slots, narrowest(tree))
        skips = [counts["polarized_matmul_skip"], counts["polarized_matmul_tc_skip"]]
        if mode.startswith("block") and (skips != want or counts["polarized_matmul"]
                                         or counts["polarized_matmul_tc"]):
            raise AssertionError(f"block mode did not run every projection through the "
                                 f"skip kernel: {counts}, {calls} model calls")
        return {"tokens": {r.uid: r.tokens for r in results}, "wall_s": wall,
                "decode_steps": steps, "model_calls": calls,
                "decode_step_ms": decode_ms / steps,
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
    Returns the path's launches, the timed sums over the five leaves and
    the mean EIC."""
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
    mean_eic = sum(r["mean_eic"] for r in recs.values()) / len(recs)
    emit("fidelity", launches=launches, leaves=recs, mean_eic=mean_eic,
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
    return launches, row, mean_eic


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
    default); at the one-matrix calls that ``compress_tree`` makes (energy
    rule, one (K, N) layer matrix at a time) for qwen2-1.5b and
    h2o-danube-1.8b, its untied head included: bit for bit, timed per
    qwen2 layer; and a case with zero-sum fragments, -0.0 and NaN.  Returns
    the stacked rows and the per-layer row of the one-matrix calls."""
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
    # compress_tree's calls (forms.from_dense): one f32 layer matrix each
    matrix_rows = []
    for K, N in (list(LAYER_SHAPES) + list(DENSE_SHAPES[SERVED_ARCH])
                 + [(2560, 32000)]):
        v = torch.randn((K, N), generator=gen, device="cuda")
        out, signs = admm_polarize(v, m=8, rule="energy")
        want, want_s = ref_admm_polarize(v, 8, "energy")
        torch.cuda.synchronize()
        rec = {"K": K, "N": N, "equal": same(out, want) and torch.equal(signs, want_s)}
        if (K, N) in LAYER_SHAPES:
            rec["kernel_ms"] = timed_ms(lambda: admm_polarize(v, m=8, rule="energy"), flush)
            rec["plain_ms"] = timed_ms(lambda: ref_admm_polarize(v, 8, "energy"), flush,
                                       reps=5)
            rec["bound_ms"], rec["bound_by"] = polarize_bound((K, N))
        if not rec["equal"]:
            raise AssertionError(f"the polarization kernel disagrees at one matrix: {rec}")
        matrix_rows.append(rec)
        del v, out, signs, want, want_s
    timed = [r for r in matrix_rows if "kernel_ms" in r]
    matrix_row = {k: sum(r[k] * LAYER_SHAPES[(r["K"], r["N"])] for r in timed)
                  for k in ("kernel_ms", "plain_ms", "bound_ms")}
    matrix_row["bound_by"] = bound_by(timed)
    emit("polarize_matrix", rule="energy", held=[[r["K"], r["N"]] for r in matrix_rows],
         per="the 7 matrices of one qwen2-1.5b layer, one call each", **matrix_row)
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
    return rows, matrix_row


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
    step_ms, z_ms, losses, gnorms, pol_after = [], {}, [], [], []
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
        pol_after.append(launch_counts()["admm_polarize"])
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
    return launches["admm_polarize"], {"losses": losses,
                                       "grad_norms": [float(g) for g in gnorms],
                                       "polarize_after": pol_after, "step_ms": step_ms,
                                       "z_update_ms": z_ms, "peak_mem_gb": peak_gb}


# --------------------------------------------------------------------------
# sharded training on a device mesh
# --------------------------------------------------------------------------

MESH_TRAIN_STEPS = 4
# the (data, model) meshes whose local shards of the 7 stacked leaves kernel
# #4 is held and timed at
TRAIN_SHARD_MESHES = ((2, 2), (4, 2), (8, 1))


def shard_coords(spec, ctx):
    """Every coordinate dict of the axes a spec splits (one per shard)."""
    import itertools
    axes = [a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))]
    for combo in itertools.product(*(range(ctx.shape[a]) for a in axes)):
        yield dict(zip(axes, combo))


def train_shard_rows(gen, flush, floor_ms, leaves=ADMM_LEAVES, label="mesh_train_kernel"):
    """Kernel #4 (the fresh Z-update's sign election) at the local shards of
    the leaves ``leaves`` (path -> (L, K, N) stacked or (K, N); qwen2-1.5b's
    7 by default) under ``params_shardings(fsdp=True)`` at
    each mesh of ``TRAIN_SHARD_MESHES``: on every shard the kernel's output
    and signs equal the whole leaf's slice bit for bit, and the quantized Z
    with the column scale max-reduced over the shards that split K equals
    the whole leaf's Z slice bit for bit; one shard's launch timed."""
    import torch
    from repro_torch.core import quantization as Q
    from repro_torch.distributed.context import local_slice, padded_spec
    from repro_torch.distributed.sharding import ParallelContext, params_shardings
    from repro_torch.kernels.admm_polarize import admm_polarize

    spec = Q.QuantSpec(bits=8)
    rows = []
    for data, model in TRAIN_SHARD_MESHES:
        ctx = ParallelContext.for_shape({"data": data, "model": model})
        tree = {}
        for path, shape in leaves.items():
            *parents, name = path.split("/")
            node = tree
            for key in parents:
                node = node.setdefault(key, {})
            node[name] = torch.empty(shape, device="meta")
        specs = params_shardings(tree, ctx, fsdp=True)
        for path, shape in leaves.items():
            node = specs
            for key in path.split("/"):
                node = node[key]
            sp = padded_spec(node.spec, len(shape))
            v = torch.randn(shape, generator=gen, device="cuda")
            out, signs = admm_polarize(v, m=8, rule="sum")
            z = Q.project_quantize(out, spec, Q.scale_for(out, spec))
            coords = list(shard_coords(sp, ctx))
            pieces = [(c, local_slice(v, sp, ctx, c).contiguous()) for c in coords]
            outs = [(c, *admm_polarize(piece, m=8, rule="sum")) for c, piece in pieces]
            # the column max of every shard, reduced over those with the same
            # N slice (the ranks that split K)
            n_key = lambda c: tuple(c.get(a) for a in (sp[-1] if isinstance(  # noqa: E731
                sp[-1], tuple) else (sp[-1],)) if a is not None)
            amax = {}
            for c, o, _ in outs:
                m = o.abs().amax(dim=-2, keepdim=True)
                k = n_key(c)
                amax[k] = m if k not in amax else torch.maximum(amax[k], m)
            equal = True
            for c, o, sg in outs:
                zl = Q.project_quantize(o, spec, Q.scale_for(
                    o, spec, amax_reduce=lambda a, pc, k=n_key(c): amax[k]))
                sp_signs = sp[:-2] + (sp[-2], sp[-1])
                equal &= (torch.equal(o, local_slice(out, sp, ctx, c))
                          and torch.equal(sg, local_slice(signs, sp_signs, ctx, c))
                          and torch.equal(zl, local_slice(z, sp, ctx, c)))
            torch.cuda.synchronize()
            local = tuple(pieces[0][1].shape)
            first = pieces[0][1]
            rec = {"mesh": {"data": data, "model": model}, "leaf": path,
                   "spec": [list(e) if isinstance(e, tuple) else e for e in sp],
                   "local_shape": list(local), "shards": len(coords), "equal": bool(equal),
                   "kernel_ms": timed_ms(lambda: admm_polarize(first, m=8, rule="sum"), flush,
                                         reps=10),
                   "launch_floor_ms": floor_ms}
            rec["bound_ms"], rec["bound_by"] = polarize_bound(local)
            rows.append(rec)
            emit(label, **rec)
            if not equal:
                raise AssertionError(f"kernel #4 on a training shard differs from the whole "
                                     f"leaf's slice: {rec}")
            del v, out, signs, z, pieces, outs, amax
            torch.cuda.empty_cache()
    return rows


def phase_mesh_train(plain, floor_ms):
    """Sharded training on a device mesh: full-width qwen2-1.5b with the
    train phase's settings through ``make_train_step(ctx=)`` with the state
    placed by ``place_train_state`` (``fsdp=True`` specs) on
    ``make_mesh(MeshConfig(data=1, model=1))``, a world of one over NCCL
    (NCCL takes one rank per card: one card runs no collective).  The
    train phase runs the same step body on a world of one without a mesh,
    so this run holds the live mesh and the placement: its losses and
    gradient norms against the train phase's (same seed and batches) at
    1e-6 relative, kernel #4's launches (counted over this run) against the
    plain run's first steps, a Z violation of 0; #4 at the training shard shapes
    (:func:`train_shard_rows`); the launcher's ``mesh:`` line.  Returns the
    run's #4 launches and the shard rows."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MeshConfig
    from repro_torch.core import polarization as P
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build
    from repro_torch.training import train_loop

    cfg = get_config("qwen2-1.5b")
    model = build(cfg, device="cuda")
    tcfg = train_config(total_steps=TRAIN["steps"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = make_mesh(MeshConfig(data=1, model=1), device="cuda")
    ctx = shd.ParallelContext.for_mesh(mesh)
    state, table = train_loop.init_train_state(model, tcfg)
    state = shd.place_train_state(state, ctx, table)
    step = train_loop.make_train_step(model, tcfg, table, ctx=ctx)
    ds = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
                        global_batch=TRAIN["global_batch"], seed=0)
    batches = [lm_batch(ds, i, "cuda") for i in range(MESH_TRAIN_STEPS)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_counts()
    losses, gnorms, step_ms, z_ms = [], [], [], {}
    for i in range(MESH_TRAIN_STEPS):
        t = time.perf_counter()
        state, metrics = step(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        state = train_loop.maybe_admm_update(state, table, tcfg, i + 1, ctx)
        torch.cuda.synchronize()
        if (i + 1) % tcfg.admm_update_every == 0:
            z_ms[i + 1] = (time.perf_counter() - t) * 1e3
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    launches = launch_counts()["admm_polarize"]
    viol = {p: float(P.polarization_violation(st.z, 8).max()) for p, st in state.admm.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state, step
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    n = MESH_TRAIN_STEPS
    rel = [abs(a - b) / abs(b) for a, b in zip(losses + gnorms,
                                               plain["losses"][:n] + plain["grad_norms"][:n])]
    want_launches = plain["polarize_after"][n - 1]

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = train_shard_rows(gen, lambda: scrub.zero_(), floor_ms)

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-1.5b", "--reduced",
         "--steps", "4", "--admm", "--admm-every", "2", "--mesh-data", "1", "--mesh-model",
         "1"], capture_output=True, text=True, timeout=600, env=env, cwd=str(ROOT))
    lines = proc.stdout.splitlines()
    line = next((ln for ln in lines if ln.startswith("mesh: ")), None)
    want_line = "mesh: {'data': 1, 'model': 1} over 1 devices, 0 param leaves sharded"
    emit("mesh_train", arch=cfg.name, mesh={"data": 1, "model": 1}, backend="nccl", world=1,
         steps=n, seq_len=TRAIN["seq_len"], global_batch=TRAIN["global_batch"],
         setup_s=setup_s, losses=losses, grad_norms=gnorms,
         plain_losses=plain["losses"][:n], plain_grad_norms=plain["grad_norms"][:n],
         max_rel_diff=max(rel), step_ms=step_ms, plain_step_ms=plain["step_ms"][:n],
         mean_step_ms_after_first=sum(step_ms[1:]) / (n - 1),
         plain_mean_step_ms_after_first=sum(plain["step_ms"][1:n]) / (n - 1),
         z_update_ms=z_ms, plain_z_update_ms={k: v for k, v in plain["z_update_ms"].items()
                                              if k <= n},
         admm_polarize_launches=launches, admm_polarize_launches_plain=want_launches,
         z_violation=viol, peak_mem_gb=peak_gb, plain_peak_mem_gb=plain["peak_mem_gb"],
         launcher_line=line, launcher_last=lines[-2:] if lines else [],
         launcher_s=time.perf_counter() - t, shard_rows=len(rows),
         nvidia_smi=nvidia_smi_line())
    if max(rel) > 1e-6:
        raise AssertionError(f"the sharded step on a world of one differs from the plain "
                             f"step: {max(rel)} (losses {losses} vs {plain['losses'][:n]}, "
                             f"grad norms {gnorms} vs {plain['grad_norms'][:n]})")
    if launches != want_launches or not launches:
        raise AssertionError(f"the sharded run launched #4 {launches} times, the plain run "
                             f"{want_launches}")
    if any(v != 0.0 for v in viol.values()):
        raise AssertionError(f"a sharded Z leaf is not polarized: {viol}")
    if proc.returncode != 0 or line != want_line:
        raise AssertionError(f"train --mesh-data 1 --mesh-model 1: rc {proc.returncode}, "
                             f"line {line!r}\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return launches, rows


# --------------------------------------------------------------------------
# the dry run's analysis held against the card
# --------------------------------------------------------------------------

# qwen2-1.5b cells that fit one card: (kind, seq_len, batch)
DRYRUN_CELLS = (("decode", 8192, 16), ("prefill", 8192, 1), ("train", 1024, 8))
DRYRUN_REPS = 3


def _materialize(cell, gen):
    """Real tensors on the card for a cell's fake global arguments: zeros,
    the params drawn from ``gen`` (N(0, 0.02))."""
    import torch
    from repro_torch.core import paths
    from repro_torch.launch import dryrun as D
    args = D._map(cell.args, lambda t: torch.zeros(t.shape, dtype=t.dtype, device="cuda"))
    params = args[0].params if cell.names[0] == "state" else args[0]
    for leaf in paths.leaves(params):
        if leaf.is_floating_point():
            leaf.normal_(0.0, 0.02, generator=gen)
    return args


def phase_dryrun():
    """The dry run's analysis against the card: full-width qwen2-1.5b on a
    world of one (``data=1, model=1``), a decode step at batch 16 on an
    8,192-token cache, a prefill at 1 x 8,192 and a train step at 8 x 1,024
    (f32 moments, no ADMM).  Each cell is built and traced with the dry
    run's own functions on fake CUDA tensors, then the same step runs on
    the card: its ``FlopCounterMode`` FLOPs against the trace's (1%), the
    growth of ``memory_allocated`` as the inputs are placed against the
    argument bytes (1%), ``max_memory_allocated`` against the predicted
    peak (10% or 0.5 GB), the measured step ms beside the roofline's.  Then
    ``dryrun --arch qwen2-1.5b --mesh single`` (its three production cells,
    in this process): no allocation on the card and no kernel launch."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis import roofline as roof
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.context import RecordingContext
    from repro_torch.launch import dryrun as D
    from repro_torch.models.registry import build

    cfg = get_config("qwen2-1.5b")
    ctx = RecordingContext({"data": 1, "model": 1})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    smi = nvidia_smi_line()
    rows = []
    for kind, seq, batch in DRYRUN_CELLS:
        shape = ShapeConfig(f"{kind}_{batch}x{seq}", seq, batch, kind)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with D.fake_mode():
            cell = D.build_cell(build(cfg, device="cuda"), shape, ctx)
            trace = D.trace_step(cell, cell.place(), ctx)
        if torch.cuda.memory_allocated() != before:
            raise AssertionError(f"the fake trace of {shape.name} allocated on the card")
        report = roof.RooflineReport(
            arch=cfg.name, shape=shape.name, mesh="1x1", chips=1, kind=kind,
            hlo_flops_per_device=trace.cost.flops, hlo_bytes_per_device=trace.cost.bytes,
            collective_bytes_per_device=float(trace.cost.collectives.total_bytes),
            model_flops_global=roof.model_flops(kind, cfg.active_param_count(),
                                                batch * (seq if kind != "decode" else 1)),
            tokens_per_step=batch * (seq if kind != "decode" else 1))

        args = _materialize(cell, gen)
        torch.cuda.synchronize()
        arg_measured = torch.cuda.memory_allocated() - before
        local = cell.place(args)
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            out = cell.fn(*local)
        torch.cuda.synchronize()
        peak_measured = torch.cuda.max_memory_allocated() - before
        del out
        flops_measured = float(fc.get_total_flops())
        times = []
        for _ in range(DRYRUN_REPS):
            t = time.perf_counter()
            out = cell.fn(*local)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            del out
        del args, local
        predicted_peak = trace.argument_size + trace.temp_size
        step_ms = statistics.median(times)
        row = {"cell": shape.name, "kind": kind, "seq_len": seq, "batch": batch,
               "flops_traced": trace.cost.flops, "flops_card": flops_measured,
               "flops_rel_diff": abs(flops_measured - trace.cost.flops) / trace.cost.flops,
               "argument_bytes_traced": trace.argument_size,
               "argument_bytes_card": arg_measured,
               "argument_rel_diff": abs(arg_measured - trace.argument_size) / trace.argument_size,
               "peak_bytes_predicted": predicted_peak, "peak_bytes_card": peak_measured,
               "peak_error_bytes": predicted_peak - peak_measured,
               "peak_errs": "over" if predicted_peak > peak_measured else "under",
               "bytes_traced": trace.cost.bytes, "trace_s": trace.seconds,
               "roofline_step_ms": report.step_time_s * 1e3,
               "roofline_bottleneck": report.bottleneck, "step_ms": step_ms,
               "step_ms_all": times, "step_over_roofline": step_ms / (report.step_time_s * 1e3)}
        rows.append(row)
        emit("dryrun", nvidia_smi=smi, **row)
        if row["flops_rel_diff"] > 0.01:
            raise AssertionError(f"{shape.name}: the card's FLOPs {flops_measured} are not "
                                 f"within 1% of the trace's {trace.cost.flops}")
        if row["argument_rel_diff"] > 0.01:
            raise AssertionError(f"{shape.name}: the inputs took {arg_measured} bytes on the "
                                 f"card, the trace counts {trace.argument_size}")
        if abs(predicted_peak - peak_measured) > max(0.1 * peak_measured, 0.5e9):
            raise AssertionError(f"{shape.name}: predicted peak {predicted_peak} bytes, the "
                                 f"card's {peak_measured}")
        gc.collect()
        torch.cuda.empty_cache()

    # the CLI's qwen2-1.5b cells on the production mesh, in this process
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    reset_counts()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    try:
        t = time.perf_counter()
        D.main(["--arch", "qwen2-1.5b", "--mesh", "single", "--out", out_dir])
        cli_s = time.perf_counter() - t
        cells = {}
        for path in sorted(pathlib.Path(out_dir).glob("*.json")):
            d = json.loads(path.read_text())
            cells[d["shape"]] = {"status": d["status"], "traced_device": d["traced_device"],
                                 "flops": d["cost_analysis"]["flops"],
                                 "bytes": d["cost_analysis"]["bytes_accessed"],
                                 "collective_bytes": d["collectives"]["total_bytes"],
                                 "argument_size": d["memory_analysis"]["argument_size"],
                                 "temp_size": d["memory_analysis"]["temp_size"],
                                 "step_ms": d["roofline"]["step_time_s"] * 1e3,
                                 "bottleneck": d["roofline"]["bottleneck"],
                                 "trace_s": d["lower_s"]}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    launches = launch_counts()
    moved = torch.cuda.memory_allocated() - before
    emit("dryrun_cli", nvidia_smi=smi, seconds=cli_s, cells=cells, launches=launches,
         allocated_delta=moved)
    if moved != 0 or any(launches.values()):
        raise AssertionError(f"the dry run moved the card's allocation by {moved} bytes or "
                             f"launched kernels: {launches}")
    if sorted(cells) != ["decode_32k", "prefill_32k", "train_4k"] or any(
            c["status"] != "ok" or c["traced_device"] != "cuda" for c in cells.values()):
        raise AssertionError(f"the dry run's qwen2-1.5b cells: {cells}")
    return rows


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


# --------------------------------------------------------------------------
# kernel #1 at the mixed plans' widths and the other dense configs' shapes
# --------------------------------------------------------------------------

NEW_BITS = (2, 4, 6)        # the auto-bits ladder below 8
SERVE_MAX_LEN = 256         # the served engines' max_len
# the untied FORMS heads (K = d_model, N = vocab): h2o-danube-1.8b,
# qwen1.5-4b and yi-9b; and qwen2-1.5b's tied head, served dense, for scale
HEAD_SHAPES = [(1536, 151936), (2560, 32000), (2560, 151936), (4096, 64000)]
HEAD_M = (1, DECODE_M)      # the head's last prefill row, and a decode step
# the other dense configs' projections at full width, (K, N) -> calls per layer
DENSE_SHAPES = {"h2o-danube-1.8b": {(2560, 2560): 2, (2560, 640): 2, (2560, 6912): 2,
                                    (6912, 2560): 1},
                "qwen1.5-4b": {(2560, 2560): 4, (2560, 6912): 2, (6912, 2560): 1},
                "yi-9b": {(4096, 4096): 2, (4096, 512): 2, (4096, 11008): 2,
                          (11008, 4096): 1}}
SERVED_ARCH = "h2o-danube-1.8b"   # the one of them served whole (dense_configs)


def served_m(arch: str):
    """The M a served run of the slice's prompts gives every projection of
    ``arch``: each prompt's prefill bucket, and the decode step's slots."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import prefill_bucket
    return sorted({prefill_bucket(len(p), SERVE_MAX_LEN)
                   for p in slice_prompts(get_config(arch))} | {DECODE_M})


def autobits_m():
    """The M the auto-bits path gives qwen2-1.5b's projections at a width
    below 8: the mixed tree's prefills and decode steps, the auto-draft's
    verify widths, and the calibration forwards of the plan's validation."""
    from repro_torch.forms.autobits import AutoBitsConfig
    acfg = AutoBitsConfig()
    return sorted(set(served_m("qwen2-1.5b")) | set(VERIFY_M)
                  | {acfg.calib_batch * acfg.calib_len})


def held_matmul(gen, M, K, N, bits=8, flush=None, x_dtype=None):
    """Kernel #1 through its route on bf16 x (as the served models give it;
    ``x_dtype=torch.float32`` for the f32 projections of the sLSTM) and
    ``bits``-bit codes: two launches equal bit for bit and held against the
    plain version within REL_TOL; with ``flush``, timed beside the plain
    version, the ``torch.matmul`` of the pre-folded weight in x's dtype and
    the bound."""
    import torch
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.kernels.ref import ref_polarized_matmul_fast

    x_dtype = x_dtype or torch.bfloat16
    x, mags, signs, scale = kernel_inputs(gen, M, K, N, levels=2 ** bits, x_dtype=x_dtype)
    got = pm.polarized_matmul(x, mags, signs, scale, 8)
    again = pm.polarized_matmul(x, mags, signs, scale, 8)
    want = ref_polarized_matmul_fast(x, mags, signs, scale, 8)
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rec = {"M": M, "K": K, "N": N, "bits": bits, "x": str(x_dtype).removeprefix("torch."),
           "max_code": int(mags.max()),
           "route": "tc" if pm.uses_tensor_cores(x.dtype, mags.dtype, "cuda", M, N) else "f32",
           "max_abs_err": abs_err, "max_rel_err": abs_err / float(want.abs().max())}
    if not torch.equal(got, again):
        raise AssertionError(f"two launches differ: {rec}")
    if not rec["max_rel_err"] <= REL_TOL:
        raise AssertionError(f"kernel #1 disagrees with its plain version: {rec}")
    if flush is not None:
        wb = (mags.float() * signs.float().repeat_interleave(8, dim=0)).to(x_dtype)
        rec["kernel_ms"] = timed_ms(lambda: pm.polarized_matmul(x, mags, signs, scale, 8), flush)
        rec["plain_ms"] = timed_ms(lambda: ref_polarized_matmul_fast(x, mags, signs, scale, 8),
                                   flush)
        rec["library_ms"] = timed_ms(lambda: torch.matmul(x, wb), flush)
        rec["bound_ms"], rec["bound_by"] = bound(M, K, N, 1, x_bytes=x.element_size())
    return rec


def layer_row(gen, M, flush, bits=8):
    """``held_matmul`` at each of qwen2-1.5b's 7 projections of one layer at
    M, timed, summed per layer."""
    recs = [(held_matmul(gen, M, K, N, bits, flush), calls)
            for (K, N), calls in LAYER_SHAPES.items()]
    return {"M": M, "bits": bits, "route": recs[0][0]["route"],
            **{k: sum(r[k] * c for r, c in recs)
               for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")},
            "bound_by": bound_by([r for r, _ in recs]),
            "max_abs_err": max(r["max_abs_err"] for r, _ in recs),
            "max_rel_err": max(r["max_rel_err"] for r, _ in recs)}


def phase_kernel_widths():
    """Kernel #1 at the auto-bits widths 2, 4 and 6 (uint8 codes below 2^bits)
    on qwen2-1.5b's projections: held at every M the auto-bits path gives
    them (``autobits_m``), timed per layer at decode (M=4, the f32 kernel)
    and prefill (M=64, tensor cores); every projection of the other dense
    configs held, h2o-danube-1.8b's at every M its served run gives them
    (``served_m``), the other two at M=4 and 64; the untied heads held at
    M=1 and 4, timed at M=4.  Returns the per-layer width rows and the head
    rows."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()
    width_rows = []
    for bits in NEW_BITS:
        held = [held_matmul(gen, M, K, N, bits) for M in autobits_m()
                if M not in (DECODE_M, PREFILL_M) for K, N in LAYER_SHAPES]
        emit("kernel_bits_held", bits=bits, shapes=[[r["M"], r["K"], r["N"], r["route"]]
                                                    for r in held],
             max_abs_err=max(r["max_abs_err"] for r in held),
             max_rel_err=max(r["max_rel_err"] for r in held))
        for M in (DECODE_M, PREFILL_M):
            row = layer_row(gen, M, flush, bits)
            emit("kernel_bits", per="the 7 projections of one qwen2-1.5b layer, bf16 x", **row)
            width_rows.append(row)
    for arch, shapes in DENSE_SHAPES.items():
        ms = served_m(arch) if arch == SERVED_ARCH else (DECODE_M, PREFILL_M)
        recs = [held_matmul(gen, M, K, N) for M in ms for (K, N) in shapes]
        emit("kernel_dense_shapes", arch=arch, shapes=[[r["M"], r["K"], r["N"], r["route"]]
                                                       for r in recs],
             max_abs_err=max(r["max_abs_err"] for r in recs),
             max_rel_err=max(r["max_rel_err"] for r in recs))
    head_rows = []
    for K, N in HEAD_SHAPES:
        for M in HEAD_M:
            rec = held_matmul(gen, M, K, N, flush=flush if M == DECODE_M else None)
            if M == DECODE_M:
                rec["dense_bf16_bound_ms"] = (K * N * 2 + M * (K * 2 + N * 4)) \
                    / HBM_BYTES_PER_S * 1e3
                head_rows.append(rec)
            emit("kernel_head", **rec)
    del scrub
    return width_rows, head_rows


# --------------------------------------------------------------------------
# auto mixed precision on the full-width model
# --------------------------------------------------------------------------

AUTOBITS_BUDGET = 0.05
SERVED_NEW = 16             # new tokens per request of the served runs below


def served(eng, prompts):
    """One greedy run of ``prompts`` (SERVED_NEW tokens each) on ``eng``, the
    launch counts set to 0 just before it: every request must return
    SERVED_NEW tokens in the vocabulary.  Returns the tokens, the results,
    the wall seconds, the decode steps, the decode rounds' host ms
    (``run_timed``), ms per decode step and per prefill, and the counts."""
    from repro_torch.serving.engine import Request

    vocab = eng.cfg.vocab_size
    reqs = [Request(uid=i, prompt=p, max_new_tokens=SERVED_NEW) for i, p in enumerate(prompts)]
    rounds0 = eng.scheduler.rounds
    reset_counts()
    results, wall, decode_ms = run_timed(eng, reqs)
    counts = launch_counts()
    steps = (eng.scheduler.rounds - rounds0) * eng.decode_block
    tokens = {r.uid: r.tokens for r in results}
    for toks in tokens.values():
        if len(toks) != SERVED_NEW or not all(0 <= v < vocab for v in toks):
            raise AssertionError(f"a request returned {toks}")
    return {"tokens": tokens, "results": results, "reqs": reqs, "wall_s": wall,
            "decode_steps": steps, "decode_ms": decode_ms,
            "decode_step_ms": decode_ms / steps,
            "mean_prefill_ms": sum(r.prefill_ms for r in results) / len(results),
            "counts": counts}


def synced_ms(fn, *a, **k):
    """``fn(*a, **k)`` and its wall ms, the card synchronized on both sides."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*a, **k)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def phase_autobits(engine, prompts, plain_tokens, uniform_draft):
    """``forms/autobits`` on full-width qwen2-1.5b (random weights from seed
    0, the slice's ``FormsSpec(m=8, bits=8)``, ``AutoBitsConfig()`` at
    acc_budget 0.05): the sweep's parts timed on their own (the Fisher pass,
    each width's compress and decompress), then the whole sweep, whose one
    kernel is the polarization (kernel #4) that ``compress_tree`` launches
    once per layer matrix and width; the validated plan, its measured
    candidates (back-off rounds), histogram, predicted and measured dNLL,
    the ReRAM model's speedup, the FLOP coverage and peak memory; the
    validation's launches reckoned from its measured NLLs (M = 8 x 32 = 256,
    tensor cores, and one polarization per layer matrix of each tree it
    compresses).  Then the slice's requests served on the mixed tree beside
    the uniform 8-bit ``engine`` (uniform, mixed, mixed, uniform), the
    launcher's parity block, and the ``--auto-draft`` speculative run beside
    the uniform 4-bit draft's acceptance, its tokens under the speculate
    phase's token rule and its launches reckoned from the round widths.
    Returns the launches."""
    import torch
    from repro_torch.forms import FormsSpec, compress_tree, compressed_paths, to_dense
    from repro_torch.forms import autobits as AB
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.launch.serve import auto_bits_parity
    from repro_torch.serving.engine import ServingEngine

    model, cfg = engine.model, engine.cfg
    spec = FormsSpec(m=8, bits=8, rule="energy")
    acfg = AB.AutoBitsConfig(acc_budget=AUTOBITS_BUDGET)
    per_call = 7 * cfg.num_layers
    common = dict(page_size=16, batch_slots=4, max_len=SERVE_MAX_LEN, decode_block=4,
                  device="cuda")
    params = model.init(0)                 # the slice's dense weights

    # the sweep's parts, each timed on its own
    calib = AB.random_calibration(cfg.vocab_size, acfg, "cuda")
    fisher, fisher_ms = synced_ms(AB.fisher_diag, model, params, calib)
    del fisher
    candidates = sorted(set(acfg.candidate_bits) | {spec.bits}, reverse=True)
    compress_ms, decompress_ms = {}, {}
    for b in candidates:
        (comp, _), compress_ms[b] = synced_ms(compress_tree, params, spec.with_bits(b))
        decompress_ms[b] = synced_ms(
            lambda: [to_dense(fp) for fp in compressed_paths(comp).values()])[1]
        del comp
    # the whole sweep: its forwards are dense, its one kernel the
    # polarization inside compress_tree, once per layer matrix and width;
    # the peak memory is the sweep's and the plan's
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    table, sweep_ms = synced_ms(AB.measure_sensitivity, model, params, spec, acfg)
    matrices = sum(ls.stack for ls in table.leaves.values())
    sweep_launches = {k: v for k, v in launch_counts().items() if v}
    sweep_want = {"admm_polarize": len(candidates) * matrices}
    if sweep_launches != sweep_want:
        raise AssertionError(f"the sweep launched {sweep_launches}, reckoned {sweep_want}")
    # the validated plan: each measured NLL runs calib_batches forwards of
    # one compressed tree (per_call projections each, M = calib_batch x
    # calib_len) and compress_tree's polarization of its layer matrices
    reset_counts()
    plan, plan_ms = synced_ms(AB.plan_auto_bits, model, params, spec, acfg, table=table)
    plan_launches = {k: v for k, v in launch_counts().items() if v}
    names = ("polarized_matmul", "polarized_matmul_tc")
    name = names[pm.uses_tensor_cores(torch.bfloat16, torch.uint8, "cuda",
                                      acfg.calib_batch * acfg.calib_len, SLICE_COLS)]
    nlls, rest = divmod(plan_launches.get(name, 0), acfg.calib_batches * per_call)
    base_plan = all(b == spec.bits for b in plan.bits.values())
    want = {name: nlls * acfg.calib_batches * per_call, "admm_polarize": nlls * matrices}
    # the base tree's NLL, then one per candidate plan measured (at most 4)
    if rest or not (1 if base_plan else 2) <= nlls <= 5 or plan_launches != want:
        raise AssertionError(f"the validation launched {plan_launches}: not {nlls} measured "
                             f"NLLs' {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    coverage = AB.flop_coverage(table)
    if not 0.0 < coverage <= 1.0:
        raise AssertionError(f"the cost model covers {coverage} of the counted FLOPs")
    if not (plan.measured_dl <= AUTOBITS_BUDGET and plan.modeled_seconds <= plan.base_seconds):
        raise AssertionError(f"the plan misses its budget: {plan.summary()}")
    validation = [plan_launches.get(n, 0) for n in names]
    emit("autobits", arch=cfg.name, budget=AUTOBITS_BUDGET, summary=plan.summary(),
         histogram=plan.histogram(), predicted_dnll=plan.predicted_dl,
         measured_dnll=plan.measured_dl, modeled_speedup=plan.modeled_speedup,
         modeled_speedup_note="the paper's ReRAM ADC-event model (core/perfmodel), not a "
                              "time on the card",
         measured_nlls=nlls, backoff_rounds=nlls - 1,
         backoff_rounds_note="candidate plans measured against the budget",
         fisher_ms=fisher_ms, compress_ms=compress_ms, decompress_ms=decompress_ms,
         sweep_ms=sweep_ms, plan_ms=plan_ms,
         fwd_flops=table.fwd_flops, modeled_flops=table.modeled_flops, flop_coverage=coverage,
         peak_mem_gb=peak_gb, sweep_launches=sweep_launches, validation_launches=validation,
         validation_polarize_launches=plan_launches["admm_polarize"], bits=plan.bits,
         top_groups=plan.top_groups())

    # the slice's requests on the mixed tree, beside the uniform 8-bit tree
    mixed = ServingEngine(model, params, spec=spec, plan=plan.specs(), **common)
    buckets = [mixed.runner.bucket_for(len(p)) for p in prompts]
    runs = {"uniform8": [], "mixed": []}
    for name in ("uniform8", "mixed", "mixed", "uniform8"):
        runs[name].append(served(engine if name == "uniform8" else mixed, prompts))
    for name, rs in runs.items():
        for r in rs:
            want = route_split(per_call, buckets, r["decode_steps"], 4, SLICE_COLS)
            got = {k: v for k, v in r["counts"].items() if v}
            if got != {k: v for k, v in zip(names, want) if v}:
                raise AssertionError(f"{name}: launched {got}, reckoned {want}")
    if runs["uniform8"][0]["tokens"] != plain_tokens \
            or runs["mixed"][0]["tokens"] != runs["mixed"][1]["tokens"]:
        raise AssertionError("a repeated run gave other tokens")
    mixed_tokens = runs["mixed"][0]["tokens"]
    first = runs["mixed"][0]
    parity = auto_bits_parity(model, params, spec, plan, AUTOBITS_BUDGET, first["reqs"],
                              first["results"], **common)
    torch.cuda.empty_cache()

    # --auto-draft: the mixed target with the draft the same table plans
    dplan = AB.plan_draft_bits(table, match_bits=4)
    threshold, _ = verify_threshold(mixed, prompts, mixed_tokens, (1, 2, 3, 4))
    draft_engine = ServingEngine(model, params, spec=spec, plan=plan.specs(), speculate=True,
                                 draft_k=SPEC_K, draft_bits=4, draft_plan=dplan.specs(), **common)
    del params
    spec_run = served(draft_engine, prompts)
    widths = list(draft_engine.runner.round_widths)
    want = spec_reckoning(per_call, buckets, widths, cfg.num_layers, SLICE_COLS)
    got = {k: v for k, v in spec_run["counts"].items() if v}
    if got != {k: v for k, v in zip(names, want) if v}:
        raise AssertionError(f"auto-draft: launched {got}, the round widths "
                             f"{widths} give {want}")
    rule = speculative_token_rule(mixed, draft_engine, prompts, mixed_tokens,
                                  spec_run["tokens"], threshold, "auto-draft")
    st = draft_engine.stats()["speculate"]
    emitted = sum(len(t) - 1 for t in spec_run["tokens"].values())
    emit("autobits_serve", arch=cfg.name,
         decode_step_ms={k: [r["decode_step_ms"] for r in rs] for k, rs in runs.items()},
         mean_prefill_ms={k: [r["mean_prefill_ms"] for r in rs] for k, rs in runs.items()},
         launches={k: [rs[0]["counts"][n] for n in names] for k, rs in runs.items()},
         weight_bytes={"uniform8": engine.compression_report.bytes_compressed,
                       "mixed": mixed.compression_report.bytes_compressed},
         mixed_tokens_equal_uniform8=mixed_tokens == plain_tokens, parity=parity,
         auto_draft={"histogram": dplan.histogram(), "summary": dplan.summary(),
                     "acceptance": st["acceptance"], "tokens_per_round": st["tokens_per_round"],
                     "decode_ms_per_token": spec_run["decode_ms"] / emitted,
                     "launches": [spec_run["counts"][n] for n in names],
                     "launches_expected": want,
                     "threshold": threshold, "token_rule": rule,
                     "tokens_equal_mixed": spec_run["tokens"] == mixed_tokens},
         uniform_4bit_draft=uniform_draft)
    launches = [[runs["mixed"][0]["counts"][n] for n in names], validation,
                [spec_run["counts"][n] for n in names],
                sweep_launches["admm_polarize"] + plan_launches["admm_polarize"]]
    del mixed, draft_engine
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# the other dense configs: h2o-danube-1.8b at full width, untied FORMS head
# --------------------------------------------------------------------------

def phase_dense_configs():
    """Full-width h2o-danube-1.8b (24 layers, d_model 2560, kv N = 640, the
    untied FORMS head at N = 32000; random weights from seed 0) served with
    ``--forms`` on the paged cache, 4 requests of 16 new tokens, with
    zero_skip off and block (off, block, block, off): block gives off's
    tokens; each run's launches reckoned (7 projections per layer on the
    route of their M, the head at M = 1 per prefill and M = slots per decode
    step); decode and prefill ms.  Returns the off and block launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.forms import FormsLinearParams, FormsSpec, compress_tree
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(SERVED_ARCH)
    model = build(cfg, device="cuda")
    spec = FormsSpec(m=8, bits=8, rule="energy")
    t0 = time.perf_counter()
    with torch.inference_mode():
        tree, rep = compress_tree(model.init(0), spec)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    head = tree["head"]
    if not (isinstance(head, FormsLinearParams)
            and tuple(head.mags.shape) == (cfg.d_model, cfg.vocab_size)):
        raise AssertionError(f"the untied head is not a FORMS leaf of (d_model, vocab): {head}")
    prompts = slice_prompts(cfg)
    engines = {mode: ServingEngine(model, tree, spec=spec, zero_skip=mode, page_size=16,
                                   batch_slots=4, max_len=SERVE_MAX_LEN, decode_block=4,
                                   device="cuda")
               for mode in ("off", "block")}
    buckets = [engines["off"].runner.bucket_for(len(p)) for p in prompts]
    route = wide_route(narrowest(tree))
    runs = {"off": [], "block": []}
    for mode in ("off", "block", "block", "off"):
        run = served(engines[mode], prompts)
        want = route_split(7 * cfg.num_layers, buckets, run["decode_steps"], 4, narrowest(tree))
        want[route(1)] += len(prompts)          # the head at each prefill's last row
        want[route(4)] += run["decode_steps"]   # and at each decode step
        names = (("polarized_matmul", "polarized_matmul_tc") if mode == "off"
                 else ("polarized_matmul_skip", "polarized_matmul_tc_skip"))
        got = {k: v for k, v in run["counts"].items() if v}
        if got != {n: w for n, w in zip(names, want) if w}:
            raise AssertionError(f"{mode}: launched {got}, reckoned {dict(zip(names, want))}")
        run["launches"] = {n: run["counts"][n] for n in names}
        runs[mode].append(run)
    tokens = [r["tokens"] for rs in runs.values() for r in rs]
    if any(t != tokens[0] for t in tokens):
        raise AssertionError("zero_skip='block' (or a repeated run) changed the tokens")
    emit("dense_configs", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, head_dim=cfg.hd(), kv_heads=cfg.num_kv_heads,
         sliding_window=cfg.sliding_window, compression=rep.summary(), setup_s=setup_s,
         head={"K": head.k, "N": head.n, "bits": head.bits},
         block_equals_off=True, prompt_lens=[len(p) for p in prompts],
         decode_step_ms={k: [r["decode_step_ms"] for r in rs] for k, rs in runs.items()},
         mean_prefill_ms={k: [r["mean_prefill_ms"] for r in rs] for k, rs in runs.items()},
         launches={k: rs[0]["launches"] for k, rs in runs.items()}, tokens=tokens[0])
    out = {k: rs[0]["launches"] for k, rs in runs.items()}
    del engines, tree
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# reliability: fault injection, VECOM read-back and self-healing serving
# --------------------------------------------------------------------------

# step 2's faulted leaves and step 3's (attention leaves: a stuck-cell
# injection draws one uniform per cell of the leaf, sequentially)
STUCK_LEAVES = ("blocks/attn/wo", "blocks/attn/wq")
CHAOS_LEAF = "blocks/attn/wk"
PROBE_EVERY = 4
# the zero-noise and sigma injections' leaves: the attention leaves, 12% of
# the tree's cells.  A cut: the whole tree's four host injections took
# ~250 s of a ~800 s script (the injector walks each leaf's cells on one
# sequential normal stream, the reference's semantics)
INJECT_LEAVES = ("blocks/attn/wk", "blocks/attn/wo", "blocks/attn/wq", "blocks/attn/wv")


def host_peak_gb() -> float:
    """The process's peak resident host memory so far (``ru_maxrss``)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def with_encoding(tree, encoding: str):
    """The same compressed tree with ``encoding`` on every leaf (the codes
    are the same under both encodings)."""
    from repro_torch.forms import FormsLinearParams
    if isinstance(tree, dict):
        return {k: with_encoding(v, encoding) for k, v in tree.items()}
    if isinstance(tree, FormsLinearParams):
        return dataclasses.replace(tree, encoding=encoding)
    return tree


def phase_reliability(plain_engine, plain_tokens):
    """``reliability/*`` on the slice-1 engine's full-width qwen2-1.5b tree
    (FORMS m=8, 8 bits, paged, the slice's 4 requests of 16 new tokens),
    ``HealthConfig(probe_every=4)``: (1) zero noise on INJECT_LEAVES (a cut
    of the whole tree, printed) under ``binary`` and ``vecom``: the slice's
    tokens, every probe's drift exactly 0; (2) stuck cells (1e-3 on, 1e-3 off) on two named leaves
    before the run: the first tick flags exactly those two, repair brings
    the drift to at most the threshold (exactly 0), the slice's tokens;
    (3) a chaos fault scheduled for round 2 (probes every 2 rounds here, so
    it strikes mid-run): every request completes, a repair is logged;
    (4) variation sigma=0.1, rho=0.6 on INJECT_LEAVES, binary then vecom,
    served without the monitor: codes changed, mean |dcode| (vecom below
    binary), greedy agreement with the slice's tokens (no gate: random
    weights have near-ties); (5) the stat line of ``stats_every=4``.  Each
    run's launches reckoned: the route's prefills and decode steps, and two
    probe forwards at M=8 (the tensor-core kernel) per probe.  Times: probe ms,
    scan s (1.31 GB device to host and compared), repair ms, each
    injection's s, and the host's peak RSS."""
    import contextlib
    import io

    import torch
    from repro_torch.forms import compressed_paths
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.reliability import FaultModel, HealthConfig
    from repro_torch.serving.engine import ServingEngine

    model, cfg = plain_engine.model, plain_engine.cfg
    spec = plain_engine.spec
    tree = {k: v for k, v in plain_engine.params.items() if k != "head_cast"}
    prompts = slice_prompts(cfg)
    per_call = 7 * cfg.num_layers
    route = wide_route(SLICE_COLS)
    leaves = compressed_paths(tree)
    cells = sum(leaf.mags.numel() * 4 for leaf in leaves.values())
    cut_cells = sum(leaves[p].mags.numel() * 4 for p in INJECT_LEAVES)
    peak0 = host_peak_gb()

    def engine(encoding="binary", health=True, probe_every=PROBE_EVERY, **kw):
        return ServingEngine(model, with_encoding(tree, encoding),
                             spec=dataclasses.replace(spec, encoding=encoding), page_size=16,
                             batch_slots=4, max_len=SERVE_MAX_LEN, decode_block=4,
                             device="cuda",
                             health=HealthConfig(probe_every=probe_every) if health else None,
                             **kw)

    def watched(eng):
        """Record every probe's drift."""
        drifts, probe = [], eng.health.probe

        def rec(params):
            drifts.append(probe(params))
            return drifts[-1]

        eng.health.probe = rec
        return drifts

    def run_checked(eng, label):
        probes0 = eng.health.probes if eng.health is not None else 0
        run = served(eng, prompts)
        probes = (eng.health.probes if eng.health is not None else 0) - probes0
        want = route_split(per_call, [eng.runner.bucket_for(len(p)) for p in prompts],
                           run["decode_steps"], 4, SLICE_COLS)
        want[route(8)] += probes * 2 * per_call
        got = [run["counts"]["polarized_matmul"], run["counts"]["polarized_matmul_tc"]]
        if got != want:
            raise AssertionError(f"{label}: launched {got}, reckoned {want} ({probes} probes)")
        run["launches"], run["probes"] = got, probes
        return run

    def injected(eng, fault, **kw):
        t = time.perf_counter()
        rep = eng.inject_faults(fault, **kw)
        torch.cuda.synchronize()
        return rep, time.perf_counter() - t

    out = {"cells": cells, "host_peak_gb_before": peak0,
           "cut": {"injected_leaves": list(INJECT_LEAVES), "cells": cut_cells,
                   "of_cells": cells, "note": "zero-noise and sigma injections on the "
                                              "attention leaves, not the whole tree"}}
    launches = [0, 0]
    # 1. zero noise, both encodings
    for enc in ("binary", "vecom"):
        eng = engine(enc)
        drifts = watched(eng)
        rep, inj_s = injected(eng, FaultModel(), paths=list(INJECT_LEAVES))
        run = run_checked(eng, f"zero-noise {enc}")
        h = eng.stats()["health"]
        out[f"zero_{enc}"] = {"inject_s": inj_s, "codes_changed": rep.codes_changed,
                              "leaves": len(rep.leaves), "probes": h["probes"],
                              "drifts": drifts, "events": len(h["events"]),
                              "tokens_equal": run["tokens"] == plain_tokens,
                              "launches": run["launches"], "host_peak_gb": host_peak_gb()}
        if enc == "binary":
            probe_ms = [synced_ms(eng.health.probe, eng.params)[1] for _ in range(3)]
            scan = [synced_ms(eng.health.scan, eng.params)[1] / 1e3 for _ in range(2)]
            out["probe_ms"], out["scan_s"] = probe_ms, scan
        launches = [a + b for a, b in zip(launches, run["launches"])]
        del eng
        gc.collect()
        if not (run["tokens"] == plain_tokens and rep.codes_changed == 0 and drifts
                and all(d == 0.0 for d in drifts) and not h["events"]):
            raise AssertionError(f"zero-noise {enc}: {out[f'zero_{enc}']}")
    # 2. stuck cells on two named leaves, before the run; and the stat line
    eng = engine(stats_every=4)
    rep, inj_s = injected(eng, FaultModel(p_stuck_on=1e-3, p_stuck_off=1e-3, seed=2),
                          paths=list(STUCK_LEAVES))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = run_checked(eng, "stuck")
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[serve]")]
    h = eng.stats()["health"]
    ev = h["events"]
    repair_ms = [synced_ms(eng.health.repair, eng.params, list(STUCK_LEAVES))[1]
                 for _ in range(3)]
    out["stuck"] = {"inject_s": inj_s, "codes_changed": rep.codes_changed,
                    "stuck_cells": rep.stuck_cells,
                    "events": [{k: v for k, v in e.items() if k != "detail"} for e in ev],
                    "board": h["flagged"], "last_drift": h["last_drift"],
                    "tokens_equal": run["tokens"] == plain_tokens, "launches": run["launches"],
                    "repair_ms": repair_ms, "stat_lines": lines}
    launches = [a + b for a, b in zip(launches, run["launches"])]
    if not (len(ev) >= 2 and ev[0]["event"] == "drift" and ev[0]["round"] == 0
            and ev[0]["leaves"] == sorted(STUCK_LEAVES) and ev[1]["event"] == "repair"
            and ev[1]["drift_after"] <= eng.health.config.drift_threshold
            and run["tokens"] == plain_tokens and len(lines) == 1):
        raise AssertionError(f"stuck: {out['stuck']}")
    del eng
    gc.collect()
    # 3. chaos mid-run
    eng = engine(probe_every=2)
    eng.health.schedule_fault(2, FaultModel(p_stuck_on=1e-3, seed=4), paths=[CHAOS_LEAF])
    run = run_checked(eng, "chaos")
    ev = eng.stats()["health"]["events"]
    out["chaos"] = {"events": [(e["round"], e["event"]) for e in ev],
                    "repair_event_ms": [e["ms"] for e in ev if e["event"] == "repair"],
                    "tokens_equal": run["tokens"] == plain_tokens,
                    "completed": sorted(len(t) for t in run["tokens"].values()),
                    "rounds": eng.stats()["rounds"], "launches": run["launches"]}
    launches = [a + b for a, b in zip(launches, run["launches"])]
    if not (any(e["event"] == "repair" for e in ev) and ev[0]["round"] == 2
            and ev[0]["round"] < out["chaos"]["rounds"]):
        raise AssertionError(f"chaos: {out['chaos']}")
    del eng
    gc.collect()
    # 4. variation on the attention leaves, binary then vecom, without the monitor
    for enc in ("binary", "vecom"):
        eng = engine(enc, health=False)
        rep, inj_s = injected(eng, FaultModel(sigma=0.1, rho=0.6, seed=0),
                              paths=list(INJECT_LEAVES))
        run = served(eng, prompts)
        pairs = [(run["tokens"][u], plain_tokens[u]) for u in plain_tokens]
        out[f"sigma_{enc}"] = {
            "inject_s": inj_s, "codes_changed": rep.codes_changed,
            "mean_abs_dcode": sum(s.mean_abs_dcode * s.cells for s in rep.leaves.values())
            / sum(s.cells for s in rep.leaves.values()),
            "max_abs_dcode": max(s.max_abs_dcode for s in rep.leaves.values()),
            "agreement": sum(sum(a == b for a, b in zip(x, y)) for x, y in pairs)
            / sum(len(y) for _, y in pairs),
            "host_peak_gb": host_peak_gb()}
        del eng
        gc.collect()
    b, v = out["sigma_binary"], out["sigma_vecom"]
    out["host_peak_gb"] = host_peak_gb()
    emit("reliability", arch=cfg.name, probe_every=PROBE_EVERY, **out)
    if not (v["mean_abs_dcode"] < b["mean_abs_dcode"] and v["codes_changed"] < b["codes_changed"]):
        raise AssertionError(f"vecom did not read back closer than binary: {b} {v}")
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# the MoE family at olmoe-1b-7b's full width
# --------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"
MOE_ATTN = (2048, 2048)      # olmoe's q/k/v/o (16 heads of 128, MHA)
MOE_HEAD = (2048, 50304)     # its untied head
MOE_EXPERT_SHAPES = [(2048, 1024), (1024, 2048)]   # w_gate/w_up, w_down


def phase_moe():
    """Full-width olmoe-1b-7b (16 layers, d_model 2048, MHA 16 x 128, 64
    experts top-8 of moe_d_ff 1024, vocab 50304, untied head; random
    weights from seed 0) compressed by FORMS (m=8, 8 bits; every (layer,
    expert) matrix one polarization launch, reckoned) and served on the
    paged cache with exact-length prefill, the slice's 4 requests of 16
    new tokens, twice (the same tokens): decode ms per step, prefill ms,
    launches reckoned (the 4 attention projections per layer at M = each
    prompt's length and at M = 4 per decode step, the head at M = 1 per
    prefill and 4 per step; the router stays dense).  Kernel #1 held at
    every (shape, M) the run gives it and timed at M=4; kernel #4 bit for
    bit at the expert, attention and head matrices, timed per (layer,
    expert) triple.  Peak memory with the f32 tree, which is freed after
    compression."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import paths
    from repro_torch.forms import FormsSpec, compress_tree, compressed_paths
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.kernels.admm_polarize import admm_polarize
    from repro_torch.kernels.ref import ref_admm_polarize
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(MOE_ARCH)
    model = build(cfg, device="cuda")
    spec = FormsSpec(m=8, bits=8, rule="energy")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = synced_ms(model.init, 0)
    reset_counts()
    with torch.inference_mode():
        (tree, rep), compress_ms = synced_ms(compress_tree, params, spec)
    pol_launches = launch_counts()["admm_polarize"]
    n_params = sum(v.numel() for v in paths.leaves(params))
    del params
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = compressed_paths(tree)
    matrices = sum(int(torch.tensor(leaf.mags.shape[:-2]).prod()) for leaf in leaves.values())
    want_pol = (3 * cfg.num_layers * cfg.num_experts + 4 * cfg.num_layers + 1)
    if pol_launches != want_pol or matrices != want_pol or "blocks/moe/router" in leaves:
        raise AssertionError(f"compress_tree polarized {pol_launches} matrices "
                             f"({matrices} in the tree), reckoned {want_pol}")
    tree_gb = sum(t.numel() * t.element_size() for leaf in leaves.values()
                  for t in (leaf.mags, leaf.signs, leaf.scale)) / 1e9
    engine = ServingEngine(model, tree, spec=spec, page_size=16, batch_slots=4,
                           max_len=SERVE_MAX_LEN, decode_block=4, device="cuda")
    prompts = slice_prompts(cfg)
    lens = [len(p) for p in prompts]
    if [engine.runner.bucket_for(n) for n in lens] != lens:
        raise AssertionError("the MoE engine padded a prompt")
    route = wide_route(narrowest(tree))
    runs = []
    for _ in range(2):
        run = served(engine, prompts)
        want = [0, 0]
        for n in lens:
            want[route(n)] += 4 * cfg.num_layers
            want[route(1)] += 1
        want[route(4)] += run["decode_steps"] * (4 * cfg.num_layers + 1)
        got = [run["counts"]["polarized_matmul"], run["counts"]["polarized_matmul_tc"]]
        if got != want:
            raise AssertionError(f"moe: launched {got}, reckoned {want}")
        run["launches"] = got
        runs.append(run)
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError("two greedy MoE runs gave other tokens")
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del engine, tree
    torch.cuda.empty_cache()
    # kernel #1 at every (shape, M) of the run, timed at M=4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()
    held = ([held_matmul(gen, M, *MOE_ATTN) for M in sorted(set(lens)) if M != DECODE_M]
            + [held_matmul(gen, 1, *MOE_HEAD)])
    attn_row = held_matmul(gen, DECODE_M, *MOE_ATTN, flush=flush)
    head_row = held_matmul(gen, DECODE_M, *MOE_HEAD, flush=flush)
    held += [attn_row, head_row]
    # kernel #4 bit for bit at the matrices compress_tree polarizes
    pol = []
    for K, N in MOE_EXPERT_SHAPES + [MOE_ATTN, MOE_HEAD]:
        v = torch.randn((K, N), generator=gen, device="cuda")
        outp, signs = admm_polarize(v, m=8, rule="energy")
        want_p, want_s = ref_admm_polarize(v, 8, "energy")
        torch.cuda.synchronize()
        rec = {"K": K, "N": N, "equal": torch.equal(outp.view(torch.int32),
                                                     want_p.view(torch.int32))
               and torch.equal(signs, want_s)}
        if (K, N) in MOE_EXPERT_SHAPES:
            rec["kernel_ms"] = timed_ms(lambda: admm_polarize(v, m=8, rule="energy"), flush)
            rec["plain_ms"] = timed_ms(lambda: ref_admm_polarize(v, 8, "energy"), flush, reps=5)
            rec["bound_ms"], rec["bound_by"] = polarize_bound((K, N))
        pol.append(rec)
        del v, outp, signs, want_p, want_s
    if not all(r["equal"] for r in pol):
        raise AssertionError(f"kernel #4 disagrees at an MoE matrix: {pol}")
    # one (layer, expert): w_gate and w_up are 2048 x 1024, w_down 1024 x 2048
    triple = {k: 2 * pol[0][k] + pol[1][k] for k in ("kernel_ms", "plain_ms", "bound_ms")}
    triple["bound_by"] = bound_by(pol[:2])
    del scrub
    last = runs[-1]
    emit("moe", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         experts=cfg.num_experts, top_k=cfg.experts_per_token, moe_d_ff=cfg.moe_d_ff,
         vocab=cfg.vocab_size, params=n_params, init_ms=init_ms, compress_s=compress_ms / 1e3,
         compression=rep.summary(), tree_gb=tree_gb, peak_gb=peak_gb,
         serve_peak_gb=serve_peak_gb, polarize_launches=pol_launches,
         prompt_lens=lens, decode_steps=last["decode_steps"],
         decode_step_ms=[r["decode_step_ms"] for r in runs],
         mean_prefill_ms=[r["mean_prefill_ms"] for r in runs],
         launches=last["launches"], launches_per_decode_step=4 * cfg.num_layers + 1,
         tokens=last["tokens"])
    emit("moe_kernels", held=[[r["M"], r["K"], r["N"], r["route"]] for r in held],
         max_abs_err=max(r["max_abs_err"] for r in held),
         max_rel_err=max(r["max_rel_err"] for r in held),
         attn_m4=attn_row, head_m4=head_row, polarize=pol, polarize_expert_triple=triple)
    return {"launches": last["launches"], "polarize_launches": pol_launches,
            "attn_m4": attn_row, "head_m4": head_row, "held": held, "triple": triple}


# --------------------------------------------------------------------------
# MLA and multi-token prediction (deepseek-v3), whisper-small
# --------------------------------------------------------------------------

MLA_ARCH = "deepseek-v3-671b"
MLA_CUT = dict(num_layers=4, num_experts=16)      # 61 layers, 256 experts published
# deepseek-v3's FORMS projections (K, N): MLA, the shared expert, the MTP proj
MLA_SHAPES = {"q_down": (7168, 1536), "q_up": (1536, 24576), "kv_down": (7168, 576),
              "kv_up": (512, 32768), "wo": (16384, 7168), "shared_gate": (7168, 2048),
              "shared_up": (7168, 2048), "shared_down": (2048, 7168)}
MLA_DECODE = ("q_down", "q_up", "kv_down", "wo", "shared_gate", "shared_up", "shared_down")
MLA_HEAD = (7168, 129280)
MLA_MTP_PROJ = (14336, 7168)
# absorbed decode vs expanded forward in f32 (activations and latent
# cache): the largest logit difference as a share of the largest |logit|.
# The two forms sum the same f32 products in other orders (1.6e-7 of 0.5
# on the reduced model); in bf16 a router near-tie can flip an expert
# between them, so the bf16 check holds the tokens only (a near-tie rule)
MLA_FORMS_TOL = 1e-3
WHISPER_ARCH = "whisper-small"
WHISPER_SHAPES = [(768, 768), (768, 3072), (3072, 768)]
# whisper's model-level check (f32): cache slots and context, prompt length
WHISPER_CHECK = dict(slots=2, max_len=64, prompt=8)
WHISPER_TOL = 1e-3          # f32: the same products summed in other orders


def phase_train_moe():
    """A reduced deepseek-v3 (MLA + MTP) and a reduced olmoe (f32), two
    steps each on the card and on the CPU from the same params and
    batches: the losses agree within 1e-4, and the loss carries the
    load-balance term (0.01 x ``moe_aux_loss``) and, with MTP, 0.3 x the
    shift-2 CE: it exceeds the bare next-token CE by at least the first."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    from repro_torch.models.registry import build
    from repro_torch.training import train_loop

    tcfg = train_config(learning_rate=1e-3, admm_enabled=False)
    rows = {}
    for arch in (MLA_ARCH, MOE_ARCH):
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        params = build(cfg, device="cpu").init(0)
        ds = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
        out = {}
        for dev in ("cpu", "cuda"):
            model = build(cfg, device=dev)
            p = _tree_to(params, dev)
            with torch.no_grad():
                b0 = lm_batch(ds, 0, dev)
                hidden, aux = model.forward(p, b0, return_hidden=True)
                bare = float(train_loop.chunked_ce(hidden, model.head_matrix(p), b0["tokens"]))
                full = float(train_loop.hidden_loss(model, p, b0, hidden, aux))
            state, _ = train_loop.init_train_state(model, tcfg, params=p)
            step = train_loop.make_train_step(model, tcfg)
            losses = []
            for i in range(2):
                state, metrics = step(state, lm_batch(ds, i, dev))
                losses.append(float(metrics["loss"]))
            out[dev] = {"losses": losses, "bare_ce": bare, "loss": full,
                        "moe_aux_loss": float(aux["moe_aux_loss"]), "mtp": "mtp_hidden" in aux}
        err = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"]["losses"], out["cpu"]["losses"]))
        card = out["cuda"]
        extra = card["loss"] - card["bare_ce"] - 0.01 * card["moe_aux_loss"]
        rows[arch] = {"runs": out, "max_rel_loss_err": err, "mtp_term": extra}
        ok = (err <= 1e-4 and abs(card["losses"][0] - card["loss"]) <= 1e-4 * card["loss"]
              and card["moe_aux_loss"] > 0 and card["mtp"] == (arch == MLA_ARCH)
              and (extra > 0.1 if card["mtp"] else abs(extra) <= 1e-4 * card["loss"]))
        if not ok:
            raise AssertionError(f"{arch}: the MoE train step on the card: {rows[arch]}")
    emit("train_moe", **rows)


def polarize_rows(gen, shapes, flush, rule="energy"):
    """Kernel #4 (``rule``: energy, as ``compress_tree`` calls it, or the
    ADMM Z-update's sum) at each matrix shape: bit for bit with its plain
    version, timed beside it and its bound."""
    import torch
    from repro_torch.kernels.admm_polarize import admm_polarize
    from repro_torch.kernels.ref import ref_admm_polarize
    rows = []
    for K, N in shapes:
        v = torch.randn((K, N), generator=gen, device="cuda")
        outp, signs = admm_polarize(v, m=8, rule=rule)
        want_p, want_s = ref_admm_polarize(v, 8, rule)
        torch.cuda.synchronize()
        rec = {"K": K, "N": N, "equal": torch.equal(outp.view(torch.int32),
                                                     want_p.view(torch.int32))
               and torch.equal(signs, want_s)}
        del outp, signs, want_p, want_s
        rec["kernel_ms"] = timed_ms(lambda: admm_polarize(v, m=8, rule=rule), flush)
        rec["plain_ms"] = timed_ms(lambda: ref_admm_polarize(v, 8, rule), flush, reps=5)
        rec["bound_ms"], rec["bound_by"] = polarize_bound((K, N))
        rows.append(rec)
        del v
        torch.cuda.empty_cache()
    if not all(r["equal"] for r in rows):
        raise AssertionError(f"kernel #4 disagrees with its plain version: {rows}")
    return rows


def teacher_forced_check(engine, prompts, tokens):
    """The served engine's per-step logits, teacher-forced over its greedy
    tokens (exact-length paged prefill, then T=1 decode at M = slots), held
    against the full-sequence ``forward`` over prompt + tokens: the largest
    difference, the largest |logit|, how many tokens are not forward's
    argmax, and the largest margin (forward's top logit less the token's)
    of those."""
    import torch
    from repro_torch.forms import default_spec
    seq = torch.tensor([tokens[i] for i in range(len(prompts))], device="cuda")
    with torch.inference_mode(), default_spec(engine.runner.spec):
        forced = forced_logits(engine, prefilled(engine, prompts), seq)
    diff, top, parted, worst = 0.0, 0.0, 0, 0.0
    for i, p in enumerate(prompts):
        n = len(p)
        full = target_logits(engine, list(p) + tokens[i][:-1])[n - 1:]
        diff = max(diff, float((forced[i] - full).abs().max()))
        top = max(top, float(full.abs().max()))
        picked = full.gather(1, seq[i][:, None].long())[:, 0]
        margin = full.max(dim=1).values - picked
        parted += int((margin > 0).sum())
        worst = max(worst, float(margin.max()))
    return {"max_logit_diff": diff, "max_abs_logit": top, "tokens_not_argmax": parted,
            "worst_margin": worst}


def phase_mla():
    """Full-width deepseek-v3 (d_model 7168, 128 heads, MLA q_lora 1536 /
    kv_lora 512 / nope, rope, v 128, 64, 128, moe_d_ff 2048, one shared
    expert, top-8, vocab 129280, untied head, MTP on), depth cut to 4
    layers and routed experts to 16 (``MLA_CUT``, with
    ``dataclasses.replace``), random weights from seed 0, compressed by
    FORMS (m=8, 8 bits, energy rule; the polarizations reckoned) and
    served on the paged cache, the slice's 4 prompts at exact length, 16
    new tokens, twice (the same tokens), then on the dense slot cache
    (the same tokens, or a first parting at a near-tie).  Decode ms per
    step beside its byte bound, prefill ms, peak memory, #1 launches
    reckoned (7 per layer and the head per decode step: ``kv_up`` is
    rebuilt by the absorbed decode, not launched).  At a capacity factor
    of experts / top-k (no token dropped), the engine's teacher-forced
    decode logits (absorbed) against ``forward`` (expanded) on the same
    tree.  The same tree served on a world of one (:func:`mesh_serve`,
    near-tie threshold: the bf16 check's logit difference).  Then #1 held
    at every (shape, M) of the run and timed at M=4, #4 bit for bit at each
    matrix shape and timed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import paths
    from repro_torch.forms import FormsSpec, compress_tree, compressed_paths
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import ServingEngine

    published = get_config(MLA_ARCH)
    cfg = dataclasses.replace(published, **MLA_CUT)
    model = build(cfg, device="cuda")
    spec = FormsSpec(m=8, bits=8, rule="energy")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = synced_ms(model.init, 0)
    n_params = sum(v.numel() for v in paths.leaves(params))
    reset_counts()
    with torch.inference_mode():
        (tree, rep), compress_ms = synced_ms(compress_tree, params, spec)
    pol_launches = launch_counts()["admm_polarize"]
    del params
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = compressed_paths(tree)
    per_block = 5 + 3 + 3 * cfg.num_experts          # MLA, shared, routed experts
    want_pol = cfg.num_layers * per_block + (1 + per_block) + 1   # + MTP (proj, block), head
    matrices = sum(int(torch.tensor(leaf.mags.shape[:-2]).prod()) for leaf in leaves.values())
    if pol_launches != want_pol or matrices != want_pol or any("router" in p for p in leaves):
        raise AssertionError(f"compress_tree polarized {pol_launches} matrices "
                             f"({matrices} in the tree), reckoned {want_pol}")
    tree_gb = sum(t.numel() * t.element_size() for leaf in leaves.values()
                  for t in (leaf.mags, leaf.signs, leaf.scale)) / 1e9
    prompts = slice_prompts(cfg)
    lens = [len(p) for p in prompts]
    kw = dict(spec=spec, batch_slots=4, max_len=SERVE_MAX_LEN, decode_block=4, device="cuda")
    engine = ServingEngine(model, tree, page_size=16, **kw)
    if [engine.runner.bucket_for(n) for n in lens] != lens:
        raise AssertionError("the MLA engine padded a prompt")
    route = wide_route(narrowest(tree))
    L = cfg.num_layers
    runs = []
    for _ in range(2):
        run = served(engine, prompts)
        want = [0, 0]
        for n in lens:
            want[route(n)] += 8 * L          # the 5 MLA projections and the shared expert
            want[route(1)] += 1              # the head at the prompt's last row
        want[route(DECODE_M)] += run["decode_steps"] * (7 * L + 1)
        got = [run["counts"]["polarized_matmul"], run["counts"]["polarized_matmul_tc"]]
        if got != want:
            raise AssertionError(f"mla: launched {got}, reckoned {want}")
        run["launches"] = got
        runs.append(run)
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError("two greedy MLA runs gave other tokens")
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dense = served(ServingEngine(model, tree, page_size=0, **kw), prompts)
    dense_part = first_divergence(engine, prompts, runs[0]["tokens"], dense["tokens"])
    # absorbed (decode) against expanded (forward), no token dropped: in
    # bf16 as served, and in f32 with an f32 latent cache
    no_drop = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    checks = {}
    for dtype in ("bfloat16", "float32"):
        m = build(dataclasses.replace(no_drop, dtype=dtype), device="cuda")
        if dtype == "float32":
            paged = m.init_paged_cache
            m = dataclasses.replace(
                m, init_paged_cache=lambda n, ps, slots=1, max_len=None, dtype=torch.float32:
                paged(n, ps, slots, max_len, dtype=dtype))
        check_engine = ServingEngine(m, tree, page_size=16, **kw)
        checks[dtype] = teacher_forced_check(check_engine, prompts,
                                             served(check_engine, prompts)["tokens"])
        del check_engine
    check = checks["float32"]
    check["tol"] = MLA_FORMS_TOL * check["max_abs_logit"]
    if dense_part is not None and not dense_part["top2_margin"] < check["max_logit_diff"]:
        raise AssertionError(f"the dense cache parted from the paged one away from a "
                             f"near-tie: {dense_part}")
    if not (check["max_logit_diff"] <= check["tol"] and check["tokens_not_argmax"] == 0
            and checks["bfloat16"]["worst_margin"] <= checks["bfloat16"]["max_logit_diff"]):
        raise AssertionError(f"absorbed decode disagrees with the expanded forward: {checks}")
    # the step's byte bound: #1's codes, signs and scales, and the bytes
    # the rebuilds read (routed experts and kv_up, uint8 codes + signs)
    def code_bytes(K, N):
        return K * N + (K // 8) * N + N * 4
    kern_bytes = L * sum(code_bytes(*MLA_SHAPES[n]) for n in MLA_DECODE) + code_bytes(*MLA_HEAD)
    expert = sum(code_bytes(*MLA_SHAPES[n]) for n in ("shared_gate", "shared_up",
                                                       "shared_down"))
    rebuilt = L * (cfg.num_experts * expert + code_bytes(*MLA_SHAPES["kv_up"]))
    mesh = mesh_serve("mla", model, tree, kw, prompts, engine, runs[0]["tokens"],
                      checks["bfloat16"]["max_logit_diff"])
    del engine, tree
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()
    shapes = sorted(set(MLA_SHAPES.values()))
    held = [held_matmul(gen, M, K, N) for M in sorted(set(lens)) for K, N in shapes]
    held += [held_matmul(gen, 1, *MLA_HEAD)]
    decode_rows = {name: held_matmul(gen, DECODE_M, *MLA_SHAPES[name], flush=flush)
                   for name in ("q_down", "q_up", "kv_down", "wo", "shared_gate",
                                "shared_down")}
    decode_rows["shared_up"] = decode_rows["shared_gate"]
    head_row = held_matmul(gen, DECODE_M, *MLA_HEAD, flush=flush)
    held += list(decode_rows.values())[:-1] + [head_row]
    layer = {k: sum(decode_rows[n][k] for n in MLA_DECODE)
             for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    layer["bound_by"] = bound_by([decode_rows[n] for n in MLA_DECODE])
    pol = polarize_rows(gen, sorted(set(MLA_SHAPES.values())) + [MLA_MTP_PROJ, MLA_HEAD],
                        flush)
    by_shape = {(r["K"], r["N"]): r for r in pol}
    block_shapes = ([MLA_SHAPES[n] for n in ("q_down", "q_up", "kv_down", "kv_up", "wo")]
                    + [MLA_SHAPES[n] for n in ("shared_gate", "shared_up", "shared_down")]
                    * (1 + cfg.num_experts))
    pol_layer = {k: sum(by_shape[s][k] for s in block_shapes)
                 for k in ("kernel_ms", "plain_ms", "bound_ms")}
    pol_layer["bound_by"] = bound_by([by_shape[s] for s in set(block_shapes)])
    del scrub
    last = runs[-1]
    emit("mla", arch=cfg.name, cut={k: [getattr(published, k), v] for k, v in MLA_CUT.items()},
         d_model=cfg.d_model, heads=cfg.num_heads, mla=dataclasses.asdict(cfg.mla),
         top_k=cfg.experts_per_token, moe_d_ff=cfg.moe_d_ff, vocab=cfg.vocab_size,
         mtp=cfg.mtp, params=n_params, init_ms=init_ms, compress_s=compress_ms / 1e3,
         compression=rep.summary(), tree_gb=tree_gb, peak_gb=peak_gb,
         serve_peak_gb=serve_peak_gb, polarize_launches=pol_launches, prompt_lens=lens,
         decode_steps=last["decode_steps"],
         decode_step_ms=[r["decode_step_ms"] for r in runs + [dense]],
         mean_prefill_ms=[r["mean_prefill_ms"] for r in runs + [dense]],
         kernel_code_gb=kern_bytes / 1e9, kernel_bound_ms=kern_bytes / HBM_BYTES_PER_S * 1e3,
         rebuilt_code_gb=rebuilt / 1e9,
         step_bound_ms=(kern_bytes + rebuilt) / HBM_BYTES_PER_S * 1e3,
         launches=last["launches"], launches_per_decode_step=7 * L + 1,
         dense_tokens_equal=dense["tokens"] == runs[0]["tokens"], dense_first_part=dense_part,
         tokens=last["tokens"])
    emit("mla_check", capacity_factor=no_drop.capacity_factor, **checks,
         note="the engine's decode logits (absorbed; #1 at M=4) teacher-forced against "
              "forward (expanded; #1 at M = prompt + 15) on the same tree: bf16 as served "
              "(bf16 latent cache), and f32 activations with an f32 latent cache (tol)")
    emit("mla_kernels", held=[[r["M"], r["K"], r["N"], r["route"]] for r in held],
         max_abs_err=max(r["max_abs_err"] for r in held),
         max_rel_err=max(r["max_rel_err"] for r in held),
         decode_m4={n: {k: decode_rows[n][k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                                       "bound_ms", "bound_by")}
                    for n in decode_rows}, layer_m4=layer, head_m4=head_row,
         polarize=pol, polarize_layer=pol_layer)
    return {"launches": last["launches"], "polarize_launches": pol_launches,
            "layer_m4": layer, "head_m4": head_row, "held": held, "pol_layer": pol_layer,
            "mesh_launches": mesh}


def phase_whisper():
    """Full-width whisper-small (12 encoder and 12 decoder layers, d_model
    768, 12 heads, d_ff 3072, vocab 51865, tied head; random weights from
    seed 0), compressed by FORMS (m=8, 8 bits, energy rule; the
    polarizations reckoned) and served on the paged cache against the zero
    encoder context the engine leaves (as the reference's), the slice's 4
    prompts, 16 new tokens, twice (the same tokens): decode and prefill
    ms, launches reckoned (per decoder layer 8 projections at M = the
    bucket or the slots, and the cross k/v at M = max_len per prefill and
    M = slots x max_len per step, on the tensor-core route).  Then the
    model at f32 on the same tree: ``encode`` of seeded frames written into
    ``enc_out``, prefill logits against stepwise decode, on the card and on
    the CPU (the plain versions), each held at WHISPER_TOL of the largest
    |value|.  The served tree on a world of one (:func:`mesh_serve`, the
    tokens exactly).  #1 held at every (shape, M) of the run and timed at
    M=4, #4 bit for bit at the three matrix shapes."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import paths
    from repro_torch.forms import FormsSpec, compress_tree, compressed_paths
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.models import whisper as W
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import ServingEngine, prefill_bucket

    cfg = get_config(WHISPER_ARCH)
    model = build(cfg, device="cuda")
    spec = FormsSpec(m=8, bits=8, rule="energy")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0)
    n_params = sum(v.numel() for v in paths.leaves(params))
    reset_counts()
    with torch.inference_mode():
        (tree, rep), compress_ms = synced_ms(compress_tree, params, spec)
    pol_launches = launch_counts()["admm_polarize"]
    del params
    L, Le = cfg.num_layers, cfg.encoder_layers
    want_pol = 1 + 6 * Le + 10 * L
    if pol_launches != want_pol or len(compressed_paths(tree)) != 17:
        raise AssertionError(f"whisper: {pol_launches} polarizations, reckoned {want_pol}")
    engine = ServingEngine(model, tree, spec=spec, page_size=16, batch_slots=4,
                           max_len=SERVE_MAX_LEN, decode_block=4, device="cuda")
    enc_out = engine.cache.dense["enc_out"]
    prompts = slice_prompts(cfg)
    buckets = [prefill_bucket(len(p), SERVE_MAX_LEN) for p in prompts]
    route = wide_route(narrowest(tree))
    runs = []
    for _ in range(2):
        run = served(engine, prompts)
        want = [0, 0]
        for b in buckets:
            want[route(b)] += 8 * L
            want[route(SERVE_MAX_LEN)] += 2 * L
        want[route(DECODE_M)] += run["decode_steps"] * 8 * L
        want[route(DECODE_M * SERVE_MAX_LEN)] += run["decode_steps"] * 2 * L
        got = [run["counts"]["polarized_matmul"], run["counts"]["polarized_matmul_tc"]]
        if got != want:
            raise AssertionError(f"whisper: launched {got}, reckoned {want}")
        run["launches"] = got
        runs.append(run)
    if runs[0]["tokens"] != runs[1]["tokens"] or float(enc_out.abs().max()) != 0.0:
        raise AssertionError("two greedy whisper runs differ, or enc_out was written")
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kw = dict(spec=spec, batch_slots=4, max_len=SERVE_MAX_LEN, decode_block=4, device="cuda")
    mesh = mesh_serve("whisper", model, tree, kw, prompts, engine, runs[0]["tokens"], 0.0)
    del engine
    # the model at f32, card and CPU, on the same tree
    c = WHISPER_CHECK
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen_cpu = torch.Generator().manual_seed(3)
    frames = torch.randn((c["slots"], c["max_len"], cfg.d_model), generator=gen_cpu)
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, c["prompt"]).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        m32 = build(cfg32, device=dev)
        t = _tree_to_dev(tree, dev)
        with torch.inference_mode():
            enc = W.encode(cfg32, t, frames.to(dev))
            cache = m32.init_cache(c["slots"], c["max_len"], dtype=torch.float32)
            cache["enc_out"].copy_(enc)
            pre, _ = m32.prefill(t, torch.from_numpy(prompt[None]).to(dev), cache, 1,
                                 len(prompt))
            cache = m32.init_cache(c["slots"], c["max_len"], dtype=torch.float32)
            cache["enc_out"].copy_(enc)
            pos = torch.zeros(c["slots"], dtype=torch.int32, device=dev)
            for tok in prompt:
                tb = torch.zeros((c["slots"], 1), dtype=torch.int32, device=dev)
                tb[1, 0] = int(tok)
                lg, cache = m32.decode_step(t, tb, cache, pos.clone())
                pos[1] += 1
        out[dev] = {"enc": enc.cpu(), "prefill": pre[0].cpu(), "step": lg[1, 0].cpu()}
        del t
    rel = lambda a, b: float((a - b).abs().max()) / float(b.abs().max())
    model_check = {"prefill_vs_step_card": rel(out["cuda"]["step"], out["cuda"]["prefill"]),
                   "prefill_vs_step_cpu": rel(out["cpu"]["step"], out["cpu"]["prefill"]),
                   **{f"{k}_card_vs_cpu": rel(out["cuda"][k], out["cpu"][k])
                      for k in ("enc", "prefill", "step")},
                   "argmax_equal": int(out["cuda"]["step"].argmax()) == int(
                       out["cpu"]["prefill"].argmax()),
                   "tol": WHISPER_TOL}
    if not all(v <= WHISPER_TOL for k, v in model_check.items()
               if isinstance(v, float) and k != "tol"):
        raise AssertionError(f"whisper's model check: {model_check}")
    del tree
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()
    held = [held_matmul(gen, M, K, N) for M in sorted(set(buckets)) for K, N in WHISPER_SHAPES]
    attn, up, down = WHISPER_SHAPES
    held += [held_matmul(gen, SERVE_MAX_LEN, *attn)]
    cross = held_matmul(gen, DECODE_M * SERVE_MAX_LEN, *attn, flush=flush)
    m4 = {s: held_matmul(gen, DECODE_M, *s, flush=flush) for s in WHISPER_SHAPES}
    held += [cross] + list(m4.values())
    calls = {attn: 6, up: 1, down: 1}
    layer = {k: sum(m4[s][k] * n for s, n in calls.items())
             for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    layer["bound_by"] = bound_by(list(m4.values()))
    pol = polarize_rows(gen, WHISPER_SHAPES, flush)
    del scrub
    last = runs[-1]
    emit("whisper", arch=cfg.name, layers=[Le, L], d_model=cfg.d_model, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, params=n_params, compress_s=compress_ms / 1e3,
         compression=rep.summary(), polarize_launches=pol_launches, buckets=buckets,
         decode_steps=last["decode_steps"],
         decode_step_ms=[r["decode_step_ms"] for r in runs],
         mean_prefill_ms=[r["mean_prefill_ms"] for r in runs], serve_peak_gb=serve_peak_gb,
         launches=last["launches"], launches_per_decode_step=[8 * L, 2 * L],
         model_check=model_check, tokens=last["tokens"])
    emit("whisper_kernels", held=[[r["M"], r["K"], r["N"], r["route"]] for r in held],
         max_abs_err=max(r["max_abs_err"] for r in held),
         max_rel_err=max(r["max_rel_err"] for r in held), layer_m4=layer, cross_kv=cross,
         polarize=pol)
    return {"launches": last["launches"], "polarize_launches": pol_launches,
            "layer_m4": layer, "cross_kv": cross, "mesh_launches": mesh}


# --------------------------------------------------------------------------
# MLA and whisper on a device mesh: serving, #1/#2 at their shard shapes,
# sharded training and #4 at their training shards
# --------------------------------------------------------------------------

# the local shard shapes of deepseek-v3's and whisper-small's FORMS leaves
# on a model axis of tp: (name, K, N, how the spec cuts it).  q_up, kv_up
# and the shared experts' gate/up by columns, wo and shared_down by
# whole-fragment rows; whisper's self- and cross-attention q/k/v and
# mlp/up by columns, wo and mlp/down by rows (its 12 heads do not divide
# 8: the columns still split, and the block runs on all heads there)
MLA_SHARD_PROJ = (("mla/q_up", 1536, 24576, "n"), ("mla/kv_up", 512, 32768, "n"),
                  ("mla/wo", 16384, 7168, "k"), ("moe/shared_gate|up", 7168, 2048, "n"),
                  ("moe/shared_down", 2048, 7168, "k"))
WHISPER_SHARD_PROJ = (("attn|xattn/wq|wk|wv", 768, 768, "n"), ("attn|xattn/wo", 768, 768, "k"),
                      ("mlp/up", 768, 3072, "n"), ("mlp/down", 3072, 768, "k"))
# xlstm-350m's and zamba2-2.7b's: xLSTM's N-split projections (the mLSTM's
# q/k/v/o on bf16 x, the sLSTM's z/i/f on f32 x) and the mLSTM's wi/wf
# (N = 4 heads: 2 and 1 columns at tp = 2 and 4, whole at 8), its wout and
# wo_g whole (no shard); Zamba2's shared block by columns (q/k/v, gate/up)
# and whole-fragment rows (wo, down), its Mamba leaves whole (no rule
# matches blocks/in_proj or blocks/out_proj)
XLSTM_SHARD_PROJ = (("mlstm/wq|wk|wv|wo", 1024, 1024, "n"), ("mlstm/wi|wf", 1024, 4, "n"),
                    ("slstm/wz|wi|wf (f32 x)", 1024, 1024, "n", "float32"))
ZAMBA_SHARD_PROJ = (("shared_attn/attn/wq|wk|wv", 2560, 2560, "n"),
                    ("shared_attn/attn/wo", 2560, 2560, "k"),
                    ("shared_attn/mlp/gate|up", 2560, 10240, "n"),
                    ("shared_attn/mlp/down", 10240, 2560, "k"))
CROSS_KV_M = DECODE_M * SERVE_MAX_LEN    # the cross k/v of a decode step: slots x max_len
MESH_TRAIN_FAMILY_STEPS = 2
# deepseek-v3's train cut: the most layers (at most MLA_CUT's), then the
# most routed experts (MLA_CUT's, halved down to top-k), whose state,
# gradients and step transients, reckoned from their bytes, leave about 10
# GB of the card's 80 GB.  The transients are reckoned as 4 x the largest
# leaf in f32 (the int8 AdamW's f32 moments and update of one leaf): a
# 1-layer, 16-expert cut (state and gradients 61.5 GB) ran out of memory
# at ~74.6 GB in its first step's AdamW
MLA_TRAIN_BUDGET = 70e9
MLA_TRAIN_TRANSIENT_LEAVES = 4
MLA_TRAIN = dict(seq_len=64, global_batch=2, moment_dtype="int8")
WHISPER_TRAIN = dict(seq_len=64, global_batch=2, moment_dtype="float32")
# the recurrent families' sharded train pairs: xlstm-350m at full width
# (5.96 GB reckoned with f32 moments); zamba2-2.7b at the deepest depth in
# whole groups of shared_attn_every Mamba blocks that MLA_TRAIN_BUDGET
# holds, reckoned as deepseek-v3's with int8 moments (full width, 54
# layers: 66.05 GB; f32 moments would take 80.58 GB)
XLSTM_TRAIN = dict(seq_len=64, global_batch=2, moment_dtype="float32")
ZAMBA_TRAIN = dict(seq_len=64, global_batch=2, moment_dtype="int8")


def mesh_serve(label, model, tree, kw, prompts, plain_engine, plain_tokens, threshold):
    """A family phase's compressed tree served by ``ServingEngine(mesh=
    make_mesh(MeshConfig(data=1, model=1)))`` on a world of one over NCCL
    beside the phase's plain engine, plain, mesh, mesh, plain: every run's
    tokens equal the plain engine's (or part first at a near-tie whose
    top-2 margin lies below ``threshold``, the phase's measured logit
    difference; 0: exactly), every run's launches equal and each kernel of
    the path launched.  Returns the mesh run's launches (f32, tc)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import MeshConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import ServingEngine

    t0 = time.perf_counter()
    mesh = make_mesh(MeshConfig(data=1, model=1), device="cuda")
    init_s = time.perf_counter() - t0
    engine = ServingEngine(model, tree, page_size=16, **kw, mesh=mesh)
    order = [("plain", plain_engine), ("mesh", engine), ("mesh", engine), ("plain", plain_engine)]
    runs = [(name, served(eng, prompts)) for name, eng in order]
    launches = [[r["counts"]["polarized_matmul"], r["counts"]["polarized_matmul_tc"]]
                for _, r in runs]
    parts = [first_divergence(plain_engine, prompts, plain_tokens, r["tokens"])
             for _, r in runs]
    del engine
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    step_ms = {name: [r["decode_step_ms"] for n, r in runs if n == name]
               for name in ("plain", "mesh")}
    emit(f"mesh_{label}", arch=model.config.name, mesh={"data": 1, "model": 1},
         backend="nccl", world=1, init_s=init_s, decode_steps=runs[1][1]["decode_steps"],
         decode_step_ms=step_ms,
         decode_step_ms_mean={k: float(np.mean(v)) for k, v in step_ms.items()},
         mean_prefill_ms={name: [r["mean_prefill_ms"] for n, r in runs if n == name]
                          for name in ("plain", "mesh")},
         launches=launches[1], tokens_equal=all(p is None for p in parts), first_parts=parts,
         near_tie_threshold=threshold, nvidia_smi=nvidia_smi_line())
    if any(p is not None and not p["top2_margin"] < threshold for p in parts):
        raise AssertionError(f"{label} on a mesh: tokens parted from the plain engine's "
                             f"away from a near-tie: {parts}")
    if any(n != launches[0] for n in launches) or not all(launches[1]):
        raise AssertionError(f"{label}: launches differ between the plain and the mesh "
                             f"engine, or a kernel never ran: {launches}")
    return launches[1]


def shard_rows(label, projs, gen, flush, ms=(DECODE_M, PREFILL_M)):
    """Kernels #1 and #2 (every other K slice dead) held and timed at every
    local shard shape of ``projs`` ((name, K, N, cut[, x dtype])) at model =
    SHARD_TP, at each M of ``ms`` on bf16 x (or the projection's x dtype):
    two launches equal bit for bit, #2 equal to #1.  A dim that tp does not
    divide replicates (the rank holds the whole leaf, held in its family's
    phase): no row."""
    import torch
    rows = {"polarized_matmul": [], "polarized_matmul_skip": []}
    for tp in SHARD_TP:
        for name, K, N, cut, *xd in projs:
            if (K if cut == "k" else N) % tp:
                continue
            xd = getattr(torch, xd[0]) if xd else None
            k, n = (K // tp, N) if cut == "k" else (K, N // tp)
            for M in ms:
                one = held_matmul(gen, M, k, n, flush=flush, x_dtype=xd)
                two = held_skip(gen, M, k, n, flush, x_dtype=xd)
                for key, rec in (("polarized_matmul", one), ("polarized_matmul_skip", two)):
                    rec.update(tp=tp, proj=name)
                    rows[key].append(rec)
                    emit(label, kernel=key, **rec)
    return rows


def phase_mesh_shards():
    """#1 and #2 at the local shard shapes that model = 2, 4 and 8 give
    deepseek-v3's, whisper-small's, xlstm-350m's and zamba2-2.7b's FORMS
    leaves (``MLA_SHARD_PROJ``, ``WHISPER_SHARD_PROJ``, ``XLSTM_SHARD_PROJ``,
    ``ZAMBA_SHARD_PROJ``) at M=4 and M=64, and whisper's cross k/v at M =
    slots x max_len.  Returns the rows by family."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()
    out = {"mla": shard_rows("mesh_mla_kernel", MLA_SHARD_PROJ, gen, flush),
           "whisper": shard_rows("mesh_whisper_kernel", WHISPER_SHARD_PROJ, gen, flush),
           "xlstm": shard_rows("mesh_xlstm_kernel", XLSTM_SHARD_PROJ, gen, flush),
           "zamba": shard_rows("mesh_zamba_kernel", ZAMBA_SHARD_PROJ, gen, flush)}
    narrow = sorted({r["N"] for r in out["xlstm"]["polarized_matmul"] if r["N"] < 4})
    if narrow != [1, 2]:
        raise AssertionError(f"the mLSTM's wi/wf shards were not held at N = 1 and 2: {narrow}")
    cross = shard_rows("mesh_whisper_kernel", (("xattn/wk|wv (cross k/v)", 768, 768, "n"),),
                       gen, flush, ms=(CROSS_KV_M,))
    for key, rs in cross.items():
        out["whisper"][key] += rs
    emit("mesh_shards", rows={f: {k: len(v) for k, v in r.items()} for f, r in out.items()},
         nvidia_smi=nvidia_smi_line())
    return out


def reckon_train_gb(cfg, moment_dtype):
    """The train state (``moment_dtype`` moments, ADMM), gradients and
    transients (MLA_TRAIN_TRANSIENT_LEAVES x the largest leaf in f32) of
    ``cfg`` in GB, reckoned on fake tensors (nothing allocated)."""
    from repro_torch.analysis import opcount
    from repro_torch.core import paths
    from repro_torch.launch import dryrun as D
    from repro_torch.models.registry import build
    from repro_torch.training import train_loop

    tcfg = train_config(moment_dtype=moment_dtype)
    with D.fake_mode():
        state, _ = train_loop.init_train_state(build(cfg, device="cpu"), tcfg,
                                               params=D.param_specs(cfg, "cpu"))
        state_b = opcount.tree_bytes([state.params, state.opt.mu, state.opt.nu,
                                      state.opt.mu_scale, state.opt.nu_scale, state.admm])
        grads_b = opcount.tree_bytes(state.params)
        largest = max(t.numel() for t in paths.leaves(state.params)) * 4
    return (state_b + grads_b + MLA_TRAIN_TRANSIENT_LEAVES * largest) / 1e9


def mla_train_cut():
    """deepseek-v3's train cut (see MLA_TRAIN_BUDGET): each (layers,
    experts) candidate reckoned by :func:`reckon_train_gb`; the deepest
    that fits, then the one with the most experts.  Returns (the config,
    the reckoning in GB)."""
    from repro_torch.configs import get_config

    published = get_config(MLA_ARCH)
    experts = [e for e in (MLA_CUT["num_experts"] >> i for i in range(5))
               if e >= published.experts_per_token]
    reckoned = {f"{layers}x{e}": reckon_train_gb(
                    dataclasses.replace(published, num_layers=layers, num_experts=e),
                    MLA_TRAIN["moment_dtype"])
                for layers in range(1, MLA_CUT["num_layers"] + 1) for e in experts}
    fits = [tuple(map(int, k.split("x"))) for k, gb in reckoned.items()
            if gb * 1e9 <= MLA_TRAIN_BUDGET]
    if not fits:
        raise AssertionError(f"no cut of deepseek-v3 fits the card: {reckoned}")
    layers, e = max(fits)
    return (dataclasses.replace(published, num_layers=layers, num_experts=e),
            {"reckoned_gb": reckoned, "budget_gb": MLA_TRAIN_BUDGET / 1e9})


def zamba_train_cut():
    """zamba2-2.7b's train depth (see ZAMBA_TRAIN): the deepest in whole
    groups of ``shared_attn_every`` Mamba blocks whose reckoning
    (:func:`reckon_train_gb`) MLA_TRAIN_BUDGET holds, the published 54 if it
    does.  Returns (the config, the reckoning in GB)."""
    from repro_torch.configs import get_config

    published = get_config(ZAMBA_ARCH)
    per = published.shared_attn_every
    reckoned = {}
    for layers in range(published.num_layers, 0, -per):
        reckoned[layers] = reckon_train_gb(dataclasses.replace(published, num_layers=layers),
                                           ZAMBA_TRAIN["moment_dtype"])
        if reckoned[layers] * 1e9 <= MLA_TRAIN_BUDGET:
            return (dataclasses.replace(published, num_layers=layers),
                    {"reckoned_gb": reckoned, "budget_gb": MLA_TRAIN_BUDGET / 1e9})
    raise AssertionError(f"no depth of zamba2-2.7b fits the card: {reckoned}")



def train_pair(cfg, tcfg, shape):
    """The plain train step and the sharded one on a world of one over NCCL
    (``make_train_step(ctx=)``, the state placed by ``place_train_state``),
    each alone on the card (one state at a time), from the same seed and
    batches (``launch.train.train_batch``: whisper's frames too), under
    deterministic algorithms: MESH_TRAIN_FAMILY_STEPS steps with a Z-update
    after each.  Each run's losses, gradient norms, the float64 sum of
    every param and Z leaf afterwards, #4's launches, step ms and peak
    memory."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import MeshConfig
    from repro_torch.core import paths
    from repro_torch.data.synthetic import LMStreamConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_batch
    from repro_torch.models.registry import build
    from repro_torch.training import train_loop

    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode in ("plain", "mesh"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model = build(cfg, device="cuda")
            ds = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=shape["seq_len"],
                                global_batch=shape["global_batch"], seed=0)
            batches = [train_batch(model, ds, i, torch.device("cuda"))
                       for i in range(MESH_TRAIN_FAMILY_STEPS)]
            t0 = time.perf_counter()
            ctx = None
            state, table = train_loop.init_train_state(model, tcfg)
            if mode == "mesh":
                ctx = shd.ParallelContext.for_mesh(make_mesh(MeshConfig(data=1, model=1),
                                                             device="cuda"))
                state = shd.place_train_state(state, ctx, table)
            step = train_loop.make_train_step(model, tcfg, table, ctx=ctx)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            reset_counts()
            losses, gnorms, step_ms = [], [], []
            for i in range(MESH_TRAIN_FAMILY_STEPS):
                t = time.perf_counter()
                state, metrics = step(state, batches[i])
                state = train_loop.maybe_admm_update(state, table, tcfg, i + 1, ctx)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                losses.append(float(metrics["loss"]))
                gnorms.append(float(metrics["grad_norm"]))
            launches = launch_counts()["admm_polarize"]
            sums = {p: float(t.double().sum()) for p, t in paths.iter_leaves(state.params)}
            sums.update({f"z:{p}": float(st.z.double().sum()) for p, st in state.admm.items()})
            out[mode] = {"losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
                         "setup_s": setup_s, "admm_polarize_launches": launches,
                         "constrained_leaves": len(table), "sums": sums,
                         "params": sum(t.numel() for t in paths.leaves(state.params)),
                         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            del state, step, model, batches
            if ctx is not None:
                dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    return out


def phase_mesh_train_families(floor_ms):
    """Sharded training of whisper-small (full width), deepseek-v3 (MLA,
    its MoE and MTP module; at :func:`mla_train_cut`, printed), xlstm-350m
    (full width) and zamba2-2.7b (at :func:`zamba_train_cut`, printed) on
    a world of one: :func:`train_pair` with ADMM (a fresh Z-update after
    each of 2 steps): the sharded run equal to the plain one bit for bit
    (losses, gradient norms, every param and Z leaf's sum), #4 launched
    once per constrained leaf per Z-update in both.  Then #4 bit for bit at
    every training shard of their stacked leaves (xLSTM: one mLSTM and one
    sLSTM block's matrices; Zamba2: the Mamba stacks and the shared block)
    at data x model = 2x2, 4x2 and 8x1 (:func:`train_shard_rows`).  Returns
    the sharded runs' #4 launches and the shard rows."""
    import torch
    from repro_torch.configs import get_config

    mla_cfg, reckoning = mla_train_cut()
    zamba_cfg, zamba_reckoning = zamba_train_cut()
    families = {"whisper": (get_config(WHISPER_ARCH), WHISPER_TRAIN),
                "mla": (mla_cfg, MLA_TRAIN),
                "xlstm": (get_config(XLSTM_ARCH), XLSTM_TRAIN),
                "zamba": (zamba_cfg, ZAMBA_TRAIN)}
    launches = {}
    for name, (cfg, shape) in families.items():
        tcfg = train_config(total_steps=100, admm_update_every=1,
                            moment_dtype=shape["moment_dtype"])
        runs = train_pair(cfg, tcfg, shape)
        plain, mesh = runs["plain"], runs["mesh"]
        want = MESH_TRAIN_FAMILY_STEPS * plain["constrained_leaves"]
        equal = all(plain[k] == mesh[k] for k in ("losses", "grad_norms", "sums"))
        extra = {}
        if name == "mla":
            extra = {"cut": {k: [getattr(get_config(MLA_ARCH), k), getattr(cfg, k)]
                             for k in ("num_layers", "num_experts")}, **reckoning}
        if name == "zamba":
            extra = {"cut": {"num_layers": [get_config(ZAMBA_ARCH).num_layers,
                                            cfg.num_layers]}, **zamba_reckoning}
        emit(f"mesh_train_{name}", arch=cfg.name, mesh={"data": 1, "model": 1},
             backend="nccl", world=1, steps=MESH_TRAIN_FAMILY_STEPS, **shape, **extra,
             params=plain["params"], bit_equal=equal,
             **{f"{k}_{m}": runs[m][k] for m in ("plain", "mesh")
                for k in ("losses", "grad_norms", "step_ms", "setup_s",
                          "admm_polarize_launches", "peak_mem_gb")},
             admm_polarize_launches_reckoned=want, nvidia_smi=nvidia_smi_line())
        if not equal:
            raise AssertionError(f"{name}: the sharded step on a world of one differs from "
                                 f"the plain step")
        if not (plain["admm_polarize_launches"] == mesh["admm_polarize_launches"] == want):
            raise AssertionError(f"{name}: #4 launched {plain['admm_polarize_launches']} "
                                 f"(plain) and {mesh['admm_polarize_launches']} (mesh) "
                                 f"times, reckoned {want}")
        launches[name] = mesh["admm_polarize_launches"]
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()
    rows = {"whisper": train_shard_rows(gen, flush, floor_ms, WHISPER_TRAIN_LEAVES,
                                        "mesh_train_whisper_kernel"),
            "mla": train_shard_rows(gen, flush, floor_ms, mla_train_leaves(mla_cfg),
                                    "mesh_train_mla_kernel"),
            "xlstm": train_shard_rows(gen, flush, floor_ms, XLSTM_TRAIN_LEAVES,
                                      "mesh_train_xlstm_kernel"),
            "zamba": train_shard_rows(gen, flush, floor_ms, zamba_train_leaves(zamba_cfg),
                                      "mesh_train_zamba_kernel")}
    del scrub
    torch.cuda.empty_cache()
    return launches, rows


# whisper-small's stacked crossbar leaves (L, K, N): encoder self-attention
# and MLP, decoder self- and cross-attention and MLP
WHISPER_TRAIN_LEAVES = {
    **{f"enc_blocks/attn/{w}": (12, 768, 768) for w in ("wk", "wo", "wq", "wv")},
    "enc_blocks/mlp/down": (12, 3072, 768), "enc_blocks/mlp/up": (12, 768, 3072),
    **{f"dec_blocks/{a}/{w}": (12, 768, 768) for a in ("attn", "xattn")
       for w in ("wk", "wo", "wq", "wv")},
    "dec_blocks/mlp/down": (12, 3072, 768), "dec_blocks/mlp/up": (12, 768, 3072)}


# xlstm-350m's crossbar leaves, one block of each kind (every block of a
# kind has the same specs: the list counts as scanned): the mLSTM at block
# 1, the sLSTM at block 0
XLSTM_TRAIN_LEAVES = {
    **{f"blocks/1/mlstm/{w}": (1024, 1024) for w in ("wq", "wk", "wv", "wo", "wout")},
    **{f"blocks/1/mlstm/{w}": (1024, 4) for w in ("wi", "wf")},
    **{f"blocks/0/slstm/{w}": (1024, 1024) for w in ("wz", "wi", "wf", "wo_g", "wout")}}


def zamba_train_leaves(cfg):
    """zamba2-2.7b's crossbar leaves at ``cfg``'s depth: the stacked Mamba
    in_proj/out_proj (L, K, N) and the shared block's 7 matrices."""
    d, d_in = cfg.d_model, cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_head_dim
    return {"blocks/in_proj": (cfg.num_layers, d, 2 * d_in + 2 * cfg.ssm_state + heads),
            "blocks/out_proj": (cfg.num_layers, d_in, d),
            **{f"shared_attn/attn/{w}": (d, cfg.num_heads * cfg.hd())
               for w in ("wq", "wk", "wv", "wo")},
            **{f"shared_attn/mlp/{w}": (d, cfg.d_ff) for w in ("gate", "up")},
            "shared_attn/mlp/down": (cfg.d_ff, d)}


def mla_train_leaves(cfg):
    """deepseek-v3's stacked 3-D crossbar leaves (L, K, N) at ``cfg``'s
    depth: the five MLA projections and the shared expert's three (the
    routed experts' 4-D leaves are projected gathered, as a conv view)."""
    return {f"blocks/{'moe' if n.startswith('shared') else 'mla'}/{n}":
            (cfg.num_layers, *MLA_SHAPES[n]) for n in sorted(MLA_SHAPES)}


# --------------------------------------------------------------------------
# the recurrent families: xlstm-350m (sLSTM + mLSTM), zamba2-2.7b (Mamba2 +
# shared attention), served on the dense slot cache
# --------------------------------------------------------------------------

XLSTM_ARCH = "xlstm-350m"
XLSTM_SQUARE = (1024, 1024)   # mLSTM wq/wk/wv/wo/wout, sLSTM wz/wi/wf/wo_g/wout
XLSTM_GATES = (1024, 4)       # mLSTM wi/wf: N = num_heads, the element-wise staging path
XLSTM_HEAD = (1024, 50304)
ZAMBA_ARCH = "zamba2-2.7b"
ZAMBA_SHAPES = {"in_proj": (2560, 10448), "out_proj": (5120, 2560), "attn": (2560, 2560),
                "mlp_in": (2560, 10240), "mlp_out": (10240, 2560)}
ZAMBA_HEAD = (2560, 32000)
ZAMBA_CHECK_LAYERS = 6        # the model check's cut: one group (6 Mamba blocks + the shared one)
# the model check: an f32 model on the served tree; prefill of slot 1 of 2
# against stepwise decode, card against CPU, and forward at S = 256 with
# the default chunk (128: two chunks) against one chunk of 256
RECURRENT_CHECK = dict(slots=2, max_len=64, prompt=8, seq=256)
# of the largest |logit|: f32, other summation orders; the chunked form's
# decay ratios are differences of cumulative log-decays, which at zamba's
# fast decays reach ~1e3-1e4 within a chunk, so one chunk of 256 against two
# of 128 differs by ~f32 eps x that (8.2e-4 for zamba2-2.7b on an H100, PERF.md)
RECURRENT_TOL = 1e-3


def serve_recurrent(cfg, want_pol, launches_at, state_leaves, step_calls, label):
    """A recurrent family at ``cfg``, random weights from seed 0, compressed
    by FORMS (m=8, 8 bits, energy rule; ``want_pol`` polarizations
    reckoned) and served with ``page_size=16`` asked for: the engine falls
    back to the dense slot cache (``engine.paged`` False).  The slice's 4
    prompts at exact length, 16 new tokens, 4 slots, max_len 256,
    decode_block 4, twice (the same tokens), every run's launches equal to
    ``launches_at(n, 1)`` ([f32, tc] of an n-token prefill, the head at its
    last row) per prompt plus ``launches_at(4, 4)`` per decode step (M = 4
    slots), whose sum the tree reckons too: ``step_calls(path)`` calls of
    each compressed leaf per decode step.
    The decode step's byte bound: every code, sign and scale of the tree
    read once, and the recurrent state (the cache leaves in
    ``state_leaves``) read and written once.  Then ``mesh_serve`` (line
    ``mesh_<label>``): the same tree through ``ServingEngine(mesh=)`` on a
    world of one, its tokens and launches the plain engine's, so the
    launches reckoned here too."""
    import torch
    from repro_torch.core import paths
    from repro_torch.forms import FormsSpec, compress_tree, compressed_paths
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import ServingEngine, cache_nbytes

    model = build(cfg, device="cuda")
    spec = FormsSpec(m=8, bits=8, rule="energy")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = synced_ms(model.init, 0)
    n_params = sum(v.numel() for v in paths.leaves(params))
    reset_counts()
    with torch.inference_mode():
        (tree, rep), compress_ms = synced_ms(compress_tree, params, spec)
    pol_launches = launch_counts()["admm_polarize"]
    del params
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = compressed_paths(tree)
    matrices = sum(math.prod(leaf.mags.shape[:-2]) for leaf in leaves.values())
    if pol_launches != want_pol or matrices != want_pol:
        raise AssertionError(f"{cfg.name}: compress_tree polarized {pol_launches} matrices "
                             f"({matrices} in the tree), reckoned {want_pol}")
    step_split = launches_at(DECODE_M, DECODE_M)
    step_launches = sum(step_split)
    if sum(step_calls(p) for p in leaves) != step_launches:
        raise AssertionError(f"{cfg.name}: the tree reckons {sum(map(step_calls, leaves))} "
                             f"launches per decode step, the config {step_launches}")
    tree_bytes = sum(t.numel() * t.element_size() for leaf in leaves.values()
                     for t in (leaf.mags, leaf.signs, leaf.scale))
    engine = ServingEngine(model, tree, spec=spec, page_size=16, batch_slots=4,
                           max_len=SERVE_MAX_LEN, decode_block=4, device="cuda")
    if engine.paged or engine.page_allocator is not None:
        raise AssertionError(f"{cfg.name}: the engine did not fall back to the dense cache")
    prompts = slice_prompts(cfg)
    lens = [len(p) for p in prompts]
    if [engine.runner.bucket_for(n) for n in lens] != lens:
        raise AssertionError(f"{cfg.name}: the engine padded a prompt")
    runs = []
    for _ in range(2):
        run = served(engine, prompts)
        want = [run["decode_steps"] * v for v in step_split]
        for n in lens:
            want = [a + b for a, b in zip(want, launches_at(n, 1))]
        got = [run["counts"]["polarized_matmul"], run["counts"]["polarized_matmul_tc"]]
        if got != want:
            raise AssertionError(f"{cfg.name}: launched {got}, reckoned {want}")
        run["launches"] = got
        runs.append(run)
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError(f"two greedy {cfg.name} runs gave other tokens")
    state_bytes = cache_nbytes({name: engine.cache[name] for name in state_leaves})
    last = runs[-1]
    kw = dict(spec=spec, batch_slots=4, max_len=SERVE_MAX_LEN, decode_block=4, device="cuda")
    mesh = mesh_serve(label, model, tree, kw, prompts, engine, last["tokens"], 0.0)
    if mesh != last["launches"]:
        raise AssertionError(f"{cfg.name} on a mesh launched {mesh}, reckoned "
                             f"{last['launches']}")
    line = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
                params=n_params, init_ms=init_ms, compress_s=compress_ms / 1e3,
                compression=rep.summary(), tree_gb=tree_bytes / 1e9, peak_gb=peak_gb,
                serve_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                page_size_asked=16, paged=engine.paged,
                note="no paged path (O(1) recurrent state): the dense slot cache serves",
                cache_gb=engine.cache_bytes() / 1e9, state_gb=state_bytes / 1e9,
                polarize_launches=pol_launches, prompt_lens=lens,
                decode_steps=last["decode_steps"],
                decode_step_ms=[r["decode_step_ms"] for r in runs],
                step_bound_ms=(tree_bytes + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3,
                mean_prefill_ms=[r["mean_prefill_ms"] for r in runs],
                launches=last["launches"], launches_per_decode_step=step_split,
                mesh_launches=mesh, tokens=last["tokens"])
    del engine
    return line, tree


def _first_layers(blocks, n: int):
    """The first ``n`` layers of a stacked block tree (FORMS leaves too)."""
    from repro_torch.forms import FormsLinearParams
    if isinstance(blocks, dict):
        return {k: _first_layers(v, n) for k, v in blocks.items()}
    if isinstance(blocks, FormsLinearParams):
        return dataclasses.replace(blocks, mags=blocks.mags[:n], signs=blocks.signs[:n],
                                   scale=blocks.scale[:n])
    return blocks[:n]


def recurrent_model_check(cfg, tree, module):
    """The model at f32 on the served tree (RECURRENT_CHECK): the prefill
    logits of slot 1 of 2 against stepwise decode, on the card and on the
    CPU (the plain versions), card against CPU; and on the card ``forward``
    at S = 256 with the default chunk (two chunks of 128, the carry between
    them) against one chunk of 256 (``module``'s recurrence swapped for
    the call; its largest |cumulative log-decay| printed, which scales the
    f32 error of the decay ratios).  Each held at RECURRENT_TOL of the
    largest |logit|."""
    import numpy as np
    import torch
    from repro_torch.models import ssm_common
    from repro_torch.models.registry import build

    c = RECURRENT_CHECK
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, cfg.vocab_size, c["prompt"]).astype(np.int32)
    seq = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, c["seq"])).astype(np.int32))
    if ssm_common.chunk_width(c["seq"], ssm_common.DEFAULT_CHUNK) * 2 != c["seq"]:
        raise AssertionError("the forward check does not run two chunks")
    out, t0 = {}, time.perf_counter()
    for dev in ("cuda", "cpu"):
        m32 = build(cfg32, device=dev)
        t = _tree_to_dev(tree, dev)
        with torch.inference_mode():
            cache = m32.init_cache(c["slots"], c["max_len"], dtype=torch.float32)
            pre, _ = m32.prefill(t, torch.from_numpy(prompt[None]).to(dev), cache, 1,
                                 len(prompt))
            cache = m32.init_cache(c["slots"], c["max_len"], dtype=torch.float32)
            pos = torch.zeros(c["slots"], dtype=torch.int32, device=dev)
            for tok in prompt:
                tb = torch.zeros((c["slots"], 1), dtype=torch.int32, device=dev)
                tb[1, 0] = int(tok)
                lg, cache = m32.decode_step(t, tb, cache, pos.clone())
                pos[1] += 1
            out[dev] = {"prefill": pre[0].cpu(), "step": lg[1, 0].cpu()}
            if dev == "cuda":
                two, _ = m32.forward(t, {"tokens": seq.to(dev)})
                orig, cums = module.chunked_linear_recurrence, []

                def one_chunk(q, k, v, log_a, gate, *, chunk, **kw):
                    # the largest |cumulative log-decay| in the one chunk:
                    # the decay ratios are differences of such sums, so
                    # they carry about f32 eps times it of absolute error
                    cums.append(float(torch.cumsum(log_a.float(), 1).abs().max()))
                    return orig(q, k, v, log_a, gate, chunk=c["seq"], **kw)

                module.chunked_linear_recurrence = one_chunk
                try:
                    one, _ = m32.forward(t, {"tokens": seq.to(dev)})
                finally:
                    module.chunked_linear_recurrence = orig
                out["chunks"] = {"two": two.cpu(), "one": one.cpu(), "max_cum": max(cums)}
        del t, cache
        torch.cuda.empty_cache()
    rel = lambda a, b: float((a - b).abs().max()) / float(b.abs().max())  # noqa: E731
    check = {"prefill_vs_step_card": rel(out["cuda"]["step"], out["cuda"]["prefill"]),
             "prefill_vs_step_cpu": rel(out["cpu"]["step"], out["cpu"]["prefill"]),
             **{f"{k}_card_vs_cpu": rel(out["cuda"][k], out["cpu"][k])
                for k in ("prefill", "step")},
             "two_chunks_vs_one": rel(out["chunks"]["two"], out["chunks"]["one"]),
             "max_abs_cum_log_decay": out["chunks"]["max_cum"],
             "argmax_equal": int(out["cuda"]["step"].argmax()) == int(
                 out["cpu"]["prefill"].argmax()),
             "tol": RECURRENT_TOL, "layers": cfg.num_layers,
             "seconds": time.perf_counter() - t0}
    if not all(v <= RECURRENT_TOL for k, v in check.items()
               if isinstance(v, float) and k not in ("tol", "seconds", "max_abs_cum_log_decay")):
        raise AssertionError(f"{cfg.name}'s model check: {check}")
    return check


def phase_xlstm():
    """Full-width xlstm-350m (24 blocks: 21 mLSTM and 3 sLSTM at 0, 8 and
    16; d_model 1024, 4 heads of 256, vocab 50304, untied head), not cut:
    ``serve_recurrent`` with 163 polarizations reckoned (7 per mLSTM, 5 per
    sLSTM, the head) and 163 #1 launches per decode step on the f32 kernel
    (the sLSTM's wz/wi/wf/wo_g take f32 x at every M, so its prefill runs
    them on the f32 kernel at M = S), then served on a world of one
    (``mesh_xlstm``: the same tokens and launches).  The model check on the
    same tree.
    #1 held at every (shape, M, x dtype) of the run, N = 4 included (the
    mLSTM's wi/wf), timed at M=4 beside the library call and the bound; #4
    bit for bit at the three matrix shapes, timed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.models import xlstm

    cfg = get_config(XLSTM_ARCH)
    n_s = sum(1 for i in range(cfg.num_layers) if i % cfg.slstm_every == 0)
    n_m = cfg.num_layers - n_s
    route = wide_route(XLSTM_SQUARE[1])

    def launches_at(M, head_rows):
        want = [4 * n_s, 0]                  # the sLSTM's f32-x input projections
        want[route(M)] += 5 * n_m + n_s      # the mLSTM's wq/wk/wv/wo/wout, the sLSTM's wout
        want[route(M, XLSTM_GATES[1])] += 2 * n_m   # the mLSTM's wi/wf, N = num_heads
        want[route(head_rows)] += 1          # the head (a prefill's last row)
        return want

    line, tree = serve_recurrent(cfg, 7 * n_m + 5 * n_s + 1, launches_at,
                                 [f"layer{i}" for i in range(cfg.num_layers)],
                                 lambda path: 1, "xlstm")   # every leaf is one 2-D matrix
    check = recurrent_model_check(cfg, tree, xlstm)
    del tree
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()  # noqa: E731
    f32 = torch.float32
    held = [held_matmul(gen, M, *shape, x_dtype=xd) for M in sorted(set(line["prompt_lens"]))
            for shape, xd in ((XLSTM_SQUARE, None), (XLSTM_GATES, None), (XLSTM_SQUARE, f32))]
    held.append(held_matmul(gen, 1, *XLSTM_HEAD))
    m4 = {"square": held_matmul(gen, DECODE_M, *XLSTM_SQUARE, flush=flush),
          "gates": held_matmul(gen, DECODE_M, *XLSTM_GATES, flush=flush),
          "square_f32": held_matmul(gen, DECODE_M, *XLSTM_SQUARE, flush=flush, x_dtype=f32),
          "head": held_matmul(gen, DECODE_M, *XLSTM_HEAD, flush=flush)}
    held += list(m4.values())
    calls = {"square": 5 * n_m + n_s, "gates": 2 * n_m, "square_f32": 4 * n_s, "head": 1}
    step = {k: sum(m4[n][k] * c for n, c in calls.items())
            for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    step["bound_by"] = bound_by(list(m4.values()))
    pol = polarize_rows(gen, [XLSTM_SQUARE, XLSTM_GATES, XLSTM_HEAD], flush)
    by_shape = {(r["K"], r["N"]): r for r in pol}
    pol_calls = {XLSTM_SQUARE: 5 * n_m + 5 * n_s, XLSTM_GATES: 2 * n_m, XLSTM_HEAD: 1}
    pol_tree = {k: sum(by_shape[s][k] * c for s, c in pol_calls.items())
                for k in ("kernel_ms", "plain_ms", "bound_ms")}
    pol_tree["bound_by"] = bound_by(pol)
    del scrub
    emit("xlstm", **line)
    emit("xlstm_check", **check)
    emit("xlstm_kernels", held=[[r["M"], r["K"], r["N"], r["x"], r["route"]] for r in held],
         max_abs_err=max(r["max_abs_err"] for r in held),
         max_rel_err=max(r["max_rel_err"] for r in held),
         m4={n: {k: r[k] for k in ("route", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                   "bound_by")} for n, r in m4.items()},
         decode_step_m4=step, polarize=pol, polarize_tree=pol_tree)
    return {"launches": line["launches"], "polarize_launches": line["polarize_launches"],
            "mesh_launches": line["mesh_launches"], "step_m4": step, "gates_m4": m4["gates"],
            "pol_tree": pol_tree}


def phase_zamba():
    """Full-width zamba2-2.7b (54 Mamba2 blocks in 9 groups of 6, each
    followed by the shared attention block: 32 heads of 80, d_ff 10240;
    d_in 5120 in 80 SSM heads of 64, state 64; vocab 32000, untied head),
    not cut: ``serve_recurrent`` with 116 polarizations reckoned (in_proj
    and out_proj per layer, the shared block's 7, the head) and 172 #1
    launches per decode step (2 per Mamba block, 7 per shared-block
    application, the head), then served on a world of one (``mesh_zamba``:
    the same tokens and launches).  The model check on the full-width
    model cut to ZAMBA_CHECK_LAYERS layers (one group), which keeps its CPU
    side near a minute.  #1 held at every (shape, M) of the run, timed at M=4; #4 bit
    for bit at each matrix shape, timed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.models import zamba

    cfg = get_config(ZAMBA_ARCH)
    L, groups = cfg.num_layers, cfg.num_layers // cfg.shared_attn_every
    route = wide_route(min(N for _, N in ZAMBA_SHAPES.values()))
    per_call = 2 * L + 7 * groups

    def launches_at(M, head_rows):
        want = [0, 0]
        want[route(M)] += per_call
        want[route(head_rows)] += 1
        return want

    # a stacked Mamba leaf runs once per layer, a shared-block leaf once per
    # application, the head once
    line, tree = serve_recurrent(
        cfg, 2 * L + 7 + 1, launches_at, ["ssm", "conv"],
        lambda path: L if path.startswith("blocks/") else
        groups if path.startswith("shared_attn/") else 1, "zamba")
    cut = dataclasses.replace(cfg, num_layers=ZAMBA_CHECK_LAYERS)
    check = recurrent_model_check(cut, {**tree, "blocks": _first_layers(tree["blocks"],
                                                                         ZAMBA_CHECK_LAYERS)},
                                  zamba)
    check["cut"] = {"num_layers": [L, ZAMBA_CHECK_LAYERS]}
    del tree
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()  # noqa: E731
    held = [held_matmul(gen, M, *shape) for M in sorted(set(line["prompt_lens"]))
            for shape in ZAMBA_SHAPES.values()]
    held.append(held_matmul(gen, 1, *ZAMBA_HEAD))
    m4 = {n: held_matmul(gen, DECODE_M, *shape, flush=flush) for n, shape in ZAMBA_SHAPES.items()}
    m4["head"] = held_matmul(gen, DECODE_M, *ZAMBA_HEAD, flush=flush)
    held += list(m4.values())
    calls = {"in_proj": L, "out_proj": L, "attn": 4 * groups, "mlp_in": 2 * groups,
             "mlp_out": groups, "head": 1}
    step = {k: sum(m4[n][k] * c for n, c in calls.items())
            for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    step["bound_by"] = bound_by(list(m4.values()))
    pol = polarize_rows(gen, list(ZAMBA_SHAPES.values()) + [ZAMBA_HEAD], flush)
    by_shape = {(r["K"], r["N"]): r for r in pol}
    pol_calls = {ZAMBA_SHAPES["in_proj"]: L, ZAMBA_SHAPES["out_proj"]: L,
                 ZAMBA_SHAPES["attn"]: 4, ZAMBA_SHAPES["mlp_in"]: 2, ZAMBA_SHAPES["mlp_out"]: 1,
                 ZAMBA_HEAD: 1}
    pol_tree = {k: sum(by_shape[s][k] * c for s, c in pol_calls.items())
                for k in ("kernel_ms", "plain_ms", "bound_ms")}
    pol_tree["bound_by"] = bound_by(pol)
    del scrub
    emit("zamba", **line)
    emit("zamba_check", **check)
    emit("zamba_kernels", held=[[r["M"], r["K"], r["N"], r["route"]] for r in held],
         max_abs_err=max(r["max_abs_err"] for r in held),
         max_rel_err=max(r["max_rel_err"] for r in held),
         m4={n: {k: r[k] for k in ("route", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                   "bound_by")} for n, r in m4.items()},
         decode_step_m4=step, polarize=pol, polarize_tree=pol_tree)
    return {"launches": line["launches"], "polarize_launches": line["polarize_launches"],
            "mesh_launches": line["mesh_launches"], "step_m4": step, "pol_tree": pol_tree}


# --------------------------------------------------------------------------
# the paper's CNN pipeline, the VLM patch prefix, recurrent training
# --------------------------------------------------------------------------

CNN_CHECK_BATCH = 4         # the card-vs-CPU forward
CNN_TOL = 1e-4              # of the largest |logit|: card vs CPU, compressed vs decompressed
CNN_ADMM_STEPS = 2          # the full-width configs' ADMM SGD steps, one fresh Z-update
CNN_FULL_LR = 1e-4          # their SGD rate: ResNet-18 (no normalization) diverges from
                            # random weights at the pipeline's 0.05 (loss 18 -> 4e8 -> nan)
VLM_ARCH = "phi-3-vision-4.2b"
VLM_CHECK_LAYERS = 2        # the f32 model card vs CPU: full width, this many layers
VLM_CHECK_TEXT = 16         # text tokens after the 1,024 patch positions
VLM_TOL = 1e-4              # of the largest |hidden|, card vs CPU
RECURRENT_TRAIN = ("xlstm-350m", "zamba2-2.7b")


def held_fc(name, leaf, x, flush=None):
    """Kernel #1 on a compressed FC leaf at its input ``x`` (M, K) f32,
    K padded to whole fragments as ``forms.apply`` pads it: two launches
    equal bit for bit and held against the plain version within REL_TOL;
    with ``flush``, timed beside the plain version, the f32 ``torch.matmul``
    of x and the dense weight, and the bound."""
    import torch
    from repro_torch.forms import to_dense
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.kernels.ref import ref_polarized_matmul_fast

    kp = leaf.mags.shape[0]
    xp = torch.nn.functional.pad(x, (0, kp - x.shape[1])).contiguous()
    args = (xp, leaf.mags, leaf.signs, leaf.scale, leaf.m)
    got, again = pm.polarized_matmul(*args), pm.polarized_matmul(*args)
    want = ref_polarized_matmul_fast(*args)
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rec = {"leaf": name, "M": x.shape[0], "K": leaf.k, "Kp": kp, "N": leaf.n,
           "route": "tc" if pm.uses_tensor_cores(xp.dtype, leaf.mags.dtype, "cuda",
                                                 x.shape[0], leaf.n) else "f32",
           "max_abs_err": abs_err, "max_rel_err": abs_err / max(float(want.abs().max()), 1e-30)}
    if not torch.equal(got, again):
        raise AssertionError(f"two launches differ: {rec}")
    if not rec["max_rel_err"] <= REL_TOL:
        raise AssertionError(f"kernel #1 disagrees with its plain version: {rec}")
    if flush is not None:
        w = to_dense(leaf)
        rec["kernel_ms"] = timed_ms(lambda: pm.polarized_matmul(*args), flush)
        rec["plain_ms"] = timed_ms(lambda: ref_polarized_matmul_fast(*args), flush)
        rec["library_ms"] = timed_ms(lambda: torch.matmul(x, w), flush)
        rec["bound_ms"], rec["bound_by"] = bound(x.shape[0], kp, leaf.n, 1, m=leaf.m)
    return rec


def cnn_tiny_pipeline():
    """The port's pipeline on ``tiny_cnn()`` at the reference's step counts
    (``tests/test_system.py``'s m = 4) on the card, then the launcher's
    second half (``cnn_pipeline.evaluate``): ``test_system.py``'s thresholds,
    each phase's ms, images/s, and the kernels' launches reckoned (#4 once
    per matrix per fresh Z-update and per compressed leaf, #1 once per FC
    leaf in the compressed forward, #3 once)."""
    import torch
    from repro_torch.core import admm as A
    from repro_torch.core import polarization as P
    from repro_torch.core.quantization import quantize_activations
    from repro_torch.core.zeroskip import eic_stats
    from repro_torch.data.synthetic import image_batch
    from repro_torch.launch import cnn_pipeline as CP
    from repro_torch.models import cnn as C

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    t = CP.train_forms_cnn(fragment=4, device="cuda")
    train_counts = launch_counts()
    reset_counts()
    e, eval_ms = synced_ms(CP.evaluate, t)
    counts = launch_counts()
    wall = time.perf_counter() - t0
    n_mat, n_fc = len(t["table"]), sum(1 for s in t["cfg"].arch if s[0] == "fc")
    fresh = sum(1 for i in range(240) if (i + 1) % 30 == 0 and i < 240 * 0.6)
    want = {"admm_polarize": fresh * n_mat + n_mat, "polarized_matmul": n_fc,
            "bitserial_crossbar": 1}
    got = {k: train_counts[k] + counts[k] for k in want}
    polarized = all(bool(P.is_polarized(A._as_matrix(t["projected"][p], c), c.polarize.m))
                    for p, c in t["table"].items())
    img, _ = image_batch(t["ds"], 2000, "cuda")
    with torch.no_grad():
        _, acts = C.forward(t["cfg"], t["projected"], img, collect_activations=True)
    saved = [eic_stats(quantize_activations(a.reshape(a.shape[0], -1), 16)[0], 4, 16).savings
             for _, a in acts]
    rep = e["rep"]
    train_s = sum(t["phase_s"][k] for k in ("pretrain", "admm", "finetune"))
    line = {"config": t["cfg"].name, "fragment": 4, "acc_pre": t["acc_pre"],
            "acc_post": t["acc_post"], "phase_ms": {k: v * 1e3 for k, v in t["phase_s"].items()},
            "evaluate_ms": eval_ms, "wall_s": wall, "images": t["images"],
            "train_images_per_s": t["images"] / train_s, "polarized": polarized,
            "quant_factor": rep.quant_factor, "polarization_factor": rep.polarization_factor,
            "crossbar_reduction": rep.total, "max_zero_skip_savings": max(saved),
            "compressed_argmax_agreement": e["agree"], "sim_rel_l2": e["sim_rel"],
            "decompress_residual": e["resid"], "mean_eic": e["mean_eic"],
            "fps_model": e["fps"], "launches": got, "launches_reckoned": want}
    ok = (t["acc_pre"] > 0.6 and t["acc_post"] > t["acc_pre"] - 0.15 and polarized
          and rep.quant_factor == 2.0 and rep.polarization_factor == 2.0 and rep.total >= 2.0
          and max(saved) > 0.15 and got == want)
    if not ok:
        raise AssertionError(f"the tiny CNN pipeline on the card: {line}")
    emit("cnn_tiny", **line)
    return got


def cnn_full(cfg, flush):
    """One of the paper's CNNs at its published widths, random weights from
    seed 0, batch 64: the pipeline's training cut to 1 pretrain step,
    CNN_ADMM_STEPS ADMM SGD steps at CNN_FULL_LR ending in one fresh
    Z-update (#4 once per constrained matrix, reckoned), ``project_hard``
    and 1 projected fine-tune step; then the Z-update timed, #4 bit for bit
    at every conv and FC matrix's shape (sum rule, K padded);
    ``compress_tree`` (one polarization per crossbar leaf, reckoned); the
    compressed forward (#1 once per FC leaf, reckoned) against the
    decompressed one; #1 held at every FC (shape, M) of the run and timed
    at M = 64; ``apply_simulated`` on every FC leaf (#3 once each,
    reckoned), #3 exact against its plain version and timed; the mean EIC;
    the paper's ReRAM model numbers; the compressed model at batch 4 on the
    card against the CPU (the plain versions)."""
    import torch
    from repro_torch.core import admm as A
    from repro_torch.core import crossbar as X
    from repro_torch.core import perfmodel as PM
    from repro_torch.core.quantization import quantize_activations, slice_to_cells
    from repro_torch.core.zeroskip import fragment_eic
    from repro_torch.data.synthetic import ImageStreamConfig, image_batch
    from repro_torch.forms import apply_simulated, compress_tree, decompress_tree
    from repro_torch.launch import cnn_pipeline as CP
    from repro_torch.models import cnn as C

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t, train_ms = synced_ms(CP.train_forms_cnn, cfg, fragment=8, pretrain_steps=1,
                            admm_steps=CNN_ADMM_STEPS, finetune_steps=1,
                            admm_every=CNN_ADMM_STEPS, lr=CNN_FULL_LR, device="cuda")
    train_pol = launch_counts()["admm_polarize"]
    spec, table, params = t["spec"], t["table"], t["params"]
    n_params = sum(v.numel() for v in params.values())
    fcs = [f"fc{i}" for i, s in enumerate(cfg.arch) if s[0] == "fc"]
    if train_pol != len(table):
        raise AssertionError(f"{cfg.name}: the fresh Z-update launched #4 {train_pol} times "
                             f"for {len(table)} matrices")
    zs = [synced_ms(A.admm_update, params, t["admm_state"], table, refresh_signs=True)[1]
          for _ in range(3)]
    # kernel #4 at each constrained matrix's shape, K padded as kernels.ops pads it
    mats = {p: A._as_matrix(params[p], c).shape for p, c in table.items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(37)
    pol = [dict(r, leaf=p) for p, r in zip(mats, polarize_rows(
        gen, [(-(-K // 8) * 8, N) for K, N in mats.values()], flush, rule="sum"))]
    reset_counts()
    with torch.no_grad():
        (tree, crep), compress_ms = synced_ms(compress_tree, t["projected"], spec)
    compress_pol = launch_counts()["admm_polarize"]
    if compress_pol != crep.num_compressed or crep.num_compressed != len(table):
        raise AssertionError(f"{cfg.name}: compress_tree polarized {compress_pol} matrices, "
                             f"{crep.num_compressed} leaves, {len(table)} constrained")
    img, lab = image_batch(t["ds"], 9000, "cuda")
    reset_counts()
    with torch.no_grad():
        logits, fwd_ms = synced_ms(lambda: C.forward(cfg, tree, img)[0])
    fwd = launch_counts()["polarized_matmul"]
    with torch.no_grad():
        dense_logits, acts = C.forward(cfg, decompress_tree(tree), img, collect_activations=True)
    acts = dict(acts)
    vs_dense = float((logits - dense_logits).abs().max()) / float(dense_logits.abs().max())
    agree = float((logits.argmax(-1) == dense_logits.argmax(-1)).float().mean())
    reset_counts()
    with torch.no_grad():
        sims = {n: apply_simulated(tree[n], acts[n], spec) for n in fcs}
    torch.cuda.synchronize()
    sim_launches = launch_counts()["bitserial_crossbar"]
    if fwd != len(fcs) or sim_launches != len(fcs):
        raise AssertionError(f"{cfg.name}: #1 launched {fwd}, #3 {sim_launches} times for "
                             f"{len(fcs)} FC leaves")
    # the card against the CPU, compressed, at batch 4 (FC on #1 at M = 4)
    small = ImageStreamConfig(cfg.image_size, cfg.in_channels, cfg.num_classes,
                              CNN_CHECK_BATCH)
    img4, _ = image_batch(small, 9001, "cuda")
    with torch.no_grad():
        card, small_acts = C.forward(cfg, tree, img4, collect_activations=True)
        cpu, _ = C.forward(cfg, _tree_to_dev(tree, "cpu"), img4.cpu())
    card_vs_cpu = float((card.cpu() - cpu).abs().max()) / float(cpu.abs().max())
    held = [held_fc(n, tree[n], dict(small_acts)[n]) for n in fcs]
    m64 = [held_fc(n, tree[n], acts[n], flush) for n in fcs]
    bit = []
    for n in fcs:
        leaf = tree[n]
        x2 = torch.nn.functional.pad(acts[n], (0, leaf.mags.shape[0] - leaf.k))
        codes, _ = quantize_activations(x2, spec.input_bits)
        cells = slice_to_cells(leaf.mags, spec.quant).to(torch.uint8)
        rec = bitserial_check(f"{cfg.name} {n}", codes.to(torch.int32), cells, leaf.signs,
                              None, mags=leaf.mags, time_it=True, flush=flush)
        _, eic, _ = sims[n]
        if not torch.equal(eic, fragment_eic(codes, leaf.m, spec.input_bits)):
            raise AssertionError(f"{cfg.name} {n}: apply_simulated's EIC is not the kernel's")
        bit.append(rec)
    mean_eic = CP.mean_eic(cfg, t["projected"], img, spec)
    shapes = C.crossbar_weight_shapes(cfg, t["projected"])
    rep = X.reduction_report(shapes, shapes, X.CrossbarSpec(), spec.quant, baseline_bits=16)
    fps = PM.fps_speedup(rep.prune_factor, rep.quant_factor, fragment=spec.m,
                         mean_eic=mean_eic)
    line = {"config": cfg.name, "params": n_params, "batch": CP.BATCH, "fragment": 8,
            "train_ms": train_ms, "phase_ms": {k: v * 1e3 for k, v in t["phase_s"].items()},
            "z_update_ms": zs, "matrices": len(table), "compress_ms": compress_ms,
            "compression": crep.summary(), "forward_ms": fwd_ms,
            "images_per_s_forward": CP.BATCH / fwd_ms * 1e3,
            "compressed_vs_decompressed": vs_dense, "argmax_agreement": agree,
            "card_vs_cpu": card_vs_cpu, "tol": CNN_TOL, "mean_eic": mean_eic,
            "reram_model": {"note": "the paper's ReRAM accelerator model, not card times",
                            "crossbar_reduction": rep.total, "quant_factor": rep.quant_factor,
                            "polarization_factor": rep.polarization_factor, "fps": fps},
            "launches": {"admm_polarize": train_pol + compress_pol,
                         "polarized_matmul": fwd, "bitserial_crossbar": sim_launches},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if not (vs_dense <= CNN_TOL and card_vs_cpu <= CNN_TOL):
        raise AssertionError(f"{cfg.name}: the compressed forward disagrees: {line}")
    emit("cnn", **line)
    emit("cnn_kernels", config=cfg.name,
         polarize=[{k: r[k] for k in ("leaf", "K", "N", "kernel_ms", "plain_ms", "bound_ms",
                                      "bound_by")} for r in pol],
         polarize_z_update={k: sum(r[k] for r in pol) for k in ("kernel_ms", "plain_ms",
                                                                  "bound_ms")},
         held=[[r["leaf"], r["M"], r["K"], r["Kp"], r["N"], r["route"]] for r in held + m64],
         max_rel_err=max(r["max_rel_err"] for r in held + m64),
         fc_m64=[{k: r[k] for k in ("leaf", "K", "Kp", "N", "kernel_ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by")} for r in m64],
         bitserial=[{k: r[k] for k in ("case", "M", "K", "N", "grid", "mmas", "kernel_ms",
                                        "plain_ms", "library_ms", "bound_ms", "bound_by")}
                    for r in bit])
    del t, params, tree
    return {"launches": line["launches"], "pol": pol, "fc": m64, "bit": bit}


def phase_cnn():
    """The paper's CNN pipeline on the card: ``cnn_tiny_pipeline``, then
    ``cnn_full`` at LeNet-5, VGG-16 and ResNet-18 (not cut: 0.06 M, 14.98 M
    and 11.24 M params; ResNet-18's stride-2 res blocks pad (0, 1) as XLA's
    SAME).  Returns the launches of the path and the kernel rows."""
    import torch
    from repro_torch.configs.paper_cnns import LENET5, RESNET18, VGG16

    tiny = cnn_tiny_pipeline()
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()  # noqa: E731
    full = {cfg.name: cnn_full(cfg, flush) for cfg in (LENET5, VGG16, RESNET18)}
    del scrub
    torch.cuda.empty_cache()
    launches = {k: tiny[k] + sum(f["launches"][k] for f in full.values()) for k in tiny}
    return {"launches": launches, "full": full}


def phase_vlm():
    """Full-width phi-3-vision-4.2b (32 layers, d_model 3072, 32 heads of 96,
    MHA, d_ff 8192, vocab 32064, untied head; ~15 GB f32 at init), random
    weights from seed 0, compressed (FORMS m=8, 8 bits, energy rule: 225
    polarizations reckoned) and served text-only on the paged cache with
    the slice-1 engine settings, the slice's 4 prompts twice: the same
    tokens, #1 launches reckoned (7 per layer on the route of their M, the
    head at M = 1 per prefill and M = 4 per decode step), decode and
    prefill ms.  Then the f32 model cut to VLM_CHECK_LAYERS layers at full
    width: ``forward`` on a ``make_inputs`` batch (1,024 patch positions +
    VLM_CHECK_TEXT tokens) card vs CPU, on the hidden states.  #1 held at
    every (shape, M) of the run, timed at M = 4."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import paths
    from repro_torch.forms import FormsLinearParams, FormsSpec, compress_tree
    from repro_torch.kernels import polarized_matmul as pm
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(VLM_ARCH)
    model = build(cfg, device="cuda")
    spec = FormsSpec(m=8, bits=8, rule="energy")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = synced_ms(model.init, 0)
    n_params = sum(v.numel() for v in paths.leaves(params))
    reset_counts()
    with torch.inference_mode():
        (tree, rep), compress_ms = synced_ms(compress_tree, params, spec)
    pol = launch_counts()["admm_polarize"]
    del params
    torch.cuda.empty_cache()
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    want_pol = 7 * cfg.num_layers + 1
    head = tree["head"]
    if pol != want_pol or not isinstance(head, FormsLinearParams):
        raise AssertionError(f"{cfg.name}: compress_tree polarized {pol} matrices, reckoned "
                             f"{want_pol}; head {type(head)}")
    prompts = slice_prompts(cfg)
    engine = ServingEngine(model, tree, spec=spec, page_size=16, batch_slots=4,
                           max_len=SERVE_MAX_LEN, decode_block=4, device="cuda")
    buckets = [engine.runner.bucket_for(len(p)) for p in prompts]
    route = wide_route(narrowest(tree))
    runs = []
    for _ in range(2):
        run = served(engine, prompts)
        want = route_split(7 * cfg.num_layers, buckets, run["decode_steps"], 4, narrowest(tree))
        want[route(1)] += len(prompts)
        want[route(DECODE_M)] += run["decode_steps"]
        got = [run["counts"]["polarized_matmul"], run["counts"]["polarized_matmul_tc"]]
        if got != want:
            raise AssertionError(f"{cfg.name}: launched {got}, reckoned {want}")
        run["launches"] = got
        runs.append(run)
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError(f"two greedy {cfg.name} runs gave other tokens")
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    del engine, tree
    torch.cuda.empty_cache()
    check = vlm_model_check(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    scrub = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.zero_()  # noqa: E731
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    shapes = {"attn": (d, cfg.num_heads * cfg.hd()), "mlp_in": (d, f), "mlp_out": (f, d)}
    held = [held_matmul(gen, M, *shape) for M in sorted(set(buckets)) for shape in shapes.values()]
    held.append(held_matmul(gen, 1, d, v))
    m4 = {n: held_matmul(gen, DECODE_M, *shape, flush=flush) for n, shape in shapes.items()}
    m4["head"] = held_matmul(gen, DECODE_M, d, v, flush=flush)
    held += list(m4.values())
    calls = {"attn": 4, "mlp_in": 2, "mlp_out": 1}
    layer = {k: sum(m4[n][k] * c for n, c in calls.items())
             for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    layer["bound_by"] = bound_by([m4[n] for n in calls])
    del scrub
    last = runs[-1]
    emit("vlm", arch=cfg.name, layers=cfg.num_layers, d_model=d, heads=cfg.num_heads,
         head_dim=cfg.hd(), d_ff=f, vocab=v, num_image_tokens=cfg.num_image_tokens,
         params=n_params, init_ms=init_ms, compress_s=compress_ms / 1e3,
         compression=rep.summary(), polarize_launches=pol, init_peak_gb=init_peak,
         serve_peak_gb=serve_peak, prompt_lens=[len(p) for p in prompts], buckets=buckets,
         note="served text-only, as the reference's engine",
         decode_steps=last["decode_steps"],
         decode_step_ms=[r["decode_step_ms"] for r in runs],
         mean_prefill_ms=[r["mean_prefill_ms"] for r in runs],
         launches=last["launches"], tokens=last["tokens"])
    emit("vlm_check", **check)
    emit("vlm_kernels", held=[[r["M"], r["K"], r["N"], r["route"]] for r in held],
         max_abs_err=max(r["max_abs_err"] for r in held),
         max_rel_err=max(r["max_rel_err"] for r in held),
         m4={n: {k: r[k] for k in ("route", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                   "bound_by")} for n, r in m4.items()}, layer_m4=layer)
    return {"launches": last["launches"], "polarize_launches": pol, "layer_m4": layer,
            "head_m4": m4["head"]}


def vlm_model_check(cfg):
    """phi-3-vision at f32, full width cut to VLM_CHECK_LAYERS layers, random
    weights from seed 0 drawn on the CPU: ``forward(return_hidden=True)``
    on one ``make_inputs`` batch (the 1,024 patch positions, then
    VLM_CHECK_TEXT tokens) on the card and on the CPU, held at VLM_TOL of
    the largest |hidden|; the patches lead the sequence, so the text
    positions differ from a text-only forward."""
    import torch
    from repro_torch.models.registry import build

    cut = dataclasses.replace(cfg, num_layers=VLM_CHECK_LAYERS, dtype="float32")
    cpu_model = build(cut, device="cpu")
    params = cpu_model.init(0)
    g = torch.Generator()
    g.manual_seed(31)
    batch = cpu_model.make_inputs(g, 1, cfg.num_image_tokens + VLM_CHECK_TEXT)
    t0 = time.perf_counter()
    with torch.inference_mode():
        want, _ = cpu_model.forward(params, batch, return_hidden=True)
    cpu_s = time.perf_counter() - t0
    card_model = build(cut, device="cuda")
    card_params = _tree_to_dev(params, "cuda")
    card_batch = {k: v.to("cuda") for k, v in batch.items()}
    with torch.inference_mode():
        got, card_ms = synced_ms(lambda: card_model.forward(card_params, card_batch,
                                                            return_hidden=True)[0])
        text, _ = card_model.forward(card_params, {"tokens": card_batch["tokens"]},
                                     return_hidden=True)
    got = got.cpu()
    rel = float((got - want).abs().max()) / float(want.abs().max())
    prefix_moves = float((got[:, -VLM_CHECK_TEXT:] - text.cpu()).abs().max())
    check = {"layers": [cfg.num_layers, VLM_CHECK_LAYERS], "positions": got.shape[1],
             "patch_positions": cfg.num_image_tokens, "text": VLM_CHECK_TEXT,
             "card_vs_cpu": rel, "tol": VLM_TOL, "prefix_moves_text": prefix_moves,
             "card_ms": card_ms, "cpu_s": cpu_s}
    del card_params, params
    torch.cuda.empty_cache()
    if not (got.shape == (1, cfg.num_image_tokens + VLM_CHECK_TEXT, cfg.d_model)
            and rel <= VLM_TOL and prefix_moves > 1e-3):
        raise AssertionError(f"{cfg.name}'s model check: {check}")
    return check


def phase_train_recurrent():
    """Reduced xlstm-350m and zamba2-2.7b (f32), two ``make_train_step`` steps
    each on the card and on the CPU from the same params and batches: the
    losses agree within 1e-4 (zamba's f32 gradients are ill-conditioned at
    its fast decays, so the second loss carries that, ROADMAP §3)."""
    from repro_torch.configs import get_reduced
    from repro_torch.core import paths
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    from repro_torch.models.registry import build
    from repro_torch.training import train_loop

    tcfg = train_config(learning_rate=1e-3, admm_enabled=False)
    rows = {}
    for arch in RECURRENT_TRAIN:
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        params = build(cfg, device="cpu").init(0)
        ds = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
        out = {}
        for dev in ("cpu", "cuda"):
            model = build(cfg, device=dev)
            # a copy per device: the optimizer updates the params in place
            copy = paths.tree_map(lambda t: t.to(dev, copy=True), params)
            state, _ = train_loop.init_train_state(model, tcfg, params=copy)
            step = train_loop.make_train_step(model, tcfg)
            losses, norms = [], []
            for i in range(2):
                state, metrics = step(state, lm_batch(ds, i, dev))
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
            out[dev] = {"losses": losses, "grad_norms": norms}
        err = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"]["losses"],
                                                      out["cpu"]["losses"]))
        rows[arch] = {"runs": out, "max_rel_loss_err": err}
        if not (err <= 1e-4 and all(math.isfinite(v) for v in out["cuda"]["grad_norms"])):
            raise AssertionError(f"{arch}: the recurrent train step on the card: {rows[arch]}")
    emit("train_recurrent", **rows)


def _tree_to_dev(tree, dev):
    """A params tree (FORMS leaves included) copied to ``dev``."""
    from repro_torch.forms import FormsLinearParams
    if isinstance(tree, dict):
        return {k: _tree_to_dev(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to_dev(v, dev) for v in tree]
    if isinstance(tree, FormsLinearParams):
        return dataclasses.replace(tree, mags=tree.mags.to(dev), signs=tree.signs.to(dev),
                                   scale=tree.scale.to(dev))
    return tree.to(dev)


def perfmodel_line(mean_eic: float) -> None:
    """The paper's hardware model (``core/perfmodel``) at the fidelity
    phase's measured mean EIC, beside its published Table V rows: model
    numbers of a ReRAM accelerator, not times of the card."""
    from repro_torch.core import perfmodel as PM
    forms, isaac = PM.forms_throughput(8, mean_eic=mean_eic), PM.isaac_throughput()
    emit("perfmodel", note="the paper's ReRAM accelerator model, not card times",
         mean_eic=mean_eic,
         forms_events_per_column=forms.events_per_column_per_input,
         forms_peak_rel_isaac=forms.peak_throughput_rel(isaac),
         table_v=[dataclasses.asdict(r) for r in PM.table_v(8, mean_eic=mean_eic)],
         table_v_published={k: list(v) for k, v in PM.TABLE_V_PUBLISHED.items()},
         fps_speedup_fig13_low=PM.fps_speedup(7.5 / 2, 2.0, 8, mean_eic),
         fps_speedup_fig13_high=PM.fps_speedup(200.8 / 4, 4.0, 8, mean_eic))


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

    from repro_torch import obs
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    obs.enable()
    build.build(["polarized_matmul", "polarized_matmul_tc", "bitserial_crossbar",
                 "admm_polarize"])
    obs.disable()
    built = [s for s in obs.drain()[0] if s.name == "rt.kernels.build"]
    emit("build", seconds=time.perf_counter() - t0,
         ptxas=built[0].attrs["ptxas"] if built else {})

    rows, worst_abs, worst_rel = phase_kernels()
    tc_rows, tc_abs, tc_rel, crossover, floor_ms, tc_extra = phase_kernels_tc()
    width_rows, head_rows = phase_kernel_widths()
    skip_rows, skip_bf16_rows, tc_skip_rows, skip_err = phase_skip()
    bit_rows, bit_adc4_rows = phase_bitserial()
    pol_rows, pol_matrix_row = phase_polarize()
    small_launches = phase_small()
    phase_train_small()
    phase_train_moe()
    phase_train_recurrent()
    launches, slice_engine, slice_tokens = phase_slice()
    torch.cuda.empty_cache()
    mesh_launches, mesh_rows, mesh_runs = phase_mesh(slice_engine, slice_tokens)
    torch.cuda.empty_cache()
    spec_launches, verify_rows, uniform_draft = phase_speculate(
        slice_engine.model, slice_engine.cfg, slice_prompts(slice_engine.cfg), slice_engine,
        slice_tokens, trace=args.trace_speculate)
    torch.cuda.empty_cache()
    fleet_launches = phase_fleet(slice_engine, slice_tokens)
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt_serve_launches = phase_checkpoint_serve(slice_engine, slice_tokens, ckpt_root)
        torch.cuda.empty_cache()
        ab_launches = phase_autobits(slice_engine, slice_prompts(slice_engine.cfg),
                                     slice_tokens, uniform_draft)
        torch.cuda.empty_cache()
        rel_launches = phase_reliability(slice_engine, slice_tokens)
        del slice_engine
        torch.cuda.empty_cache()
        dense_launches = phase_dense_configs()
        moe = phase_moe()
        torch.cuda.empty_cache()
        mla = phase_mla()
        torch.cuda.empty_cache()
        whisper = phase_whisper()
        torch.cuda.empty_cache()
        family_shards = phase_mesh_shards()
        torch.cuda.empty_cache()
        xlstm = phase_xlstm()
        torch.cuda.empty_cache()
        zamba = phase_zamba()
        torch.cuda.empty_cache()
        cnn = phase_cnn()
        torch.cuda.empty_cache()
        vlm = phase_vlm()
        torch.cuda.empty_cache()
        tree, cfg, prompts, skip_launches = phase_zero_skip()
        bit_launches, fidelity_row, mean_eic = phase_fidelity(tree, cfg, prompts)
        perfmodel_line(mean_eic)
        del tree          # the serving trees go before the training state comes
        torch.cuda.empty_cache()
        pol_launches, train_run = phase_train()
        torch.cuda.empty_cache()
        mesh_train_launches, mesh_train_rows = phase_mesh_train(train_run, floor_ms)
        torch.cuda.empty_cache()
        family_train_launches, family_train_rows = phase_mesh_train_families(floor_ms)
        torch.cuda.empty_cache()
        phase_dryrun()
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
            and all(ckpt_serve_launches) and ckpt_pol_launches
            and all(ab_launches[0]) and ab_launches[1][1] and all(ab_launches[2])
            and ab_launches[3] and all(rel_launches) and all(moe["launches"])
            and moe["polarize_launches"] and all(mla["launches"]) and mla["polarize_launches"]
            and all(whisper["launches"]) and whisper["polarize_launches"]
            and all(xlstm["launches"]) and xlstm["polarize_launches"]
            and all(zamba["launches"]) and zamba["polarize_launches"]
            and all(cnn["launches"].values()) and all(vlm["launches"])
            and vlm["polarize_launches"]
            and all(all(v.values()) for v in dense_launches.values())
            and all(mesh_launches.values()) and mesh_train_launches
            and all(mesh_runs["speculate"].values()) and all(mesh_runs["block"].values())
            and all(mla["mesh_launches"]) and all(whisper["mesh_launches"])
            and all(xlstm["mesh_launches"]) and all(zamba["mesh_launches"])
            and all(family_train_launches.values())):
        raise AssertionError("a kernel of a path was never launched on it")

    def total(rows, key):
        return sum(r[key] for r in rows)

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
        "autobits_launches": ab_launches[0][0],
        "auto_draft_launches": ab_launches[2][0],
        "dense_configs_launches": dense_launches["off"]["polarized_matmul"],
        "reliability_launches": rel_launches[0],
        "moe_launches": moe["launches"][0],
        "moe": {"attn_m4": moe["attn_m4"], "head_m4": moe["head_m4"]},
        "mla_launches": mla["launches"][0],
        "mla": {"layer_m4": mla["layer_m4"], "head_m4": mla["head_m4"]},
        "whisper_launches": whisper["launches"][0],
        "whisper": {"layer_m4": whisper["layer_m4"]},
        "xlstm_launches": xlstm["launches"][0],
        "xlstm": {"step_m4": xlstm["step_m4"], "gates_m4": xlstm["gates_m4"]},
        "zamba_launches": zamba["launches"][0],
        "zamba": {"step_m4": zamba["step_m4"]},
        "cnn_launches": cnn["launches"]["polarized_matmul"],
        "cnn": {name: [{k: r[k] for k in ("leaf", "K", "Kp", "N", "kernel_ms", "plain_ms",
                                          "library_ms", "bound_ms", "bound_by")}
                       for r in f["fc"]] for name, f in cnn["full"].items()},
        "vlm_launches": vlm["launches"][0],
        "vlm": {"layer_m4": vlm["layer_m4"], "head_m4": vlm["head_m4"]},
        "mesh_launches": mesh_launches["polarized_matmul"],
        "mesh_speculate_launches": mesh_runs["speculate"]["polarized_matmul"],
        "mesh_shards": [r for r in mesh_rows["polarized_matmul"] if r["route"] == "f32"],
        "mesh_mla_launches": mla["mesh_launches"][0],
        "mesh_whisper_launches": whisper["mesh_launches"][0],
        "mesh_xlstm_launches": xlstm["mesh_launches"][0],
        "mesh_zamba_launches": zamba["mesh_launches"][0],
        "mesh_family_shards": {f: [r for r in rows["polarized_matmul"] if r["route"] == "f32"]
                               for f, rows in family_shards.items()},
        "verify": [r for r in verify_rows if r["route"] == "f32"],
        "bits": [r for r in width_rows if r["route"] == "f32"],
        "heads": head_rows,
        "per": "the 7 projections of one qwen2-1.5b layer at M=4, f32 x (bf16_x: the same "
               "on bf16 x, widened in the kernel, as the served decode gives it; its "
               "library_ms is one bf16 torch.matmul with the pre-folded bf16 weight; "
               "verify: the speculative verify's M on bf16 x that this route takes); "
               "speculate_launches: the first greedy speculative run's; fleet_launches: "
               "the chunked fleet run's (expected: reckoned from its recorded prefills, "
               "chunk widths and rounds); checkpoint_serve_launches: the restored "
               "serving checkpoint's run; autobits_launches: the mixed-plan tree's run; "
               "auto_draft_launches: the auto-draft speculative run's; "
               "dense_configs_launches: h2o-danube-1.8b's off run (its head at M=1 and 4 "
               "included); reliability_launches: the reliability phase's served runs with "
               "their probes (M=8); moe_launches: the olmoe-1b-7b run's (decode and the "
               "head); moe: olmoe's q/k/v/o (2048x2048) and head (2048x50304) at M=4, bf16 x; "
               "mla_launches: deepseek-v3's run (4 layers, 16 experts; 7 per layer and the "
               "head per decode step, the head per prefill); mla: its 7 decode projections "
               "of one layer and its head (7168x129280) at M=4, bf16 x; whisper_launches: "
               "whisper-small's run (8 per decoder layer per decode step); whisper: its 8 "
               "projections of one decoder layer at M=4 (the cross k/v run on the "
               "tensor-core route), bf16 x; xlstm_launches: xlstm-350m's run (163 per "
               "decode step, the sLSTM's f32-x inputs at every prefill, the head per "
               "prefill); xlstm: its 163 projections of one decode call at M=4 (the sLSTM's "
               "16 on f32 x) and gates_m4 its 1024x4 wi/wf at M=4 (N = 4, element-wise "
               "staging); zamba_launches: zamba2-2.7b's run (172 per decode step, the head "
               "per prefill); zamba: its 172 projections of one decode call at M=4, bf16 x; "
               "cnn_launches: the cnn phase's compressed forwards (one per FC leaf, f32 x at "
               "M=64: the tiny pipeline's and the three published CNNs'); cnn: each FC leaf "
               "of LeNet-5, VGG-16 and ResNet-18 at M=64 on its collected f32 input, K "
               "padded to whole fragments, library_ms the f32 torch.matmul of the dense "
               "weight; vlm_launches: phi-3-vision-4.2b's served run (7 per layer per "
               "decode step, the head at M=1 per prefill and M=4 per step); vlm: its 7 "
               "projections of one layer and its head (3072x32064) at M=4, bf16 x; "
               "bits: the same 7 at 2-, 4- and 6-bit codes, bf16 x; heads: the "
               "untied heads' shapes at M=4, bf16 x; mesh_launches: the slice served on "
               "a data=1,model=1 mesh; mesh_speculate_launches: its tree restored "
               "straight into that mesh's layout, served speculatively; mesh_shards: every local shard shape of the "
               "slice's projections and head at model = 2, 4, 8 (N/tp columns, Kp/tp "
               "rows for o/down), M=4 on bf16 x (M=64: the tensor-core entry's); "
               "mesh_mla_launches, mesh_whisper_launches, mesh_xlstm_launches, "
               "mesh_zamba_launches: the mla, whisper, xlstm and zamba phases' "
               "trees served on a data=1,model=1 mesh; mesh_family_shards: every local "
               "shard shape of their FORMS leaves at model = 2, 4, 8 (MLA q_up, kv_up, wo, "
               "the shared expert; whisper's attention, cross attention and MLP; xLSTM's "
               "N-split projections, the mLSTM's wi/wf at N = 2 and 1, the sLSTM's on "
               "f32 x; Zamba2's shared block), M=4 on bf16 x",
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
        "dense_configs_launches": dense_launches["block"]["polarized_matmul_skip"],
        "mesh_block_launches": mesh_runs["block"]["polarized_matmul_skip"],
        "mesh_shards": [r for r in mesh_rows["polarized_matmul_skip"] if r["route"] == "f32"],
        "mesh_family_shards": {f: [r for r in rows["polarized_matmul_skip"]
                                   if r["route"] == "f32"]
                               for f, rows in family_shards.items()},
        "per": "the 7 projections of one qwen2-1.5b layer at M=4, f32 x, every other "
               "K slice of x zero (bf16_x: the same on bf16 x; mesh_block_launches: the "
               "slice served with zero_skip='block' on a data=1,model=1 mesh; "
               "mesh_shards: the local "
               "shard shapes of the mesh phase, every other K slice dead, M=4 on bf16 "
               "x; M=64: the tensor-core entry's; mesh_family_shards: the same at MLA's, "
               "whisper's, xLSTM's (the sLSTM's on f32 x) and Zamba2's shard shapes)",
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
        "cnn_launches": cnn["launches"]["bitserial_crossbar"],
        "cnn": {name: [{k: r[k] for k in ("case", "M", "K", "N", "kernel_ms", "plain_ms",
                                          "library_ms", "bound_ms", "bound_by")}
                       for r in f["bit"]] for name, f in cnn["full"].items()},
        "library_note": "one float64 torch.matmul of the codes and the signed "
                        "weights: the exact integer product of the ideal ADC",
        "per": "M=4 at 1536x1536, 1536x8960 and 8960x1536, 16-bit inputs, ideal ADC "
               "(adc4_ms: the same with a 4-bit ADC; fidelity_m64: the five leaves of "
               "the fidelity path at M=64, ideal ADC; cnn_launches: apply_simulated on "
               "every FC leaf of the cnn phase's compressed CNNs, and the tiny pipeline's "
               "one; cnn: those FC leaves' operands at M=64, K padded)",
    }, {
        "name": "admm_polarize", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/admm_polarize.cu",
        "replaces": "src/repro/kernels/admm_polarize.py:26",
        "launches": pol_launches,
        "checkpoint_launches": ckpt_pol_launches,
        "autobits_launches": ab_launches[3],
        "moe_launches": moe["polarize_launches"],
        "moe_expert_triple": moe["triple"],
        "mla_launches": mla["polarize_launches"],
        "mla_layer": mla["pol_layer"],
        "whisper_launches": whisper["polarize_launches"],
        "xlstm_launches": xlstm["polarize_launches"],
        "xlstm_tree": xlstm["pol_tree"],
        "zamba_launches": zamba["polarize_launches"],
        "zamba_tree": zamba["pol_tree"],
        "cnn_launches": cnn["launches"]["admm_polarize"],
        "cnn_z_update": {name: {k: sum(r[k] for r in f["pol"])
                                for k in ("kernel_ms", "plain_ms", "bound_ms")}
                         for name, f in cnn["full"].items()},
        "vlm_launches": vlm["polarize_launches"],
        "mesh_train_launches": mesh_train_launches,
        "mesh_train_family_launches": family_train_launches,
        "mesh_train_family_shards": {
            f: [{k: r[k] for k in ("mesh", "leaf", "local_shape", "shards", "kernel_ms",
                                   "bound_ms", "bound_by", "launch_floor_ms")} for r in rows]
            for f, rows in family_train_rows.items()},
        "mesh_train_shards": [{k: r[k] for k in ("mesh", "leaf", "local_shape", "shards",
                                                 "kernel_ms", "bound_ms", "bound_by",
                                                 "launch_floor_ms")}
                              for r in mesh_train_rows],
        "per_matrix": pol_matrix_row,
        "max_abs_err": max(max(r["sum_max_abs_err"], r["energy_max_abs_err"]) for r in pol_rows),
        "ms": total(pol_rows, "kernel_ms"), "plain_ms": total(pol_rows, "plain_ms"),
        "bound_ms": total(pol_rows, "bound_ms"), "bound_by": bound_by(pol_rows),
        "library_ms": None,
        "library_note": "no single PyTorch call elects a sign per fragment and zeroes "
                        "the entries that disagree with it",
        "per": "one fresh Z-update of qwen2-1.5b: its 7 stacked leaves (1.31 G f32 "
               "elements), m=8, sum rule; launches: the train run's; checkpoint_launches: "
               "the checkpoint phase's runs A, B before the save and B after the restore; "
               "autobits_launches: the compress_tree calls of the auto-bits sweep and its "
               "validation (energy rule, one per layer matrix); moe_launches: compress_tree "
               "of olmoe-1b-7b (one per (layer, expert) matrix, attention matrix and the "
               "head); mla_launches: compress_tree of the cut deepseek-v3 (4 layers of 5 MLA, "
               "3 shared and 48 expert matrices, the MTP module's proj and block, the head); "
               "mla_layer: one such layer's 56 matrices, energy rule; whisper_launches: "
               "compress_tree of whisper-small (193 matrices); xlstm_launches, xlstm_tree: "
               "compress_tree of xlstm-350m (163 matrices, 42 of them 1024x4) and their "
               "summed times; zamba_launches, zamba_tree: of zamba2-2.7b (116: in_proj and "
               "out_proj of 54 layers, the shared block's 7, the head); cnn_launches: the "
               "cnn phase's fresh Z-updates and compress_tree calls (one per conv or FC "
               "matrix, sum rule); cnn_z_update: one Z-update's matrices of each published "
               "CNN, one call each, K padded; vlm_launches: compress_tree of "
               "phi-3-vision-4.2b (225 matrices); mesh_train_launches: the sharded "
               "train run's (4 steps on a data=1,model=1 mesh); mesh_train_shards: one local "
               "shard of each stacked leaf at data x model = 2x2, 4x2 and 8x1 (fsdp=True "
               "specs), sum rule, every shard held bit for bit; "
               "mesh_train_family_launches: whisper-small's, the cut deepseek-v3's, "
               "xlstm-350m's and zamba2-2.7b's sharded train runs (2 steps, a fresh "
               "Z-update after each, one launch per constrained leaf); "
               "mesh_train_family_shards: their stacked leaves' shards (xLSTM: one "
               "mLSTM and one sLSTM block's matrices; Zamba2: the Mamba stacks and the "
               "shared block), as mesh_train_shards; "
               "moe_expert_triple: one (layer, expert)'s w_gate, w_up (2048x1024) "
               "and w_down (1024x2048), energy rule; per_matrix: those calls "
               "for the 7 matrices of one qwen2-1.5b layer, energy rule",
    }, {
        "name": "polarized_matmul_tc", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/polarized_matmul_tc.cu",
        "replaces": "src/repro/kernels/polarized_matmul.py:45 and :68 (bf16 x, uint8 "
                    "codes, M >= TC_MIN_ROWS, N >= TC_MIN_COLS)",
        "launches": launches["polarized_matmul_tc"],
        "skip_launches": skip_launches["polarized_matmul_tc_skip"],
        "speculate_launches": spec_launches["polarized_matmul_tc"],
        "fleet_launches": fleet_launches[0][1],
        "fleet_launches_expected": fleet_launches[1][1],
        "checkpoint_serve_launches": ckpt_serve_launches[1],
        "autobits_launches": ab_launches[0][1],
        "autobits_validation_launches": ab_launches[1][1],
        "auto_draft_launches": ab_launches[2][1],
        "dense_configs_launches": dense_launches["off"]["polarized_matmul_tc"],
        "reliability_launches": rel_launches[1],
        "moe_launches": moe["launches"][1],
        "mla_launches": mla["launches"][1],
        "mesh_launches": mesh_launches["polarized_matmul_tc"],
        "mesh_speculate_launches": mesh_runs["speculate"]["polarized_matmul_tc"],
        "mesh_block_skip_launches": mesh_runs["block"]["polarized_matmul_tc_skip"],
        "mesh_shards": [dict(r, skip=key.endswith("skip")) for key, rs in mesh_rows.items()
                        for r in rs if r["route"] == "tc"],
        "mesh_mla_launches": mla["mesh_launches"][1],
        "mesh_whisper_launches": whisper["mesh_launches"][1],
        "mesh_xlstm_launches": xlstm["mesh_launches"][1],
        "mesh_zamba_launches": zamba["mesh_launches"][1],
        "mesh_family_shards": {f: [dict(r, skip=key.endswith("skip"))
                                   for key, rs in rows.items() for r in rs
                                   if r["route"] == "tc"]
                               for f, rows in family_shards.items()},
        "whisper_launches": whisper["launches"][1],
        "whisper_cross_kv": whisper["cross_kv"],
        "xlstm_launches": xlstm["launches"][1],
        "zamba_launches": zamba["launches"][1],
        "vlm_launches": vlm["launches"][1],
        "dense_configs_skip_launches": dense_launches["block"]["polarized_matmul_tc_skip"],
        "verify": [r for r in verify_rows if r["route"] == "tc"],
        "bits": [r for r in width_rows if r["route"] == "tc"],
        "max_abs_err": tc_abs, "max_rel_err": tc_rel,
        "ms": per_layer(tc_rows, PREFILL_M, "kernel_ms"),
        "plain_ms": per_layer(tc_rows, PREFILL_M, "plain_ms"),
        "bound_ms": per_layer(tc_rows, PREFILL_M, "bound_ms"),
        "bound_by": bound_by([r for r in tc_rows if r["M"] == PREFILL_M]),
        "library_ms": per_layer(tc_rows, PREFILL_M, "library_ms"),
        "library_f32_ms": per_layer(tc_rows, PREFILL_M, "library_f32_ms"),
        "f32_kernel_ms": per_layer(rows, PREFILL_M, "kernel_ms"),
        "per_m": {M: {k: per_layer(tc_rows, M, k) for k in
                      ("kernel_ms", "plain_ms", "bound_ms", "library_ms", "library_f32_ms")}
                  for M in TC_TIMED_M},
        "tb_s": {M: sum(r["tb_s"] * r["kernel_ms"] * LAYER_SHAPES[(r["K"], r["N"])]
                        for r in tc_rows if r["M"] == M) / per_layer(tc_rows, M, "kernel_ms")
                 for M in TC_TIMED_M},
        "whisper_m1024": {k: tc_extra["whisper_m1024"][k] for k in
                          ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "tb_s")},
        "narrow_n": tc_extra["narrow_n"],
        "host_us": tc_extra["host"],
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
               "the speculative verify's M that this route takes; autobits_launches: the "
               "mixed-plan tree's run; autobits_validation_launches: plan_auto_bits' "
               "measured-NLL forwards at M=256; auto_draft_launches: the auto-draft "
               "speculative run's; dense_configs_launches: h2o-danube-1.8b's prefills; "
               "reliability_launches: the reliability phase's prefills; moe_launches: "
               "olmoe-1b-7b's exact-length prefills (M = 16-64); mla_launches: deepseek-v3's "
               "exact-length prefills (8 per layer); whisper_launches: whisper-small's "
               "prefills (M = the bucket, the cross k/v at M = max_len) and every decode "
               "step's cross k/v (M = 4 slots x 256); whisper_cross_kv: that M=1024 call "
               "(768x768), timed; xlstm_launches, zamba_launches: the recurrent families' "
               "exact-length prefills (M = 16-64; xlstm's mLSTM wi/wf, N = 4, take the f32 "
               "kernel); "
               "vlm_launches: phi-3-vision-4.2b's prefills at their buckets; "
               "bits: the 7 at M=64 on 2-, 4- and 6-bit codes; mesh_launches: the slice "
               "served on a data=1,model=1 mesh; mesh_speculate_launches: its tree "
               "restored straight into that layout, served speculatively; "
               "mesh_block_skip_launches: the slice on that mesh with zero_skip='block'; "
               "mesh_shards: the mesh phase's shard "
               "shapes at M=64 (skip: the block-skip launch, every other K slice dead); "
               "mesh_mla_launches, mesh_whisper_launches, mesh_xlstm_launches, "
               "mesh_zamba_launches: their phases' trees on a data=1,model=1 mesh; "
               "mesh_family_shards: MLA's, whisper's, xLSTM's and Zamba2's shard shapes "
               "at M=64 and whisper's cross k/v at M = 4 slots x 256; per_m, tb_s: the 7 "
               "per layer at each M of TC_TIMED_M, the kernel called directly; "
               "whisper_m1024: the cross k/v at M=1,024; narrow_n: both routes at M=64, "
               "K=1024, N = 1-128; host_us: host microseconds per call of the wrapper "
               "and of the C entry at 1536x1536",
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
