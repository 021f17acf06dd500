"""Serving launcher of the port: paged KV cache (or the dense slot cache)
+ bulk prefill + chunked decode, with optional FORMS compression and
self-speculative decoding.

  python -m repro_torch.launch.serve --arch qwen2-1.5b --forms
  python -m repro_torch.launch.serve --arch qwen2-1.5b --reduced --device cpu
  python -m repro_torch.launch.serve --reduced --forms --device cpu \
      --mlp-act relu --act-sparsity 0.5 --zero-skip block --zero-skip-stats
  python -m repro_torch.launch.serve --reduced --forms --device cpu \
      --speculate --draft-bits 4 --draft-k 4
  python -m repro_torch.launch.serve --reduced --forms --device cpu --page-size 0
  python -m repro_torch.launch.serve --reduced --forms --device cpu \
      --loadgen n=16,rate=50,adversarial=40 --prefill-chunk 16
  python -m repro_torch.launch.serve --reduced --forms --device cpu \
      --auto-bits --acc-budget 0.05
  python -m repro_torch.launch.serve --reduced --forms --device cpu \
      --auto-bits --speculate --auto-draft --draft-bits 4
  python -m repro_torch.launch.serve --reduced --forms --device cpu \
      --fault-sigma 0.1 --fault-stuck 0.001 --fault-repair --probe-every 4
  python -m repro_torch.launch.serve --arch olmoe-1b-7b --reduced --forms --device cpu
  python -m repro_torch.launch.serve --arch deepseek-v3-671b --reduced --forms --device cpu
  python -m repro_torch.launch.serve --arch whisper-small --reduced --forms --device cpu
  python -m repro_torch.launch.serve --arch xlstm-350m --reduced --forms --device cpu
  python -m repro_torch.launch.serve --arch zamba2-2.7b --reduced --forms --device cpu

Weights are random, made from seed 0 on the device (the JAX launcher inits
with ``PRNGKey(0)``).  With ``--forms`` the weights are compressed by
``repro_torch.forms.compress_tree`` and every projection runs the
polarized-matmul kernel (the CUDA kernel on the card); ``--zero-skip``
serves it with input zero-skipping (``block``: the kernel skips all-zero
input tiles; ``compact``: live fragments are gathered into a smaller
product) and ``--zero-skip-stats`` prints the decode path's measured
per-layer input sparsity.  ``--mlp-act relu --act-sparsity FRAC`` give the
model the fragment-sparse activations zero-skipping exploits.
``--speculate`` (paged cache) serves with a low-bit draft derived from the
served weights: ``--draft-bits``, ``--draft-mode`` (``forms`` or ``int``),
``--draft-fragment`` and ``--draft-layer-step`` shape it, ``--draft-k``
bounds the drafts verified per round, and per-slot adaptive K
(``--no-adaptive-k`` turns it off) shrinks a slot's draft length when its
acceptance drops.  ``--page-size 0`` serves on the dense slot cache, where
``--speculate`` falls back to plain decoding.  Any of ``--prefill-chunk``,
``--step-token-budget``, ``--priority-default``, ``--deadline-ms`` and
``--loadgen`` switches the engine to the SLO fleet scheduler (chunked
prefill, priorities with preemption, deadlines; paged cache only) and
prints its TTFT and inter-token tails per class; ``--loadgen SPEC`` serves
the seeded open-loop trace of ``serving/loadgen.py`` instead of the
``--requests`` batch.
``--auto-bits`` (with ``--forms``) serves a mixed-precision plan of
``forms/autobits.py``: per-leaf widths from a Fisher-diagonal sensitivity
sweep, a greedy knapsack on the paper's ReRAM ADC-event model under the
``--acc-budget`` predicted NLL increase; the launcher then serves the
uniform width that fits the same budget and reports greedy token agreement
(asserted exact when the plan degenerates to that width).  With
``--speculate --auto-draft`` the draft's per-leaf widths come from the same
table at the modeled cost of a uniform ``--draft-bits`` draft.  The modeled
speedup is the ReRAM model's, not a time on the GPU: a mixed tree stores
uint8 codes at every width.
Reliability (``--forms`` only): ``--fault-sigma``, ``--fault-stuck`` and
``--fault-drift`` corrupt the live compressed weights with the seeded ReRAM
fault model (lognormal conductance variation, stuck-at cells, retention
drift; ``--fault-seed``) before serving, ``--encoding vecom`` reads them
back with VECOM-style reference-column offset compensation, and
``--fault-repair`` arms the health monitor: golden-prompt drift probes
every ``--probe-every`` decode rounds past ``--drift-threshold``, per-leaf
scoreboards, and re-encoding of flagged leaves from the clean reference
copy without dropping a request.  ``--stats-every N`` prints a stat line
(pages, prefix hits, acceptance, drift and repairs) every N decode rounds.
``--arch olmoe-1b-7b`` serves the MoE family (prompts at their exact
length); ``--arch deepseek-v3-671b`` serves it with MLA (absorbed decode
over the latent cache; the MTP module is not run in serving).  ``--arch
whisper-small`` serves the encoder-decoder against a zero encoder context:
the engine, as the reference's, never writes ``enc_out``.  ``--arch
xlstm-350m`` and ``--arch zamba2-2.7b`` serve the recurrent families at
the exact prompt length on the dense slot cache: their O(1) state has no
paged path, so ``--page-size`` falls back (the launcher says so) and the
SLO flags are refused.
``--mesh data=D,model=M`` serves SPMD on a device mesh (``launch/mesh.py``,
one process per device; weights tensor-parallel over ``model``, slots or
pages over ``data``) and prints the reference's ``mesh:`` line: on the card
``--mesh data=1,model=1`` (a world of one over NCCL, or more ranks under
``torchrun``), on the CPU ``--device cpu --mesh data=2,model=2
--fake-devices 4`` (four gloo processes; rank 0 prints).  ``--no-donate``
writes every dispatch into a fresh copy of the cache.
``--device`` defaults to ``cuda`` and the launcher fails without a card
unless ``--device cpu`` is given.  Requests are made as the JAX launcher
makes them (``np.random.RandomState(0)``).  The summary line gives each
request's time to first token (``Result.ttft_ms``: median and max);
``--trace-out PATH`` writes the serving call's spans (``repro_torch.obs``)
to PATH as a Chrome/Perfetto trace (rank 0's on a mesh).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.forms import FormsSpec
from repro_torch.forms import autobits as AB
from repro_torch.kernels.polarized_matmul import polarized_matmul, polarized_matmul_skip
from repro_torch.models.registry import build
from repro_torch.reliability import FaultModel, HealthConfig
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.loadgen import LoadGenConfig, generate
from repro_torch.serving.sched import SLOConfig


_LOADGEN_KEYS = {"n": int, "rate": float, "seed": int, "prompt-lo": int, "prompt-hi": int,
                 "out-lo": int, "out-hi": int, "batch-frac": float, "deadline-ms": float,
                 "batch-deadline-ms": float, "adversarial": int, "adversarial-count": int}


def parse_loadgen(spec: str, args, vocab: int) -> LoadGenConfig:
    """``--loadgen`` SPEC (comma-separated key=value) as a LoadGenConfig,
    with the reference launcher's defaults."""
    kv = {}
    for part in filter(None, spec.split(",")):
        if "=" not in part:
            raise SystemExit(f"--loadgen: expected key=value, got {part!r}")
        k, v = part.split("=", 1)
        kv[k.strip()] = v.strip()
    bad = sorted(set(kv) - set(_LOADGEN_KEYS))
    if bad:
        raise SystemExit(f"--loadgen: unknown key(s) {bad}; known: {sorted(_LOADGEN_KEYS)}")
    g = {k: _LOADGEN_KEYS[k](v) for k, v in kv.items()}
    return LoadGenConfig(
        n_requests=g.get("n", args.requests), rate=g.get("rate", 100.0),
        seed=g.get("seed", 0), prompt_len=(g.get("prompt-lo", 2), g.get("prompt-hi", 8)),
        out_len=(g.get("out-lo", 4), g.get("out-hi", args.max_new_tokens)),
        batch_frac=g.get("batch-frac", 0.25), deadline_ms=g.get("deadline-ms"),
        batch_deadline_ms=g.get("batch-deadline-ms"),
        adversarial_len=g.get("adversarial", 0),
        adversarial_count=g.get("adversarial-count", 1),
        vocab=vocab, temperature=args.temperature)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--forms", action="store_true",
                    help="serve on the FORMS-compressed tree")
    ap.add_argument("--fragment", type=int, default=8)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--sign-rule", default="energy", choices=("sum", "energy"))
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--decode-block", type=int, default=4,
                    help="tokens decoded per host sync")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="fixed prompt length (default: random 2-5)")
    ap.add_argument("--page-size", type=int, default=16, metavar="ROWS",
                    help="KV-cache page size for paged serving (attention families; "
                         "the recurrent families always use the dense slot cache); "
                         "0 = the dense slot cache")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size (default: every slot can hold a "
                         "full max_len request)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share page-aligned prompt prefixes across "
                         "concurrent requests")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="TOKENS",
                    help="SLO fleet scheduler: prefill prompts in page-aligned "
                         "chunks of ~TOKENS interleaved with decode rounds "
                         "(0 = whole-prompt admission); any SLO flag switches "
                         "the engine to the fleet scheduler")
    ap.add_argument("--step-token-budget", type=int, default=None, metavar="TOKENS",
                    help="fleet scheduler per-round token budget shared by "
                         "decode and chunked prefill (0 = unbounded)")
    ap.add_argument("--priority-default", default=None,
                    choices=("interactive", "batch"),
                    help="fleet scheduler priority class of requests that set "
                         "none (interactive preempts batch by page eviction)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="fleet scheduler default completion deadline after "
                         "arrival; admission is earliest-deadline-first within "
                         "a class, misses are counted per class")
    ap.add_argument("--loadgen", default=None, metavar="SPEC",
                    help="serve the seeded open-loop trace of "
                         "serving/loadgen.py instead of the --requests batch: "
                         "comma-separated keys, e.g. 'n=64,rate=100,seed=0,"
                         "batch-frac=0.25,adversarial=96' (n, rate, seed, "
                         "prompt-lo, prompt-hi, out-lo, out-hi, batch-frac, "
                         "deadline-ms, batch-deadline-ms, adversarial, "
                         "adversarial-count)")
    ap.add_argument("--speculate", action="store_true",
                    help="self-speculative decoding: low-bit draft + "
                         "one-call verification (paged cache only)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="max draft tokens verified per speculative round")
    ap.add_argument("--draft-bits", type=int, default=4,
                    help="draft magnitude bits")
    ap.add_argument("--draft-mode", default="forms", choices=("forms", "int"),
                    help="draft weights: FORMS low-bit compression or the "
                         "symmetric int grid")
    ap.add_argument("--draft-fragment", type=int, default=None,
                    help="forms-mode draft fragment size m (default: the "
                         "target's geometry)")
    ap.add_argument("--draft-layer-step", type=int, default=1,
                    help="keep every n-th layer in the draft (1 = full depth)")
    ap.add_argument("--no-adaptive-k", action="store_true",
                    help="disable per-slot adaptive draft length")
    ap.add_argument("--auto-bits", action="store_true",
                    help="auto mixed precision: Fisher-sensitivity sweep + "
                         "modeled-throughput knapsack assigns per-leaf "
                         "magnitude bits under --acc-budget (forms serving "
                         "only)")
    ap.add_argument("--acc-budget", type=float, default=0.05, metavar="NATS",
                    help="predicted mean-NLL increase budget of the "
                         "--auto-bits plan vs the uniform --bits tree")
    ap.add_argument("--auto-draft", action="store_true",
                    help="derive the speculative draft's per-leaf bits from "
                         "the --auto-bits sensitivity table at the modeled "
                         "cost of a uniform --draft-bits draft")
    ap.add_argument("--zero-skip", default="off",
                    choices=("off", "block", "compact"),
                    help="activation zero-skipping in the compressed "
                         "matmuls: 'block' skips all-zero input tiles "
                         "(bit-identical), 'compact' gathers live fragments "
                         "into a smaller matmul (forms serving only)")
    ap.add_argument("--zero-skip-keep", type=float, default=0.5,
                    metavar="FRAC",
                    help="compaction fragment budget as a fraction of K/m; "
                         "the compact path runs the full product when more "
                         "fragments are live")
    ap.add_argument("--zero-skip-stats", action="store_true",
                    help="measure per-layer activation sparsity on the "
                         "decode path and print it with the final stats")
    ap.add_argument("--mlp-act", default=None,
                    choices=("silu", "gelu", "relu"),
                    help="override the MLP activation (relu + "
                         "--act-sparsity is the regime zero-skipping "
                         "exploits; changes the model)")
    ap.add_argument("--act-sparsity", type=float, default=None, metavar="FRAC",
                    help="fragment-structured activation sparsification: "
                         "drop this fraction of MLP input fragments per row "
                         "(keep the strongest by max|x|; changes the model)")
    ap.add_argument("--act-fragment", type=int, default=None,
                    help="fragment size for --act-sparsity (align with "
                         "--fragment so dropped fragments map onto whole "
                         "skip units; default: ModelConfig's)")
    ap.add_argument("--stats-every", type=int, default=0, metavar="ROUNDS",
                    help="print pool/acceptance/health stats every N decode rounds")
    ap.add_argument("--encoding", default="binary", choices=("binary", "vecom"),
                    help="cell-level encoding of the compressed weights: "
                         "plain bit-slice or VECOM-style reference-column "
                         "offset compensation (reliability)")
    ap.add_argument("--fault-sigma", type=float, default=None,
                    help="inject lognormal conductance variation of this "
                         "scale into the live compressed weights")
    ap.add_argument("--fault-stuck", type=float, default=None,
                    help="per-cell stuck-at fault probability (split evenly "
                         "between stuck-SET and stuck-RESET)")
    ap.add_argument("--fault-drift", type=float, default=None, metavar="T",
                    help="retention time for drift injection "
                         "((1+T)^-nu conductance decay)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="fault-injection RNG seed")
    ap.add_argument("--fault-repair", action="store_true",
                    help="arm the health monitor: probe for logit drift and "
                         "auto-repair corrupted leaves from the reference "
                         "copy (forms serving only)")
    ap.add_argument("--probe-every", type=int, default=16, metavar="ROUNDS",
                    help="decode rounds between health probes "
                         "(with --fault-repair)")
    ap.add_argument("--drift-threshold", type=float, default=1e-3,
                    help="max-abs logit drift that triggers scan/repair")
    ap.add_argument("--no-donate", action="store_true",
                    help="write every dispatch into a fresh copy of the cache "
                         "instead of updating it in place")
    ap.add_argument("--mesh", default=None, metavar="AXES",
                    help='device mesh as "data=D,model=M" (sharded serving, one '
                         "process per device)")
    ap.add_argument("--fake-devices", type=int, default=None, metavar="N",
                    help="with --device cpu: run the mesh as N gloo processes on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the serving call's spans to PATH (Chrome/Perfetto JSON)")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    if args.fake_devices is not None:
        if args.device != "cpu":
            raise SystemExit("--fake-devices runs gloo processes on the CPU: add "
                             "--device cpu (on cards, start one process per card "
                             "with torchrun)")
        if not args.mesh:
            raise SystemExit("--fake-devices N serves a mesh: add --mesh data=D,model=M")
        from repro_torch.launch.mesh import spawn_cpu_world
        spawn_cpu_world(args.fake_devices, _serve_rank, args)
        return
    _serve(args)


def _serve_rank(args) -> None:
    """One rank of ``--fake-devices``: the launcher in the gloo world
    already joined."""
    _serve(args)


def _serve(args) -> None:
    """Serve with ``args``; on a mesh every rank serves and rank 0 prints."""
    import torch.distributed as dist
    mesh = None
    ours = False
    if args.mesh:
        from repro_torch.launch.mesh import make_mesh, parse_mesh_arg
        ours = not dist.is_initialized()
        mesh = make_mesh(parse_mesh_arg(args.mesh), device=torch.device(args.device).type)
    quiet = mesh is not None and dist.get_rank() != 0
    try:
        with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
            _serve_on(args, mesh)
    finally:
        if ours:
            dist.destroy_process_group()


def _serve_on(args, mesh) -> None:
    fault_args = (args.fault_sigma, args.fault_stuck, args.fault_drift)
    wants_faults = any(v is not None for v in fault_args)
    if (wants_faults or args.fault_repair or args.encoding != "binary") and not args.forms:
        raise SystemExit("--fault-*/--encoding model ReRAM cells, which only "
                         "exist for compressed weights: add --forms")

    if (args.auto_bits or args.auto_draft) and not args.forms:
        raise SystemExit("--auto-bits/--auto-draft pick per-leaf FORMS "
                         "bit-widths: add --forms")
    if args.auto_draft and not args.auto_bits:
        raise SystemExit("--auto-draft reuses the --auto-bits sensitivity "
                         "table: add --auto-bits")
    if args.auto_draft and args.draft_mode != "forms":
        raise SystemExit("--auto-draft plans FORMS bit-widths: use "
                         "--draft-mode forms")
    if (args.zero_skip != "off" or args.zero_skip_stats) and not args.forms:
        raise SystemExit("--zero-skip/--zero-skip-stats act on the FORMS "
                         "matmul path: add --forms")
    slo_flags = [n for n, v in (("--prefill-chunk", args.prefill_chunk),
                                ("--step-token-budget", args.step_token_budget),
                                ("--priority-default", args.priority_default),
                                ("--deadline-ms", args.deadline_ms),
                                ("--loadgen", args.loadgen))
                 if v is not None]
    if slo_flags and not args.page_size:
        raise SystemExit(f"{'/'.join(slo_flags)} need the SLO fleet scheduler, which "
                         "schedules KV pages (chunked prefill, preemption by page "
                         "eviction): drop --page-size 0")
    if args.loadgen is not None and args.prompt_len is not None:
        raise SystemExit("--loadgen draws its own prompt-length mix from the seed: "
                         "drop --prompt-len (or drop --loadgen for fixed-length prompts)")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    lg_cfg = parse_loadgen(args.loadgen, args, cfg.vocab_size) if args.loadgen else None
    slo = None
    if slo_flags:
        slo = SLOConfig(
            prefill_chunk=args.prefill_chunk if args.prefill_chunk is not None else 32,
            step_token_budget=(args.step_token_budget
                               if args.step_token_budget is not None else 128),
            default_priority=args.priority_default or "interactive",
            default_deadline_ms=args.deadline_ms)
    act_over = {k: v for k, v in (("mlp_act", args.mlp_act),
                                  ("act_sparsity", args.act_sparsity),
                                  ("act_fragment", args.act_fragment))
                if v is not None}
    if act_over:
        cfg = dataclasses.replace(cfg, **act_over)
    model = build(cfg, device=args.device)
    if slo_flags and not model.supports_paged:
        raise SystemExit(f"{'/'.join(slo_flags)} need the SLO fleet scheduler, but family "
                         f"{cfg.family!r} has no paged path (O(1) recurrent state — "
                         "nothing to chunk or evict): pick an attention family")
    params = model.init(0)
    spec = (FormsSpec(m=args.fragment, bits=args.bits, rule=args.sign_rule,
                      encoding=args.encoding)
            if args.forms else None)
    auto = plan = draft_plan = None
    if args.auto_bits:
        auto = AB.plan_auto_bits(model, params, spec, AB.AutoBitsConfig(acc_budget=args.acc_budget))
        plan = auto.specs()
        print(f"auto-bits: {auto.summary()}")
        for pth, grp, dl in auto.top_groups():
            print(f"auto-bits: most sensitive {pth} col-group {grp} (dl {dl:.2e})")
        if args.auto_draft:
            dplan = AB.plan_draft_bits(auto.table, match_bits=args.draft_bits)
            draft_plan = dplan.specs()
            print(f"auto-bits draft: {dplan.summary()}")
    engine = ServingEngine(model, params, max_len=args.max_len,
                           batch_slots=args.slots, spec=spec, plan=plan, draft_plan=draft_plan,
                           decode_block=args.decode_block,
                           page_size=args.page_size, num_pages=args.num_pages,
                           prefix_cache=args.prefix_cache, device=args.device,
                           speculate=args.speculate, draft_k=args.draft_k,
                           draft_bits=args.draft_bits, draft_mode=args.draft_mode,
                           draft_fragment=args.draft_fragment,
                           draft_layer_step=args.draft_layer_step,
                           adaptive_k=not args.no_adaptive_k,
                           zero_skip=args.zero_skip,
                           zero_skip_keep=args.zero_skip_keep,
                           zero_skip_stats=args.zero_skip_stats, slo=slo,
                           donate=not args.no_donate, mesh=mesh,
                           health=(HealthConfig(probe_every=args.probe_every,
                                                drift_threshold=args.drift_threshold)
                                   if args.fault_repair else None),
                           stats_every=args.stats_every)
    if auto is None:
        del params
    if engine.compression_report is not None:
        print(f"forms: {engine.compression_report.summary()} "
              f"(encoding={args.encoding})")
    if wants_faults:
        stuck = (args.fault_stuck or 0.0) / 2
        report = engine.inject_faults(FaultModel(
            sigma=args.fault_sigma or 0.0, p_stuck_on=stuck, p_stuck_off=stuck,
            t=args.fault_drift or 0.0, seed=args.fault_seed))
        print(f"faults: {report.summary()}")
    if engine.paged:
        alloc = engine.page_allocator
        print(f"paged cache: {alloc.capacity} pages x {engine.page_size} rows "
              f"(+{alloc.partitions} scratch), {engine.cache_bytes() / 2**20:.1f} MiB, "
              f"prefix_cache={'on' if engine.prefix_cache else 'off'}")
    else:
        if args.page_size:
            print(f"paged cache: unsupported for family {cfg.family!r} "
                  "(O(1) recurrent state) — dense slot cache")
        print(f"dense slot cache: {engine.slots} slots x {engine.max_len} rows, "
              f"{engine.cache_bytes() / 2**20:.1f} MiB")
    if engine.speculative:
        detail = ("int grid" if args.draft_mode == "int"
                  else engine.draft_report.summary())
        print(f"speculate: k={args.draft_k}, {args.draft_bits}-bit "
              f"{args.draft_mode} draft, layer_step={args.draft_layer_step} "
              f"({detail})")
    elif args.speculate:
        print("speculate: unsupported on the dense cache — plain decode")
    if mesh is not None:
        import torch.distributed as dist
        from repro_torch.distributed.sharding import sharded_leaf_count
        print(f"mesh: {dict(engine.ctx.shape)} over {dist.get_world_size()} devices, "
              f"{sharded_leaf_count(engine.param_shardings)} param leaves sharded")
    if lg_cfg is not None:
        reqs = generate(lg_cfg)
        print(f"loadgen: {lg_cfg.n_requests} requests at {lg_cfg.rate:.0f}/s "
              f"(seed {lg_cfg.seed}, batch_frac {lg_cfg.batch_frac}, "
              f"adversarial {lg_cfg.adversarial_len})")
    else:
        rng = np.random.RandomState(0)
        plen = lambda: (args.prompt_len if args.prompt_len else rng.randint(2, 6))
        reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, size=plen()),
                        max_new_tokens=args.max_new_tokens,
                        temperature=args.temperature)
                for i in range(args.requests)]
    launches0 = polarized_matmul.launches
    skips0 = polarized_matmul_skip.launches
    tracing = args.trace_out and (mesh is None or torch.distributed.get_rank() == 0)
    if tracing:
        obs.enable()
    t0 = time.perf_counter()
    results = engine.run(reqs)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    if tracing:
        obs.disable()
        print(f"trace: {obs.write_chrome(args.trace_out)} spans -> {args.trace_out}")
    toks = sum(len(r.tokens) for r in results)
    for r in results[:4]:
        print(f"req {r.uid}: {r.tokens}")
    pf = np.mean([r.prefill_ms for r in results])
    ttft = [r.ttft_ms for r in results]
    print(f"{len(results)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, forms={args.forms}, "
          f"block={args.decode_block}, device={engine.device}); "
          f"mean prefill {pf:.1f}ms, ttft median {np.median(ttft):.1f}ms "
          f"max {max(ttft):.1f}ms")
    stats = engine.stats()
    parts = [f"rounds {stats['rounds']}",
             f"max_concurrent {stats['max_concurrent']}"]
    if "pages" in stats:
        pg = stats["pages"]
        parts.append(f"pages hw {pg['high_water']}/{pg['capacity']} "
                     f"(shared {pg['shared']})")
    if "prefix_hits" in stats:
        parts.append(f"prefix_hits {stats['prefix_hits']}")
    if "speculate" in stats:
        sp = stats["speculate"]
        parts.append(f"acceptance {sp['acceptance']:.2f} "
                     f"tok/round {sp['tokens_per_round']:.2f}")
    if "health" in stats:
        h = stats["health"]
        parts.append(f"probes {h['probes']} repairs {h['repairs']} "
                     f"drift {h['last_drift']:.2e}")
    if "sparsity" in stats:
        ov = stats["sparsity"]["overall"]
        parts.append(f"sparsity elem {ov['elem_sparsity']:.2f} "
                     f"frag {ov['fragment_sparsity']:.2f} "
                     f"({ov['calls']} matmuls)")
    if engine.device.type == "cuda" and args.forms:
        parts.append(f"polarized_matmul launches "
                     f"{polarized_matmul.launches - launches0}")
        if args.zero_skip == "block":
            parts.append(f"polarized_matmul_skip launches "
                         f"{polarized_matmul_skip.launches - skips0}")
    print("stats: " + ", ".join(parts))
    if "slo" in stats:
        s = stats["slo"]
        print(f"slo: ttft p50 {s['ttft_ms']['p50']:.1f}ms "
              f"p99 {s['ttft_ms']['p99']:.1f}ms, "
              f"itl p50 {s['inter_token_ms']['p50']:.2f}ms "
              f"p99 {s['inter_token_ms']['p99']:.2f}ms, "
              f"preempt {s['preemptions']} (resumed {s['resumes']}), "
              f"miss {s['deadline_misses']}, "
              f"chunks {s['chunked_prefill']['calls']}"
              f"/{s['chunked_prefill']['tokens']}tok")
        for cls, c in s["per_class"].items():
            print(f"slo[{cls}]: {c['completed']} done, "
                  f"ttft p99 {c['ttft_ms']['p99']:.1f}ms, "
                  f"itl p99 {c['inter_token_ms']['p99']:.2f}ms, "
                  f"miss {c['deadline_misses']}, "
                  f"preempt {c['preemptions']}, "
                  f"queue peak {c['queue_peak']}")
    if "health" in stats:
        for ev in stats["health"]["events"]:
            print(f"health[{ev['round']}]: "
                  + ", ".join(f"{k}={v}" for k, v in ev.items() if k != "round"))
    if "sparsity" in stats:
        for tag, s in stats["sparsity"]["layers"].items():
            print(f"sparsity[{tag}]: elem {s['elem_sparsity']:.2f} "
                  f"frag {s['fragment_sparsity']:.2f} calls {s['calls']}")
    if auto is not None and args.temperature == 0.0:
        del engine
        par = auto_bits_parity(model, params, spec, auto, args.acc_budget, reqs, results,
                               max_len=args.max_len, batch_slots=args.slots,
                               decode_block=args.decode_block, page_size=args.page_size,
                               num_pages=args.num_pages, device=args.device)
        print(f"auto-bits parity: matched-budget uniform {par['uniform_bits']}b, modeled "
              f"{par['uniform_over_plan']:.2f}x slower than plan (ReRAM ADC-event model), "
              f"greedy token agreement {par['agreement']:.2f}"
              + (" (exact, asserted)" if par["degenerate"] else ""))


def auto_bits_parity(model, params, spec, auto, acc_budget, reqs, results, **engine_kw
                     ) -> dict:
    """Greedy parity of a served plan against the uniform width that fits
    the same budget, served from ``params`` with ``engine_kw``: the plan
    must not cost more than that uniform tree on the ReRAM model, and where
    it degenerates to exactly that width the two engines must emit the same
    tokens (same weights, same greedy argmax).  A mixed plan serves other
    weights, so its token agreement is reported, not held."""
    u = AB.uniform_bits_for_budget(auto.table, acc_budget)
    u_seconds = AB.uniform_seconds(auto.table, u)
    if not auto.modeled_seconds <= u_seconds + 1e-12:
        raise AssertionError(f"mixed plan modeled slower than uniform {u}b at equal budget")
    uni = ServingEngine(model, params, spec=dataclasses.replace(spec, bits=u), **engine_kw)
    ures = {r.uid: list(r.tokens) for r in uni.run(
        [Request(uid=r.uid, prompt=np.asarray(r.prompt), max_new_tokens=r.max_new_tokens)
         for r in reqs])}
    got = {r.uid: list(r.tokens) for r in results}
    pairs = [(got[uid], ures[uid]) for uid in got]
    agree = (sum(sum(a == b for a, b in zip(x, y)) for x, y in pairs)
             / max(1, sum(len(x) for x, _ in pairs)))
    degenerate = set(auto.bits.values()) == {u}
    if degenerate and not all(x == y for x, y in pairs):
        raise AssertionError("plan degenerated to the uniform width but tokens differ")
    return {"uniform_bits": u, "uniform_over_plan": u_seconds / max(auto.modeled_seconds, 1e-30),
            "agreement": agree, "degenerate": degenerate}


if __name__ == "__main__":
    main()
