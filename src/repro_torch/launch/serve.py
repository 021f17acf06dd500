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
``--speculate`` falls back to plain decoding.
``--device`` defaults to ``cuda`` and the launcher fails without a card
unless ``--device cpu`` is given.  Requests are made as the JAX launcher
makes them (``np.random.RandomState(0)``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.forms import FormsSpec
from repro_torch.kernels.polarized_matmul import polarized_matmul, polarized_matmul_skip
from repro_torch.models.registry import build
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None) -> None:
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
                    help="KV-cache page size (0: the dense slot cache)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size (default: every slot can hold a "
                         "full max_len request)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share page-aligned prompt prefixes across "
                         "concurrent requests")
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
    ap.add_argument("--auto-draft", action="store_true",
                    help="per-leaf draft bits from a sensitivity sweep (not "
                         "ported yet: ROADMAP queue 1, item 8)")
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.auto_draft:
        raise SystemExit("--auto-draft is not ported yet (ROADMAP queue 1, item 8: "
                         "auto mixed precision, forms/autobits.py)")
    if (args.zero_skip != "off" or args.zero_skip_stats) and not args.forms:
        raise SystemExit("--zero-skip/--zero-skip-stats act on the FORMS "
                         "matmul path: add --forms")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    act_over = {k: v for k, v in (("mlp_act", args.mlp_act),
                                  ("act_sparsity", args.act_sparsity),
                                  ("act_fragment", args.act_fragment))
                if v is not None}
    if act_over:
        cfg = dataclasses.replace(cfg, **act_over)
    model = build(cfg, device=args.device)
    params = model.init(0)
    spec = (FormsSpec(m=args.fragment, bits=args.bits, rule=args.sign_rule)
            if args.forms else None)
    engine = ServingEngine(model, params, max_len=args.max_len,
                           batch_slots=args.slots, spec=spec,
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
                           zero_skip_stats=args.zero_skip_stats)
    del params
    if engine.compression_report is not None:
        print(f"forms: {engine.compression_report.summary()}")
    if engine.paged:
        alloc = engine.page_allocator
        print(f"paged cache: {alloc.capacity} pages x {engine.page_size} rows "
              f"(+1 scratch), {engine.cache_bytes() / 2**20:.1f} MiB, "
              f"prefix_cache={'on' if engine.prefix_cache else 'off'}")
    else:
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
    rng = np.random.RandomState(0)
    plen = lambda: (args.prompt_len if args.prompt_len else rng.randint(2, 6))
    reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, size=plen()),
                    max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature)
            for i in range(args.requests)]
    launches0 = polarized_matmul.launches
    skips0 = polarized_matmul_skip.launches
    t0 = time.perf_counter()
    results = engine.run(reqs)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in results)
    for r in results[:4]:
        print(f"req {r.uid}: {r.tokens}")
    pf = np.mean([r.prefill_ms for r in results])
    dm = np.mean([r.decode_ms for r in results])
    print(f"{len(results)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, forms={args.forms}, "
          f"block={args.decode_block}, device={engine.device}); "
          f"mean prefill {pf:.1f}ms, mean decode share {dm:.1f}ms")
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
    if "sparsity" in stats:
        for tag, s in stats["sparsity"]["layers"].items():
            print(f"sparsity[{tag}]: elem {s['elem_sparsity']:.2f} "
                  f"frag {s['fragment_sparsity']:.2f} calls {s['calls']}")


if __name__ == "__main__":
    main()
