"""Serving launcher of the port: paged KV cache + bulk prefill + chunked
decode, with optional FORMS compression.

  python -m repro_torch.launch.serve --arch qwen2-1.5b --forms
  python -m repro_torch.launch.serve --arch qwen2-1.5b --reduced --device cpu

Weights are random, made from seed 0 on the device (the JAX launcher inits
with ``PRNGKey(0)``).  With ``--forms`` the weights are compressed by
``repro_torch.forms.compress_tree`` and every projection runs the
polarized-matmul kernel (the CUDA kernel on the card).
``--device`` defaults to ``cuda`` and the launcher fails without a card
unless ``--device cpu`` is given.  Requests are made as the JAX launcher
makes them (``np.random.RandomState(0)``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.forms import FormsSpec
from repro_torch.kernels.polarized_matmul import polarized_matmul
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
                    help="KV-cache page size (the dense slot cache, 0, is not "
                         "ported yet)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page-pool size (default: every slot can hold a "
                         "full max_len request)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share page-aligned prompt prefixes across "
                         "concurrent requests")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build(cfg, device=args.device)
    params = model.init(0)
    spec = (FormsSpec(m=args.fragment, bits=args.bits, rule=args.sign_rule)
            if args.forms else None)
    engine = ServingEngine(model, params, max_len=args.max_len,
                           batch_slots=args.slots, spec=spec,
                           decode_block=args.decode_block,
                           page_size=args.page_size, num_pages=args.num_pages,
                           prefix_cache=args.prefix_cache, device=args.device)
    del params
    if engine.compression_report is not None:
        print(f"forms: {engine.compression_report.summary()}")
    alloc = engine.page_allocator
    print(f"paged cache: {alloc.capacity} pages x {engine.page_size} rows "
          f"(+1 scratch), {engine.cache_bytes() / 2**20:.1f} MiB, "
          f"prefix_cache={'on' if engine.prefix_cache else 'off'}")
    rng = np.random.RandomState(0)
    plen = lambda: (args.prompt_len if args.prompt_len else rng.randint(2, 6))
    reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, size=plen()),
                    max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature)
            for i in range(args.requests)]
    launches0 = polarized_matmul.launches
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
    pg = stats["pages"]
    parts = [f"rounds {stats['rounds']}",
             f"max_concurrent {stats['max_concurrent']}",
             f"pages hw {pg['high_water']}/{pg['capacity']} (shared {pg['shared']})"]
    if "prefix_hits" in stats:
        parts.append(f"prefix_hits {stats['prefix_hits']}")
    if engine.device.type == "cuda" and args.forms:
        parts.append(f"polarized_matmul launches "
                     f"{polarized_matmul.launches - launches0}")
    print("stats: " + ", ".join(parts))


if __name__ == "__main__":
    main()
