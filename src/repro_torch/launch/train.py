"""Training launcher of the port: deterministic synthetic data, AdamW, the
ADMM polarization schedule, optional gradient compression, and async
checkpointing with resume and SIGTERM preemption.

  python -m repro_torch.launch.train --arch qwen2-1.5b --steps 50 --admm
  python -m repro_torch.launch.train --reduced --steps 4 --admm --admm-every 2 \
      --device cpu
  python -m repro_torch.launch.train --reduced --steps 8 --admm --admm-every 2 \
      --device cpu --ckpt-dir /path/to/ckpt --ckpt-every 4 [--resume]

Weights are random, made from ``--seed`` on the device.  With ``--admm``
the loss carries the ADMM penalty and every ``--admm-every`` steps the Z/U
update projects W + U onto the FORMS constraint sets; its fresh
polarization runs the polarization kernel (the CUDA kernel on the card).
Every ``--log-every`` steps it prints the loss, the gradient norm, the mean
ms per step since the last line (host clock, after a device synchronize)
and, with ADMM, the polarization violation of W; at the end, tokens/s.
``--device`` defaults to ``cuda`` and the launcher fails without a card
unless ``--device cpu`` is given.  The reference's checkpointing,
preemption handler and mesh flags are not ported yet.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager, install_preemption_handler
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import admm as admm_mod
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import LMStreamConfig, lm_batch
from repro_torch.models.registry import build
from repro_torch.training import train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--admm", action="store_true")
    ap.add_argument("--admm-rho", type=float, default=1e-3)
    ap.add_argument("--admm-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "bf16_ef", "int8_ef"])
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build(cfg, device=dev)
    tcfg = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10),
        microbatches=args.microbatches, admm_enabled=args.admm,
        admm_rho=args.admm_rho, admm_update_every=args.admm_every,
        grad_compression=args.grad_compression,
        moment_dtype=args.moment_dtype, remat=not args.reduced, seed=args.seed,
        checkpoint_every=args.ckpt_every)
    state, table = train_loop.init_train_state(model, tcfg)
    step = train_loop.make_train_step(model, tcfg, table)
    ds = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                        global_batch=args.global_batch, seed=tcfg.seed)

    start = 0
    mgr = None
    guard = contextlib.nullcontext
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=tcfg.keep_checkpoints)
        latest = mgr.latest_step()
        if args.resume and latest is not None:
            template = train_loop.restore_template(state, table, tcfg, latest)
            del state
            state, start = mgr.restore_latest(template)
            del template
            print(f"resumed from step {start}")

        def on_preempt():
            mgr.wait()
            mgr.save_sync(state, int(state.step))
            print("preemption checkpoint written", flush=True)

        guard = install_preemption_handler(on_preempt).critical

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = t_log = time.perf_counter()
    since = 0
    for i in range(start, args.steps):
        ts = time.perf_counter()
        with guard():
            state, metrics = step(state, lm_batch(ds, i, dev))
            state = train_loop.maybe_admm_update(state, table, tcfg, i + 1)
        dt = time.perf_counter() - ts
        if i > start + 2 and dt > 5 * (time.perf_counter() - t0) / max(i - start, 1):
            print(f"[watchdog] slow step {i}: {dt:.2f}s", flush=True)
        since += 1
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            sync()
            now = time.perf_counter()
            extra = ""
            if state.admm is not None:
                cm = admm_mod.constraint_metrics(state.params, state.admm, table)
                extra = f"  viol {float(cm['polarization_violation']):.4f}"
            print(f"step {i + 1:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"{(now - t_log) / since * 1e3:.0f}ms/step{extra}", flush=True)
            t_log, since = time.perf_counter(), 0
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save_async(state, i + 1)
    if mgr:
        mgr.save_sync(state, args.steps)
    sync()
    tput = ((args.steps - start) * args.global_batch * args.seq_len
            / max(time.perf_counter() - t0, 1e-9))
    print(f"done: {args.steps - start} steps, {tput:.0f} tokens/s on {dev}")


if __name__ == "__main__":
    main()
