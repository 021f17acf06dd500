"""Training launcher of the port: deterministic synthetic data, AdamW, the
ADMM polarization schedule, optional gradient compression, async
checkpointing with resume and SIGTERM preemption, on a device mesh.

  python -m repro_torch.launch.train --arch qwen2-1.5b --steps 50 --admm
  python -m repro_torch.launch.train --reduced --steps 4 --admm --admm-every 2 \
      --device cpu
  python -m repro_torch.launch.train --reduced --steps 8 --admm --admm-every 2 \
      --device cpu --ckpt-dir /path/to/ckpt --ckpt-every 4 [--resume]
  python -m repro_torch.launch.train --reduced --steps 4 --admm --admm-every 2 \
      --device cpu --mesh-data 2 --mesh-model 2 --fake-devices 4
  torchrun --nproc-per-node 8 -m repro_torch.launch.train --mesh-data 4 --mesh-model 2

Weights are random, made from ``--seed`` on the device.  With ``--admm``
the loss carries the ADMM penalty and every ``--admm-every`` steps the Z/U
update projects W + U onto the FORMS constraint sets; its fresh
polarization runs the polarization kernel (the CUDA kernel on the card).
Every ``--log-every`` steps it prints the loss, the gradient norm, the mean
ms per step since the last line (host clock, after a device synchronize)
and, with ADMM, the polarization violation of W; at the end, tokens/s.
``--device`` defaults to ``cuda`` and the launcher fails without a card
unless ``--device cpu`` is given.  ``--ckpt-dir`` saves every
``--ckpt-every`` steps in the background (``--resume`` continues from the
latest save), and SIGTERM saves the last finished step and exits 0.

As the reference always does, the launcher trains on a mesh of
``--pods`` x ``--mesh-data`` x ``--mesh-model`` devices (``launch/mesh``):
explicit SPMD, one process per device, each holding its shards of the
state (FSDP over the batch axes for leaves of 4M elements or more, tensor
parallel over ``model``) and its rows of every global batch; at 1/1/1 a
world of one.  It prints a ``mesh:`` line, and rank 0 prints every line.
On the card start one process per card with ``torchrun``; on the CPU
``--fake-devices N`` runs the N ranks as gloo processes.  Every family
trains on a mesh (the recurrent ones too: xLSTM with all heads on every
model rank, Zamba2's Mamba blocks on the rank's SSM heads).
``--trace-out PATH`` writes the steps' spans (``repro_torch.obs``: the
train step, the Z-updates, attention) to PATH as a Chrome/Perfetto trace
(rank 0's).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import time

import torch

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager, install_preemption_handler
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import admm as admm_mod
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import LMStreamConfig, lm_batch
from repro_torch.models.registry import build
from repro_torch.training import train_loop


def train_batch(model, ds: LMStreamConfig, step: int, dev: torch.device):
    """The global batch of ``step``: the token stream's, and for whisper
    the encoder's frame embeddings ``(B, seq_len, d_model)`` too, drawn on
    the CPU from the step's seed (the same on every rank and device)."""
    batch = lm_batch(ds, step, dev)
    if "frames" in model.input_fields:
        g = torch.Generator()
        g.manual_seed((ds.seed * 1_000_003 + step) % (2 ** 63) + 1)
        batch["frames"] = torch.randn((ds.global_batch, ds.seq_len, model.config.d_model),
                                      generator=g).to(dev)
    return batch


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
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--fake-devices", type=int, default=None, metavar="N",
                    help="with --device cpu: run the mesh as N gloo processes on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the steps' spans to PATH (Chrome/Perfetto JSON; rank 0)")
    args = ap.parse_args(argv)
    if args.fake_devices is not None:
        if args.device != "cpu":
            raise SystemExit("--fake-devices runs gloo processes on the CPU: add --device "
                             "cpu (on cards, start one process per card with torchrun)")
        from repro_torch.launch.mesh import spawn_cpu_world
        spawn_cpu_world(args.fake_devices, _train, args)
        return
    _train(args)


def _train(args) -> None:
    """Train with ``args`` on its mesh; every rank trains, rank 0 prints."""
    import torch.distributed as dist
    from repro_torch.configs.base import MeshConfig
    from repro_torch.launch.mesh import make_mesh
    dev = resolve_device(args.device)
    mesh_cfg = MeshConfig(pods=args.pods, data=args.mesh_data, model=args.mesh_model)
    ours = not dist.is_initialized()
    try:
        mesh = make_mesh(mesh_cfg, device=dev.type)
    except RuntimeError as e:
        if ours and dist.is_initialized():
            dist.destroy_process_group()
        raise SystemExit(f"{e} (on the CPU: --fake-devices {mesh_cfg.num_devices})") from e
    quiet = dist.get_rank() != 0
    try:
        with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
            _train_on(args, dev, mesh)
    finally:
        if ours:
            dist.destroy_process_group()


def _train_on(args, dev: torch.device, mesh) -> None:
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    ctx = shd.ParallelContext.for_mesh(mesh)
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
    # the whole state from the seed on every rank, then each rank's pieces
    state, table = train_loop.init_train_state(model, tcfg)
    shardings = shd.train_state_shardings(state, ctx, table)
    print(f"mesh: {dict(ctx.shape)} over {dist.get_world_size()} devices, "
          f"{shd.sharded_leaf_count(shardings.params)} param leaves sharded", flush=True)
    step = train_loop.make_train_step(model, tcfg, table, ctx=ctx)
    ds = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                        global_batch=args.global_batch, seed=tcfg.seed)

    start = 0
    mgr = None
    guard = contextlib.nullcontext
    latest = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=tcfg.keep_checkpoints, ctx=ctx)
        latest = mgr.latest_step()
    if args.resume and latest is not None:
        template = train_loop.restore_template(state, table, tcfg, latest)
        del state
        state, start = mgr.restore_latest(
            template, shardings=shd.train_state_shardings(template, ctx, table))
        del template
        print(f"resumed from step {start}")
    else:
        state = shd.reshard_state(state, shardings)
    del shardings
    if mgr:
        def on_preempt():
            mgr.wait()
            mgr.save_sync(state, int(state.step))
            print("preemption checkpoint written", flush=True)

        agree = None
        if dist.get_world_size() > 1:
            # the vote runs on a host (gloo) group: it never waits for the card
            votes = dist.new_group(backend="gloo")

            def agree(pending: bool) -> bool:
                flag = torch.tensor([int(pending)])
                dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=votes)
                return bool(flag)

        guard = install_preemption_handler(on_preempt, agree).critical

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    tracing = args.trace_out and dist.get_rank() == 0
    if tracing:
        obs.enable()
    t0 = t_log = time.perf_counter()
    since = 0
    for i in range(start, args.steps):
        ts = time.perf_counter()
        with guard():
            state, metrics = step(state, train_batch(model, ds, i, dev))
            state = train_loop.maybe_admm_update(state, table, tcfg, i + 1, ctx)
        dt = time.perf_counter() - ts
        if i > start + 2 and dt > 5 * (time.perf_counter() - t0) / max(i - start, 1):
            print(f"[watchdog] slow step {i}: {dt:.2f}s", flush=True)
        since += 1
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            sync()
            now = time.perf_counter()
            extra = ""
            if state.admm is not None:
                with shd.parallel_context(ctx):
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
    if tracing:
        obs.disable()
        print(f"trace: {obs.write_chrome(args.trace_out)} spans -> {args.trace_out}")


if __name__ == "__main__":
    main()
