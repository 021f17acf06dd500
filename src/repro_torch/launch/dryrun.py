"""Multi-pod dry run: trace every (arch x shape x mesh) cell, one rank's
program, on fake tensors.

For each cell this script:
  1. builds the params / train state / cache / batch as fake tensors of
     their global shapes (``FakeTensorMode``: no storage, no values drawn,
     at any model size; the reference's ``jax.eval_shape``);
  2. derives their shardings from the logical rules
     (``distributed/sharding.py``, held equal to the reference's
     ``PartitionSpec``s) and cuts rank 0's local shard of every input;
  3. runs rank 0's step on those shards through a
     ``distributed.context.RecordingContext`` of the production mesh
     (16x16 single-pod = 256 ranks, 2x16x16 multi-pod = 512): every
     collective returns a tensor of its output's shape and records its
     operand bytes by kind;
  4. counts the traced ops (``analysis/opcount``: FLOPs, bytes, peak live
     memory) and writes the three roofline terms against the H100's peak
     rates (``analysis/roofline.H100``) into a JSON artifact.

The reference lowers and compiles one SPMD program with XLA; the port runs
explicit SPMD (one process per device), so its analogue is one rank's
eager program.  Nothing is allocated on any device and no kernel runs: a
kernel's wrapper reached with fake tensors raises (the cells are dense
bf16 or int8, as in the reference, so none lies on their path).  The
trace runs on fake ``cuda`` tensors, the card's program, where this torch
is built with CUDA (with or without a card); a CPU-only torch cannot index
a fake CUDA tensor (its CUDA device guard is not linked), so there it
traces on fake ``cpu`` tensors.  No op of the cells' path branches on
the device, so both traces count the same FLOPs, collectives and memory;
the MoE train cells' bytes differ by about 0.01% (a decomposition in their
backward that depends on the device).  The artifact names the device as
``traced_device``.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out DIR
  python -m repro_torch.analysis.report DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import opcount
from repro_torch.analysis import roofline as roof
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, shapes_for
from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import RecordingContext, parallel_context
from repro_torch.models.registry import Model, build

PyTree = Any


def trace_device() -> str:
    """``cuda`` where this torch is built with CUDA, else ``cpu`` (see the
    module docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def fake_mode():
    """A fresh ``FakeTensorMode`` (a new one per cell: its tensors die with it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


# ---------------------------------------------------------------------------
# input specs (fake or meta tensors, no allocation)
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                device: Any = "meta") -> Dict[str, torch.Tensor]:
    """The model inputs of one cell at their global shapes, as tensors on
    ``device`` (``meta`` by default: shapes and dtypes only)."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, torch.Tensor] = {}
    if cfg.family == "whisper":
        specs["frames"] = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16, device=device)
        specs["tokens"] = torch.empty((b, s), dtype=torch.int32, device=device)
    elif cfg.num_image_tokens:
        specs["patch_embeds"] = torch.empty((b, cfg.num_image_tokens, cfg.d_model),
                                            dtype=torch.bfloat16, device=device)
        specs["tokens"] = torch.empty((b, s - cfg.num_image_tokens), dtype=torch.int32,
                                      device=device)
    else:
        specs["tokens"] = torch.empty((b, s), dtype=torch.int32, device=device)
    return specs


def input_specs(arch: str, shape_name: str) -> Dict[str, torch.Tensor]:
    """Public helper: the model-input stand-ins (meta tensors) of one cell."""
    return batch_specs(get_config(arch), SHAPES[shape_name])


def _map(tree: PyTree, fn: Callable[[torch.Tensor], Any]) -> PyTree:
    """``fn`` on every tensor of a tree of dicts, lists, tuples and
    dataclasses (a FORMS leaf, a train state); anything else as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def _on(tree: PyTree, device: Any) -> PyTree:
    """The tree's tensors as uninitialized tensors of the same shapes and
    dtypes on ``device`` (under ``FakeTensorMode``: fake ones)."""
    dev = torch.device(device)
    return _map(tree, lambda t: t if t.device == dev else torch.empty_like(t, device=dev))


def _cast_tree(tree: PyTree, dtype: torch.dtype) -> PyTree:
    return _map(tree, lambda x: x.to(dtype) if x.is_floating_point() else x)


def param_specs(cfg: ModelConfig, device: Any, dtype: Optional[torch.dtype] = None) -> PyTree:
    """The params of ``cfg`` at their global shapes on ``device``, built
    from shapes under the ambient ``FakeTensorMode`` (the family's ``init``
    on a host generator, so no device generator is asked for; no value is
    drawn), cast to ``dtype`` when given."""
    host = build(cfg, device="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    params = _on(host.init(generator=g), device)
    return params if dtype is None else _cast_tree(params, dtype)


# ---------------------------------------------------------------------------
# sharding assignment
# ---------------------------------------------------------------------------

def cache_shardings(cache: PyTree, cfg: ModelConfig, ctx) -> PyTree:
    """Decode-cache shardings: batch over ('pod', 'data'), heads (or the
    sequence, where the KV heads do not divide) over model; the shared
    rules of ``distributed/sharding.py``, which the serving engine uses."""
    del cfg
    return shd.cache_shardings(cache, ctx)


def batch_shardings(specs: Dict[str, torch.Tensor], ctx) -> Dict[str, shd.Sharding]:
    out = {}
    for k, v in specs.items():
        logical = ("batch",) + (None,) * (v.ndim - 1)
        out[k] = shd.Sharding(ctx, shd._checked_spec(logical, tuple(v.shape), ctx))
    return out


def _replicated_like(tree: PyTree, ctx) -> PyTree:
    return _map(tree, lambda _: shd.Sharding(ctx, ()))


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """One cell's step and its inputs: ``fn(*args)`` on rank 0's local
    shards, where ``args`` are the global specs and ``shardings`` their
    layouts (the argument groups are named by ``names``)."""

    fn: Callable
    args: Tuple
    shardings: Tuple
    names: Tuple[str, ...]

    def place(self, args: Optional[Tuple] = None) -> Tuple:
        """Rank 0's pieces of every argument (``shd.reshard_state``), of
        ``args`` when given (real tensors of the specs' shapes)."""
        args = self.args if args is None else args
        return tuple(shd.reshard_state(a, s) for a, s in zip(args, self.shardings))


def build_train_cell(model: Model, shape: ShapeConfig, ctx, tcfg: TrainConfig) -> Cell:
    """The train step (``make_train_step(ctx=)``) on the whole train state,
    FSDP over the batch axes and tensor parallel over model, and the global
    batch, which the port's step takes on every rank."""
    from repro_torch.training import train_loop
    dev = model.device
    host = build(model.config, device="cpu")
    state, table = train_loop.init_train_state(host, tcfg,
                                               params=param_specs(model.config, "cpu"))
    state = _on(state, dev)
    b_specs = batch_specs(model.config, shape, dev)
    state_sh = shd.train_state_shardings(state, ctx, table, fsdp=True)
    b_sh = _replicated_like(b_specs, ctx)

    def train(state, batch):
        step = train_loop.make_train_step(model, tcfg, table, ctx=ctx)
        return step(state, batch)

    return Cell(train, (state, b_specs), (state_sh, b_sh), ("state", "batch"))


def _serving_fsdp(cfg: ModelConfig, ctx) -> bool:
    """Serving param-sharding policy: replicate over data when weights fit.

    FSDP'd weights cost an all-gather per layer per token at decode; when the
    bf16 weights fit HBM under model-axis sharding alone (< ~12 GB/chip),
    serving replicates them across the data axes (standard inference TP).
    """
    tp = max(ctx.axis_size("model"), 1)
    return (cfg.param_count() * 2 / tp) > 12e9


def build_prefill_cell(model: Model, shape: ShapeConfig, ctx) -> Cell:
    """The full-sequence forward on bf16 params, logits out."""
    cfg = model.config

    def prefill(params, batch):
        with parallel_context(ctx):
            logits, _ = model.forward(params, batch)
        return logits

    params = param_specs(cfg, model.device, torch.bfloat16)
    b_specs = batch_specs(cfg, shape, model.device)
    params_sh = shd.params_shardings(params, ctx, fsdp=_serving_fsdp(cfg, ctx))
    return Cell(prefill, (params, b_specs), (params_sh, batch_shardings(b_specs, ctx)),
                ("params", "batch"))


def build_decode_cell(model: Model, shape: ShapeConfig, ctx,
                      int8_weights: bool = False) -> Cell:
    """One decode step on the dense slot cache (``model.decode_step``) on
    bf16 or int8-grid (``serving/quant_weights``) params; ``pos`` is the
    port's ``(B,)`` first-token positions."""
    cfg = model.config
    dev = model.device

    def serve_step(params, tokens, cache, pos):
        with parallel_context(ctx):
            return model.decode_step(params, tokens, cache, pos)

    params = param_specs(cfg, dev, torch.bfloat16)
    if int8_weights:
        from repro_torch.serving.quant_weights import quantize_tree
        params = quantize_tree(params)[0]
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    tok = torch.empty((shape.global_batch, 1), dtype=torch.int32, device=dev)
    pos = torch.empty((shape.global_batch,), dtype=torch.int32, device=dev)
    params_sh = shd.params_shardings(params, ctx, fsdp=_serving_fsdp(cfg, ctx))
    cache_sh = cache_shardings(cache, cfg, ctx)
    batch_sh = batch_shardings({"tokens": tok, "pos": pos}, ctx)
    return Cell(serve_step, (params, tok, cache, pos),
                (params_sh, batch_sh["tokens"], cache_sh, batch_sh["pos"]),
                ("params", "tokens", "cache", "pos"))


def build_cell(model: Model, shape: ShapeConfig, ctx, *, admm: bool = False,
               microbatches: int = 1, moment_dtype: str = "float32",
               grad_compression: str = "none", int8_weights: bool = False) -> Cell:
    if shape.kind == "train":
        tcfg = TrainConfig(admm_enabled=admm, microbatches=microbatches, remat=True,
                           moment_dtype=moment_dtype, grad_compression=grad_compression)
        return build_train_cell(model, shape, ctx, tcfg)
    if shape.kind == "prefill":
        return build_prefill_cell(model, shape, ctx)
    return build_decode_cell(model, shape, ctx, int8_weights=int8_weights)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """What one traced step cost this rank."""

    cost: opcount.ModuleCost
    argument_bytes: Dict[str, int]
    output_size: int
    alias_size: int
    temp_size: int
    seconds: float
    ops: Optional[list] = None

    @property
    def argument_size(self) -> int:
        return sum(self.argument_bytes.values())


def _storages(tree: PyTree) -> set:
    return {t.untyped_storage()._cdata for t in opcount._tensors(tree)}


def trace_step(cell: Cell, local: Tuple, ctx: RecordingContext,
               record_ops: bool = False) -> Trace:
    """Run ``cell.fn`` on the placed arguments ``local`` under the op
    counters (inside the ``FakeTensorMode`` they were made in), with the
    recording context's counts zeroed first."""
    ctx.reset()
    args_bytes = {n: opcount.tree_bytes(a) for n, a in zip(cell.names, local)}
    counter = opcount.OpCounter(record_ops=record_ops)
    counter.exclude(local)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops, counter:
        out = cell.fn(*local)
    seconds = time.perf_counter() - t0
    arg_keys = _storages(local)
    outs = list(opcount._tensors(out))
    alias = sum(opcount.tensor_bytes(t) for t in outs
                if t.untyped_storage()._cdata in arg_keys)
    cost = opcount.ModuleCost(
        flops=float(flops.get_total_flops()), bytes=float(counter.bytes),
        collectives=opcount.CollectiveStats(dict(ctx.bytes_by_kind),
                                            dict(ctx.count_by_kind)))
    return Trace(cost=cost, argument_bytes=args_bytes,
                 output_size=sum(opcount.tensor_bytes(t) for t in outs), alias_size=alias,
                 temp_size=int(counter.peak), seconds=seconds, ops=counter.ops)


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             admm: bool = False, microbatches: int = 1,
             save_hlo: bool = False, moment_dtype: Optional[str] = None,
             grad_compression: str = "none", tag_suffix: str = "",
             moe_int8: bool = False, capacity_factor: Optional[float] = None,
             int8_weights: bool = False) -> Dict:
    cfg = get_config(arch)
    if moe_int8:
        cfg = dataclasses.replace(cfg, moe_dispatch_int8=True)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    shape = SHAPES[shape_name]
    mcfg = MeshConfig(pods=2 if mesh_kind == "multi" else 1)    # 2x16x16 or 16x16
    ctx = RecordingContext.for_config(mcfg)
    chips = mcfg.num_devices
    if moment_dtype is None:
        # int8 (quantized-Adam) moments for the 671B-class state; f32 else
        moment_dtype = "int8" if cfg.param_count() > 5e10 else "float32"
    dev = trace_device()
    tag = (f"{arch}__{shape_name}__{mesh_kind}" + ("__admm" if admm else "") + tag_suffix)
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": chips,
        "kind": shape.kind, "traced_device": dev}
    common = {"admm": admm, "microbatches": microbatches,
              "moment_dtype": moment_dtype, "grad_compression": grad_compression}

    t0 = time.perf_counter()
    with fake_mode():
        model = build(cfg, device=dev)
        cell = build_cell(model, shape, ctx, admm=admm, microbatches=microbatches,
                          moment_dtype=moment_dtype, grad_compression=grad_compression,
                          int8_weights=int8_weights)
        local = cell.place()
        setup_s = time.perf_counter() - t0
        trace = trace_step(cell, local, ctx, record_ops=save_hlo)
        del cell, local

    coll = trace.cost.collectives
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = roof.model_flops(shape.kind, cfg.active_param_count(), tokens)
    peak = float(trace.argument_size + trace.temp_size)
    report = roof.RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_kind, chips=chips,
        kind=shape.kind, hlo_flops_per_device=trace.cost.flops,
        hlo_bytes_per_device=trace.cost.bytes,
        collective_bytes_per_device=float(coll.total_bytes),
        model_flops_global=mf, tokens_per_step=tokens, peak_memory_bytes=peak)
    mem_info = {
        "argument_size": trace.argument_size,
        "argument_breakdown": trace.argument_bytes,
        "output_size": trace.output_size,
        "temp_size": trace.temp_size,
        "generated_code_size": None,
        "alias_size": trace.alias_size,
        "fits_hbm": peak <= roof.H100.hbm_bytes,
    }
    result.update({
        "status": "ok",
        "lower_s": trace.seconds,       # the trace of the rank's step
        "compile_s": 0.0,               # eager: nothing is compiled
        "setup_s": setup_s,
        "cost_analysis": {"flops": trace.cost.flops,
                          "bytes_accessed": trace.cost.bytes,
                          "oplevel_bytes": trace.cost.bytes},
        "memory_analysis": mem_info,
        "collectives": {"bytes_by_kind": coll.bytes_by_kind,
                        "count_by_kind": coll.count_by_kind,
                        "total_bytes": coll.total_bytes},
        "roofline": report.to_dict(),
        **common,
    })
    _write(out_dir, tag, result)
    if save_hlo:
        with open(os.path.join(out_dir, tag + ".ops.txt"), "w") as f:
            f.write("\n".join(trace.ops) + "\n")
    print(roof.summarize(report))
    print(f"  memory_analysis: {mem_info}")
    print(f"  collectives: {coll.bytes_by_kind}")
    print(f"  setup {setup_s:.1f}s trace {trace.seconds:.1f}s")
    return result


def _write(out_dir: str, tag: str, result: Dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(result, f, indent=2)


def cells_for(arch: str):
    return [s.name for s in shapes_for(get_config(arch))]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, choices=ARCH_NAMES + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="run every applicable cell")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--admm", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--save-hlo", action="store_true",
                    help="write the traced rank's aten ops as <tag>.ops.txt")
    ap.add_argument("--moe-int8", action="store_true")
    ap.add_argument("--int8-weights", action="store_true",
                    help="serve with int8 block weights (FORMS quantization)")
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.list:
        for a in archs:
            print(a, cells_for(a))
        return

    failures = []
    for arch in archs:
        shapes = cells_for(arch) if args.shape is None else [args.shape]
        for shape in shapes:
            if shape not in cells_for(arch):
                print(f"SKIP {arch} x {shape} (inapplicable: long_500k needs "
                      "sub-quadratic decode)")
                continue
            for mesh_kind in meshes:
                tag = f"{arch} x {shape} x {mesh_kind}"
                print(f"=== {tag} ===", flush=True)
                try:
                    run_cell(arch, shape, mesh_kind, args.out, admm=args.admm,
                             microbatches=args.microbatches,
                             save_hlo=args.save_hlo, moe_int8=args.moe_int8,
                             capacity_factor=args.capacity_factor,
                             int8_weights=args.int8_weights)
                except Exception:
                    failures.append(tag)
                    traceback.print_exc()
    if failures:
        print("FAILED CELLS:", failures)
        raise SystemExit(1)
    print("ALL CELLS OK")


if __name__ == "__main__":
    main()
