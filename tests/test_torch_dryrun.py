"""The dry run and the roofline analysis against the JAX package.

* ``SHAPES``/``shapes_for`` equal the reference's field for field.
* The roofline arithmetic: the port's ``RooflineReport`` with the
  reference's TPU v5e rates gives the reference's ``to_dict()``,
  ``model_flops`` and ``summarize`` line on the same inputs.
* Per-device argument bytes of every arch at ``decode_32k`` and
  ``train_4k`` on the 16x16 mesh equal the same sum over the reference's
  shardings (``params_shardings``/``cache_shardings``/the train state's)
  of its ``jax.eval_shape`` trees, every family included.  Two
  differences are exact and named: the reference's PRNG key (uint32[2])
  is a host generator in the port, and with int8 moments (deepseek-v3)
  the port cuts each moment's row scales with its rows where the
  reference applies the path rules to the ``(..., 1)`` scale and
  replicates it; and the port's train step takes the global batch on every
  rank (the reference's batch is sharded over the batch axes).
* FLOPs of the traced step equal ``repro.analysis.hlo.analyze_module`` on
  the reference's compiled program, reduced configs on a world of one:
  prefill and decode exactly; train exactly plus one head product per
  chunked-CE call (the port's checkpointed chunk recomputes its logits in
  the backward; XLA drops the one-trip scan's rematerialization,
  ``prevent_cse=False``).
* ``markdown_table`` of the same artifacts equals the reference's string.
* The recording context on a fake 2x2 mesh records the collective bytes
  the reckoning gives; the live gloo worlds of ``test_torch_mesh_world``
  and ``test_torch_mesh_train`` run the same helpers unchanged.
* The CLI at full width in a subprocess (the check the reference's own
  subprocess test makes), under 2 GB of peak RSS.
* MLA's, whisper's and xLSTM's cells on the 2x16x16 mesh (their argument
  bytes against the reference's; no cell is refused),
  ``resolve_device`` under fake mode, a kernel reached with
  fake tensors, the context-parallel cache write without a host sync, and
  the int8 weights of a list-shaped tree.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.analysis import hlo as jhlo
from repro.analysis import report as jreport
from repro.analysis import roofline as jroof
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import get_reduced as jreduced
from repro.configs import shapes_for as jshapes_for
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrainConfig
from repro.distributed import sharding as jshd
from repro.models.registry import build as jbuild
from repro_torch.analysis import opcount
from repro_torch.analysis import report
from repro_torch.analysis import roofline as roof
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, get_reduced, shapes_for
from repro_torch.configs.base import MeshConfig, ShapeConfig
from repro_torch.core.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import RecordingContext, parallel_context
from repro_torch.launch import dryrun as D
from repro_torch.models import layers as L
from repro_torch.models.registry import build

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _reference_dryrun():
    """The reference's ``launch/dryrun`` module: importing it sets
    ``XLA_FLAGS`` to 512 host devices, which this process and its children
    must not see, so the variable is put back at once."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdr
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdr


def test_shapes_equal_the_reference_field_for_field():
    assert list(SHAPES) == list(JSHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JSHAPES[name])
        assert s.is_decode == JSHAPES[name].is_decode
    for arch in ARCH_NAMES:
        got = [dataclasses.asdict(s) for s in shapes_for(get_config(arch))]
        assert got == [dataclasses.asdict(s) for s in jshapes_for(jget(arch))]
    assert [a for a in ARCH_NAMES if "long_500k" in D.cells_for(a)] == [
        "xlstm-350m", "zamba2-2.7b"]


V5E = roof.Hardware(name="TPU v5e", peak_flops=jroof.PEAK_FLOPS,
                    hbm_bytes_per_s=jroof.HBM_BW, link_bytes_per_s=jroof.ICI_BW,
                    hbm_bytes=16e9)


@pytest.mark.parametrize("inputs", [
    dict(arch="yi-9b", shape="train_4k", mesh="single", chips=256, kind="train",
         hlo_flops_per_device=3.1e14, hlo_bytes_per_device=2.2e11,
         collective_bytes_per_device=7.5e9, model_flops_global=5.6e16,
         tokens_per_step=1048576, peak_memory_bytes=3.2e10),
    dict(arch="qwen2-1.5b", shape="decode_32k", mesh="multi", chips=512, kind="decode",
         hlo_flops_per_device=4.3e9, hlo_bytes_per_device=8.1e9,
         collective_bytes_per_device=4.4e6, model_flops_global=3.95e11,
         tokens_per_step=128, peak_memory_bytes=None),
    dict(arch="olmoe-1b-7b", shape="prefill_32k", mesh="single", chips=256,
         kind="prefill", hlo_flops_per_device=0.0, hlo_bytes_per_device=0.0,
         collective_bytes_per_device=9.0e8, model_flops_global=1.0e15,
         tokens_per_step=1048576, peak_memory_bytes=1.0),
])
def test_roofline_arithmetic_equals_the_reference(inputs):
    """Same inputs and the reference's rates: the dicts are equal (floats
    exactly: the same operations in the same order), and so is the line."""
    port = roof.RooflineReport(**inputs, hardware=V5E)
    ref = jroof.RooflineReport(**inputs)
    assert port.to_dict() == ref.to_dict()
    assert roof.summarize(port) == jroof.summarize(ref)
    for kind in ("train", "prefill", "decode"):
        assert roof.model_flops(kind, 1_543_714_304, 4096) == jroof.model_flops(
            kind, 1_543_714_304, 4096)
    h100 = roof.RooflineReport(**inputs)
    assert h100.hardware == roof.H100
    assert h100.compute_s == inputs["hlo_flops_per_device"] / 989e12
    assert h100.memory_s == inputs["hlo_bytes_per_device"] / 3.35e12
    assert h100.collective_s == inputs["collective_bytes_per_device"] / 50e9


# ---------------------------------------------------------------------------
# per-device argument bytes against the reference's shardings
# ---------------------------------------------------------------------------

MESH_SIZES = {"data": 16, "model": 16}


def _ref_bytes(specs, shardings, sizes=MESH_SIZES) -> int:
    """Per-device bytes of a spec tree under its ``NamedSharding`` tree on
    the mesh of axis ``sizes`` (the 16x16 mesh by default): each sharded
    dim divided by its axes' sizes."""
    leaves = jax.tree_util.tree_leaves(specs)
    shs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(shs)
    total = 0
    for a, s in zip(leaves, shs):
        shape = list(a.shape)
        for dim, entry in enumerate(tuple(s.spec)):
            if entry is not None:
                names = entry if isinstance(entry, tuple) else (entry,)
                shape[dim] //= math.prod(sizes[n] for n in names)
        total += math.prod(shape) * np.dtype(a.dtype).itemsize
    return total


@pytest.fixture(scope="module")
def jdr():
    return _reference_dryrun()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_argument_bytes_equal_the_references_shardings(jdr, arch):
    jctx = jshd.ParallelContext.for_mesh(AbstractMesh((16, 16), ("data", "model")))
    ctx = RecordingContext(MESH_SIZES)
    jmodel = jbuild(jget(arch))
    cfg = get_config(arch)
    moments = "int8" if cfg.param_count() > 5e10 else "float32"
    for shape_name in ("decode_32k", "train_4k"):
        with jshd.parallel_context(jctx):
            if shape_name == "train_4k":
                _, specs, in_sh, _, _ = jdr.build_train_cell(
                    jmodel, JSHAPES[shape_name], jctx,
                    JTrainConfig(remat=True, moment_dtype=moments))
            else:
                _, specs, in_sh, _, _ = jdr.build_decode_cell(jmodel, JSHAPES[shape_name], jctx)
        with D.fake_mode():
            cell = D.build_cell(build(cfg, device="cpu"), SHAPES[shape_name], ctx,
                                moment_dtype=moments)
            local = dict(zip(cell.names, cell.place()))
            got = {n: opcount.tree_bytes(a) for n, a in local.items()}
            if shape_name == "train_4k":
                opt = local["state"].opt
                scales = opcount.tree_bytes([opt.mu_scale, opt.nu_scale])
        if shape_name == "decode_32k":
            assert got["params"] == _ref_bytes(specs[0], in_sh[0]), arch
            assert got["cache"] == _ref_bytes(specs[2], in_sh[2]), arch
            assert got["tokens"] == _ref_bytes(specs[1], in_sh[1]), arch
            # the port's pos is (B,) over the batch axes, the reference's a scalar
            assert got["pos"] == 4 * 128 // 16
            continue
        state, st_sh = specs[0], in_sh[0]
        ref_state = _ref_bytes(state, st_sh)
        ref_key = _ref_bytes(state.rng, st_sh.rng)
        assert ref_key == 8
        ref_scales = (_ref_bytes([state.opt.mu_scale, state.opt.nu_scale],
                                 [st_sh.opt.mu_scale, st_sh.opt.nu_scale])
                      if state.opt.mu_scale is not None else 0)
        assert got["state"] - scales == ref_state - ref_key - ref_scales, arch
        if moments == "float32":
            assert scales == ref_scales == 0
        else:
            assert 0 < scales < ref_scales
        # the port's step takes the global batch; the reference's is sharded
        assert got["batch"] == _ref_bytes(specs[1], in_sh[1]) * 16


# ---------------------------------------------------------------------------
# FLOPs against the reference's analyzer on its compiled program
# ---------------------------------------------------------------------------

SMALL = {"prefill": (64, 2), "decode": (64, 2), "train": (32, 2)}


def _ref_flops(jdr, arch: str, kind: str) -> float:
    """The reference's cell on a world of one: its builders' step and
    specs, compiled on the one host device without shardings (the
    reference's MoE scan on a concrete 1x1 mesh trips over its own carry
    layout, and one device has nothing to shard)."""
    seq, batch = SMALL[kind]
    jctx = jshd.ParallelContext.for_mesh(AbstractMesh((1, 1), ("data", "model")))
    model = jbuild(jreduced(arch))
    shape = JShape(kind, seq_len=seq, global_batch=batch, kind=kind)
    if kind == "train":
        fn, specs = jdr.build_train_cell(model, shape, jctx, JTrainConfig(remat=True))[:2]
    elif kind == "prefill":
        fn, specs = jdr.build_prefill_cell(model, shape, jctx)[:2]
    else:
        fn, specs = jdr.build_decode_cell(model, shape, jctx)[:2]
    compiled = jax.jit(fn).lower(*specs).compile()
    return jhlo.analyze_module(compiled.as_text()).flops


def _port_flops(arch: str, kind: str) -> float:
    seq, batch = SMALL[kind]
    ctx = RecordingContext({"data": 1, "model": 1})
    with D.fake_mode():
        cell = D.build_cell(build(get_reduced(arch), device="cpu"),
                            ShapeConfig(kind, seq, batch, kind), ctx)
        return D.trace_step(cell, cell.place(), ctx).cost.flops


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b", "phi-3-vision-4.2b"])
def test_traced_flops_equal_the_reference_analyzer(jdr, arch):
    cfg = get_reduced(arch)
    for kind in ("prefill", "decode"):
        assert _port_flops(arch, kind) == _ref_flops(jdr, arch, kind), (arch, kind)
    seq, batch = SMALL["train"]
    text = seq - cfg.num_image_tokens
    head = 2.0 * batch * (text - 1) * cfg.d_model * cfg.vocab_size
    assert _port_flops(arch, "train") == _ref_flops(jdr, arch, "train") + head, arch


def test_op_counter_bytes_and_peak():
    """Operands plus result of a non-view op; nothing for views, aliases
    and allocations; the indices and twice the values of an indexed write;
    the peak of the temporaries above the excluded arguments."""
    with D.fake_mode():
        a = torch.empty(4, 8)
        b = torch.empty(8, 16)
        counter = opcount.OpCounter(record_ops=True)
        counter.exclude((a, b))
        with counter:
            c = a @ b                                   # 128 + 512 + 256 bytes
            v = c.t().reshape(-1)                       # a view and a copy of 256
            w = torch.empty(1000)                       # allocated, not written
            del w
            idx = torch.zeros(3, dtype=torch.long)      # 24 bytes written
            c.index_put_((idx,), torch.ones(3, 16))     # 24 + 2 * 192
            b.add_(1.0)                                 # an argument, in place: 2 x 512
        assert counter.bytes == (128 + 512 + 256) + (256 + 256) + 24 + 192 + (24 + 2 * 192) \
            + 2 * 512
        assert "aten.mm.default" in counter.ops
        # live: c (256), v's copy (256), w (4000, freed), idx (24), the ones (192)
        assert counter.peak == 256 + 256 + 4000
        del c, v, idx
        assert counter.live == 0


# ---------------------------------------------------------------------------
# the recording context
# ---------------------------------------------------------------------------

def test_recording_context_records_the_reckoned_collectives():
    """A swiglu MLP on a fake 2x2 mesh (gate/up split along N, down along
    K): the forward sums the f32 partial product of ``down`` over model
    (one all-reduce of B*S*d*4 bytes); the backward sums the input's
    cotangent at ``model_entry`` in bf16 (B*S*d*2).  ``gate`` alone,
    its N-split output gathered, records one all-gather of the local
    columns (B*S*F/2*2)."""
    b, s, d, f = 2, 3, 8, 16
    ctx = RecordingContext({"data": 2, "model": 2})
    assert ctx.rank == 0 and ctx.coord("model") == 0 and ctx.gather_objects(5) == [5]
    with D.fake_mode():
        g = {"gate": torch.empty(d, f), "up": torch.empty(d, f), "down": torch.empty(f, d)}
        sh = shd.params_shardings({"mlp": g}, ctx, fsdp=False)
        assert sh["mlp"]["gate"].spec == (None, "model")
        assert sh["mlp"]["down"].spec == ("model",)
        p = shd.reshard_state({"mlp": g}, sh)["mlp"]
        assert tuple(p["gate"].shape) == (d, f // 2)
        x = torch.empty(b, s, d, dtype=torch.bfloat16, requires_grad=True)
        with parallel_context(ctx):
            y = L.swiglu(p, x, torch.bfloat16)
            assert ctx.count_by_kind["all-reduce"] == 1
            assert ctx.bytes_by_kind["all-reduce"] == b * s * d * 4
            y.float().sum().backward()
        assert ctx.count_by_kind["all-reduce"] == 2
        assert ctx.bytes_by_kind["all-reduce"] == b * s * d * (4 + 2)
        ctx.reset()
        with parallel_context(ctx):
            out = L.linear(p, "gate", x.detach(), torch.bfloat16)
        assert tuple(out.shape) == (b, s, f)
        assert ctx.count_by_kind == {"all-gather": 1, "all-reduce": 0, "reduce-scatter": 0,
                                     "all-to-all": 0, "collective-permute": 0}
        assert ctx.bytes_by_kind["all-gather"] == b * s * (f // 2) * 2
    # a context over sizes alone still refuses to communicate
    plain = shd.ParallelContext.for_shape({"data": 1, "model": 2})
    with pytest.raises(RuntimeError, match="live mesh"):
        plain.all_reduce(torch.zeros(2), "model")


def _backward_counts(model, params, batch, ctx, leaves, thread: bool):
    """The recording context's counts of one loss's backward, run on this
    thread or on another (as autograd runs a CUDA backward on its device
    thread, where no ambient context is set)."""
    import threading
    from repro_torch.training import train_loop
    with parallel_context(ctx):
        hidden, aux = model.forward(params, batch, remat=True, return_hidden=True)
        loss = train_loop.hidden_loss(model, params, batch, hidden, aux)
    ctx.reset()
    out = {}

    def backward():
        out["grads"] = torch.autograd.grad(loss, leaves)
    if thread:
        t = threading.Thread(target=backward)
        t.start()
        t.join()
    else:
        backward()
    assert len(out["grads"]) == len(leaves)
    return dict(ctx.count_by_kind), dict(ctx.bytes_by_kind)


def test_remat_recomputes_under_the_forwards_context_on_any_thread():
    """A block (and a chunked-CE chunk) recomputed in the backward runs
    under the forward's parallel context even when the backward runs on
    another thread: before ``context.remat``, the recompute on autograd's
    CUDA device thread saw no context (the train cells of the fake-CUDA
    sweep failed on it).  Real CPU tensors through the recording context
    on data=1, model=2 (collective results are placeholders)."""
    from repro_torch.core import paths
    from repro_torch.distributed.context import set_shard, shard_of
    cfg = get_reduced("qwen2-1.5b")
    model = build(cfg, device="cpu")
    ctx = RecordingContext({"data": 1, "model": 2})
    params = model.init(0)
    placed = shd.reshard_state(params, shd.params_shardings(params, ctx, fsdp=False))
    live = {p: set_shard(t.detach().requires_grad_(True), shard_of(t))
            for p, t in paths.iter_leaves(placed)}
    tree = paths.rebuild(placed, live)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32)}
    here = _backward_counts(model, tree, batch, ctx, list(live.values()), thread=False)
    there = _backward_counts(model, tree, batch, ctx, list(live.values()), thread=True)
    assert here == there and here[0]["all-reduce"] > 0


# ---------------------------------------------------------------------------
# the CLI, the report, the 2x16x16 cells
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun`` at full width in a child of
    a child, so that ``RUSAGE_CHILDREN`` reads its peak RSS alone."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    wrapper = ("import json, resource, subprocess, sys\n"
               "p = subprocess.run(sys.argv[1:], capture_output=True, text=True)\n"
               "print(json.dumps({'rc': p.returncode, 'out': p.stdout + p.stderr,\n"
               "    'rss_kb': resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss}))\n")
    proc = subprocess.run(
        [sys.executable, "-c", wrapper, sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "qwen2-1.5b", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(out)], capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return out, json.loads(proc.stdout.strip().splitlines()[-1])


def test_cli_cell_at_full_width_under_two_gb(cli_run):
    out, run = cli_run
    assert run["rc"] == 0, run["out"]
    assert "ALL CELLS OK" in run["out"]
    data = json.loads((out / "qwen2-1.5b__decode_32k__single.json").read_text())
    assert data["status"] == "ok" and data["chips"] == 256
    assert data["cost_analysis"]["flops"] > 0
    assert data["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert data["memory_analysis"]["fits_hbm"] is True
    # qwen2's 2 KV heads do not split 16 ways: the cache shards its sequence
    # over model (context-parallel decode), 28 x 8 x 2048 x 2 x 128 bf16 x 2
    assert data["memory_analysis"]["argument_breakdown"]["cache"] == 28 * 8 * 2048 * 2 * 128 * 4
    assert data["collectives"]["count_by_kind"]["all-reduce"] > 0
    assert run["rss_kb"] < 2 * 1024 * 1024, run["rss_kb"]


def test_report_table_equals_the_reference(cli_run, tmp_path):
    out, _ = cli_run
    rows = report.load_artifacts(str(out))
    zamba = D.run_cell("zamba2-2.7b", "long_500k", "single", str(tmp_path))
    assert zamba["status"] == "ok"
    rows = rows + [zamba]
    for mesh in ("single", "multi"):
        assert report.markdown_table(rows, mesh) == jreport.markdown_table(rows, mesh)
    table = report.markdown_table(rows)
    assert table.count("\n") == 4 and "| zamba2-2.7b | long_500k | decode |" in table
    stats = report.summary_stats(rows)
    assert {k: stats[k] for k in ("cells", "bottlenecks", "total_compile_s")} == \
        jreport.summary_stats(rows)
    assert stats["cells"] == 2 and stats["over_hbm"] == []


MULTI_SIZES = {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("arch,shape", [("xlstm-350m", "long_500k"),
                                        ("deepseek-v3-671b", "train_4k"),
                                        ("whisper-small", "decode_32k")])
def test_item_13d_cells_trace_and_13e_cells_are_refused_by_name(jdr, arch, shape,
                                                               tmp_path):
    """On the 2x16x16 mesh every family traces as ``ok`` (nothing is
    refused since item 13e): MLA and whisper (item 13d), and xLSTM's
    ``long_500k`` decode (item 13e, one slot: its state replicates over the
    batch axes), their per-device argument bytes equal to the reference's
    shardings (the named exceptions of the 16x16 test)."""
    res = D.run_cell(arch, shape, "multi", str(tmp_path))
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__multi.json").read_text())
    assert on_disk == res and res["chips"] == 512
    got = res["memory_analysis"]["argument_breakdown"]
    assert res["status"] == "ok", res
    assert res["cost_analysis"]["flops"] > 0 and res["collectives"]["total_bytes"] > 0
    jctx = jshd.ParallelContext.for_mesh(AbstractMesh((2, 16, 16), ("pod", "data", "model")))
    jmodel = jbuild(jget(arch))
    with jshd.parallel_context(jctx):
        if shape == "train_4k":
            _, specs, in_sh, _, _ = jdr.build_train_cell(
                jmodel, JSHAPES[shape], jctx, JTrainConfig(remat=True, moment_dtype="int8"))
        else:
            _, specs, in_sh, _, _ = jdr.build_decode_cell(jmodel, JSHAPES[shape], jctx)
    if shape in ("decode_32k", "long_500k"):
        for i, name in enumerate(("params", "tokens", "cache")):
            assert got[name] == _ref_bytes(specs[i], in_sh[i], MULTI_SIZES), name
        # the port's (B,) int32 positions: the 128 slots split 32 ways, the
        # one slot of long_500k whole
        assert got["pos"] == (4 * 128 // 32 if shape == "decode_32k" else 4)
        return
    with D.fake_mode():
        cell = D.build_cell(build(get_config(arch), device="cpu"), SHAPES[shape],
                            RecordingContext.for_config(MeshConfig(pods=2)),
                            moment_dtype="int8")
        opt = dict(zip(cell.names, cell.place()))["state"].opt
        scales = opcount.tree_bytes([opt.mu_scale, opt.nu_scale])
    state, st_sh = specs[0], in_sh[0]
    ref_key = _ref_bytes(state.rng, st_sh.rng, MULTI_SIZES)
    ref_scales = _ref_bytes([state.opt.mu_scale, state.opt.nu_scale],
                            [st_sh.opt.mu_scale, st_sh.opt.nu_scale], MULTI_SIZES)
    assert 0 < scales < ref_scales and ref_key == 8
    assert got["state"] - scales == _ref_bytes(state, st_sh, MULTI_SIZES) - ref_key - ref_scales
    assert got["batch"] == _ref_bytes(specs[1], in_sh[1], MULTI_SIZES) * 32


def test_list_prints_each_archs_cells(capsys):
    D.main(["--list", "--arch", "zamba2-2.7b"])
    assert capsys.readouterr().out.strip() == (
        "zamba2-2.7b ['train_4k', 'prefill_32k', 'decode_32k', 'long_500k']")


# ---------------------------------------------------------------------------
# tracing without a card, and the repairs
# ---------------------------------------------------------------------------

def test_resolve_device_takes_cuda_only_under_fake_mode(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with D.fake_mode():
        assert resolve_device("cuda").type == "cuda"
        assert build(get_reduced("qwen2-1.5b"), device="cuda").device.type == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build(get_reduced("qwen2-1.5b"))


def test_a_kernel_reached_with_fake_tensors_raises():
    from repro_torch.kernels import ops
    with D.fake_mode():
        x = torch.empty(4, 16)
        mags = torch.empty(16, 8, dtype=torch.uint8)
        signs = torch.empty(2, 8, dtype=torch.int8)
        scale = torch.empty(1, 8)
        with pytest.raises(RuntimeError, match="fake tensors"):
            ops.polarized_matmul(x, mags, signs, scale, m=8)
        with pytest.raises(RuntimeError, match="fake tensors"):
            ops.admm_polarize(torch.empty(16, 8), m=8)


def _write_range_by_mask(view, rows, grid, offset):
    """The write as a boolean-indexed scatter (a host sync on the card)."""
    b, s = view.shape[:2]
    loc = grid - offset
    live = (loc >= 0) & (loc < s)
    bidx = torch.arange(b)[:, None].expand_as(grid)
    view[bidx[live], loc[live].long()] = rows[live]
    return view


@pytest.mark.parametrize("offset", [0, 4, 8])
def test_context_parallel_cache_write_has_static_shapes(offset):
    """``layers.write_view_range`` equals the boolean-mask write it
    replaced, for rows that straddle this rank's slice on either side, and
    traces on fake tensors (no data-dependent shape)."""
    g = torch.Generator().manual_seed(offset)
    view = torch.randn(3, 4, 2, 5, generator=g)
    rows = torch.randn(3, 5, 2, 5, generator=g)
    grid = torch.tensor([[0, 1, 2, 3, 4], [3, 4, 5, 6, 7], [6, 7, 8, 9, 10]])
    want = _write_range_by_mask(view.clone(), rows, grid, offset)
    got = L.write_view_range(view.clone(), rows, grid, offset)
    assert torch.equal(got, want)
    one = grid[:, :1] + 2
    assert torch.equal(L.write_view_range(view.clone(), rows[:, :1], one, offset),
                       _write_range_by_mask(view.clone(), rows[:, :1], one, offset))
    with D.fake_mode():
        v = torch.empty(3, 4, 2, 5)
        L.write_view_range(v, torch.empty(3, 5, 2, 5), torch.zeros(3, 5, dtype=torch.long), 4)


def test_int8_weights_walk_list_shaped_trees():
    """``quantize_tree`` descends lists as the reference's ``tree_flatten``
    does (xLSTM's per-layer blocks are a list)."""
    from repro.serving.quant_weights import quantize_tree as jquantize
    from repro_torch.serving.quant_weights import quantize_tree
    w = np.random.default_rng(0).standard_normal((2, 16, 8)).astype(np.float32)
    tree = {"blocks": [{"attn": {"wq": torch.from_numpy(w)}}]}
    out, before, after = quantize_tree(tree)
    jout, jbefore, jafter = jquantize({"blocks": [{"attn": {"wq": jnp.asarray(w)}}]})
    assert (before, after) == (jbefore, jafter) == (w.nbytes, 2 * 16 * 8 + 2 * 8 * 4)
    assert np.array_equal(out["blocks"][0]["attn"]["wq"]["q"].numpy(),
                          np.asarray(jout["blocks"][0]["attn"]["wq"]["q"]))
