"""Sharded serving in gloo worlds on the CPU, against the JAX package.

One world per mesh shape, every check inside it (process start costs
seconds): 4 ranks at data=2, model=2 for the engine, 2 ranks at data=1,
model=2 for the expert-parallel MoE dispatch.  The reference's
single-device tokens and MoE outputs are computed in the pytest process
(JAX is imported there only: the ranks import this module, which imports
the port alone at its top) and handed to the ranks with the bridged
weights.  Each rank also serves the port's unsharded engine: the sharded
greedy tokens must equal both, for plain paged, dense slot cache,
speculative, fleet with chunked prefill, a mixed-precision plan, a restore
straight into the sharded layout (served plainly and speculatively, with
FORMS, int-grid, layer-skipping and per-leaf-planned drafts built from the
placed leaves) and
``donate=False``, on the reduced qwen2 (f32, random QKV biases) and the
reference's two-layer test model, and for a head count that does not
divide the model axis.
"""
import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import MeshConfig
from repro_torch.forms import FormsSpec, compress_tree, compressed_paths, validate_tree_sharding
from repro_torch.launch.mesh import make_mesh, spawn_cpu_world
from repro_torch.models.registry import build
from repro_torch.serving import speculate as SP
from repro_torch.serving.engine import Request, ServingEngine

PROMPTS = [[1, 2, 3], [2, 2, 3], [3, 2, 3], [4, 2, 3]]
NEW = 6
TIMEOUT_S = 120


def _requests():
    return [Request(uid=i, prompt=np.array(p), max_new_tokens=NEW)
            for i, p in enumerate(PROMPTS)]


def _tiny_cfg(base, heads=2, kv=2, hd=16, d_ff=64):
    """The reference child's ``_tiny_model`` config (two f32 layers of yi-9b)."""
    return dataclasses.replace(base, num_layers=2, d_model=heads * hd, num_heads=heads,
                               num_kv_heads=kv, head_dim=hd, d_ff=d_ff, vocab_size=64,
                               dtype="float32")


MODELS = {
    "qwen2": lambda base: dataclasses.replace(base, dtype="float32"),
    "tiny": lambda base: _tiny_cfg(base),
    "heads3": lambda base: _tiny_cfg(base, heads=3, kv=3, d_ff=96),
}
BASE = {"qwen2": "qwen2-1.5b", "tiny": "yi-9b", "heads3": "yi-9b"}


# (tag, draft_mode, draft_bits, draft_layer_step, draft_plan) of the drafts
# built from a tree restored straight into its layout
SPECULATIVE_RESTORES = [
    ("restore_speculative", "forms", 4, 1, None),
    ("restore_speculative_int", "int", 4, 1, None),
    ("restore_speculative_int_skip2", "int", 8, 2, None),
    ("restore_speculative_plan", "forms", 4, 1,
     {"attn/wq": FormsSpec(m=8, bits=2), "mlp/down": FormsSpec(m=8, bits=6)}),
]


def _plan():
    spec = FormsSpec(m=8)
    return spec, {"attn/wq": spec.with_bits(4), "mlp/gate": spec.with_bits(2),
                  "attn/wo": dataclasses.replace(spec, m=16, bits=6)}


# ---------------------------------------------------------------------------
# the ranks (this module's top imports only the port)
# ---------------------------------------------------------------------------

def _tokens(eng):
    return {str(r.uid): list(r.tokens) for r in eng.run(_requests())}


def _split_bytes_ok(params) -> int:
    """Assert every model-split leaf holds its spec's share; returns how
    many leaves were split."""
    from repro_torch.distributed.context import shard_of
    n = 0
    for path, leaf in _leaves(params):
        planes = ([(t, s) for t, s in zip((leaf.mags, leaf.signs, leaf.scale), leaf.shard)]
                  if hasattr(leaf, "mags") and leaf.shard is not None
                  else [(leaf, shard_of(leaf))])
        for t, sh in planes:
            if sh is None or not any(e is not None for e in sh.spec):
                continue
            ways = 1
            for e in sh.spec:
                ways *= 2 if e is not None else 1
            glob = int(np.prod(sh.shape)) * t.element_size()
            assert t.numel() * t.element_size() * ways == glob, (path, t.shape, sh)
            n += 1
    return n


def _same_leaves(a, b) -> bool:
    """Whether two placed trees hold the same leaves, code for code, with
    the same layouts."""
    from repro_torch.distributed.context import shard_of
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    if la.keys() != lb.keys():
        return False
    for path, x in la.items():
        y = lb[path]
        planes = (lambda t: (t.mags, t.signs, t.scale)) if hasattr(x, "mags") else (
            lambda t: (t,))
        if shard_of(x) != shard_of(y) or not all(
                p.dtype == q.dtype and torch.equal(p, q) for p, q in zip(planes(x), planes(y))):
            return False
    return True


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    elif tree is not None:
        yield prefix, tree


def _world_engine(path, out):
    """The data=2, model=2 world: every engine check of this file."""
    import torch.distributed as dist
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.distributed import sharding as shd
    from repro_torch.reliability import FaultModel, HealthConfig

    blob = torch.load(path, weights_only=False)
    mesh = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    rank = dist.get_rank()
    res = {}

    def check(name, got, *wants):
        res[name] = {"got": got, "ok": all(got == w for w in wants)}

    for name in ("qwen2", "tiny"):
        cfg = MODELS[name](get_reduced(BASE[name]))
        m = build(cfg, device="cpu")
        p = blob["params"][name]
        want = blob["want"][name]
        kw = dict(max_len=32, batch_slots=4, device="cpu")
        runs = {
            "paged": dict(forms=True, page_size=8),
            "dense": dict(forms=True, page_size=0),
            "speculative": dict(forms=True, page_size=8, speculate=True, draft_k=4,
                                draft_bits=4),
            "fleet": dict(forms=True, page_size=4,
                          slo={"prefill_chunk": 4, "step_token_budget": 8}),
            "donate_false": dict(forms=True, page_size=8, donate=False),
        }
        for run, extra in runs.items():
            plain = _tokens(ServingEngine(m, p, **kw, **extra))
            eng = ServingEngine(m, p, **kw, **extra, mesh=mesh)
            check(f"{name}/{run}", _tokens(eng), plain, want)
            if run == "paged":
                res[f"{name}/split_leaves"] = _split_bytes_ok(eng.params)
                pool = eng.cache.pool["k"]
                res[f"{name}/pool_pages"] = [int(pool.shape[1]), int(pool.shape[3])]
                res[f"{name}/validated"] = sorted(validate_tree_sharding(eng.params).items())
            if run == "fleet":
                res[f"{name}/fleet_chunks"] = eng.stats()["slo"]["chunked_prefill"]["calls"]
            if run == "speculative":
                res[f"{name}/draft_split"] = _split_bytes_ok(eng.runner.draft_params)
        # block zero-skip composes with the mesh: the mask is built from each
        # rank's K slice of x
        extra = dict(forms=True, page_size=8, zero_skip="block")
        check(f"{name}/zero_skip_block", _tokens(ServingEngine(m, p, **kw, **extra, mesh=mesh)),
              _tokens(ServingEngine(m, p, **kw, **extra)))
        spec, plan = _plan()
        plain = _tokens(ServingEngine(m, p, **kw, spec=spec, plan=plan, page_size=8))
        eng = ServingEngine(m, p, **kw, spec=spec, plan=plan, page_size=8, mesh=mesh)
        check(f"{name}/mixed", _tokens(eng), plain, blob["want"][f"{name}/mixed"])
        wo = eng.params["blocks"]["attn"]["wo"]
        res[f"{name}/mixed_wo"] = [wo.m, wo.bits, list(wo.shard[0].spec)]
        # a restore straight into the sharded layout (each rank its pieces)
        comp, _ = compress_tree(p, FormsSpec(m=8))
        ctx = shd.ParallelContext.for_mesh(mesh)
        d = os.path.join(os.path.dirname(path), f"ckpt_{name}")
        if rank == 0:
            ckpt.save(d, comp, step=1)
        dist.barrier()
        restored, _ = ckpt.restore(d, comp, shardings=shd.params_shardings(comp, ctx,
                                                                             fsdp=False))
        res[f"{name}/restore_split"] = _split_bytes_ok(restored)
        eng = ServingEngine(m, restored, **kw, page_size=8, mesh=mesh)
        check(f"{name}/restore", _tokens(eng), _tokens(ServingEngine(m, comp, **kw,
                                                                     page_size=8)), want)
        # speculative serving from that layout: the draft is built leaf by
        # leaf from the placed target, and equals this rank's slice of the
        # draft built from the whole tree, by the unplaced mesh engine and
        # by make_draft off the mesh, resharded whole
        for tag, mode, bits, step, plan in SPECULATIVE_RESTORES:
            sp = dict(page_size=8, speculate=True, draft_k=4, draft_bits=bits,
                      draft_mode=mode, draft_layer_step=step, draft_plan=plan)
            eng = ServingEngine(m, restored, **kw, **sp, mesh=mesh)
            check(f"{name}/{tag}", _tokens(eng), _tokens(ServingEngine(m, comp, **kw, **sp)),
                  want)
            res[f"{name}/{tag}_draft_split"] = _split_bytes_ok(eng.runner.draft_params)
            unplaced = ServingEngine(m, comp, **kw, **sp, mesh=mesh).runner.draft_params
            dm, dp, _ = SP.make_draft(m, comp, SP.SpeculateConfig(k=4, bits=bits, mode=mode,
                                                                  layer_step=step), plan=plan)
            whole = dm.serving_params(shd.reshard_state(
                dp, shd.params_shardings(dp, ctx, fsdp=False)))
            res[f"{name}/{tag}_draft_equal"] = (_same_leaves(eng.runner.draft_params, unplaced)
                                               and _same_leaves(eng.runner.draft_params, whole))
        # the reference's own checkpoint of the same codes, read into the layout
        restored, _ = ckpt.restore(os.path.join(os.path.dirname(path), f"ref_ckpt_{name}"),
                                   comp, shardings=shd.params_shardings(comp, ctx, fsdp=False))
        check(f"{name}/restore_reference_checkpoint",
              _tokens(ServingEngine(m, restored, **kw, page_size=8, mesh=mesh)), want)
        # donate=False leaves the cache object held before a round as it was
        for donate in (True, False):
            eng = ServingEngine(m, p, **kw, forms=True, page_size=8, mesh=mesh, donate=donate)
            eng.runner.prefill_slot(0, np.array([5, 6]), pages=np.array([1], np.int32))
            held = eng.runner.cache
            before = held.pool["k"].clone()
            tables = np.zeros((4, 4), np.int32)
            tables[0, 0] = 1
            eng.runner.decode_chunk(np.zeros(4, np.int32), np.array([2, 0, 0, 0], np.int32),
                                    np.zeros(4, np.float32), block_tables=tables)
            res[f"{name}/donate_{donate}_moved"] = not torch.equal(held.pool["k"], before)
            res[f"{name}/donate_{donate}_rebound"] = eng.runner.cache is not held

    # the MoE family serves on the mesh (GQA attention on local heads, the
    # experts split over model): all ranks agree on full-length tokens
    om = build(dataclasses.replace(get_reduced("olmoe-1b-7b"), dtype="float32"),
               device="cpu")
    eng = ServingEngine(om, om.init(0), max_len=32, batch_slots=4, device="cpu", forms=True,
                        page_size=8, mesh=mesh)
    res["olmoe/tokens"] = _tokens(eng)
    res["olmoe/experts_local"] = int(eng.params["blocks"]["moe"]["w_gate"].mags.shape[1])

    # a head count that does not divide the model axis
    cfg = MODELS["heads3"](get_reduced("yi-9b"))
    m = build(cfg, device="cpu")
    p = blob["params"]["heads3"]
    for run, page in (("paged", 8), ("dense", 0)):
        kw = dict(max_len=32, batch_slots=4, device="cpu", forms=True, page_size=page)
        plain = _tokens(ServingEngine(m, p, **kw))
        eng = ServingEngine(m, p, **kw, mesh=mesh)
        check(f"heads3/{run}", _tokens(eng), plain, blob["want"]["heads3"])
        k = eng.cache.pool["k"] if page else eng.cache["k"]
        res[f"heads3/{run}_cache"] = list(k.shape)
        res[f"heads3/{run}_cache_spec"] = list(eng.cache_shardings.pool["k"].spec if page
                                              else eng.cache_shardings["k"].spec)
        res["heads3/wq_spec"] = list(eng.params["blocks"]["attn"]["wq"].shard[0].spec)
        res["heads3/wk_spec"] = list(eng.params["blocks"]["attn"]["wk"].shard[0].spec)

    # health: stuck-at faults in rank 1's shard of one leaf
    cfg = MODELS["tiny"](get_reduced("yi-9b"))
    m = build(cfg, device="cpu")
    p = blob["params"]["tiny"]
    eng = ServingEngine(m, p, max_len=32, batch_slots=4, device="cpu", forms=True,
                        page_size=8, mesh=mesh,
                        health=HealthConfig(probe_every=1, drift_threshold=1e-3))
    if rank == 1:
        rep = eng.inject_faults(FaultModel(p_stuck_on=0.05, seed=2), paths=["blocks/attn/wq"])
        assert rep.codes_changed > 0
    check("health/tokens", _tokens(eng), blob["want"]["tiny"])
    h = eng.stats()["health"]
    drift = [e for e in h["events"] if e["event"] == "drift"]
    res["health/flagged"] = {k: v["replicas"] for k, v in h["flagged"].items()}
    res["health/drift_leaves"] = drift[0]["leaves"] if drift else []
    res["health/repairs"] = h["repairs"]
    res["health/last_drift"] = h["last_drift"]
    clean = compressed_paths(ServingEngine(m, p, max_len=32, batch_slots=4, device="cpu",
                                           forms=True, page_size=8, mesh=mesh).params)
    live = compressed_paths(eng.params)
    res["health/clean_again"] = all(torch.equal(live[k].mags, clean[k].mags) for k in live)

    # the serve launcher's mesh line
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--reduced", "--forms", "--device", "cpu", "--mesh", "data=2,model=2",
                    "--requests", "4", "--max-new-tokens", "4"])
    res["serve/stdout"] = buf.getvalue() if rank == 0 else ""

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, res)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(every, f)


def _world_moe(path, out):
    """The data=1, model=2 world: moe_ffn's expert-parallel path, f32 and
    int8, on reduced olmoe's layer 0."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import parallel_context
    from repro_torch.models import moe as tmoe
    from repro_torch.models.transformer import layer_params

    blob = torch.load(path, weights_only=False)
    mesh = make_mesh(MeshConfig(data=1, model=2), device="cpu")
    ctx = shd.ParallelContext.for_mesh(mesh)
    res = {}
    params = blob["params"]
    placed = shd.reshard_state(params, shd.params_shardings(params, ctx, fsdp=False))
    p0 = layer_params(placed["blocks"], 0)["moe"]
    res["experts_local"] = int(p0["w_gate"].shape[0])
    x = torch.from_numpy(blob["x"])
    for name, cf, int8 in blob["cases"]:
        cfg = dataclasses.replace(get_reduced("olmoe-1b-7b"), dtype="float32",
                                  capacity_factor=cf, moe_dispatch_int8=int8)
        seen = {}
        orig = tmoe.moe_dispatch.dispatch

        def spy(*a, **k):
            buf, slots = orig(*a, **k)
            seen["slots"] = slots
            return buf, slots
        tmoe.moe_dispatch.dispatch = spy
        try:
            with torch.inference_mode(), parallel_context(ctx):
                y, aux = tmoe.moe_ffn(p0, x, cfg, torch.float32)
        finally:
            tmoe.moe_dispatch.dispatch = orig
        res[name] = {"y": y.numpy().tolist(), "aux": float(aux),
                     "slots": seen["slots"].numpy().tolist() if "slots" in seen else None}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, res)
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(every, f)


# ---------------------------------------------------------------------------
# the pytest side: the reference's numbers, the worlds, the assertions
# ---------------------------------------------------------------------------

def _jax_side(d):
    """Bridged weights and the reference's tokens for every model here; the
    reference's checkpoint of each compressed tree under ``d``."""
    import jax
    from repro.checkpoint import manager as jckpt
    from repro.configs import get_reduced as jax_reduced
    from repro.models.registry import build as jax_build
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
    from repro_torch.bridge import params_from_numpy
    from torch_parity_util import models, to_numpy
    from test_torch_mesh import _to_jax

    params, want = {}, {}
    _, _, _, params["qwen2"] = models("float32")
    for name in ("tiny", "heads3"):
        jm = jax_build(MODELS[name](jax_reduced(BASE[name])))
        params[name] = params_from_numpy(to_numpy(jm.init(jax.random.PRNGKey(0))),
                                         device="cpu")
    jreqs = lambda: [JRequest(uid=i, prompt=np.array(p), max_new_tokens=NEW)  # noqa: E731
                     for i, p in enumerate(PROMPTS)]
    spec, plan = _plan()
    for name in ("qwen2", "tiny", "heads3"):
        jm = jax_build(MODELS[name](jax_reduced(BASE[name])))
        # the port's codes as the reference's leaves (the codes of both
        # packages' compression are equal: test_torch_forms)
        comp, _ = compress_tree(params[name], FormsSpec(m=8))
        eng = JEngine(jm, _to_jax(comp), max_len=32, batch_slots=4, page_size=8)
        want[name] = {str(r.uid): list(map(int, r.tokens)) for r in eng.run(jreqs())}
        jckpt.save(str(d / f"ref_ckpt_{name}"), _to_jax(comp), step=1)
        if name != "heads3":
            mixed, _ = compress_tree(params[name], spec, plan=plan)
            eng = JEngine(jm, _to_jax(mixed), max_len=32, batch_slots=4, page_size=8)
            want[f"{name}/mixed"] = {str(r.uid): list(map(int, r.tokens))
                                     for r in eng.run(jreqs())}
    return params, want


@pytest.fixture(scope="module")
def engine_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_world")
    params, want = _jax_side(d)
    path = str(d / "blob.pt")
    torch.save({"params": params, "want": want}, path)
    out = str(d / "out.json")
    spawn_cpu_world(4, _world_engine, path, out, timeout_s=TIMEOUT_S)
    with open(out) as f:
        return json.load(f), want


CHECKS = [f"{m}/{r}" for m in ("qwen2", "tiny")
          for r in ("paged", "dense", "speculative", "fleet", "donate_false", "mixed",
                    "restore", "restore_reference_checkpoint", "zero_skip_block",
                    *(r[0] for r in SPECULATIVE_RESTORES))] + [
    "heads3/paged", "heads3/dense", "health/tokens"]


@pytest.mark.parametrize("check", CHECKS)
def test_sharded_tokens_equal_unsharded_and_reference(engine_world, check):
    """On every rank the data=2,model=2 engine's greedy tokens equal the
    port's unsharded engine's and the reference's single-device tokens."""
    ranks, _ = engine_world
    for r, res in enumerate(ranks):
        assert res[check]["ok"], (r, check, res[check])
    assert len({json.dumps(res[check]["got"], sort_keys=True) for res in ranks}) == 1


@pytest.mark.parametrize("name", ["qwen2", "tiny"])
def test_no_rank_holds_a_whole_copy_of_a_model_sharded_leaf(engine_world, name):
    """Each rank's bytes of every model-sharded leaf are the spec's share
    (served, drafted and restored trees, and the drafts built leaf by leaf
    from the restored layout, which equal the rank's slices of the drafts
    built from the whole tree code for code); the pool holds half the pages
    per data rank, its heads split over model; the compressed leaves pass
    validate_tree_sharding with their N (or K) on 'model'."""
    ranks, _ = engine_world
    for res in ranks:
        assert res[f"{name}/split_leaves"] >= 7
        assert res[f"{name}/draft_split"] >= 7
        for tag, *_ in SPECULATIVE_RESTORES:
            assert res[f"{name}/{tag}_draft_split"] >= 7
            assert res[f"{name}/{tag}_draft_equal"]
        assert res[f"{name}/restore_split"] >= 7
        pages, heads = res[f"{name}/pool_pages"]
        assert pages == (4 * 4 + 2) // 2 and heads == 1
        specs = dict((k, tuple(v)) for k, v in res[f"{name}/validated"])
        assert specs["blocks/attn/wq"] == (None, None, "model")
        assert specs["blocks/mlp/down"] == (None, "model", None)


def test_per_leaf_fragment_size_shards_by_its_own_geometry(engine_world):
    """The mixed plan's m=16 wo shards K at whole 16-row fragments when
    Kp divides model*m (tiny: 32 = 2*16; qwen2: 48 does not)."""
    ranks, _ = engine_world
    assert ranks[0]["tiny/mixed_wo"] == [16, 6, [None, "model", None]]
    assert ranks[0]["qwen2/mixed_wo"] == [16, 6, [None, None, None]]


@pytest.mark.parametrize("name", ["qwen2", "tiny"])
def test_donate_false_keeps_the_held_cache(engine_world, name):
    """donate=True updates the held cache in place; donate=False writes a
    fresh copy, so the held one keeps its values (the data rank of slot 0
    writes: its ranks see the move)."""
    ranks, _ = engine_world
    assert any(r[f"{name}/donate_True_moved"] for r in ranks)
    assert not any(r[f"{name}/donate_True_rebound"] for r in ranks)
    assert not any(r[f"{name}/donate_False_moved"] for r in ranks)
    assert all(r[f"{name}/donate_False_rebound"] for r in ranks)


def test_the_moe_family_serves_on_the_mesh(engine_world):
    """Reduced olmoe on data=2,model=2: each rank holds 4 of the 8 experts
    of every layer, and every rank returns the same full-length tokens."""
    ranks, _ = engine_world
    assert all(r["olmoe/experts_local"] == 4 for r in ranks)
    toks = ranks[0]["olmoe/tokens"]
    assert all(r["olmoe/tokens"] == toks for r in ranks)
    assert sorted(toks) == ["0", "1", "2", "3"] and all(len(t) == NEW for t in toks.values())


def test_non_dividing_heads_replicate_what_the_reference_replicates(engine_world):
    """3 heads on a 2-way model axis: q/k/v columns (48) still split, the
    page pool replicates its heads, and the dense cache shards its sequence
    (context-parallel decode, merged by log-sum-exp) — the reference's
    cache_logical_axes."""
    res = engine_world[0][0]
    assert res["heads3/wq_spec"] == [None, None, "model"]
    assert res["heads3/wk_spec"] == [None, None, "model"]
    assert res["heads3/paged_cache_spec"] == [None, "data"]
    assert res["heads3/paged_cache"][3] == 3
    assert res["heads3/dense_cache_spec"] == [None, "data", "model"]
    assert res["heads3/dense_cache"][1:3] == [2, 16]


def test_health_names_the_faulty_ranks_shard_and_repairs_it(engine_world):
    """Stuck-at faults in rank 1's shard of blocks/attn/wq: every rank's
    scoreboard names 'cpu:1' alone, the leaf is repaired, the drift is back
    to 0, the codes equal a clean engine's, and the tokens the reference's."""
    ranks, _ = engine_world
    for res in ranks:
        assert list(res["health/flagged"]) == ["blocks/attn/wq"]
        assert list(res["health/flagged"]["blocks/attn/wq"]) == ["cpu:1"]
        assert res["health/drift_leaves"] == ["blocks/attn/wq"]
        assert res["health/repairs"] >= 1 and res["health/last_drift"] == 0.0
        assert res["health/clean_again"]


def test_serve_mesh_line(engine_world):
    """serve --mesh data=2,model=2 prints the reference's mesh line (rank 0
    prints; the other ranks are quiet)."""
    ranks, _ = engine_world
    out = ranks[0]["serve/stdout"]
    assert "mesh: {'data': 2, 'model': 2} over 4 devices, 23 param leaves sharded" in out
    assert "req 0:" in out
    assert all(r["serve/stdout"] == "" for r in ranks[1:])


# ---------------------------------------------------------------------------
# the MoE world
# ---------------------------------------------------------------------------

def _reference_moe(cases):
    """The reference's moe_ffn (scatter path, one device) and its int8
    dispatch math, on reduced olmoe's layer 0 at the bridged weights."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jax_reduced
    from repro.distributed import moe_dispatch as jdispatch
    from repro.models import moe as jmoe
    from repro.models.registry import build as jax_build
    from repro_torch.bridge import params_from_numpy
    from torch_parity_util import to_numpy

    jcfg = dataclasses.replace(jax_reduced("olmoe-1b-7b"), dtype="float32")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(to_numpy(jp), device="cpu")
    p0 = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["moe"])
    x = np.random.RandomState(3).normal(0, 1, (2, 8, jcfg.d_model)).astype(np.float32)
    qd = jax.vmap(lambda a: jdispatch._int8_a2a_fwd_impl(a, "i"), axis_name="i")
    want = {}
    for name, cf, int8 in cases:
        cfg = dataclasses.replace(jcfg, capacity_factor=cf)
        y, aux = jmoe.moe_ffn(p0, jnp.asarray(x), cfg, jnp.float32)
        entry = {"y": np.asarray(y), "aux": float(aux)}
        # the reference's dispatch positions per source rank (tp=2): a
        # stable sort by expert, the position within the expert's segment,
        # dropped past c2
        xt = jnp.asarray(x.reshape(-1, jcfg.d_model))
        probs = jax.nn.softmax(xt @ p0["router"], axis=-1)
        gates, idx = jax.lax.top_k(probs, jcfg.experts_per_token)
        gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
        idx = np.asarray(idx)
        t_loc = idx.shape[0] // 2
        c2 = max(1, int(cf * t_loc * jcfg.experts_per_token / jcfg.num_experts))
        slots = []
        for r in range(2):
            flat = idx[r * t_loc:(r + 1) * t_loc].reshape(-1)
            order = np.argsort(flat, kind="stable")
            seg = np.searchsorted(flat[order], np.arange(jcfg.num_experts))
            pos = np.empty_like(order)
            pos[order] = np.arange(flat.size) - seg[flat[order]]
            slots.append(np.where(pos < c2, pos, -1).reshape(t_loc, -1))
        entry["slots"] = slots
        # the expert-parallel math: every kept (token, expert) row through
        # its expert, quantized on the way in and out with the reference's
        # own int8 transport under int8
        wire = (lambda a: np.asarray(qd(jnp.asarray(a)[None, None])[0, 0])) if int8 \
            else (lambda a: np.asarray(a))
        flat = idx.reshape(-1)
        xin = wire(xt)
        bufe = np.zeros((jcfg.num_experts, flat.size, jcfg.d_model), np.float32)
        for j, e in enumerate(flat):
            bufe[e, j] = xin[j // jcfg.experts_per_token]
        out = np.asarray(jmoe._expert_ffn(p0, jnp.asarray(bufe), jnp.float32))
        rows = wire(out[flat, np.arange(flat.size)])
        kept = np.concatenate(slots).reshape(-1) >= 0
        g = np.asarray(gates).reshape(-1, 1) * kept[:, None]
        entry["y_ep"] = (rows * g).reshape(-1, jcfg.experts_per_token,
                                           jcfg.d_model).sum(1).reshape(x.shape)
        want[name] = entry
    return tparams, x, want


MOE_CASES = [("f32", 8.0, False), ("f32_drops", 0.5, False), ("int8", 8.0, True)]


@pytest.fixture(scope="module")
def moe_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_world")
    params, x, want = _reference_moe(MOE_CASES)
    path = str(d / "blob.pt")
    torch.save({"params": params, "x": x, "cases": MOE_CASES}, path)
    out = str(d / "out.json")
    spawn_cpu_world(2, _world_moe, path, out, timeout_s=TIMEOUT_S)
    with open(out) as f:
        return json.load(f), want


@pytest.mark.parametrize("case", [c[0] for c in MOE_CASES])
def test_expert_parallel_moe_matches_the_reference(moe_world, case):
    """moe_ffn on 2 model ranks takes the all_to_all path with each rank's
    4 of 8 experts: its output equals the reference's expert-parallel math
    within 1e-5 (the reference's per-(rank, expert) capacity drops; under
    int8 its int8 transport on both hops), the reference's own moe_ffn
    (scatter path) where nothing drops (f32 at cf=8), and its aux; at
    cf=0.5 the dropped slots are the reference's."""
    ranks, want = moe_world
    w = want[case]
    if case == "f32":
        np.testing.assert_allclose(w["y_ep"], w["y"], rtol=0, atol=1e-5)
    for r, res in enumerate(ranks):
        assert res["experts_local"] == 4
        got = res[case]
        np.testing.assert_allclose(np.asarray(got["y"]), w["y_ep"], rtol=0, atol=1e-5)
        if case == "f32":
            np.testing.assert_allclose(np.asarray(got["y"]), w["y"], rtol=0, atol=1e-5)
        assert abs(got["aux"] - w["aux"]) <= 1e-5
        assert got["slots"] == w["slots"][r].tolist()
        if case == "f32_drops":
            assert (np.asarray(got["slots"]) < 0).any()
