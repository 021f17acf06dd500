"""Sharded training on a data=2, model=2 gloo world on the CPU, against the
one-device port and the JAX package.

One world, every check inside it (process start costs seconds).  The
reference's single-device loss and gradients are computed in the pytest
process (JAX is imported there only: the ranks import this module, which
imports the port alone at its top) and handed to the ranks with the bridged
weights and the batches.  Each rank trains the one-device port beside the
sharded step, on the reduced qwen2 with remat, ADMM with a fresh Z-update
after every step, gradient compression ``none`` and ``int8_ef``, float32
and int8 moments, the FSDP threshold (``sharding.FSDP_THRESHOLD``, set in
the ranks) lowered to 1024 elements so that every matrix and the embedding
split over ``data`` as well as ``model`` (the 4M default splits none of the
reduced leaves); in bf16 compute, and again in f32, where the limits are
tight.

The limits are those ``tests/test_torch_training.py`` holds the one-device
step to against the reference (``LIMITS``).  bf16: loss, gradient norm and
every gradient (of the tree's largest) within 3e-2, params within 3e-2
absolute; the moments within 6e-2 of each leaf's largest (the second moment
squares the gradients' 3e-2).  f32: loss 1e-5 (relative), gradient norm
1e-4, gradients 1e-5 of the largest, params 1e-5 absolute, moments 1e-5 of
each leaf's largest.  Step 1's loss and gradients are held to the
reference's at the same limits.  As there, params whose gradient is as
small as the runs' summation differences (Adam turns that into a share of
the learning rate) or, with int8 moments, whose second moment quantized to
0 are counted (``OUTLIERS``: at most 1 in 10^4; 5 in 1000 for bf16 with
int8 moments, where bf16's gradient differences decide which entries
quantize to 0), and int8 moment codes off at a rounding edge are counted
(f32: at most 1 in 1000; an int8_ef gradient code off at an edge moves its
moments by a code or two).  Z and U: entries outside 3e-2 (bf16) or 1e-4
(f32) of each leaf's largest are counted, at most 1 in 1000 (a fragment
whose sum lies within the runs' differences of 0 may elect the other
sign).  The error-feedback buffer is held in f32 to 1e-5 of its leaf's
largest gradient (254 times its largest entry), entries off by a code step
counted (1 in 1000).  A save and restore in the world gives the same next
step bit for bit; across it (a one-device checkpoint in the world, the
world's on one device), within the bf16 limits.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import traceback

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import MeshConfig, TrainConfig
from repro_torch.launch.mesh import make_mesh, spawn_cpu_world

TIMEOUT_S = 180
THRESHOLD = 1024
VARIANTS = {"none-f32": dict(grad_compression="none", moment_dtype="float32"),
            "int8ef-int8": dict(grad_compression="int8_ef", moment_dtype="int8")}
# test_torch_training.py's limits: bf16 (loss, gradient norm, params,
# gradients of the largest) and f32 (loss, gradient norm, gradients of the
# largest, params absolute, moments of each leaf's largest, Z/U)
LIMITS = {"bfloat16": dict(loss=3e-2, gnorm=3e-2, grads=3e-2, params=3e-2, moments=6e-2,
                           zu=3e-2),
          "float32": dict(loss=1e-5, gnorm=1e-4, grads=1e-5, params=1e-5, moments=1e-5,
                          zu=1e-4)}
# the share of params allowed outside ``params``: entries whose gradient is
# as small as the runs' differences, which Adam's normalization turns into
# a share of the learning rate, and (int8 moments) entries whose second
# moment quantized to 0 (in bf16 the gradients' differences decide which)
OUTLIERS = {"bfloat16/none-f32": 1e-4, "bfloat16/int8ef-int8": 5e-3,
            "float32/none-f32": 1e-4, "float32/int8ef-int8": 1e-4}
RUNS = [f"{dt}/{v}" for dt in LIMITS for v in VARIANTS]
TRAIN = dict(warmup_steps=1, total_steps=20, remat=True, admm_enabled=True, admm_rho=1e-2,
             admm_update_every=1)


def _cfg(dtype):
    return dataclasses.replace(get_reduced("qwen2-1.5b"), dtype=dtype)


# ---------------------------------------------------------------------------
# the ranks (this module's top imports only the port)
# ---------------------------------------------------------------------------

def _flat(tree):
    from repro_torch.core import paths
    return dict(paths.iter_leaves(tree)) if tree is not None else {}


def _rel(got, want) -> float:
    """Largest difference relative to the largest entry of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _errors(a, b, lim):
    """State ``a`` against ``b`` (both whole): the params' largest
    difference and share outside ``lim["params"]`` (absolute, plus
    relative); the moments' largest difference of each leaf's largest
    (int8 codes: their largest code difference and share off); the share
    of Z/U and error-buffer entries outside their limits."""
    fb = _flat(b.params)
    d = [(x.float() - fb[p].float()).abs() for p, x in _flat(a.params).items()]
    w = [fb[p].float().abs() for p in _flat(a.params)]
    n = sum(t.numel() for t in d)
    out = {"params": max(float(t.max()) for t in d),
           "params_outside": sum(int((t > lim["params"] * (1 + ww)).sum())
                                 for t, ww in zip(d, w)) / n}
    int8 = a.opt.mu_scale is not None
    for f in ("mu", "nu"):
        fa, fb2 = _flat(getattr(a.opt, f)), _flat(getattr(b.opt, f))
        if int8:
            codes = [(fa[p].int() - fb2[p].int()).abs() for p in fa]
            out[f + "_codes"] = max(int(c.max()) for c in codes)
            out[f + "_codes_off"] = sum(int((c > 0).sum()) for c in codes) / n
            sa, sb = _flat(getattr(a.opt, f + "_scale")), _flat(getattr(b.opt, f + "_scale"))
            out[f] = max(_rel(fa[p].float() * sa[p], fb2[p].float() * sb[p]) for p in fa)
        else:
            out[f] = max(_rel(x.float(), fb2[p].float()) for p, x in fa.items())
    if a.grad_err is not None:
        # the buffer's entries are at most half a code step (1/254 of the
        # leaf's largest gradient): held to the limit of that gradient
        fe = _flat(b.grad_err)
        bad = sum(int(((x - fe[p]).abs() > lim["moments"] * 254 * fe[p].abs().max()).sum())
                  for p, x in _flat(a.grad_err).items())
        out["grad_err_outside"] = bad / n
    bad = total = 0
    for path, st in a.admm.items():
        other = b.admm[path]
        for f in ("z", "u"):
            x, y = getattr(st, f).float(), getattr(other, f).float()
            bad += int(((x - y).abs() > lim["zu"] * y.abs().max()).sum())
            total += y.numel()
        assert tuple(st.signs.shape) == tuple(other.signs.shape)
    out["zu_outside"] = bad / total
    return out


def _world_a(path, out):
    """The data=2, model=2 world: every check of this file."""
    import torch.distributed as dist
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core import admm as tadmm
    from repro_torch.core import paths
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import parallel_context, shard_of
    from repro_torch.models.registry import build
    from repro_torch.training import train_loop as ttl

    blob = torch.load(path, weights_only=False)
    default_threshold, shd.FSDP_THRESHOLD = shd.FSDP_THRESHOLD, THRESHOLD
    mesh = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    ctx = shd.ParallelContext.for_mesh(mesh)
    rank = dist.get_rank()
    batches = [{"tokens": torch.from_numpy(t)} for t in blob["batches"]]
    res = {}

    def fresh(model, tcfg):
        params = paths.tree_map(torch.clone, blob["params"])
        return ttl.init_train_state(model, tcfg, params=params)

    def placed(model, tcfg):
        state, table = fresh(model, tcfg)
        return shd.place_train_state(state, ctx, table), table

    def run(step, state, table, tcfg, steps, sharded):
        metrics = []
        for i in steps:
            state, met = step(state, batches[i])
            state = ttl.maybe_admm_update(state, table, tcfg, i + 1,
                                          ctx if sharded else None)
            metrics.append((float(met["loss"]), float(met["grad_norm"])))
        return state, metrics

    def whole(state):
        with parallel_context(ctx):
            return shd.gather_global(state)

    for key in RUNS:
        dtype, name = key.split("/")
        lim = LIMITS[dtype]
        model = build(_cfg(dtype), device="cpu")
        tcfg = TrainConfig(**TRAIN, **VARIANTS[name])
        one, table = fresh(model, tcfg)
        one_step = ttl.make_train_step(model, tcfg, table)
        shard, _ = placed(model, tcfg)
        step = ttl.make_train_step(model, tcfg, table, ctx=ctx)
        r = {}
        # step 1's loss and gradients (the penalty included) against the
        # one-device port's and the reference's
        loss, grads = step.grads(shard, batches[0])
        fsdp = [p for p, g in paths.iter_leaves(grads)
                if shard_of(g) is not None and "data" in shard_of(g).axes()]
        r["grad_fsdp_leaves"] = len(fsdp)
        r["grad_local"] = all(tuple(g.shape) != shard_of(g).shape
                              for p, g in paths.iter_leaves(grads) if p in fsdp)
        gw = _flat(whole(grads))

        def one_loss(p, b, st):
            h, aux = model.forward(p, b, remat=True, return_hidden=True)
            return ttl.hidden_loss(model, p, b, h, aux) + tadmm.admm_penalty(p, st, table)
        one_loss_v, one_grads = ttl._value_and_grad(one_loss, one.params, batches[0], one.admm)
        ref_grads = blob["ref_grads"][dtype]
        top_one = max(float(g.abs().max()) for g in paths.leaves(one_grads))
        top_ref = max(float(np.abs(g).max()) for g in ref_grads.values())
        r["grads_vs_one"] = max(float((gw[p].float() - g).abs().max()) / top_one
                                for p, g in _flat(one_grads).items())
        r["grads_vs_ref"] = max(float(np.abs(gw[p].float().numpy() - g).max()) / top_ref
                                for p, g in ref_grads.items())
        r["loss1"] = [float(loss), float(one_loss_v), blob["ref_loss"][dtype]]
        # two steps of each, a Z-update after each
        one, one_met = run(one_step, one, table, tcfg, (0, 1), False)
        shard, met = run(step, shard, table, tcfg, (0, 1), True)
        r["metrics"] = [met, one_met]
        r["errors"] = _errors(whole(shard), one, lim)
        # nothing whole of an FSDP leaf: params, moments, error buffer, Z
        local_ok, n_fsdp = True, 0
        for p, w in paths.iter_leaves(shard.params):
            sh = shard_of(w)
            if sh is None or "data" not in sh.axes():
                continue
            n_fsdp += 1
            trees = [shard.opt.mu, shard.opt.nu] + ([shard.grad_err] if shard.grad_err else [])
            local_ok &= tuple(w.shape) != sh.shape and math.prod(w.shape) * 4 == math.prod(
                sh.shape)
            local_ok &= all(tuple(_flat(t)[p].shape) == tuple(w.shape) for t in trees)
            if p in shard.admm:
                local_ok &= tuple(shard.admm[p].z.shape) == tuple(w.shape)
        r["fsdp_leaves"], r["fsdp_local"] = n_fsdp, local_ok
        # the violation of the sharded Z (fresh signs of each shard)
        with parallel_context(ctx):
            zt = paths.rebuild(shard.params, {**_flat(shard.params), **{
                p: st.z for p, st in shard.admm.items()}})
            r["z_violation"] = float(tadmm.constraint_metrics(zt, shard.admm, table)[
                "polarization_violation"])
        if dtype == "float32":
            res[key] = r
            continue
        # a save in the world and a restore into the layout: the same next step
        d = os.path.join(os.path.dirname(path), f"ckpt_{name}")
        mgr = ckpt.CheckpointManager(d, ctx=ctx)
        mgr.save_sync(shard, 2)
        tmpl = ttl.restore_template(fresh(model, tcfg)[0], table, tcfg, 2)
        back, at = mgr.restore_latest(tmpl, shardings=shd.train_state_shardings(
            tmpl, ctx, table))
        live, m_live = run(step, shard, table, tcfg, (2,), True)
        again, m_again = run(step, back, table, tcfg, (2,), True)
        wl, wa = whole(live), whole(again)
        r["restore_same"] = (at == 2 and m_live == m_again and all(
            torch.equal(x, _flat(wa.params)[p]) for p, x in _flat(wl.params).items()))
        # the one-device checkpoint resumes in the world, the world's on one device
        d1 = os.path.join(os.path.dirname(path), f"ckpt1_{name}_{rank}")
        ckpt.save(d1, one, 2)     # every rank its own copy: its generator re-seeded alike
        tmpl = ttl.restore_template(fresh(model, tcfg)[0], table, tcfg, 2)
        into, _ = ckpt.restore(d1, tmpl, shardings=shd.train_state_shardings(
            tmpl, ctx, table))
        tmpl = ttl.restore_template(fresh(model, tcfg)[0], table, tcfg, 2)
        onto, _ = ckpt.restore(d, tmpl)
        one_next, m_one = run(one_step, one, table, tcfg, (2,), False)
        into_next, m_into = run(step, into, table, tcfg, (2,), True)
        onto_next, m_onto = run(one_step, onto, table, tcfg, (2,), False)
        r["cross_metrics"] = [m_into, m_one, m_onto, m_live]
        r["cross_errors"] = [_errors(whole(into_next), one_next, lim)["params_outside"],
                             _errors(onto_next, wl, lim)["params_outside"]]
        res[key] = r

    # the collectives of one sharded step: the entry cotangent's reduce over
    # model, the FSDP gradients' reduce-scatter over data
    model = build(_cfg("bfloat16"), device="cpu")
    tcfg = TrainConfig(**TRAIN, **VARIANTS["none-f32"])
    shard, table = placed(model, tcfg)
    step = ttl.make_train_step(model, tcfg, table, ctx=ctx)
    model_group = ctx._groups["model"][0]
    batch_group = ctx._groups["batch"][0]
    seen = []
    originals = (dist.all_reduce, dist.reduce_scatter_tensor)

    def in_backward() -> bool:
        # whether the collective is made under a backward method of the
        # autograd pairs (a remat recompute in the backward pass runs under
        # the engine's C++ nodes, with no such frame)
        return any(frame.name == "backward" for frame in traceback.extract_stack()[:-1])

    def spy_ar(t, op=dist.ReduceOp.SUM, group=None, **k):
        seen.append(("all_reduce", "model" if group is model_group else
                     "batch" if group is batch_group else "other", str(t.dtype),
                     "sum" if op == dist.ReduceOp.SUM else "max", in_backward()))
        return originals[0](t, op=op, group=group, **k)

    def spy_rs(out, inp, op=dist.ReduceOp.SUM, group=None, **k):
        seen.append(("reduce_scatter", "batch" if group is batch_group else "other",
                     str(inp.dtype), "sum", in_backward()))
        return originals[1](out, inp, op=op, group=group, **k)

    dist.all_reduce, dist.reduce_scatter_tensor = spy_ar, spy_rs
    try:
        step(shard, batches[0])
    finally:
        dist.all_reduce, dist.reduce_scatter_tensor = originals
    res["spy"] = seen

    # a leaf whose K split cuts a fragment (m=16 on 24-row shards) is
    # gathered, projected whole and cut back: the one-device Z
    from repro_torch.core.fragments import FragmentSpec
    wide = tadmm.constraint_table(blob["params"], tadmm.default_constraints(
        polarize=FragmentSpec(m=16), rho=1e-2))
    state, _ = fresh(model, tcfg)
    want = tadmm.admm_update(state.params, tadmm.init_admm(state.params, lambda p, s: wide.get(
        p))[0], wide)
    pl = shd.place_train_state(state, ctx, table)
    with parallel_context(ctx):
        got = tadmm.admm_update(pl.params, tadmm.init_admm(pl.params, lambda p, s: wide.get(
            p))[0], wide)
        got = shd.gather_global({p: shd.set_shard(st.z, shard_of(_flat(pl.params)[p]))
                                 for p, st in got.items()})
    res["unaligned_z_equal"] = all(torch.equal(got[p], want[p].z) for p in want)

    # the launcher on this mesh, at the default threshold, with checkpoints
    # (its preemption vote runs after every step)
    from repro_torch.launch import train as tlaunch
    shd.FSDP_THRESHOLD = default_threshold
    d = os.path.join(os.path.dirname(path), "ckpt_launcher")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch.main(["--reduced", "--steps", "3", "--admm", "--admm-every", "1",
                      "--seq-len", "16", "--global-batch", "4", "--log-every", "1",
                      "--device", "cpu", "--mesh-data", "2", "--mesh-model", "2",
                      "--ckpt-dir", d, "--ckpt-every", "2"])
    res["launcher"] = buf.getvalue() if rank == 0 else ""
    dist.barrier()
    res["launcher_ckpts"] = sorted(os.listdir(d))

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, res)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(every, f)


# ---------------------------------------------------------------------------
# the pytest side: the reference's numbers, the world, the assertions
# ---------------------------------------------------------------------------

def _jax_side():
    """Bridged weights, the batches and the reference's single-device loss
    and gradients of step 1 in bf16 and f32 (the penalty is 0 there: Z = W,
    U = 0)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jax_reduced
    from repro.core import admm as jadmm
    from repro.models.registry import build as jax_build
    from repro.training import train_loop as jtl
    from repro_torch.bridge import params_from_numpy
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    from torch_parity_util import models, to_numpy

    _, jp, _, _ = models("float32")      # the reference's init with random QKV biases
    ds = LMStreamConfig(vocab_size=256, seq_len=16, global_batch=4)
    batches = [lm_batch(ds, i, "cpu")["tokens"].numpy() for i in range(3)]
    jb = {"tokens": jnp.asarray(batches[0])}
    ref_loss, ref_grads = {}, {}
    for dtype in LIMITS:
        jm = jax_build(dataclasses.replace(jax_reduced("qwen2-1.5b"), dtype=dtype))

        def jloss(p):
            h, aux = jm.forward(p, jb, remat=True, return_hidden=True)
            return jtl.hidden_loss(jm, p, jb, h, aux)

        loss, grads = jax.jit(jax.value_and_grad(jloss))(jp)
        ref_loss[dtype] = float(loss)
        ref_grads[dtype] = {p: np.asarray(g, np.float32) for p, g in jadmm.iter_weights(grads)}
    return {"params": params_from_numpy(to_numpy(jp), device="cpu"), "batches": batches,
            "ref_loss": ref_loss, "ref_grads": ref_grads}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train")
    path = str(d / "blob.pt")
    torch.save(_jax_side(), path)
    out = str(d / "out.json")
    spawn_cpu_world(4, _world_a, path, out, timeout_s=TIMEOUT_S)
    with open(out) as f:
        return json.load(f)


def _near(a: float, b: float, tol: float) -> bool:
    return abs(a - b) <= tol * abs(b)


@pytest.mark.parametrize("run", RUNS)
def test_sharded_step_equals_one_device_and_reference(world, run):
    """Step 1's loss and gradients equal the one-device port's and the
    reference's single-device step's; after two steps with a fresh Z-update
    each, the gathered params, moments, error buffer and Z/U equal the
    one-device port's, and the losses and gradient norms too, on every rank
    alike; every Z leaf is polarized."""
    lim = LIMITS[run.split("/")[0]]
    int8 = run.endswith("int8")
    for res in world:
        r = res[run]
        sharded, one, ref = r["loss1"]
        assert _near(sharded, one, lim["loss"]) and _near(sharded, ref, lim["loss"]), r["loss1"]
        assert r["grads_vs_one"] <= lim["grads"], r
        assert r["grads_vs_ref"] <= lim["grads"], r
        for (l1, g1), (l2, g2) in zip(*r["metrics"]):
            assert _near(l1, l2, lim["loss"]) and _near(g1, g2, lim["gnorm"]), r["metrics"]
        e = r["errors"]
        assert e["params"] <= lim["params"] or e["params_outside"] <= OUTLIERS[run], e
        if int8 and run.startswith("float32"):
            # codes off at a rounding edge (of a moment, or of an int8_ef
            # gradient code, which moves its moments by a code or two)
            assert e["mu_codes_off"] + e["nu_codes_off"] <= 1e-3, e
            assert e["grad_err_outside"] <= 1e-3, e
        else:
            assert e["mu"] <= lim["moments"] and e["nu"] <= lim["moments"], e
        assert e["zu_outside"] <= 1e-3, e
        assert r["z_violation"] == 0.0
    assert len({json.dumps(res[run]["metrics"]) for res in world}) == 1


@pytest.mark.parametrize("run", RUNS)
def test_no_rank_holds_a_whole_fsdp_leaf(world, run):
    """Every matrix and the embedding split over data as well as model: each
    rank holds a quarter of each, and its gradient, moments, error buffer
    and Z at the same local shape."""
    for res in world:
        r = res[run]
        assert r["fsdp_leaves"] == 8 and r["fsdp_local"]
        assert r["grad_fsdp_leaves"] == 8 and r["grad_local"]


def test_entry_cotangent_reduces_in_bf16_and_fsdp_grads_reduce_scatter(world):
    """The backward of one bf16 sharded step: the sublayer entries'
    cotangents (and the loss's hidden rows') are summed over model in bf16,
    never f32, and the FSDP leaves' gradients are reduce-scattered over
    data (f32), once per gathered leaf."""
    for res in world:
        spy = [tuple(s) for s in res["spy"]]
        sums = [s for s in spy if s[:2] == ("all_reduce", "model") and s[3] == "sum" and s[4]]
        # attention and MLP entries of 2 layers, and the loss's hidden rows
        assert len(sums) == 2 * 2 + 1 and all(s[2] == "torch.bfloat16" for s in sums), sums
        rs = [s for s in spy if s[0] == "reduce_scatter"]
        # 7 matrices per layer, and the embedding (once for lookup and head)
        assert len(rs) == 7 * 2 + 1, rs
        assert all(s[1] == "batch" and s[2] == "torch.float32" and s[4] for s in rs)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_save_and_resume_in_and_across_the_world(world, variant):
    """A save in the world (one writer, the reference's format) restored
    into the sharded layout gives the same next step bit for bit; the
    one-device checkpoint resumes in the world and the world's on one
    device, each equal to the other's next step within the bf16 limits."""
    lim = LIMITS["bfloat16"]
    for res in world:
        r = res[f"bfloat16/{variant}"]
        assert r["restore_same"]
        m_into, m_one, m_onto, m_live = r["cross_metrics"]
        for (la, ga), (lb, gb) in ((m_into[0], m_one[0]), (m_onto[0], m_live[0])):
            assert _near(la, lb, lim["loss"]) and _near(ga, gb, lim["gnorm"])
        assert max(r["cross_errors"]) <= OUTLIERS[f"bfloat16/{variant}"]


def test_unaligned_k_split_projects_the_gathered_leaf(world):
    """m=16 on 24-row K shards: the leaf is gathered, projected and cut
    back, so Z is the one-device Z bit for bit (the 48-row shards of
    ``down`` project in place)."""
    assert all(res["unaligned_z_equal"] for res in world)


def _same_losses(a: str, b: str) -> None:
    def losses(text):
        return [(float(ln.split()[3]), float(ln.split()[5])) for ln in text.splitlines()
                if ln.startswith("step ")]
    la, lb = losses(a), losses(b)
    assert len(la) == len(lb) == 3
    for (x, gx), (y, gy) in zip(la, lb):
        assert _near(x, y, 3e-2) and _near(gx, gy, 3e-2), (la, lb)


def test_train_launcher_on_the_mesh(world, capsys):
    """`launch/train --mesh-data 2 --mesh-model 2` in the world prints the
    mesh line (rank 0 only) and loss lines equal to the one-device
    launcher's (a world of one) within the bf16 limits; its checkpoints
    (every 2 steps and at the end) are written once, by rank 0."""
    from repro_torch.launch import train as tlaunch
    out = world[0]["launcher"]
    assert out.splitlines()[0] == ("mesh: {'data': 2, 'model': 2} over 4 devices, "
                                   "11 param leaves sharded")
    assert all(res["launcher"] == "" for res in world[1:])
    assert all(res["launcher_ckpts"] == ["step_00000002", "step_00000003"] for res in world)
    tlaunch.main(["--reduced", "--steps", "3", "--admm", "--admm-every", "1", "--seq-len", "16",
                  "--global-batch", "4", "--log-every", "1", "--device", "cpu"])
    one = capsys.readouterr().out
    assert one.splitlines()[0] == ("mesh: {'data': 1, 'model': 1} over 1 devices, "
                                   "0 param leaves sharded")
    _same_losses(out, one)


def test_fake_devices_launcher_prints_the_one_device_losses(capfd):
    """`launch/train --device cpu --mesh-data 2 --mesh-model 2 --fake-devices
    4` trains with ADMM in four gloo processes; rank 0's loss lines equal
    the one-device launcher's within the bf16 limits."""
    from repro_torch.launch import train as tlaunch
    argv = ["--reduced", "--steps", "3", "--admm", "--admm-every", "1", "--seq-len", "16",
            "--global-batch", "4", "--log-every", "1", "--device", "cpu"]
    tlaunch.main(argv + ["--mesh-data", "2", "--mesh-model", "2", "--fake-devices", "4"])
    mesh_out = capfd.readouterr().out
    assert "mesh: {'data': 2, 'model': 2} over 4 devices" in mesh_out
    tlaunch.main(argv)
    _same_losses(mesh_out, capfd.readouterr().out)
