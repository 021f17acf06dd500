"""Sharded training of the recurrent families (xLSTM, Zamba2) on a data=2,
model=2 gloo world on the CPU, against the one-device port and the JAX
package.

One world, every check inside it (process start costs seconds).  The
reference's single-device loss and gradients are computed in the pytest
process (JAX is imported there only: the ranks import this module, which
imports the port alone at its top) and handed to the ranks with the bridged
weights and the batches.  Both models are reduced and float32; the FSDP
threshold (``sharding.FSDP_THRESHOLD``, set in the ranks) is lowered to
1024 elements, so that the embedding, the head, xLSTM's square matrices and
Zamba2's stacked Mamba leaves also split over ``data``.  xLSTM runs every
head on every model rank (its N-split projections gathered); Zamba2's
Mamba blocks run on the rank's SSM heads, with ``B``/``C``'s cotangents
summed over ``model`` and the cut streams' gathered.

Limits (``test_torch_mesh_train.py``'s f32 ``LIMITS``): step 1's loss
within 1e-5 (relative) of the one-device port's and the reference's, every
gradient within 1e-5 of the tree's largest of the one-device port's; xLSTM's
within 1e-5 of the largest of the reference's f32 gradients too, and
Zamba2's, whose f32 gradients are ill-conditioned (its fast SSM decays,
ROADMAP §3), each leaf at least as close to the reference's float64
gradients as the reference's own f32 leaf, plus 1e-6 of the largest, as
``tests/test_torch_training.py::test_recurrent_train_step_matches_reference``
holds the one-device port.  Then two steps with ADMM (a Z-update after
each, kernel #4's plain version on each rank's shard here), clipping and
AdamW with float32 and with int8 moments, against the one-device steps:
params within 1e-5 absolute, entries outside counted: at most 1 in 10^4;
Z and U entries outside 1e-4 of each leaf's largest at most 1 in 1000 (the
limits of ``test_torch_mesh_train_mla_whisper.py``).  With int8 moments
the entries whose second moment quantized to 0 in either run are counted
apart: their step is the first moment over Adam's eps, so the last bits of
the first moment decide it.  Zamba2's per-row int8 second moments quantize
37% of its entries to 0 (54% of ``in_proj``'s), the same entries in both
runs; at most 1 in 100 of them may lie outside the limit (measured: 0.67%,
xLSTM 0.09%; ``test_torch_mesh_train_mla_whisper.py`` counts them over all
entries, where they are far fewer), and the Z and U columns that hold one
(its fragment's sign election and the column's quantization scale follow
it) are counted apart too, at most a quarter of the entries (15.7%, xLSTM
1.4%); the float32 moments hold every Z and U column.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import MeshConfig, TrainConfig
from repro_torch.launch.mesh import make_mesh, spawn_cpu_world

TIMEOUT_S = 180
THRESHOLD = 1024
ARCHS = {"xlstm": "xlstm-350m", "zamba": "zamba2-2.7b"}
TRAIN = dict(warmup_steps=1, total_steps=20, remat=True)
ADMM = dict(admm_enabled=True, admm_rho=1e-2, admm_update_every=1, grad_clip=0.5)
MOMENTS = ("float32", "int8")


def _cfg(base):
    return dataclasses.replace(base, dtype="float32")


# ---------------------------------------------------------------------------
# the ranks (this module's top imports only the port)
# ---------------------------------------------------------------------------

def _world(path, out):
    """The data=2, model=2 world: every check of this file."""
    import torch.distributed as dist
    from repro_torch.core import paths
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import parallel_context, shard_of
    from repro_torch.models.registry import build
    from repro_torch.training import train_loop as ttl

    blob = torch.load(path, weights_only=False)
    shd.FSDP_THRESHOLD = THRESHOLD        # this rank's module: the larger leaves over data too
    mesh = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    ctx = shd.ParallelContext.for_mesh(mesh)
    res = {}

    def flat(tree):
        return dict(paths.iter_leaves(tree))

    def whole(tree):
        with parallel_context(ctx):
            return shd.gather_global(tree)

    for name, arch in ARCHS.items():
        model = build(_cfg(get_reduced(arch)), device="cpu")
        side = blob[name]
        batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in side["batches"]]
        fresh = lambda: paths.tree_map(torch.clone, side["params"])  # noqa: E731
        r = {}

        # step 1's loss and gradients
        tcfg = TrainConfig(**TRAIN)
        state, table = ttl.init_train_state(model, tcfg, params=fresh())
        placed = shd.place_train_state(state, ctx, table)
        step = ttl.make_train_step(model, tcfg, table, ctx=ctx)
        loss, grads = step.grads(placed, batches[0])
        r["fsdp_grads"] = sum(1 for _, g in paths.iter_leaves(grads)
                              if shard_of(g) is not None and "data" in shard_of(g).axes())
        r["model_grads"] = sum(1 for _, g in paths.iter_leaves(grads)
                               if shard_of(g) is not None and "model" in shard_of(g).axes())
        gw = flat(whole(grads))

        def one_loss(p, b):
            h, a = model.forward(p, b, remat=True, return_hidden=True)
            return ttl.hidden_loss(model, p, b, h, a)
        one_v, one_g = ttl._value_and_grad(one_loss, state.params, batches[0])
        one_g = flat(one_g)
        top_one = max(float(g.abs().max()) for g in one_g.values())
        ref = side["ref_grads"]
        top_ref = max(float(np.abs(g).max()) for g in ref.values())
        r["loss"] = [float(loss), float(one_v), side["ref_loss"]]
        r["grads_vs_one"] = max(float((gw[p] - g).abs().max()) / top_one
                                for p, g in one_g.items())
        r["grads_vs_ref"] = max(float(np.abs(gw[p].numpy() - g).max()) / top_ref
                                for p, g in ref.items())
        if side["ref_grads_f64"] is not None:
            # each leaf no farther from the float64 gradients than the
            # reference's f32 leaf, plus 1e-6 of the largest
            r["f64_excess"] = max(
                (float(np.abs(gw[p].numpy() - g64).max())
                 - float(np.abs(ref[p] - g64).max())) / top_ref
                for p, g64 in side["ref_grads_f64"].items())
        r["paths"] = sorted(gw) == sorted(one_g) == sorted(ref)

        # two ADMM steps (a Z-update after each), clipped, float32 and int8 moments
        for moments in MOMENTS:
            tcfg = TrainConfig(**TRAIN, **ADMM, moment_dtype=moments)
            one, table = ttl.init_train_state(model, tcfg, params=fresh())
            shard = shd.place_train_state(
                ttl.init_train_state(model, tcfg, params=fresh())[0], ctx, table)
            one_step = ttl.make_train_step(model, tcfg, table)
            step = ttl.make_train_step(model, tcfg, table, ctx=ctx)
            met = []
            for i in range(2):
                one, m1 = one_step(one, batches[i])
                one = ttl.maybe_admm_update(one, table, tcfg, i + 1)
                shard, m2 = step(shard, batches[i])
                shard = ttl.maybe_admm_update(shard, table, tcfg, i + 1, ctx)
                met.append([float(m2["loss"]), float(m1["loss"]), float(m2["grad_norm"]),
                            float(m1["grad_norm"])])
            w = whole(shard)
            fo = flat(one.params)
            # params outside the limit; with int8 moments those at a second
            # moment that quantized to 0 in either run apart, and the Z/U
            # columns that hold one of them (the sign election and the
            # column scale follow such an entry)
            outside = zero_nu = at_zero_nu = n = 0
            if moments == "int8":
                fnw, fno = flat(w.opt.nu), flat(one.opt.nu)
            apart = {}
            for p, x in flat(w.params).items():
                out_p = (x - fo[p]).abs() > 1e-5 * (1 + fo[p].abs())
                n += x.numel()
                if moments == "int8":
                    zero = (fnw[p] == 0) | (fno[p] == 0)
                    at_zero_nu += int(zero.sum())
                    zero_nu += int((out_p & zero).sum())
                    if x.ndim >= 2:
                        apart[p] = (out_p & zero).any(dim=-2, keepdim=True)
                    out_p = out_p & ~zero
                outside += int(out_p.sum())
            bad = total = zu_apart = 0
            for p, st in w.admm.items():
                for f in ("z", "u"):
                    x, y = getattr(st, f), getattr(one.admm[p], f)
                    off = (x - y).abs() > 1e-4 * y.abs().max()
                    if p in apart:
                        cols = apart[p].expand_as(off)
                        zu_apart += int(cols.sum())
                        off = off & ~cols
                    bad += int(off.sum())
                    total += y.numel()
            r[f"admm/{moments}"] = {
                "metrics": met, "params_outside": outside / n,
                "zero_nu": at_zero_nu / n, "zero_nu_outside": zero_nu / max(at_zero_nu, 1),
                "zu_outside": bad / total, "zu_apart": zu_apart / total,
                "admm_leaves": len(w.admm)}
        res[name] = r

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, res)
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(every, f)


# ---------------------------------------------------------------------------
# the pytest side
# ---------------------------------------------------------------------------

def _jax_side():
    """Per model: bridged weights of the reference's init, two global
    batches, the reference's single-device step-1 loss and f32 gradients,
    and (Zamba2) its gradients with the model at dtype float64."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jax_reduced
    from repro.core import admm as jadmm
    from repro.models.registry import build as jax_build
    from repro.training import train_loop as jtl
    from repro_torch.bridge import params_from_numpy
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    from torch_parity_util import to_numpy

    out = {}
    for name, arch in ARCHS.items():
        cfg = _cfg(jax_reduced(arch))
        jm = jax_build(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        batches = [{"tokens": lm_batch(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                                      global_batch=4), i, "cpu")
                    ["tokens"].numpy()} for i in range(2)]
        jb = {"tokens": jnp.asarray(batches[0]["tokens"])}

        def jloss(p, model=jm, b=jb):
            h, a = model.forward(p, b, remat=True, return_hidden=True)
            return jtl.hidden_loss(model, p, b, h, a)

        loss, grads = jax.jit(jax.value_and_grad(jloss))(jp)
        g64 = None
        if name == "zamba":
            with jax.enable_x64(True):
                m64 = jax_build(dataclasses.replace(cfg, dtype="float64"))
                p64 = jax.tree_util.tree_map(
                    lambda a: jnp.asarray(np.asarray(a), jnp.float64), jp)
                b64 = {"tokens": jnp.asarray(batches[0]["tokens"], jnp.int32)}
                g64 = {k: np.asarray(v) for k, v in jadmm.iter_weights(
                    jax.grad(lambda p: jloss(p, m64, b64))(p64))}
        out[name] = {"params": params_from_numpy(to_numpy(jp), device="cpu"),
                     "batches": batches, "ref_loss": float(loss),
                     "ref_grads": {p: np.asarray(g) for p, g in jadmm.iter_weights(grads)},
                     "ref_grads_f64": g64}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train_recurrent")
    path = str(d / "blob.pt")
    torch.save(_jax_side(), path)
    out = str(d / "out.json")
    spawn_cpu_world(4, _world, path, out, timeout_s=TIMEOUT_S)
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("name", list(ARCHS))
def test_sharded_step_equals_one_device_and_reference(world, name):
    """Step 1's loss and every gradient equal the one-device port's and the
    reference's, on every rank, with the FSDP gradients split over data
    and the N-split ones over model."""
    for res in world:
        r = res[name]
        sharded, one, ref = r["loss"]
        assert abs(sharded - one) <= 1e-5 * abs(one), r["loss"]
        assert abs(sharded - ref) <= 1e-5 * abs(ref), r["loss"]
        assert r["grads_vs_one"] <= 1e-5, r
        if name == "zamba":
            assert r["f64_excess"] <= 1e-6, r
        else:
            assert r["grads_vs_ref"] <= 1e-5, r
        assert r["paths"] and r["fsdp_grads"] >= 4 and r["model_grads"] >= 4, r
    assert len({json.dumps(res[name]["loss"]) for res in world}) == 1


@pytest.mark.parametrize("moments", MOMENTS)
@pytest.mark.parametrize("name", list(ARCHS))
def test_admm_steps_on_the_shards_equal_one_device(world, name, moments):
    """Two clipped AdamW steps with a Z-update after each: the losses and
    gradient norms, the params and the ADMM Z/U equal the one-device
    run's."""
    for res in world:
        r = res[name][f"admm/{moments}"]
        for sh_loss, one_loss, sh_norm, one_norm in r["metrics"]:
            assert abs(sh_loss - one_loss) <= 1e-5 * abs(one_loss), r["metrics"]
            assert abs(sh_norm - one_norm) <= 1e-4 * abs(one_norm), r["metrics"]
        assert r["params_outside"] <= 1e-4 and r["zero_nu_outside"] <= 1e-2, r
        assert r["zu_outside"] <= 1e-3 and r["zu_apart"] <= 0.25, r
        assert r["admm_leaves"] >= 4 and (moments == "int8" or r["zu_apart"] == 0), r
