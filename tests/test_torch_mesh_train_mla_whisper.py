"""Sharded training of MLA (deepseek-v3 with its MoE and MTP module) and
whisper on a data=2, model=2 gloo world on the CPU, against the one-device
port and the JAX package.

One world, every check inside it (process start costs seconds).  The
reference's single-device loss and gradients are computed in the pytest
process (JAX is imported there only: the ranks import this module, which
imports the port alone at its top) and handed to the ranks with the bridged
weights and the batch.  Both models are reduced and float32; the FSDP
threshold (``sharding.FSDP_THRESHOLD``, set in the ranks) is lowered to
1024 elements, so that every matrix of the layer stacks, the MTP module's
block and ``proj``, the embedding and whisper's ``frame_proj`` also split
over ``data``.  deepseek-v3 runs at capacity factor 4 (E / K), where
neither the one-device scatter path nor the sharded expert-parallel
dispatch drops a token (their capacities differ by construction, as in
``test_torch_mesh_train_moe``); its loss carries ``0.01 *`` the
load-balance term and ``0.3 *`` the MTP module's shift-2 CE.  Whisper's
batch carries its encoder frames, split over ``data`` with the tokens.

Limits (``test_torch_mesh_train.py``'s f32 ``LIMITS``): step 1's loss
within 1e-5 (relative) and every gradient within 1e-5 of the tree's
largest, against the one-device port's and the reference's; deepseek's aux
within 1e-6 of both.  Then two steps with ADMM (a Z-update after each,
kernel #4's plain version on each rank's shard here), clipping and AdamW
with float32 and with int8 moments, against the one-device steps: params
within 1e-5 absolute, entries outside counted: at most 1 in 10^4 (Adam
turns gradients as small as the runs' summation differences into a share
of the learning rate), and apart, with int8 moments, those whose second
moment quantized to 0 in either run, which take a large step: at most 5
in 10^4 (1.1e-4 measured for both models); Z and U entries outside 1e-4
of each leaf's largest at most 1 in 1000.
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
ARCHS = {"deepseek": "deepseek-v3-671b", "whisper": "whisper-small"}
TRAIN = dict(warmup_steps=1, total_steps=20, remat=True)
ADMM = dict(admm_enabled=True, admm_rho=1e-2, admm_update_every=1, grad_clip=0.5)
MOMENTS = ("float32", "int8")


def _cfg(name, base):
    cfg = dataclasses.replace(base, dtype="float32")
    if name == "deepseek":
        return dataclasses.replace(cfg, capacity_factor=4.0)
    return cfg


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
    shd.FSDP_THRESHOLD = THRESHOLD        # this rank's module: every matrix over data too
    mesh = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    ctx = shd.ParallelContext.for_mesh(mesh)
    res = {}

    def flat(tree):
        return dict(paths.iter_leaves(tree))

    def whole(tree):
        with parallel_context(ctx):
            return shd.gather_global(tree)

    for name, arch in ARCHS.items():
        model = build(_cfg(name, get_reduced(arch)), device="cpu")
        side = blob[name]
        batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in side["batches"]]
        fresh = lambda: paths.tree_map(torch.clone, side["params"])  # noqa: E731
        r = {"local_batch": {k: list(v.shape)
                             for k, v in ttl.shard_batch(batches[0], ctx).items()}}

        # step 1's loss and gradients
        tcfg = TrainConfig(**TRAIN)
        state, table = ttl.init_train_state(model, tcfg, params=fresh())
        placed = shd.place_train_state(state, ctx, table)
        step = ttl.make_train_step(model, tcfg, table, ctx=ctx)
        loss, grads = step.grads(placed, batches[0])
        r["fsdp_grads"] = sum(1 for _, g in paths.iter_leaves(grads)
                              if shard_of(g) is not None and "data" in shard_of(g).axes())
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
        r["paths"] = sorted(gw) == sorted(one_g) == sorted(ref)
        r["mtp_grad"] = max((float(g.abs().max()) for p, g in gw.items()
                             if p.startswith("mtp/")), default=0.0)
        if name == "deepseek":
            with parallel_context(ctx), torch.no_grad():
                _, aux = model.forward(placed.params, ttl.shard_batch(batches[0], ctx),
                                       return_hidden=True)
            with torch.no_grad():
                _, one_aux = model.forward(state.params, batches[0], return_hidden=True)
            r["aux"] = [float(aux["moe_aux_loss"]), float(one_aux["moe_aux_loss"]),
                        side["ref_aux"]]
            kv_up = placed.params["blocks"]["mla"]["kv_up"]
            r["kv_up"] = [list(kv_up.shape), list(shard_of(kv_up).spec)]
            proj = placed.params["mtp"]["proj"]
            r["mtp_proj"] = [list(proj.shape), list(shard_of(proj).spec)]

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
            d = [(x - fo[p]).abs() for p, x in flat(w.params).items()]
            n = sum(t.numel() for t in d)
            bad = total = 0
            for p, st in w.admm.items():
                for f in ("z", "u"):
                    x, y = getattr(st, f), getattr(one.admm[p], f)
                    bad += int(((x - y).abs() > 1e-4 * y.abs().max()).sum())
                    total += y.numel()
            # entries outside the limit, apart and at a second moment that
            # quantized to 0 (int8 moments) in either run
            outside = zero_nu = 0
            if moments == "int8":
                fnw, fno = flat(w.opt.nu), flat(one.opt.nu)
            for t, p in zip(d, fo):
                out_p = t > 1e-5 * (1 + fo[p].abs())
                if moments == "int8":
                    at_zero = out_p & ((fnw[p] == 0) | (fno[p] == 0))
                    zero_nu += int(at_zero.sum())
                    out_p = out_p & ~at_zero
                outside += int(out_p.sum())
            r[f"admm/{moments}"] = {
                "metrics": met, "params_outside": outside / n, "zero_nu_outside": zero_nu / n,
                "zu_outside": bad / total, "admm_leaves": len(w.admm)}
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
    batches, and the reference's single-device step-1 loss (deepseek: and
    aux loss) and gradients."""
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
        cfg = _cfg(name, jax_reduced(arch))
        jm = jax_build(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        batches = []
        for i in range(2):
            b = {"tokens": lm_batch(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                                   global_batch=4), i, "cpu")["tokens"].numpy()}
            if name == "whisper":
                b["frames"] = np.random.RandomState(i).normal(
                    0, 1, (4, 16, cfg.d_model)).astype(np.float32)
            batches.append(b)
        jb = {k: jnp.asarray(v) for k, v in batches[0].items()}

        def jloss(p):
            h, a = jm.forward(p, jb, remat=True, return_hidden=True)
            return jtl.hidden_loss(jm, p, jb, h, a), a.get("moe_aux_loss", jnp.zeros(()))

        (loss, aux), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
        out[name] = {"params": params_from_numpy(to_numpy(jp), device="cpu"),
                     "batches": batches, "ref_loss": float(loss), "ref_aux": float(aux),
                     "ref_grads": {p: np.asarray(g) for p, g in jadmm.iter_weights(grads)}}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train_mla_whisper")
    path = str(d / "blob.pt")
    torch.save(_jax_side(), path)
    out = str(d / "out.json")
    spawn_cpu_world(4, _world, path, out, timeout_s=TIMEOUT_S)
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("name", list(ARCHS))
def test_sharded_step_equals_one_device_and_reference(world, name):
    """Step 1's loss and every gradient equal the one-device port's and the
    reference's, on every rank, with the FSDP gradients split over data;
    the MTP module (deepseek) takes a gradient."""
    for res in world:
        r = res[name]
        sharded, one, ref = r["loss"]
        assert abs(sharded - one) <= 1e-5 * abs(one), r["loss"]
        assert abs(sharded - ref) <= 1e-5 * abs(ref), r["loss"]
        assert r["grads_vs_one"] <= 1e-5 and r["grads_vs_ref"] <= 1e-5, r
        assert r["paths"] and r["fsdp_grads"] >= 8
        if name == "deepseek":
            assert r["mtp_grad"] > 0
    assert len({json.dumps(res[name]["loss"]) for res in world}) == 1


def test_deepseek_aux_loss_and_layouts(world):
    """The load-balance loss (its means over the whole batch before their
    product) equals the one-device port's and the reference's; kv_up holds
    half its columns on each rank and half its rows per data rank (FSDP);
    the MTP proj (no rule: replicated over model) is split over data."""
    for res in world:
        r = res["deepseek"]
        a_sh, a_one, a_ref = r["aux"]
        assert abs(a_sh - a_one) <= 1e-6 and abs(a_sh - a_ref) <= 1e-6, r["aux"]
        assert r["kv_up"] == [[2, 8, 64], [None, "data", "model"]]
        assert r["mtp_proj"] == [[64, 64], ["data", None]]


def test_whisper_batch_splits_its_frames_with_its_tokens(world):
    for res in world:
        assert res["whisper"]["local_batch"] == {"frames": [2, 16, 64], "tokens": [2, 16]}


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
        assert r["params_outside"] <= 1e-4 and r["zero_nu_outside"] <= 5e-4, r
        assert r["zu_outside"] <= 1e-3 and r["admm_leaves"] >= 8, r
