"""Sharded MoE training on a pods=2, data=1, model=2 gloo world on the CPU,
against the one-device port and the JAX package.

Reduced olmoe in f32: each pod rank takes half of the global batch, the
model axis splits the experts and each data rank's tokens (the
expert-parallel ``all_to_all`` dispatch), and with the FSDP threshold
lowered to 1024 elements every matrix also splits over the batch axes
``("pod", "data")``.  The capacity factor is 4 (E / K), so neither the
one-device scatter path (capacity ``4 * T * K / E = T``) nor the sharded
dispatch (``4 * T_loc * K / E = T_loc`` per source rank and expert) drops a
token: the two paths' capacities differ by construction, and drops under
pressure differ in the reference too.

Limits: with the f32 dispatch the loss within 1e-5 (relative) and the aux
loss within 1e-6 of the one-device port's and the reference's, every
gradient within 1e-5 of the tree's largest (the limits of the MoE cases of
``tests/test_torch_training.py``).  The int8 dispatch quantizes the expert
inputs and outputs per row (``amax / 127``, both on the gradients' path):
its loss is held within 1e-3 of the f32 dispatch's and its expert-layer
gradients within 3e-2 of their largest (1.5e-2 measured), and its
backward is the straight-through reverse ``all_to_all`` at full precision
(a spy on the exchanges' dtypes).  Every other family builds a sharded
step on this mesh too (MLA and whisper: ``test_torch_mesh_train_mla_whisper``;
xLSTM and Zamba2: ``test_torch_mesh_train_recurrent``).
"""
import dataclasses
import json
import traceback

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import MeshConfig, TrainConfig
from repro_torch.launch.mesh import make_mesh, spawn_cpu_world

TIMEOUT_S = 180
THRESHOLD = 1024
CAPACITY = 4.0
FAMILIES = ("deepseek-v3-671b", "whisper-small", "xlstm-350m", "zamba2-2.7b")


def _cfg(int8: bool):
    return dataclasses.replace(get_reduced("olmoe-1b-7b"), dtype="float32",
                               capacity_factor=CAPACITY, moe_dispatch_int8=int8)


# ---------------------------------------------------------------------------
# the ranks (this module's top imports only the port)
# ---------------------------------------------------------------------------

def _world_b(path, out):
    """The pods=2, data=1, model=2 world: every check of this file."""
    import torch.distributed as dist
    from repro_torch.core import paths
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import parallel_context, shard_of
    from repro_torch.models.registry import build
    from repro_torch.training import train_loop as ttl

    blob = torch.load(path, weights_only=False)
    shd.FSDP_THRESHOLD = THRESHOLD        # this rank's module: every matrix over pod too
    mesh = make_mesh(MeshConfig(pods=2, data=1, model=2), device="cpu")
    ctx = shd.ParallelContext.for_mesh(mesh)
    rank = dist.get_rank()
    batch = {"tokens": torch.from_numpy(blob["tokens"])}
    tcfg = TrainConfig(warmup_steps=1, total_steps=20, remat=True)
    res = {}
    seen = []
    original = dist.all_to_all_single

    def in_backward() -> bool:
        return any(frame.name == "backward" for frame in traceback.extract_stack()[:-1])

    def spy(out_t, in_t, *a, **k):
        seen.append((str(in_t.dtype), in_backward()))
        return original(out_t, in_t, *a, **k)

    for int8 in (False, True):
        model = build(_cfg(int8), device="cpu")
        params = paths.tree_map(torch.clone, blob["params"])
        state, table = ttl.init_train_state(model, tcfg, params=params)
        placed = shd.place_train_state(state, ctx, table)
        step = ttl.make_train_step(model, tcfg, table, ctx=ctx)
        seen.clear()
        dist.all_to_all_single = spy
        try:
            loss, grads = step.grads(placed, batch)
        finally:
            dist.all_to_all_single = original
        with parallel_context(ctx), torch.no_grad():
            _, aux = model.forward(placed.params, ttl.shard_batch(batch, ctx),
                                   return_hidden=True)
            gw = dict(paths.iter_leaves(shd.gather_global(grads)))
        fsdp = sum(1 for _, g in paths.iter_leaves(grads)
                   if shard_of(g) is not None and "pod" in shard_of(g).axes())

        def one_loss(p, b):
            h, a = model.forward(p, b, remat=True, return_hidden=True)
            return ttl.hidden_loss(model, p, b, h, a)
        one_v, one_g = ttl._value_and_grad(one_loss, params, batch)
        with torch.no_grad():
            _, one_aux = model.forward(params, batch, return_hidden=True)
        top_one = max(float(g.abs().max()) for g in paths.leaves(one_g))
        ref = blob["ref_grads"]
        top_ref = max(float(np.abs(g).max()) for g in ref.values())
        res[f"int8={int8}"] = {
            "loss": [float(loss), float(one_v), blob["ref_loss"]],
            "aux": [float(aux["moe_aux_loss"]), float(one_aux["moe_aux_loss"]),
                    blob["ref_aux"]],
            "grads_vs_one": max(float((gw[p] - g).abs().max()) / top_one
                                for p, g in paths.iter_leaves(one_g)),
            "grads_vs_ref": max(float(np.abs(gw[p].numpy() - g).max()) / top_ref
                                for p, g in ref.items()),
            "grads": {p: g.numpy().tolist() for p, g in gw.items() if "moe" in p},
            "fsdp_grads": fsdp,
            "a2a": list(seen),
            "experts_local": int(placed.params["blocks"]["moe"]["w_gate"].shape[1]),
        }

    refused = {}
    for arch in FAMILIES:
        m = build(get_reduced(arch), device="cpu")
        try:
            ttl.make_train_step(m, tcfg, ctx=ctx)
            refused[arch] = None
        except NotImplementedError as e:
            refused[arch] = str(e)
    res["refused"] = refused

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, res)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(every, f)


# ---------------------------------------------------------------------------
# the pytest side
# ---------------------------------------------------------------------------

def _jax_side():
    """Bridged weights of the reference's init, a global batch, and the
    reference's single-device loss, aux loss and gradients."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jax_reduced
    from repro.core import admm as jadmm
    from repro.models.registry import build as jax_build
    from repro.training import train_loop as jtl
    from repro_torch.bridge import params_from_numpy
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    from torch_parity_util import to_numpy

    jm = jax_build(dataclasses.replace(jax_reduced("olmoe-1b-7b"), dtype="float32",
                                       capacity_factor=CAPACITY))
    jp = jm.init(jax.random.PRNGKey(0))
    tokens = lm_batch(LMStreamConfig(vocab_size=256, seq_len=16, global_batch=4), 0,
                      "cpu")["tokens"].numpy()
    jb = {"tokens": jnp.asarray(tokens)}

    def jloss(p):
        h, a = jm.forward(p, jb, remat=True, return_hidden=True)
        return jtl.hidden_loss(jm, p, jb, h, a), a["moe_aux_loss"]

    (loss, aux), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    return {"params": params_from_numpy(to_numpy(jp), device="cpu"), "tokens": tokens,
            "ref_loss": float(loss), "ref_aux": float(aux),
            "ref_grads": {p: np.asarray(g) for p, g in jadmm.iter_weights(grads)}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train_moe")
    path = str(d / "blob.pt")
    torch.save(_jax_side(), path)
    out = str(d / "out.json")
    spawn_cpu_world(4, _world_b, path, out, timeout_s=TIMEOUT_S)
    with open(out) as f:
        return json.load(f)


def test_sharded_moe_step_equals_one_device_and_reference(world):
    """The f32 dispatch: loss, the aux loss (its means over the whole batch
    before their product) and every gradient equal the one-device port's
    and the reference's, on every rank; each rank holds half the experts,
    and the FSDP gradients arrive split over ("pod", "data")."""
    for res in world:
        r = res["int8=False"]
        sharded, one, ref = r["loss"]
        assert abs(sharded - one) <= 1e-5 * abs(one) and abs(sharded - ref) <= 1e-5 * abs(ref)
        a_sh, a_one, a_ref = r["aux"]
        assert abs(a_sh - a_one) <= 1e-6 and abs(a_sh - a_ref) <= 1e-6, r["aux"]
        assert r["grads_vs_one"] <= 1e-5 and r["grads_vs_ref"] <= 1e-5, r
        assert r["experts_local"] == 4 and r["fsdp_grads"] >= 8
    assert len({json.dumps(res["int8=False"]["loss"]) for res in world}) == 1


def test_int8_dispatch_trains_straight_through(world):
    """The int8 dispatch sends int8 payloads forward and takes its
    cotangents back by the reverse all-to-all in f32 (no int8 in the
    backward); its loss and gradients stay within the quantization's
    reach of the f32 dispatch's."""
    for res in world:
        r, f = res["int8=True"], res["int8=False"]
        fwd = [d for d, back in r["a2a"] if not back]
        bwd = [d for d, back in r["a2a"] if back]
        assert "torch.int8" in fwd and bwd and set(bwd) == {"torch.float32"}, r["a2a"]
        assert abs(r["loss"][0] - f["loss"][0]) <= 1e-3 * abs(f["loss"][0])
        top = max(np.abs(np.asarray(g)).max() for g in f["grads"].values())
        err = max(np.abs(np.asarray(r["grads"][p]) - np.asarray(g)).max()
                  for p, g in f["grads"].items())
        assert 0 < err <= 3e-2 * top, (err, top)


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_on_a_training_mesh_are_admitted_or_refused_by_name(world, arch):
    """Every family builds a sharded train step on this pods=2, model=2
    mesh (none is refused any more): MLA, whisper, xLSTM and Zamba2."""
    for res in world:
        msg = res["refused"][arch]
        assert msg is None, msg
