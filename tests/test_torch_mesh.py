"""Serving on a device mesh (explicit SPMD) against the JAX package.

Specs, in this process: the port's ``param_spec``, ``params_shardings``,
``forms_param_spec``, ``cache_shardings`` and ``_fsdp_extend`` equal the
reference's ``PartitionSpec``s (compared as tuples) on abstract meshes of
five shapes, over the reduced config of every registry family, uniformly
compressed and under a mixed-precision plan with a per-leaf fragment size.
The trees are compressed by the port from one set of weights and handed to
the reference as its own ``FormsLinearParams`` with the same codes (the
specs read only the planes' shapes and ``m``; ``test_torch_forms`` holds
the two packages' codes equal).

Sharded runs: one gloo world per mesh shape (4 ranks at data=2, model=2;
2 ranks at data=1, model=2 for the MoE dispatch), every check inside it.
The reference's single-device tokens are computed here and handed to the
ranks with the bridged weights; each rank also serves the port's
unsharded engine, and the sharded tokens must equal both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_reduced as jax_reduced
from repro.core.paths import path_str as jax_path_str
from repro.distributed import sharding as jshd
from repro.forms import FormsLinearParams as JaxForms
from repro.models.registry import build as jax_build
from repro_torch import forms as tforms
from repro_torch.configs import ARCH_NAMES, get_reduced
from repro_torch.distributed import sharding as shd
from repro_torch.launch import train as train_launch
from repro_torch.models.registry import build
from torch_parity_util import FORMS_META

MESHES = [((1, 16), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["1x16", "2x4", "4x2", "2x2", "2x16x16"]


def _contexts(shape, names):
    jctx = jshd.ParallelContext.for_mesh(AbstractMesh(shape, names))
    tctx = shd.ParallelContext.for_shape(dict(zip(names, shape)))
    return jctx, tctx


def _to_jax(t):
    if isinstance(t, dict):
        return {k: _to_jax(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_jax(v) for v in t]
    if isinstance(t, tforms.FormsLinearParams):
        return JaxForms(mags=jnp.asarray(t.mags.numpy()), signs=jnp.asarray(t.signs.numpy()),
                        scale=jnp.asarray(t.scale.numpy()),
                        **{f: getattr(t, f) for f in FORMS_META})
    return jnp.asarray(t.float().numpy())


def _jax_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax_path_str(p): tuple(s.spec) for p, s in flat}


def _port_specs(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_specs(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_specs(v, prefix + (i,)))
        return out
    if isinstance(tree, tforms.FormsLinearParams):
        return {"/".join(map(str, prefix + (f,))): getattr(tree, f).spec
                for f in ("mags", "signs", "scale")}
    if isinstance(tree, shd.Sharding):
        return {"/".join(map(str, prefix)): tree.spec}
    return {}


def _mixed_plan(tc):
    """A plan over two compressed leaves of ``tc``: one at m=16 and 6 bits,
    one at 4 bits (a per-leaf fragment size and per-leaf widths)."""
    paths = sorted(tforms.compressed_paths(tc))
    spec = tforms.FormsSpec(m=8)
    return {paths[0]: dataclasses.replace(spec, m=16, bits=6), paths[-1]: spec.with_bits(4)}


_TREES = {}


def _trees(arch):
    """(port tree, reference tree) for the uniform and the mixed compression
    of ``arch``'s reduced config, built once per process."""
    if arch not in _TREES:
        model = build(get_reduced(arch), device="cpu")
        params = model.init(0)
        uni, _ = tforms.compress_tree(params, tforms.FormsSpec(m=8))
        mixed, _ = tforms.compress_tree(params, tforms.FormsSpec(m=8), plan=_mixed_plan(uni))
        _TREES[arch] = {"uniform": (uni, _to_jax(uni)), "mixed": (mixed, _to_jax(mixed)),
                        "dense": (params, _to_jax(params))}
    return _TREES[arch]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_and_forms_specs_equal_the_references(arch):
    """params_shardings (fsdp on and off) of the dense, the uniformly
    compressed and the mixed-plan tree equal the reference's on every mesh
    shape, leaf by leaf and plane by plane; forms_param_spec agrees with
    what params_shardings put on each compressed leaf."""
    trees = _trees(arch)
    for (shape, names) in MESHES:
        jctx, tctx = _contexts(shape, names)
        for kind, (tt, jt) in trees.items():
            for fsdp in (True, False):
                want = _jax_specs(jshd.params_shardings(jt, jctx, fsdp=fsdp))
                got = _port_specs(shd.params_shardings(tt, tctx, fsdp=fsdp))
                assert got == want, (arch, shape, kind, fsdp)
        tt, _ = trees["mixed"]
        for pstr, leaf in tforms.compressed_paths(tt).items():
            jleaf = _to_jax(leaf)
            for scanned in (True, False):
                want = tuple(tuple(s) for s in jshd.forms_param_spec(pstr, jleaf, jctx,
                                                                      scanned=scanned))
                assert shd.forms_param_spec(pstr, leaf, tctx, scanned=scanned) == want


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_equal_the_references(arch):
    """cache_shardings of the dense slot cache and (attention families) the
    page pool equal the reference's on every mesh shape, path by path."""
    tm = build(get_reduced(arch), device="cpu")
    jm = jax_build(jax_reduced(arch))
    caches = [(tm.init_cache(4, 32), jm.init_cache(4, 32))]
    if tm.supports_paged:
        caches.append((tm.init_paged_cache(16, 8, 4, 32), jm.init_paged_cache(16, 8, 4, 32)))
    for (shape, names) in MESHES:
        jctx, tctx = _contexts(shape, names)
        for tc, jc in caches:
            want = _jax_specs(jshd.cache_shardings(jc, jctx))
            got = _port_specs(shd.cache_tree(shd.cache_shardings(tc, tctx)))
            assert got == want and len(got) > 0, (arch, shape)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_param_spec_fsdp_extend_and_batch_specs_equal_the_references(mesh):
    """The rule table at every matching path (scanned and not), the FSDP
    extension at sizes around its threshold, and the batch/replicated
    specs."""
    shape, names = mesh
    jctx, tctx = _contexts(shape, names)
    assert shd._PARAM_RULES == jshd._PARAM_RULES
    assert shd.SCANNED_PREFIXES == jshd.SCANNED_PREFIXES
    assert shd.FSDP_THRESHOLD == jshd.FSDP_THRESHOLD
    paths = ["embed", "head", "pos_embed", "blocks/attn/wq", "blocks/attn/wo/q",
             "blocks/attn/bk", "blocks/mla/kv_up", "blocks/mlp/down", "blocks/moe/w_up",
             "blocks/moe/router", "blocks/ssm/in_proj", "blocks/ssm/a_log",
             "blocks/mlstm/wz", "blocks/slstm/wout", "blocks/norm1", "final_norm"]
    for p in paths:
        for dims in ((64, 128), (2, 64, 128), (2, 8, 64, 128)):
            for scanned in (True, False):
                assert shd.param_spec(p, dims, scanned) == tuple(
                    jshd.param_spec(p, dims, scanned)), (p, dims)
    for dims, entries in [((4096, 1024), [None, None]), ((4096, 1024), [None, "model"]),
                          ((2048, 2048), [None, None]), ((64, 65536, 2), [None, None, None]),
                          ((96, 3, 16384), [None, None, "model"])]:
        for threshold in (1 << 10, jshd.FSDP_THRESHOLD):
            assert shd._fsdp_extend(entries, dims, tctx, threshold) == \
                jshd._fsdp_extend(entries, dims, jctx, threshold)
    for rank, extra in ((2, ()), (3, ("model",)), (1, ())):
        assert shd.batch_sharding(tctx, rank, extra).spec == \
            tuple(jshd.batch_sharding(jctx, rank, extra).spec)
    assert shd.replicated(tctx).spec == tuple(jshd.replicated(jctx).spec) == ()
    for logical in ("batch", "model", "tokens"):
        assert tctx.axis_size(logical) == jctx.axis_size(logical)
        assert tctx.resolve(logical) == jctx.resolve(logical)


def _placed_leaf(spec_m, spec_s, spec_c, kp=64, n=32, m=8, local_k=None):
    """A FORMS leaf marked as placed with the given plane specs."""
    from repro_torch.distributed.context import LeafShard
    lk = kp if local_k is None else local_k
    leaf = tforms.FormsLinearParams(
        mags=torch.zeros((lk, n), dtype=torch.uint8), signs=torch.ones((lk // m, n),
                                                                        dtype=torch.int8),
        scale=torch.ones((1, n)), k=kp, m=m)
    pad = lambda s: tuple(s) + (None,) * (2 - len(s))   # noqa: E731
    return dataclasses.replace(leaf, shard=(LeafShard(pad(spec_m), (kp, n)),
                                            LeafShard(pad(spec_s), (kp // m, n)),
                                            LeafShard(pad(spec_c), (1, n))))


@pytest.mark.parametrize("case", ["n_mismatch", "k_mismatch", "scale_rows", "straddle"])
def test_validate_tree_sharding_refuses_the_references_bad_cases(case):
    """The reference's three invariants and its fragment-straddle rule,
    refused with a ValueError that names the leaf's path; a good tree
    passes and decompress_tree(validate=True) checks first."""
    bad = {
        "n_mismatch": (_placed_leaf((None, "model"), (None, None), (None, "model")),
                       "N \\(output-column\\) axis must co-shard"),
        "k_mismatch": (_placed_leaf(("model", None), (None, None), (None, None)),
                       "sign fragment axis must shard"),
        "scale_rows": (_placed_leaf((None, None), (None, None), ("model", None)),
                       "scale row axis must be replicated"),
        "straddle": (_placed_leaf(("model", None), ("model", None), (None, None), kp=192,
                                  local_k=12), "K=192 sharded 16-way gives 12-row shards, not a multiple"),
    }[case]
    tree = {"blocks": {"attn": {"wq": bad[0]}}}
    with pytest.raises(ValueError, match=f"blocks/attn/wq: {bad[1]}"):
        tforms.validate_tree_sharding(tree)
    with pytest.raises(ValueError, match="blocks/attn/wq"):
        tforms.decompress_tree(tree)
    good = {"w": _placed_leaf((None, "model"), (None, "model"), (None, "model"))}
    assert tforms.validate_tree_sharding(good) == {"w": (None, "model")}
    assert tforms.tree_sharding_specs(good) == {"w": (None, "model")}


# ---------------------------------------------------------------------------
# the launchers' flags (no world)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", ["--pods", "--mesh-data", "--mesh-model"])
def test_train_mesh_flags_name_item_13c(flag, capsys):
    """ROADMAP item 13c (sharded training) is ported: the reference's train
    mesh flags build the mesh.  A mesh of 2 in a process that is alone is
    refused by name (not a usage error), pointing to ``--fake-devices``
    (the sharded runs: tests/test_torch_mesh_train*.py); at 1 the launcher
    trains on a world of one and prints its mesh line."""
    with pytest.raises(SystemExit) as e:
        train_launch.main(["--reduced", "--steps", "1", "--device", "cpu", flag, "2"])
    assert "needs 2 processes" in str(e.value.code) and "--fake-devices 2" in str(e.value.code)
    train_launch.main(["--reduced", "--steps", "1", "--log-every", "1", "--seq-len", "16",
                       "--global-batch", "2", "--device", "cpu", flag, "1"])
    out = capsys.readouterr().out
    assert out.startswith("mesh: {'data': 1, 'model': 1} over 1 devices") and (
        "step     1  loss" in out)


def test_serve_fake_devices_needs_the_cpu():
    """--fake-devices runs gloo processes: refused by name on cuda, and
    without --mesh."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="add --device cpu"):
        serve.main(["--reduced", "--mesh", "data=2,model=2", "--fake-devices", "4"])
    with pytest.raises(SystemExit, match="add --mesh"):
        serve.main(["--reduced", "--device", "cpu", "--fake-devices", "4"])


def test_serve_fake_devices_spawns_a_cpu_world(capfd):
    """serve --device cpu --mesh data=1,model=2 --fake-devices 2 serves in a
    2-process gloo world: rank 0 prints the mesh line and the tokens the
    unsharded launcher prints."""
    from repro_torch.launch import serve
    flags = ["--reduced", "--forms", "--device", "cpu", "--requests", "2",
             "--max-new-tokens", "4"]
    serve.main(flags)
    plain = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("req ")]
    serve.main(flags + ["--mesh", "data=1,model=2", "--fake-devices", "2"])
    out = capfd.readouterr().out.splitlines()
    assert "mesh: {'data': 1, 'model': 2} over 2 devices, 23 param leaves sharded" in out
    assert [ln for ln in out if ln.startswith("req ")] == plain and len(plain) == 2


def test_preemption_on_a_mesh_saves_when_any_rank_is_signalled(monkeypatch):
    """On a mesh a SIGTERM is held even between steps, and every rank saves
    at the end of the step where ``agree`` reports that any rank holds one
    (the save gathers: all ranks must make it at one step)."""
    from repro_torch.checkpoint import manager as ckpt
    saved, exits = [], []
    monkeypatch.setattr(ckpt.os, "_exit", exits.append)
    others = {"pending": False}
    handler = ckpt.PreemptionHandler(lambda: saved.append(len(saved)),
                                     agree=lambda mine: mine or others["pending"])
    with handler.critical():
        pass
    assert saved == [] and exits == []
    handler(15, None)                 # between steps: held, not acted on
    assert saved == []
    with handler.critical():
        pass
    assert saved == [0] and exits == [0]
    quiet = ckpt.PreemptionHandler(lambda: saved.append(len(saved)),
                                   agree=lambda mine: mine or others["pending"])
    others["pending"] = True          # another rank was signalled
    with quiet.critical():
        pass
    assert saved == [0, 1] and exits == [0, 0]
