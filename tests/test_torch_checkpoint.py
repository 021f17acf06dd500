"""PyTorch port vs the JAX package: checkpoints.

Each package reads the other's checkpoints, every leaf bit-identical in
value and dtype: a reduced dense tree (f32 and bf16), a FORMS tree with
its spec in ``extra_meta`` (the reference's carries ``prefer_ref``), a
per-leaf ``plan=`` tree with the reference's plan meta, and train states
with f32, bf16 and int8 moments, ADMM state after a Z-update and int8
error feedback.  The port's metadata codec (``msgpack_lite``) writes
``msgpack.packb``'s bytes on hypothesis-drawn metas and reads them back.
Then the manager's own contract on the CPU: atomic publish, keep-k, an
async snapshot that a later in-place update cannot reach, a bit-exact
resume, SIGTERM -> save -> exit 0 in a subprocess, and a restored FORMS
tree that serves the same tokens.
"""
import dataclasses
import os
import pathlib
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import forms as jforms
from repro.checkpoint import manager as jckpt
from repro.core import admm as jadmm
from repro.forms import autobits as jab
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch import forms as tforms
from repro_torch.checkpoint import manager as tckpt
from repro_torch.checkpoint import msgpack_lite
from repro_torch.configs.base import TrainConfig
from repro_torch.core import admm as tadmm
from repro_torch.data.synthetic import LMStreamConfig, lm_batch
from repro_torch.models.registry import build
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl

from torch_parity_util import FORMS_META, configs, models, shared_codes

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the port's trees as the reference's, and leaves as raw bits
# ---------------------------------------------------------------------------

_CLASSES = {ttl.TrainState: jtl.TrainState, topt.AdamWState: jopt.AdamWState,
            tadmm.AdmmLayerState: jadmm.AdmmLayerState}


def to_jax(x, key=(0, 7)):
    """A port tree as the reference's: tensors as jnp arrays (bf16 kept),
    dataclasses as the reference's classes, a generator as a uint32[2] key."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: to_jax(v, key) for k, v in x.items()}
    if isinstance(x, tforms.FormsLinearParams):
        return jforms.FormsLinearParams(
            mags=to_jax(x.mags), signs=to_jax(x.signs), scale=to_jax(x.scale),
            **{f: getattr(x, f) for f in FORMS_META})
    if type(x) in _CLASSES:
        return _CLASSES[type(x)](**{f.name: to_jax(getattr(x, f.name), key)
                                    for f in dataclasses.fields(x)})
    if isinstance(x, torch.Generator):
        return jnp.asarray(np.asarray(key, np.uint32))
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


def bits(x):
    """(raw-bit numpy array, dtype name) of a tensor or a jax/numpy array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "bfloat16"
        a = x.numpy()
    else:
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return a.view(np.int16), "bfloat16"
    return a, str(a.dtype)


def assert_same_leaves(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        (ga, gd), (wa, wd) = bits(g), bits(w)
        assert gd == wd, f"leaf {i}: dtype {gd} != {wd}"
        assert ga.shape == wa.shape, f"leaf {i}: shape {ga.shape} != {wa.shape}"
        np.testing.assert_array_equal(ga, wa, err_msg=f"leaf {i}")


def port_leaves(tree):
    """The port tree's leaves in its flatten order, generators left out."""
    return [x for x in tckpt.tree_leaves(tree) if not isinstance(x, torch.Generator)]


def jax_leaves(tree, skip_rng=False):
    if skip_rng:
        tree = dataclasses.replace(tree, rng=None)
    return jax.tree_util.tree_leaves(tree)


# ---------------------------------------------------------------------------
# the metadata codec
# ---------------------------------------------------------------------------

_scalars = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=300))
_metas = st.recursive(
    _scalars,
    lambda kids: (st.lists(kids, max_size=20)
                  | st.dictionaries(st.text(max_size=40), kids, max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None, database=None)
@given(_metas)
def test_packb_writes_msgpack_bytes_and_reads_them_back(meta):
    want = msgpack.packb(meta)
    assert msgpack_lite.packb(meta) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want)


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_length_boundaries_match_msgpack(n):
    for obj in ("x" * n, list(range(min(n, 70000))), {f"k{i}": i for i in range(n)}):
        assert msgpack_lite.packb(obj) == msgpack.packb(obj)
        assert msgpack_lite.unpackb(msgpack.packb(obj)) == msgpack.unpackb(msgpack.packb(obj))


def test_codec_refuses_what_it_does_not_know():
    for obj in (b"bytes", np.int64(3), np.float32(1.0), 2 ** 64, {1: 2}.keys(), 1j):
        with pytest.raises((TypeError, OverflowError)):
            msgpack_lite.packb(obj)
    for data in (msgpack.packb(b"bin"), msgpack.packb(1.5, use_single_float=True),
                 msgpack.packb(msgpack.ExtType(1, b"x")), msgpack.packb({1: 2}),
                 msgpack.packb([1, 2])[:-1], msgpack.packb(1) + b"\x00"):
        with pytest.raises(ValueError):
            msgpack_lite.unpackb(data)


def test_reference_meta_reads_back():
    """The whole ``tree.msgpack`` of a reference checkpoint, spec meta and
    all, reads back equal to what ``msgpack`` reads."""
    spec = jforms.FormsSpec(m=8, bits=4, adc_bits=5)
    meta = {"treedef": "PyTreeDef({'a': *})", "num_leaves": 1, "step": 123456,
            "dtypes": ["bfloat16"], "extra": dataclasses.asdict(spec)}
    data = msgpack.packb(meta)
    assert msgpack_lite.unpackb(data) == msgpack.unpackb(data)
    assert msgpack_lite.packb(msgpack.unpackb(data)) == data


# ---------------------------------------------------------------------------
# cross-reads: each package reads the other's checkpoints
# ---------------------------------------------------------------------------


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_dense_tree_cross_reads(tmp_path, writer, dtype):
    tp = _cast(models()[3], getattr(torch, dtype))
    jp = to_jax(tp)
    template_t = _cast(build(configs()[1], device="cpu").init(1), getattr(torch, dtype))
    if writer == "reference":
        jckpt.save(str(tmp_path), jp, step=3)
        got, step = tckpt.restore(str(tmp_path), template_t)
        assert step == 3
        assert_same_leaves(port_leaves(got), jax_leaves(jp))
        assert all(x.device.type == "cpu" for x in port_leaves(got))
    else:
        tckpt.save(str(tmp_path), tp, step=3)
        got, step = jckpt.restore(str(tmp_path), to_jax(template_t))
        assert step == 3
        assert_same_leaves(jax_leaves(got), port_leaves(tp))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_forms_tree_with_spec_meta_cross_reads_and_serves(tmp_path, writer):
    """The serving protocol: save a compressed tree with its spec, read the
    meta, compress a fresh init (another seed) as the template, restore,
    serve.  The reference's spec meta carries ``prefer_ref``."""
    jc, tc = shared_codes()
    tm = models()[2]
    jspec, tspec = jforms.FormsSpec(m=8, bits=8), tforms.FormsSpec(m=8, bits=8)
    if writer == "reference":
        jckpt.save(str(tmp_path), jc, step=5, extra_meta=dataclasses.asdict(jspec))
        extra = tckpt.read_meta(str(tmp_path))["extra"]
        assert "prefer_ref" in extra
        spec = tforms.spec_from_meta(extra)
        assert spec == tspec
        template, _ = tforms.compress_tree(tm.init(1), spec)
        got, step = tckpt.restore(str(tmp_path), template)
        assert step == 5
        assert_same_leaves(port_leaves(got), jax_leaves(jc))
        for p, leaf in tforms.compressed_paths(got).items():
            want = tforms.compressed_paths(tc)[p]
            assert (leaf.k, leaf.m, leaf.bits) == (want.k, want.m, want.bits)
        reqs = [Request(uid=0, prompt=np.array([3, 4, 5]), max_new_tokens=6)]
        want = ServingEngine(tm, tc, max_len=32, batch_slots=2, device="cpu").run(reqs)
        again = ServingEngine(tm, got, max_len=32, batch_slots=2, device="cpu").run(reqs)
        assert again[0].tokens == want[0].tokens
    else:
        tckpt.save(str(tmp_path), tc, step=5, extra_meta=dataclasses.asdict(tspec))
        extra = jckpt.read_meta(str(tmp_path))["extra"]
        assert jforms.FormsSpec(**extra) == jspec
        got, step = jckpt.restore(str(tmp_path), jc)
        assert step == 5
        assert_same_leaves(jax_leaves(got), port_leaves(tc))


def test_spec_meta_refuses_a_true_prefer_ref():
    meta = dataclasses.asdict(jforms.FormsSpec(prefer_ref=True))
    with pytest.raises(ValueError, match="prefer_ref"):
        tforms.spec_from_meta(meta)
    meta["prefer_ref"] = False
    assert tforms.spec_from_meta(meta) == tforms.FormsSpec()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_per_leaf_plan_tree_cross_reads(tmp_path, writer):
    """A mixed-precision tree (per-leaf bits) with the reference's plan meta
    (``autobits.plan_to_meta``): the reader rebuilds the template from the
    meta and every leaf's bits and codes come back."""
    tm = models()[2]
    tp = models()[3]
    tspec = tforms.FormsSpec(m=8)
    tplan = {"attn/wq": dataclasses.replace(tspec, bits=4),
             "mlp/gate": dataclasses.replace(tspec, bits=2)}
    tc, rep = tforms.compress_tree(tp, tspec, plan=tplan)
    assert rep.bits["blocks/attn/wq"] == 4 and rep.bits["blocks/mlp/gate"] == 2
    jc = to_jax(tc)
    jspec = jforms.FormsSpec(m=8)
    jplan = {p: jspec.with_bits(s.bits) for p, s in tplan.items()}
    if writer == "reference":
        jckpt.save(str(tmp_path), jc, step=7, extra_meta=jab.plan_to_meta(jspec, jplan))
        extra = tckpt.read_meta(str(tmp_path))["extra"]
        spec = tforms.spec_from_meta(extra["spec"])
        plan = {p: dataclasses.replace(spec, **ov) for p, ov in extra["plan"].items()}
        assert spec == tspec and plan == tplan
        template, _ = tforms.compress_tree(tm.init(1), spec, plan=plan)
        got, _ = tckpt.restore(str(tmp_path), template)
        assert_same_leaves(port_leaves(got), jax_leaves(jc))
        for p, leaf in tforms.compressed_paths(got).items():
            assert leaf.bits == rep.bits[p], p
    else:
        tckpt.save(str(tmp_path), tc, step=7, extra_meta=jab.plan_to_meta(tspec, tplan))
        spec2, plan2 = jab.plan_from_meta(jckpt.read_meta(str(tmp_path))["extra"])
        assert spec2 == jspec and plan2 == jplan
        got, _ = jckpt.restore(str(tmp_path), jc)
        assert_same_leaves(jax_leaves(got), port_leaves(tc))


STATES = {
    "f32-moments": dict(),
    "bf16-moments": dict(moment_dtype="bfloat16"),
    "int8-moments-admm": dict(moment_dtype="int8", admm_enabled=True, admm_update_every=2),
    "int8_ef-admm": dict(grad_compression="int8_ef", admm_enabled=True, admm_update_every=2),
}


def _trained(kind, steps=2):
    """A port train state of the reduced qwen2 after ``steps`` steps (and,
    with ADMM, the Z-update of step 2), its template and config."""
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=20, remat=False,
                       **STATES[kind])
    model = build(configs()[1], device="cpu")
    state, table = ttl.init_train_state(model, tcfg)
    step = ttl.make_train_step(model, tcfg, table)
    ds = LMStreamConfig(vocab_size=256, seq_len=16, global_batch=4)
    for i in range(steps):
        state, _ = step(state, lm_batch(ds, i, "cpu"))
        state = ttl.maybe_admm_update(state, table, tcfg, i + 1)
    fresh, _ = ttl.init_train_state(model, tcfg, seed=5)
    return state, ttl.restore_template(fresh, table, tcfg, steps), tcfg


@pytest.mark.parametrize("kind", list(STATES))
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_train_state_cross_reads(tmp_path, writer, kind):
    state, template, tcfg = _trained(kind)
    if tcfg.admm_enabled:
        assert all(s.signs is not None for s in state.admm.values())
    if tcfg.grad_compression == "int8_ef":
        assert state.grad_err is not None
    if writer == "reference":
        js = to_jax(state, key=(3, 9))
        jckpt.save(str(tmp_path), js, step=2)
        got, step = tckpt.restore(str(tmp_path), template)
        assert step == 2
        assert_same_leaves(port_leaves(got), jax_leaves(js, skip_rng=True))
        assert got.rng.initial_seed() == (3 << 32) | 9
    else:
        tckpt.save(str(tmp_path), state, step=2)
        got, step = jckpt.restore(str(tmp_path), to_jax(template))
        assert step == 2
        assert_same_leaves(jax_leaves(got, skip_rng=True), port_leaves(state))
        seed = state.rng.initial_seed()
        np.testing.assert_array_equal(np.asarray(got.rng),
                                      np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32))
        # the leaf order is JAX's: the reference's leaves line up one to one
        assert [tuple(x.shape) for x in jax_leaves(to_jax(state), skip_rng=True)] == \
            [tuple(x.shape) for x in port_leaves(state)]


# ---------------------------------------------------------------------------
# the manager's own contract
# ---------------------------------------------------------------------------


def test_roundtrip_keeps_dtypes_devices_and_generators(tmp_path):
    gen = torch.Generator()
    gen.manual_seed(17)
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16),
                                           "d": torch.tensor(7, dtype=torch.int32),
                                           "m": torch.tensor([True, False])},
            "g": gen, "none": None, "list": [torch.zeros(2, dtype=torch.int8)]}
    tckpt.save(str(tmp_path), tree, step=5)
    after = torch.rand(3, generator=gen)     # the saved run goes on from here
    got, step = tckpt.restore(str(tmp_path), tree)
    assert step == 5 and got["none"] is None
    assert_same_leaves(port_leaves(got), port_leaves(tree))
    torch.testing.assert_close(torch.rand(3, generator=got["g"]), after, rtol=0, atol=0)
    meta = tckpt.read_meta(str(tmp_path))
    assert meta["dtypes"] == ["float32", "bfloat16", "int32", "bool", "uint32", "int8"]
    assert meta["num_leaves"] == 6 and meta["step"] == 5


def test_shape_mismatch_and_shardings_refused(tmp_path):
    tckpt.save(str(tmp_path), {"x": torch.zeros(3)}, step=1)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path), {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore(str(tmp_path), {"x": torch.zeros(3), "y": torch.zeros(1)})
    # shardings= is ported (restore straight into a mesh layout,
    # tests/test_torch_mesh.py): a None entry restores the leaf whole, and a
    # shardings tree of another leaf count is refused as in the reference
    out, _ = tckpt.restore(str(tmp_path), {"x": torch.ones(3)}, shardings={"x": None})
    assert torch.equal(out["x"], torch.zeros(3))
    with pytest.raises(ValueError, match="shardings tree has 2 leaves, template has 1"):
        tckpt.restore(str(tmp_path), {"x": torch.zeros(3)}, shardings={"x": None, "y": None})


def test_atomic_publish_and_gc(tmp_path, monkeypatch):
    tree = {"x": torch.zeros(3)}
    for s in (1, 5, 3, 9):
        tckpt.save(str(tmp_path), tree, step=s)
    assert tckpt.latest_step(str(tmp_path)) == 9
    assert len(tckpt.gc_old(str(tmp_path), keep=2)) == 2
    assert sorted(os.listdir(tmp_path)) == ["step_00000005", "step_00000009"]

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save(str(tmp_path), tree, step=12)
    # no partial checkpoint and no temp dir left behind
    assert sorted(os.listdir(tmp_path)) == ["step_00000005", "step_00000009"]
    os.makedirs(tmp_path / ".tmp_ckpt_dead")
    assert tckpt.latest_step(str(tmp_path)) == 9
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    mgr.save_async(tree, 13)
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait()


def test_save_async_snapshot_is_a_copy(tmp_path):
    """The snapshot is taken before save_async returns: an in-place update
    right after it (as the port's optimizer makes) does not reach the file."""
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    x = torch.arange(1 << 16, dtype=torch.float32)
    y = torch.ones(8, dtype=torch.bfloat16)
    tree = {"x": x, "y": y}
    for s in (1, 2, 3):
        mgr.save_async(tree, s)
        x.add_(1.0)
        y.mul_(2.0)
    mgr.wait()
    assert mgr.latest_step() == 3 and len(os.listdir(tmp_path)) == 2
    got, s = mgr.restore_latest(tree)
    assert s == 3
    torch.testing.assert_close(got["x"], torch.arange(1 << 16, dtype=torch.float32) + 2)
    torch.testing.assert_close(got["y"], torch.full((8,), 4.0, dtype=torch.bfloat16))


def _run(model, tcfg, table, state, steps, ds):
    step = ttl.make_train_step(model, tcfg, table)
    for i in steps:
        state, _ = step(state, lm_batch(ds, i, "cpu"))
        state = ttl.maybe_admm_update(state, table, tcfg, i + 1)
    return state


@pytest.mark.parametrize("variant", ["plain", "admm-int8-int8_ef"])
def test_bit_exact_resume(tmp_path, variant):
    """6 steps against 3 + save + restore + 3: identical state.  With int8
    error feedback the rounding noise comes from the state's generator,
    which the save re-seeds: the run that saved goes on as the resumed run
    does, bit for bit."""
    kw = {} if variant == "plain" else dict(admm_enabled=True, admm_update_every=2,
                                            moment_dtype="int8", grad_compression="int8_ef")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=20, remat=False, **kw)
    model = build(dataclasses.replace(configs()[1], num_layers=2), device="cpu")
    ds = LMStreamConfig(vocab_size=256, seq_len=16, global_batch=4)
    a, table = ttl.init_train_state(model, tcfg)
    a = _run(model, tcfg, table, a, range(3), ds)
    if variant != "plain":
        tckpt.save(str(tmp_path / "a"), a, step=3)     # re-seeds a's generator too
    a = _run(model, tcfg, table, a, range(3, 6), ds)

    b, _ = ttl.init_train_state(model, tcfg)
    b = _run(model, tcfg, table, b, range(3), ds)
    tckpt.save(str(tmp_path / "b"), b, step=3)
    fresh, _ = ttl.init_train_state(model, tcfg, seed=9)
    c, start = tckpt.restore(str(tmp_path / "b"), ttl.restore_template(fresh, table, tcfg, 3))
    assert start == 3
    c = _run(model, tcfg, table, c, range(start, 6), ds)
    assert_same_leaves(port_leaves(c), port_leaves(a))
    assert int(c.step) == 6


def test_sigterm_saves_and_exits_zero(tmp_path):
    """The launcher under SIGTERM: the write in flight is waited for, the
    state of the last finished step is saved, and the process exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ck = tmp_path / "ck"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--steps", "100000",
         "--seq-len", "16", "--global-batch", "2", "--admm", "--admm-every", "2",
         "--device", "cpu", "--ckpt-dir", str(ck), "--ckpt-every", "2", "--log-every", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        lines = []
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            if line.startswith("step     3") or not line:
                break
        assert any(s.startswith("step     3") for s in lines), "".join(lines)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, "".join(lines) + out
    assert "preemption checkpoint written" in out
    latest = tckpt.latest_step(str(ck))
    assert latest is not None and latest >= 3
    meta = tckpt.read_meta(str(ck))
    assert meta["step"] == latest and not any(p.startswith(".tmp") for p in os.listdir(ck))
