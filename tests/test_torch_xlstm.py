"""PyTorch port vs the JAX package: xLSTM (sLSTM + mLSTM) on the chunked
linear recurrence, and the list-shaped params tree it brings.

The reduced xlstm-350m (4 blocks: sLSTM at 0 and 2, mLSTM at 1 and 3;
d_model 64, 2 heads of 32, vocab 256) in float32 from the reference's init
weights carried across through numpy.  Tolerances:

* ``chunked_linear_recurrence`` within 1e-5 of the reference's, at several
  chunks and at the ``s % w`` fallback, and of the port's own
  ``recurrence_decode_step`` run step by step: the same f32 products
  summed in other orders;
* ``forward`` within 1e-5; ``forward(remat=True)`` equal to ``forward``
  bit for bit, its gradients too, and finite;
* prefill against stepwise decode on one slot of a 2-slot f32 cache, and
  both against the reference's, within 1e-4;
* ``compress_tree`` code for code, report paths and their order equal;
  greedy engine tokens equal.

The list walk: ``blocks`` is a Python list, so paths read
``blocks/0/slstm/wz`` and leaves go in index order (``blocks/10`` after
``blocks/9``), through ``iter_leaves``, compression, the bridge, both
checkpoint codecs and the fault injector.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import forms as jforms
from repro import reliability as JR
from repro.checkpoint import manager as jckpt
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.core.paths import path_str as jax_path_str
from repro.models import ssm_common as JS
from repro.models.registry import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import forms as tforms
from repro_torch import reliability as TR
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import paths
from repro_torch.models import ssm_common as TS
from repro_torch.models.registry import build as torch_build
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

from torch_parity_util import (engine_requests, port_to_jax, prefill_and_stepwise,
                               result_tokens, to_numpy)

ARCH = "xlstm-350m"


@functools.lru_cache(maxsize=None)
def models(num_layers=None):
    """(jax model, jax params, port model, port params): the reference's
    init at PRNGKey(0), float32, carried across (``num_layers`` deepens
    the reduced model)."""
    over = dict(dtype="float32", **({"num_layers": num_layers} if num_layers else {}))
    jm = jax_build(dataclasses.replace(jax_reduced(ARCH), **over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(dataclasses.replace(get_reduced(ARCH), **over), device="cpu")
    return jm, jp, tm, params_from_numpy(to_numpy(jp), device="cpu")


@functools.lru_cache(maxsize=None)
def compressed():
    """(reference tree and report, port tree and report) of the same weights,
    each package compressing them itself."""
    _, jp, _, tp = models()
    jc, jrep = jforms.compress_tree(jp, jforms.FormsSpec(m=8, bits=8))
    tc, trep = tforms.compress_tree(tp, tforms.FormsSpec(m=8, bits=8))
    return jc, jrep, tc, trep


def _rng_inputs(b, s, h, dk, dv, seed, fast_decay=False):
    rng = np.random.RandomState(seed)
    q, k = rng.normal(size=(2, b, s, h, dk)).astype(np.float32)
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    pre = rng.normal(size=(b, s, h)).astype(np.float32) * (8.0 if fast_decay else 1.0)
    log_a = -np.logaddexp(0.0, -pre) - (20.0 if fast_decay else 0.0)    # log sigmoid, <= 0
    gate = 1.0 / (1.0 + np.exp(-rng.normal(size=(b, s, h)))).astype(np.float32)
    state = rng.normal(size=(b, h, dk, dv)).astype(np.float32)
    return [a.astype(np.float32) for a in (q, k, v, log_a, gate, state)]


def test_config_is_the_references_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_config(ARCH))
    assert dataclasses.asdict(get_reduced(ARCH)) == dataclasses.asdict(jax_reduced(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.hd(), cfg.vocab_size,
            cfg.slstm_every) == (24, 1024, 4, 256, 50304, 8)
    assert cfg.subquadratic


@pytest.mark.parametrize("s,chunk,init,width", [(12, 4, False, 4), (12, 4, True, 4),
                                                (12, 5, True, 12), (12, 128, False, 12),
                                                (7, 3, True, 7)])
def test_chunked_recurrence_matches_reference_and_stepwise_decode(s, chunk, init, width):
    """Several chunks (12 / 4), the ``s % w`` fallback to one chunk (12 / 5,
    7 / 3) and ``w = s`` (12 / 128), from zero or a carried state; the
    port's decode step, run token by token, gives the same outputs and the
    same final state."""
    assert TS.chunk_width(s, chunk) == width
    q, k, v, log_a, gate, state = _rng_inputs(2, s, 3, 4, 5, seed=s + chunk)
    st = state if init else None
    y, fs = TS.chunked_linear_recurrence(*map(torch.from_numpy, (q, k, v, log_a, gate)),
                                         init_state=None if st is None else torch.from_numpy(st),
                                         chunk=chunk)
    jy, jfs = JS.chunked_linear_recurrence(*map(jnp.asarray, (q, k, v, log_a, gate)),
                                           init_state=None if st is None else jnp.asarray(st),
                                           chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fs.numpy(), np.asarray(jfs), rtol=1e-5, atol=1e-5)
    cur = torch.zeros_like(fs) if st is None else torch.from_numpy(st.copy())
    steps = []
    for t in range(s):
        yt, cur = TS.recurrence_decode_step(*(torch.from_numpy(a[:, t]) for a in
                                              (q, k, v, log_a, gate)), cur)
        steps.append(yt)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cur.numpy(), fs.numpy(), rtol=1e-5, atol=1e-5)
    # in place: the new state lands in the buffer it was read from
    buf = torch.from_numpy(state.copy())
    want = TS.recurrence_decode_step(*(torch.from_numpy(a[:, 0]) for a in
                                       (q, k, v, log_a, gate)), buf.clone())
    got = TS.recurrence_decode_step(*(torch.from_numpy(a[:, 0]) for a in
                                      (q, k, v, log_a, gate)), buf, out=buf)
    assert got[1] is buf and torch.equal(buf, want[1]) and torch.equal(got[0], want[0])


def test_chunked_recurrence_bf16_values_and_fast_decay_gradient():
    """bf16 values: each chunk's output is rounded to bf16, the state stays
    f32.  Fast decay (log_a down to about -100): the decay is masked before
    its exp, so the gradient is finite and matches the reference's."""
    q, k, v, log_a, gate, _ = _rng_inputs(1, 16, 2, 4, 3, seed=3, fast_decay=True)
    y, fs = TS.chunked_linear_recurrence(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v).to(torch.bfloat16),
                                         torch.from_numpy(log_a), torch.from_numpy(gate),
                                         chunk=8)
    assert y.dtype == torch.bfloat16 and fs.dtype == torch.float32
    jy, _ = JS.chunked_linear_recurrence(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v).astype(jnp.bfloat16),
                                         jnp.asarray(log_a), jnp.asarray(gate), chunk=8)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    la = torch.from_numpy(log_a).requires_grad_(True)
    out, _ = TS.chunked_linear_recurrence(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), la, torch.from_numpy(gate),
                                          chunk=8)
    (g,) = torch.autograd.grad(out.square().sum(), la)
    jg = jax.grad(lambda a: jnp.sum(jnp.square(JS.chunked_linear_recurrence(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), a, jnp.asarray(gate),
        chunk=8)[0])))(jnp.asarray(log_a))
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4)


def test_forward_matches_reference_and_remat_is_exact():
    jm, jp, tm, tp = models()
    toks = np.random.RandomState(0).randint(0, 256, (2, 12)).astype(np.int32)
    with torch.inference_mode():
        got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
        hid, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, return_hidden=True)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert aux == {} and hid.shape == (2, 12, 64)
    assert isinstance(tp["blocks"], list) and "slstm" in tp["blocks"][0] \
        and "mlstm" in tp["blocks"][1]
    # remat recomputes each block in the backward pass: the same numbers
    live = [t.clone().requires_grad_(True) for t in paths.leaves(tp)]
    outs = []
    for remat in (False, True):
        tree = paths.rebuild(tp, dict(zip((p for p, _ in paths.iter_leaves(tp)), live)))
        lg, _ = tm.forward(tree, {"tokens": torch.from_numpy(toks)}, remat=remat)
        outs.append((lg.detach(), torch.autograd.grad(lg.square().mean(), live)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) and bool(torch.isfinite(a).all())
               for a, b in zip(outs[0][1], outs[1][1]))


def test_prefill_matches_stepwise_decode_and_reference():
    """As the reference's ``test_prefill_matches_stepwise_all_families``:
    the exact-length prefill of slot 1 of 2 against stepwise decode, and
    both against the reference's.  The cache: an f32 (B, H, dk, dk+1)
    matrix per mLSTM layer, three distinct (B, d) f32 buffers per sLSTM."""
    jm, jp, tm, tp = models()
    cache = tm.init_cache(2, 16)
    assert cache["layer1"].shape == (2, 2, 32, 33) and cache["layer1"].dtype == torch.float32
    c, n, h = cache["layer0"]
    assert c.shape == (2, 64) and c.data_ptr() != n.data_ptr() != h.data_ptr()
    prompt = np.array([5, 9, 2, 7, 1], np.int32)
    with torch.inference_mode():
        pre, step = prefill_and_stepwise(tm, tp, prompt, torch.from_numpy)
    np.testing.assert_allclose(pre, step, atol=1e-4)
    jpre, jstep = prefill_and_stepwise(jm, jp, prompt, jnp.asarray)
    np.testing.assert_allclose(pre, jpre, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(step, jstep, rtol=1e-4, atol=1e-4)


def test_prefill_overwrites_the_slot_and_decode_advances_every_slot():
    """A reused slot is clean after its prefill; decode advances every
    slot's state, live or not, as the reference's."""
    _, _, tm, tp = models()
    with torch.inference_mode():
        cache = tm.init_cache(2, 16)
        for key, leaf in cache.items():
            for t in (leaf if isinstance(leaf, tuple) else (leaf,)):
                t.fill_(3.0)
        lg, cache = tm.prefill(tp, torch.tensor([[4, 8, 15]], dtype=torch.int32), cache, 0, 3)
        fresh = tm.init_cache(2, 16)
        lg2, fresh = tm.prefill(tp, torch.tensor([[4, 8, 15]], dtype=torch.int32), fresh, 0, 3)
        assert torch.equal(lg, lg2)
        assert torch.equal(cache["layer1"][0], fresh["layer1"][0])
        assert torch.equal(cache["layer0"][2][0], fresh["layer0"][2][0])
        before = cache["layer1"][1].clone()
        tm.decode_step(tp, torch.tensor([[1], [2]], dtype=torch.int32), cache,
                       torch.tensor([3, 0], dtype=torch.int32))
        assert not torch.equal(cache["layer1"][1], before)


def test_compress_tree_code_for_code_with_the_list():
    jc, jrep, tc, trep = compressed()
    assert isinstance(tc["blocks"], list) and len(tc["blocks"]) == 4
    assert list(trep.errors) == list(jrep.errors)
    assert (trep.num_compressed, trep.num_skipped) == (jrep.num_compressed, jrep.num_skipped)
    tpaths, jpaths = tforms.compressed_paths(tc), jforms.compressed_paths(jc)
    assert list(tpaths) == list(jpaths)
    assert "blocks/1/mlstm/wi" in tpaths and tpaths["blocks/1/mlstm/wi"].n == 2
    for r in ("rz", "ri", "rf", "ro", "bf", "norm"):
        assert isinstance(tc["blocks"][0]["slstm"][r], torch.Tensor), r
    for p, leaf in tpaths.items():
        want = jpaths[p]
        for f in ("mags", "signs", "scale"):
            np.testing.assert_array_equal(getattr(leaf, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f"{p}/{f}")
        assert (leaf.k, leaf.m, leaf.bits) == (want.k, want.m, want.bits)
    back = tforms.decompress_tree(tc)
    assert isinstance(back["blocks"], list)
    np.testing.assert_allclose(back["blocks"][3]["mlstm"]["wq"].numpy(),
                               np.asarray(jforms.decompress_tree(jc)["blocks"][3]["mlstm"]["wq"]),
                               rtol=1e-6, atol=1e-7)


def test_list_walk_order_is_the_references_flatten_order():
    """Twelve blocks: ``blocks/10`` and ``blocks/11`` come after
    ``blocks/9`` (a sort of the rendered paths would put them after
    ``blocks/1``), in ``iter_leaves``, ``leaves``, ``rebuild`` and
    ``tree_map``; the bridge keeps the list."""
    _, jp, _, tp = models(12)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    want = [jax_path_str(p) for p, _ in flat]
    got = [p for p, _ in paths.iter_leaves(tp)]
    assert got == want and got.index("blocks/10/slstm/bf") > got.index("blocks/9/mlstm/wv")
    assert all(np.array_equal(a.numpy(), np.asarray(b))
               for a, b in zip(paths.leaves(tp), jax.tree_util.tree_leaves(jp)))
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 12
    doubled = paths.tree_map(lambda t: t * 2, tp)
    assert isinstance(doubled["blocks"], list)
    again = paths.rebuild(tp, {p: leaf for p, leaf in paths.iter_leaves(doubled)})
    assert torch.equal(again["blocks"][11]["mlstm"]["wq"], 2 * tp["blocks"][11]["mlstm"]["wq"])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_list_tree_checkpoint_cross_reads(tmp_path, writer):
    """The compressed list tree saved by either package restores in the
    other, the list intact, every plane bit for bit."""
    jc, _, tc, _ = compressed()
    template, _ = tforms.compress_tree(models()[2].init(1), tforms.FormsSpec(m=8, bits=8))
    if writer == "reference":
        jckpt.save(str(tmp_path), jc, step=4)
        got, step = tckpt.restore(str(tmp_path), template)
        assert step == 4 and isinstance(got["blocks"], list)
        want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jc)]
        assert len(tckpt.tree_leaves(got)) == len(want)
        assert all(np.array_equal(a.numpy(), b) for a, b in zip(tckpt.tree_leaves(got), want))
    else:
        tckpt.save(str(tmp_path), tc, step=4)
        got, step = jckpt.restore(str(tmp_path), jc)
        assert step == 4 and isinstance(got["blocks"], list)
        want = [x.numpy() for x in tckpt.tree_leaves(tc)]
        assert all(np.array_equal(np.asarray(a), b)
                   for a, b in zip(jax.tree_util.tree_leaves(got), want))


def test_inject_tree_on_the_list_tree_equals_reference():
    """The fault injector walks the list in the reference's order and draws
    the same faults, code for code; ``paths=`` takes a list path."""
    _, _, tc, _ = compressed()
    jc = port_to_jax(tc)
    kw = dict(sigma=0.2, t=3.0, p_stuck_on=0.01, p_stuck_off=0.01, p_sign_stuck=0.05, seed=7)
    tout, trep = TR.inject_tree(tc, TR.FaultModel(**kw))
    jout, jrep = JR.inject_tree(jc, JR.FaultModel(**kw))
    assert list(trep.leaves) == list(jrep.leaves) and trep.summary() == jrep.summary()
    assert isinstance(tout["blocks"], list)
    jleaves = jforms.compressed_paths(jout)
    for p, leaf in tforms.compressed_paths(tout).items():
        for f in ("mags", "signs"):
            np.testing.assert_array_equal(getattr(leaf, f).numpy(),
                                          np.asarray(getattr(jleaves[p], f)), err_msg=p)
    out, rep = TR.inject_tree(tc, TR.FaultModel(p_stuck_on=0.1, seed=2),
                              paths=["blocks/3/mlstm/wf"])
    assert list(rep.leaves) == ["blocks/3/mlstm/wf"]
    assert out["blocks"][1]["mlstm"]["wq"] is tc["blocks"][1]["mlstm"]["wq"]


def test_greedy_tokens_equal_the_reference_engine_on_the_dense_fallback():
    """``page_size`` asked for, the dense slot cache serves (no paged path),
    exact-length prefill; the tokens equal the reference engine's on the
    same codes."""
    jm, _, tm, _ = models()
    _, _, tc, _ = compressed()
    kw = dict(max_len=32, batch_slots=2, forms=True, page_size=8)
    jeng = JEngine(jm, port_to_jax(tc), **kw)
    want = result_tokens(jeng.run(engine_requests(JRequest)))
    eng = TEngine(tm, tc, device="cpu", **kw)
    assert not eng.paged and not jeng.paged and eng.page_allocator is None
    assert not tm.supports_paged and not tm.padded_prefill
    assert eng.runner.bucket_for(5) == 5
    got = result_tokens(eng.run(engine_requests(TRequest)))
    assert got == want and all(len(v) == 6 for v in got.values())
    # two mLSTM layers of (2, 2, 32, 33) f32, two sLSTM layers of 3 x (2, 64)
    assert eng.cache_bytes() == 2 * (2 * 2 * 32 * 33 * 4) + 2 * (3 * 2 * 64 * 4)


def test_speculation_falls_back_and_slo_is_refused():
    """As the reference's ``test_speculative_falls_back_for_recurrent_families``
    and ``test_fleet_rejects_recurrent_families``."""
    _, _, tm, tp = models()
    eng = TEngine(tm, tp, max_len=32, batch_slots=2, page_size=8, speculate=True,
                  device="cpu")
    assert not eng.speculative and not eng.paged
    res = eng.run([TRequest(uid=i, prompt=np.array([3, 4, 5 + i]), max_new_tokens=6)
                   for i in range(2)])
    assert all(len(r.tokens) == 6 for r in res)
    with pytest.raises(ValueError, match="paged"):
        TEngine(tm, tp, max_len=32, batch_slots=2, page_size=4, slo={"prefill_chunk": 4},
                device="cpu")
