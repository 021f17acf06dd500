"""PyTorch port vs the JAX package: Zamba2 (Mamba2 + one shared attention
block) on the chunked linear recurrence, served on the dense slot cache.

The reduced zamba2-2.7b (4 Mamba2 blocks in 2 groups, each followed by the
shared block; d_model 64, d_in 128 in 8 SSM heads of 16, state 16, 4
attention heads of 16, d_ff 128, vocab 256) in float32 from the
reference's init weights carried across through numpy.  Tolerances:

* ``causal_conv1d`` within 1e-6 (f32) of the reference's, with and without
  a carried state;
* ``forward`` within 1e-5; ``forward(remat=True)`` equal to ``forward``
  bit for bit, its gradients too;
* prefill against stepwise decode on one slot of a 2-slot f32 cache, both
  against the reference's, and a decode step with per-slot positions
  against the reference's on the same cache (logits and every cache leaf),
  within 1e-4;
* ``compress_tree`` code for code on the stacked ``in_proj``/``out_proj``
  leaves (conv and SSM parameters stay dense); greedy engine tokens equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import forms as jforms
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import ssm_common as JS
from repro.models.registry import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import forms as tforms
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import paths
from repro_torch.launch import serve as tserve
from repro_torch.models import ssm_common as TS
from repro_torch.models import zamba as TZ
from repro_torch.models.registry import build as torch_build
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

from torch_parity_util import (engine_requests, port_to_jax, prefill_and_stepwise,
                               result_tokens, to_numpy)

ARCH = "zamba2-2.7b"
DENSE_SSM = ("norm", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "gate_norm")


@functools.lru_cache(maxsize=None)
def models():
    """(jax model, jax params, port model, port params): the reference's
    init at PRNGKey(0), float32, carried across; the zero-initialized conv
    bias and dt bias get small random values, so they count."""
    jm = jax_build(dataclasses.replace(jax_reduced(ARCH), dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    blocks = dict(jp["blocks"])
    for name in ("conv_b", "dt_bias"):
        blocks[name] = jnp.asarray(rng.normal(0, 0.3, blocks[name].shape).astype(np.float32))
    jp = {**jp, "blocks": blocks}
    tm = torch_build(dataclasses.replace(get_reduced(ARCH), dtype="float32"), device="cpu")
    return jm, jp, tm, params_from_numpy(to_numpy(jp), device="cpu")


@functools.lru_cache(maxsize=None)
def compressed():
    _, jp, _, tp = models()
    jc, jrep = jforms.compress_tree(jp, jforms.FormsSpec(m=8, bits=8))
    tc, trep = tforms.compress_tree(tp, tforms.FormsSpec(m=8, bits=8))
    return jc, jrep, tc, trep


def test_config_is_the_references_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_config(ARCH))
    assert dataclasses.asdict(get_reduced(ARCH)) == dataclasses.asdict(jax_reduced(ARCH))
    cfg = get_config(ARCH)
    d_in, heads = TZ._dims(cfg)
    assert (cfg.num_layers, cfg.d_model, d_in, heads, cfg.ssm_state) == (54, 2560, 5120, 80, 64)
    assert 2 * d_in + 2 * cfg.ssm_state + heads == 10448
    assert TZ._groups(cfg) == (9, 6) and cfg.subquadratic


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv1d_matches_reference(dtype, carried):
    rng = np.random.RandomState(2)
    x, w, b = (rng.normal(size=sh).astype(np.float32) for sh in ((2, 9, 6), (4, 6), (6,)))
    state = rng.normal(size=(2, 3, 6)).astype(np.float32) if carried else None
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y, ns = TS.causal_conv1d(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                             torch.from_numpy(b).to(tdt),
                             None if state is None else torch.from_numpy(state).to(tdt))
    jy, jns = JS.causal_conv1d(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
                               jnp.asarray(b).astype(jdt),
                               None if state is None else jnp.asarray(state).astype(jdt))
    assert y.dtype == tdt and ns.shape == (2, 3, 6)
    tol = 1e-6 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_array_equal(ns.float().numpy(), np.asarray(jns.astype(jnp.float32)))
    # the conv state is the last K-1 inputs: decoding token by token from it
    # gives the full-sequence output
    cur = None if state is None else torch.from_numpy(state).to(tdt)
    outs = []
    for t in range(9):
        yt, cur = TS.causal_conv1d(torch.from_numpy(x[:, t:t + 1]).to(tdt),
                                   torch.from_numpy(w).to(tdt), torch.from_numpy(b).to(tdt), cur)
        outs.append(yt)
    assert torch.equal(torch.cat(outs, 1), y) and torch.equal(cur, ns)


def test_softplus_differs_from_jax_only_past_its_threshold():
    """``F.softplus`` turns into the identity above 20, JAX's is
    ``logaddexp(x, 0)``: they differ by less than e^-20 there."""
    x = np.linspace(-30, 40, 701).astype(np.float32)
    got = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    assert np.max(np.abs(got - want)) <= np.exp(-20.0) + 4e-6


def test_forward_matches_reference_and_remat_is_exact():
    jm, jp, tm, tp = models()
    assert {p: tuple(t.shape) for p, t in paths.iter_leaves(tm.init(0))} == \
        {p: tuple(t.shape) for p, t in paths.iter_leaves(tp)}
    assert tp["blocks"]["in_proj"].shape == (4, 64, 2 * 128 + 2 * 16 + 8)
    toks = np.random.RandomState(0).randint(0, 256, (2, 12)).astype(np.int32)
    with torch.inference_mode():
        got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert aux == {}
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
    """As the reference's ``test_prefill_matches_stepwise_all_families``.
    The cache: ``ssm`` f32, ``conv`` in the cache dtype, per-group K/V."""
    jm, jp, tm, tp = models()
    cache = tm.init_cache(2, 16)
    assert cache["ssm"].shape == (4, 2, 8, 16, 16) and cache["ssm"].dtype == torch.float32
    assert cache["conv"].shape == (4, 2, 3, 128) and cache["conv"].dtype == torch.bfloat16
    assert cache["attn_k"].shape == (2, 2, 16, 4, 16)
    prompt = np.array([5, 9, 2, 7, 1], np.int32)
    with torch.inference_mode():
        pre, step = prefill_and_stepwise(tm, tp, prompt, torch.from_numpy)
    np.testing.assert_allclose(pre, step, atol=1e-4)
    jpre, jstep = prefill_and_stepwise(jm, jp, prompt, jnp.asarray)
    np.testing.assert_allclose(pre, jpre, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(step, jstep, rtol=1e-4, atol=1e-4)


def test_decode_with_per_slot_positions_matches_reference():
    """Two slots prefilled with prompts of other lengths, then one decode
    step at positions (5, 2): the logits and every cache leaf equal the
    reference's, and each slot's new K/V lands at its own position."""
    jm, jp, tm, tp = models()
    prompts = [np.array([3, 1, 4, 1, 5], np.int32), np.array([9, 2], np.int32)]
    cache = tm.init_cache(2, 16, dtype=torch.float32)
    jcache = jm.init_cache(2, 16, dtype=jnp.float32)
    with torch.inference_mode():
        for slot, p in enumerate(prompts):
            tm.prefill(tp, torch.from_numpy(p[None]), cache, slot, len(p))
            _, jcache = jm.prefill(jp, jnp.asarray(p[None]), jcache, slot, len(p))
        toks = np.array([[7], [8]], np.int32)
        pos = np.array([5, 2], np.int32)
        lg, cache = tm.decode_step(tp, torch.from_numpy(toks), cache, torch.from_numpy(pos))
    jlg, jcache = jm.decode_step(jp, jnp.asarray(toks), jcache, jnp.asarray(pos))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=1e-4, atol=1e-4)
    for name in cache:
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    k = cache["attn_k"]
    assert float(k[:, 0, 5].abs().sum()) > 0 and float(k[:, 1, 2].abs().sum()) > 0
    assert float(k[:, 0, 6:].abs().sum()) == 0 and float(k[:, 1, 3:].abs().sum()) == 0


def test_compress_tree_code_for_code_on_the_stacked_leaves():
    jc, jrep, tc, trep = compressed()
    assert list(trep.errors) == list(jrep.errors)
    assert (trep.num_compressed, trep.num_skipped) == (jrep.num_compressed, jrep.num_skipped)
    tpaths, jpaths = tforms.compressed_paths(tc), jforms.compressed_paths(jc)
    assert list(tpaths) == list(jpaths)
    assert tpaths["blocks/in_proj"].mags.shape == (4, 64, 296)
    assert "shared_attn/mlp/down" in tpaths and "head" in tpaths
    for name in DENSE_SSM:
        assert isinstance(tc["blocks"][name], torch.Tensor), name
    for p, leaf in tpaths.items():
        for f in ("mags", "signs", "scale"):
            np.testing.assert_array_equal(getattr(leaf, f).numpy(),
                                          np.asarray(getattr(jpaths[p], f)), err_msg=f"{p}/{f}")
    # one layer of a stacked leaf is what a decode step multiplies with
    layer = tpaths["blocks/out_proj"].layer(2)
    np.testing.assert_allclose(tforms.to_dense(layer).numpy(),
                               np.asarray(jforms.to_dense(jpaths["blocks/out_proj"]))[2],
                               rtol=1e-6, atol=1e-7)


def test_greedy_tokens_equal_the_reference_engine_on_the_dense_fallback():
    jm, _, tm, _ = models()
    _, _, tc, _ = compressed()
    kw = dict(max_len=32, batch_slots=2, forms=True, page_size=8)
    jeng = JEngine(jm, port_to_jax(tc), **kw)
    want = result_tokens(jeng.run(engine_requests(JRequest)))
    eng = TEngine(tm, tc, device="cpu", **kw)
    assert not eng.paged and not jeng.paged and not tm.supports_paged
    assert set(eng.cache) == {"ssm", "conv", "attn_k", "attn_v"}
    assert eng.cache_bytes() == sum(t.numel() * t.element_size() for t in eng.cache.values())
    got = result_tokens(eng.run(engine_requests(TRequest)))
    assert got == want and all(len(v) == 6 for v in got.values())


def test_speculation_falls_back_and_slo_is_refused():
    _, _, tm, tp = models()
    eng = TEngine(tm, tp, max_len=32, batch_slots=2, page_size=8, speculate=True,
                  device="cpu")
    assert not eng.speculative and not eng.paged
    res = eng.run([TRequest(uid=i, prompt=np.array([3, 4, 5 + i]), max_new_tokens=6)
                   for i in range(2)])
    assert all(len(r.tokens) == 6 for r in res)
    with pytest.raises(ValueError, match="paged"):
        TEngine(tm, tp, max_len=32, batch_slots=2, page_size=8, slo={"prefill_chunk": 4},
                device="cpu")


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-2.7b"])
def test_launcher_notes_the_dense_fallback_and_refuses_slo_flags(arch, capsys):
    """As the reference's launcher: the paged cache asked for (the default
    --page-size 16) falls back with a note, and an SLO flag exits."""
    tserve.main(["--arch", arch, "--reduced", "--forms", "--device", "cpu", "--requests", "2",
                 "--max-new-tokens", "4", "--max-len", "32", "--speculate"])
    out = capsys.readouterr().out
    family = get_reduced(arch).family
    assert f"paged cache: unsupported for family {family!r}" in out
    assert "dense slot cache: 4 slots x 32 rows" in out and "2 requests, 8 tokens" in out
    assert "speculate: unsupported on the dense cache" in out
    with pytest.raises(SystemExit, match="no paged path"):
        tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--prefill-chunk", "8"])
