"""PyTorch port vs the JAX package: whisper-small's encoder-decoder.

The reduced whisper-small (2 encoder and 2 decoder layers, d_model 64, 4
heads of 16, d_ff 128, vocab 256) in float32 from the reference's init
weights carried across through numpy.  Tolerances:

* LayerNorm, the tanh-GELU MLP, ``encode`` and ``forward`` within 1e-5:
  the same f32 products, summed in other orders;
* prefill against stepwise decode on an f32 cache with ``enc_out =
  encode(frames)`` written by hand, as the reference's own test does, and
  both against the reference's, within 1e-4;
* greedy tokens equal: the reference's engine and the port's paged and
  dense ones, on the port's FORMS tree, against the zero encoder context
  both engines serve (neither fills ``enc_out``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import layers as JL
from repro.models import whisper as JW
from repro.models.registry import build as jax_build
from repro.serving import speculate as JSP
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import forms as tforms
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import layers as TL
from repro_torch.models import whisper as TW
from repro_torch.models.registry import build as torch_build
from repro_torch.serving import kv_cache as TKV
from repro_torch.serving import speculate as TSP
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

from torch_parity_util import _jax_leaf, to_numpy

ARCH = "whisper-small"


@functools.lru_cache(maxsize=None)
def models():
    """(jax model, jax params, port model, port params): the reference's
    init at PRNGKey(0), float32, carried across; the zero-initialized
    biases and norm shifts get small random values, so they count."""
    jm = jax_build(dataclasses.replace(jax_reduced(ARCH), dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)

    def jitter(tree, name=""):
        if isinstance(tree, dict):
            return {k: jitter(v, k) for k, v in tree.items()}
        if name in ("bias", "b_up", "b_down"):
            return jnp.asarray(rng.normal(0, 0.05, tree.shape).astype(np.float32))
        return tree

    jp = jitter(jp)
    tm = torch_build(dataclasses.replace(get_reduced(ARCH), dtype="float32"), device="cpu")
    return jm, jp, tm, params_from_numpy(to_numpy(jp), device="cpu")


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tforms.FormsLinearParams):
        return _jax_leaf(tree)
    return jnp.asarray(tree.numpy())


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in _shapes(v, f"{prefix}/{k}").items()}
    return {prefix: tuple(tree.shape)}


def _frames(b, s, d, seed=2):
    return np.random.RandomState(seed).normal(size=(b, s, d)).astype(np.float32)


def test_config_is_the_references_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_config(ARCH))
    assert dataclasses.asdict(get_reduced(ARCH)) == dataclasses.asdict(jax_reduced(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.encoder_layers, cfg.d_model, cfg.num_heads, cfg.d_ff,
            cfg.vocab_size) == (12, 12, 768, 12, 3072, 51865)


def test_layernorm_and_tanh_gelu_mlp_match_reference():
    rng = np.random.RandomState(0)
    x = rng.normal(1.0, 2.0, (3, 5, 64)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, 64).astype(np.float32),
         "bias": rng.normal(0, 0.1, 64).astype(np.float32)}
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = TL.layernorm(torch.from_numpy(x).to(tdt), {k: torch.from_numpy(v)
                                                          for k, v in p.items()})
        want = JL.layernorm(jnp.asarray(x).astype(jdt), {k: jnp.asarray(v) for k, v in p.items()})
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=1e-5, atol=1e-5 if tdt == torch.float32 else 1e-2)
    mlp = {"up": rng.normal(0, 0.3, (64, 128)), "down": rng.normal(0, 0.1, (128, 64)),
           "b_up": rng.normal(0, 0.5, 128), "b_down": rng.normal(0, 0.5, 64)}
    mlp = {k: v.astype(np.float32) for k, v in mlp.items()}
    got = TL.gelu_mlp({k: torch.from_numpy(v) for k, v in mlp.items()}, torch.from_numpy(x),
                      torch.float32)
    want = JL.gelu_mlp({k: jnp.asarray(v) for k, v in mlp.items()}, jnp.asarray(x), jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # jax.nn.gelu's default is the tanh form, which differs from the erf form
    h = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(torch.nn.functional.gelu(h, approximate="tanh").numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(h.numpy()))), atol=1e-6)
    assert (torch.nn.functional.gelu(h) - torch.nn.functional.gelu(h, approximate="tanh")
            ).abs().max() > 1e-4


def test_encode_and_forward_match_reference():
    jm, jp, tm, tp = models()
    cfg = tm.config
    assert _shapes(tm.init(0)) == _shapes(tp)
    frames = _frames(2, 20, cfg.d_model)
    toks = np.random.RandomState(0).randint(0, 256, (2, 12)).astype(np.int32)
    with torch.inference_mode():
        enc = TW.encode(cfg, tp, torch.from_numpy(frames))
        got, aux = tm.forward(tp, {"frames": torch.from_numpy(frames),
                                   "tokens": torch.from_numpy(toks)})
    want_enc = JW.encode(jm.config, jp, jnp.asarray(frames))
    want, _ = jm.forward(jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert aux == {} and got.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(TW.sinusoidal_positions(9, 64).numpy(),
                               np.asarray(JW.sinusoidal_positions(9, 64)), atol=1e-6)


def test_dense_leaf_carried_through_the_page_functions():
    """``PagedKVCache.dense`` (the slot-addressed encoder output) passes
    the page gather, both commits and the rollback unchanged, and counts
    in ``nbytes``."""
    _, _, tm, _ = models()
    cache = tm.init_paged_cache(5, 4, 2, 16)
    enc = torch.randn(2, 16, 64)
    cache.dense["enc_out"].copy_(enc)
    pool_bytes = sum(t.numel() * t.element_size() for t in cache.pool.values())
    assert cache.nbytes() == pool_bytes + 2 * 16 * 64 * 2
    table = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]], dtype=torch.int32)
    assert set(TKV.gather_views(cache, table)) == {"k", "v"}
    rows = {n: torch.ones((2, 1, 6, 4, 16)) for n in ("k", "v")}
    cache = TKV.commit_pages(cache, rows, torch.tensor([1, 2], dtype=torch.int32))
    toks = {n: torch.ones((2, 2, 3, 4, 16)) for n in ("k", "v")}
    pos = torch.tensor([6, 1], dtype=torch.int32)
    cache = TKV.commit_tokens(cache, toks, table, pos)
    cache = TKV.rollback_tokens(cache, table, pos, torch.tensor([1, 2], dtype=torch.int32), 3)
    assert torch.equal(cache.dense["enc_out"], enc.to(torch.bfloat16))
    assert float(cache.pool["k"][:, 2, 2].abs().sum()) > 0          # pos 6, kept
    assert float(cache.pool["k"][:, 2, 3].abs().sum()) == 0         # pos 7, rolled back


def _prefill_and_stepwise(model, params, enc_out, prompt, to, slot=1, slots=2, max_len=16):
    """(prefill logits, stepwise decode's last logits) of ``prompt`` at
    ``slot`` of an f32 dense cache holding ``enc_out``, either package."""
    f32 = torch.float32 if to is torch.from_numpy else jnp.float32
    results = []
    for stepwise in (False, True):
        cache = model.init_cache(slots, max_len, dtype=f32)
        if to is torch.from_numpy:
            cache["enc_out"].copy_(torch.from_numpy(enc_out))
        else:
            cache["enc_out"] = jnp.asarray(enc_out)
        if not stepwise:
            toks = np.zeros((1, 8), np.int32)
            toks[0, :len(prompt)] = prompt
            lg, _ = model.prefill(params, to(toks), cache, slot, len(prompt))
            results.append(np.asarray(lg[0]))
            continue
        pos = np.zeros(slots, np.int32)
        for t in prompt:
            tb = np.zeros((slots, 1), np.int32)
            tb[slot, 0] = t
            lg, cache = model.decode_step(params, to(tb), cache, to(pos.copy()))
            pos[slot] += 1
        results.append(np.asarray(lg[slot, 0]))
    return results


def test_prefill_matches_stepwise_decode_with_the_encoder_output():
    """As the reference's ``test_prefill_matches_stepwise_all_families``:
    ``encode(frames)`` written into ``enc_out`` by hand, the padded
    prefill against stepwise decode, and both against the reference's."""
    jm, jp, tm, tp = models()
    cfg = tm.config
    frames = _frames(2, 16, cfg.d_model)
    prompt = np.array([5, 9, 2, 7, 1], np.int32)
    with torch.inference_mode():
        enc = TW.encode(cfg, tp, torch.from_numpy(frames)).numpy()
        pre, step = _prefill_and_stepwise(tm, tp, enc, prompt, torch.from_numpy)
    np.testing.assert_allclose(pre, step, atol=1e-4)
    jenc = np.asarray(JW.encode(jm.config, jp, jnp.asarray(frames)))
    np.testing.assert_allclose(enc, jenc, rtol=1e-5, atol=1e-5)
    jpre, jstep = _prefill_and_stepwise(jm, jp, jenc, prompt, jnp.asarray)
    np.testing.assert_allclose(pre, jpre, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(step, jstep, rtol=1e-4, atol=1e-4)


def _requests(cls, n=3, new=6):
    rng = np.random.RandomState(0)
    return [cls(uid=i, prompt=rng.randint(0, 256, rng.randint(3, 12)), max_new_tokens=new)
            for i in range(n)]


def _tokens(results):
    return {r.uid: list(r.tokens) for r in results}


def test_greedy_tokens_paged_dense_and_reference_are_equal():
    jm, _, tm, tp = models()
    tc, _ = tforms.compress_tree(tp, tforms.FormsSpec(m=8, bits=8))
    assert "frame_proj" in tforms.compressed_paths(tc)
    assert "dec_blocks/xattn/wk" in tforms.compressed_paths(tc)
    kw = dict(max_len=32, batch_slots=2, forms=True)
    want = _tokens(JEngine(jm, _to_jax(tc), page_size=8, **kw).run(_requests(JRequest)))
    paged = TEngine(tm, tc, device="cpu", page_size=8, **kw)
    assert paged.cache.dense["enc_out"].shape == (2, 32, tm.config.d_model)
    assert float(paged.cache.dense["enc_out"].abs().sum()) == 0
    got = _tokens(paged.run(_requests(TRequest)))
    assert got == want and all(len(v) == 6 for v in got.values())
    dense = TEngine(tm, tc, device="cpu", page_size=0, **kw)
    assert set(dense.cache) == {"k", "v", "enc_out"}
    assert _tokens(dense.run(_requests(TRequest))) == want
    # an encoder context written by hand into both engines' caches, as the
    # reference's tests write it: the same tokens again, and other ones
    with torch.inference_mode():
        enc = TW.encode(tm.config, tc, torch.from_numpy(_frames(2, 32, tm.config.d_model)))
    jeng = JEngine(jm, _to_jax(tc), page_size=8, **kw)
    jeng.cache = dataclasses.replace(
        jeng.cache, dense={"enc_out": jnp.asarray(enc.numpy()).astype(jnp.bfloat16)})
    teng = TEngine(tm, tc, device="cpu", page_size=8, **kw)
    teng.cache.dense["enc_out"].copy_(enc)
    heard = _tokens(jeng.run(_requests(JRequest)))
    assert _tokens(teng.run(_requests(TRequest))) == heard != want


def test_skip_layers_slices_the_decoder_blocks():
    jm, jp, tm, tp = models()
    jdm, jdp = JSP.skip_layers(jm, jp, 2)
    tdm, tdp = TSP.skip_layers(tm, tp, 2)
    assert tdm.config.num_layers == jdm.config.num_layers == 1
    assert tdm.config.encoder_layers == jdm.config.encoder_layers == 2
    assert _shapes(tdp) == _shapes(to_numpy(jdp))
    assert tdp["dec_blocks"]["attn"]["wq"].shape[0] == 1
    assert tdp["enc_blocks"] is tp["enc_blocks"]
    np.testing.assert_array_equal(tdp["dec_blocks"]["xattn"]["wv"].numpy(),
                                  np.asarray(jdp["dec_blocks"]["xattn"]["wv"]))
