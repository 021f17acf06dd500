"""PyTorch port vs the JAX package: reduced-qwen2 logits.

Both packages hold the same weights (bridged from numpy) and see the same
tokens.  ``forward``, ``prefill_paged`` and ``decode_paged`` logits agree at
rtol/atol 1e-5 in float32, on the dense tree and on the FORMS tree.  The
paged cache is bf16 even at float32 (as in the reference), so a K/V row
whose float32 value differs in its last bit between the two packages can
round to a neighbouring bf16 value; one such flip moves later decode logits
by ~3e-5, and the decode steps are held at rtol/atol 1e-4.  In
bfloat16 both sides round activations at the same places but sum in other
orders, so a bf16 rounding step can differ: the bf16 check allows a few bf16
ulps of the logits (atol 3e-2 on logits of magnitude ~1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_util import models, shared_codes

F32_TOL = dict(rtol=1e-5, atol=1e-5)
F32_DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _trees(forms, dtype="float32"):
    jm, jp, tm, tp = models(dtype)
    if forms:
        jc, tc = shared_codes()
        return jm, jc, tm, tc
    return jm, jp, tm, tp


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("forms", [False, True], ids=["dense", "forms"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match(forms, dtype):
    jm, jp, tm, tp = _trees(forms, dtype)
    toks = np.random.RandomState(0).randint(0, 256, (2, 13)).astype(np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("forms", [False, True], ids=["dense", "forms"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_and_decode_match(forms, dtype):
    """Two slots prefilled into their pages, then three decode steps through
    the block tables: logits and the bf16 page pools agree."""
    jm, jp, tm, tp = _trees(forms, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    decode_tol = F32_DECODE_TOL if dtype == "float32" else BF16_TOL
    page, pages_total, max_len = 8, 9, 32
    jcache = jm.init_paged_cache(pages_total, page, 2, max_len)
    tcache = tm.init_paged_cache(pages_total, page)
    assert tcache.pool["k"].dtype == torch.bfloat16          # bf16 whatever cfg.dtype is
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 256, 11), rng.randint(0, 256, 5)]
    # one bucket for both prompts: the reference compiles one prefill
    buckets = [16, 16]
    dest = [np.array([1, 2], np.int32), np.array([3, 4], np.int32)]
    tables = np.array([[1, 2, 5, 0], [3, 4, 6, 0]], np.int32)
    first = []
    for slot, (p, b, d) in enumerate(zip(prompts, buckets, dest)):
        toks = np.zeros((1, b), np.int32)
        toks[0, :len(p)] = p
        jl, jcache = jm.prefill_paged(jp, jnp.asarray(toks), jcache, jnp.asarray(d),
                                      jnp.asarray(slot), jnp.asarray(len(p)))
        with torch.inference_mode():
            tl, tcache = tm.prefill_paged(tp, torch.from_numpy(toks), tcache,
                                          torch.from_numpy(d), slot, len(p))
        np.testing.assert_allclose(_np(tl), _np(jl), **tol)
        first.append(int(np.argmax(_np(jl)[0])))
    tok = np.array(first, np.int32)
    pos = np.array([len(p) for p in prompts], np.int32)
    for _ in range(3):
        jl, jcache = jm.decode_paged(jp, jnp.asarray(tok[:, None]), jcache,
                                     jnp.asarray(pos), jnp.asarray(tables))
        with torch.inference_mode():
            tl, tcache = tm.decode_paged(tp, torch.from_numpy(tok[:, None]), tcache,
                                         torch.from_numpy(pos), torch.from_numpy(tables))
        np.testing.assert_allclose(_np(tl), _np(jl), **decode_tol)
        tok = np.argmax(_np(jl)[:, 0], axis=-1).astype(np.int32)
        pos = pos + 1
    live = [1, 2, 3, 4, 5, 6]   # every page but scratch
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache.pool[name])[:, live],
                                   _np(jcache.pool[name])[:, live], rtol=2e-2, atol=2e-2)


def test_head_cast_copy_gives_the_same_logits():
    """The serving params hold the tied head once in the compute dtype; the
    logits are those of the per-call cast."""
    _, _, tm, tp = models("bfloat16")
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (1, 9)))
    served = tm.serving_params(tp)
    assert served["head_cast"].dtype == torch.bfloat16 and "head_cast" not in tp
    with torch.inference_mode():
        a, _ = tm.forward(tp, {"tokens": toks})
        b, _ = tm.forward(served, {"tokens": toks})
    assert torch.equal(a, b)


def test_forms_leaves_go_to_the_polarized_matmul_or_raise():
    """linear() hands every FORMS leaf to the polarized matmul (a stacked
    leaf raises instead of being decompressed), and wload() rebuilds a FORMS
    leaf densely only on the CPU."""
    from repro_torch.models import layers

    _, tc = shared_codes()
    attn = tc["blocks"]["attn"]
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 48).astype(np.float32))
    with pytest.raises(ValueError, match="2-D weight"):
        layers.linear(attn, "wq", x, torch.float32)
    one = {"wq": attn["wq"].layer(1)}
    dense = layers.wload(one, "wq", torch.float32)
    np.testing.assert_allclose(layers.linear(one, "wq", x, torch.float32).numpy(),
                               (x @ dense).numpy(), rtol=1e-5, atol=1e-5)
    leaf = one["wq"]
    on_meta = {"wq": type(leaf)(**{**vars(leaf), "mags": leaf.mags.to("meta"),
                                   "signs": leaf.signs.to("meta"),
                                   "scale": leaf.scale.to("meta")})}
    with pytest.raises(NotImplementedError, match="kernel"):
        layers.wload(on_meta, "wq", torch.float32)
