"""PyTorch port vs the JAX package: the dense family's other configs.

``h2o-danube-1.8b`` (sliding-window attention), ``qwen1.5-4b`` (MHA, QKV
bias, untied head) and ``yi-9b`` (GQA, untied head), each at its
``reduced()`` size in float32, from the reference's init weights bridged
through numpy, FORMS-compressed (the port's codes, handed to both packages
as ``torch_parity_util.shared_codes`` does): greedy paged tokens equal the
reference engine's.  h2o-danube's prompts run past its reduced window of
32, so the window masks rows in prefill and in decode, and the same
weights without the window give other logits.  The untied heads are FORMS
leaves served through ``forms.apply`` under the tag ``head``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models.registry import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import forms as tforms
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.models import layers as TL
from repro_torch.models.registry import build as torch_build
from repro_torch.serving import kv_cache as TKV
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

from torch_parity_util import _jax_leaf, to_numpy

ARCHS = ("h2o-danube-1.8b", "qwen1.5-4b", "yi-9b")
NEW = 8
COMMON = dict(max_len=64, batch_slots=2, page_size=8)


@functools.lru_cache(maxsize=None)
def trees(arch):
    """(jax model, jax FORMS tree, port model, port FORMS tree, port dense
    tree): the reference's init at float32, carried across, compressed by
    the port, and the same codes as reference leaves."""
    jcfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(tcfg, device="cpu")
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    tc, _ = tforms.compress_tree(tp, tforms.FormsSpec(m=8, bits=8))

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, tforms.FormsLinearParams):
            return _jax_leaf(t)
        return jnp.asarray(t.numpy())

    return jm, conv(tc), tm, tc, tp


def _requests(cls, arch, seed=0):
    """Two prompts; h2o-danube's are longer than its reduced window (32)."""
    rng = np.random.RandomState(seed)
    lo, hi = (36, 48) if arch.startswith("h2o") else (4, 12)
    return [cls(uid=i, prompt=rng.randint(0, 256, rng.randint(lo, hi)), max_new_tokens=NEW)
            for i in range(2)]


def _tokens(results):
    return {r.uid: list(r.tokens) for r in results}


def test_configs_are_the_references_field_for_field():
    assert set(ARCHS) <= set(ARCH_NAMES)
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_config(arch))
        assert dataclasses.asdict(get_reduced(arch)) == dataclasses.asdict(jax_reduced(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_paged_forms_tokens_equal_reference(arch, monkeypatch):
    jm, jc, tm, tc, _ = trees(arch)
    tags = []
    apply = TL.forms_apply

    def spy(p, x, *a, tag=None, **k):
        tags.append(tag)
        return apply(p, x, *a, tag=tag, **k)

    monkeypatch.setattr(TL, "forms_apply", spy)
    je = JEngine(jm, jc, forms=True, **COMMON)
    te = TEngine(tm, tc, forms=True, device="cpu", **COMMON)
    want = _tokens(je.run(_requests(JRequest, arch)))
    got = _tokens(te.run(_requests(TRequest, arch)))
    assert got == want
    assert all(len(t) == NEW for t in got.values())
    assert te.stats()["pages"] == je.stats()["pages"]
    head = te.params.get("head")
    if tm.config.tie_embeddings:
        assert head is None and "head" not in tags
    else:
        # the untied head is a FORMS leaf, run by the polarized matmul at N = vocab
        assert isinstance(head, tforms.FormsLinearParams)
        assert tuple(head.mags.shape) == (tm.config.d_model, tm.config.vocab_size)
        assert tags.count("head") == te.stats()["rounds"] * te.decode_block + len(got)


def _prefill_then_decode(model, params, prompt, steps=3):
    """Prefill ``prompt`` into a fresh paged cache, then ``steps`` greedy
    decode calls: the prefill logits and each decode's."""
    ps, n_tables = 8, TKV.pages_for(64, 8)
    cache = model.init_paged_cache(n_tables + 1, ps)
    table = torch.arange(1, n_tables + 1, dtype=torch.int32)[None]
    toks = torch.tensor(prompt, dtype=torch.int32)[None]
    with torch.inference_mode():
        logits, cache = model.prefill_paged(params, toks, cache,
                                            table[0, :TKV.pages_for(len(prompt), ps)], 0,
                                            len(prompt))
        out = [logits[0]]
        tok, pos = logits.argmax(-1).int(), len(prompt)
        for _ in range(steps):
            lg, cache = model.decode_paged(params, tok[:, None], cache,
                                           torch.tensor([pos], dtype=torch.int32), table)
            out.append(lg[0, 0])
            tok, pos = lg[:, 0].argmax(-1).int(), pos + 1
    return out


def test_the_reduced_window_binds_in_prefill_and_decode():
    jm, jc, tm, tc, tp = trees("h2o-danube-1.8b")
    assert tm.config.sliding_window == 32
    prompt = np.random.RandomState(3).randint(0, 256, 40)
    unwindowed = torch_build(dataclasses.replace(tm.config, sliding_window=None), device="cpu")
    windowed = _prefill_then_decode(tm, tc, prompt)
    full = _prefill_then_decode(unwindowed, tc, prompt)
    for a, b in zip(windowed, full):           # prefill at 40, decode at 40..42
        assert float((a - b).abs().max()) > 1e-3
    # the reference's full-sequence logits at the same window agree
    toks = prompt[None].astype(np.int32)
    want, _ = jm.forward(jc, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _ = tm.forward(tc, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # and within the window the two configs are the same model
    short = prompt[:24][None].astype(np.int32)
    with torch.inference_mode():
        a, _ = tm.forward(tc, {"tokens": torch.from_numpy(short)})
        b, _ = unwindowed.forward(tc, {"tokens": torch.from_numpy(short)})
    assert torch.equal(a, b)
