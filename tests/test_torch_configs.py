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

``phi-3-vision-4.2b`` (the VLM backbone: MHA, untied head) serves text
prompts the same way; its forward takes the patch embeddings before the
tokens, and one train step on a patch batch gives the reference's loss.
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
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch import forms as tforms
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.models import layers as TL
from repro_torch.models.registry import build as torch_build
from repro_torch.serving import kv_cache as TKV
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.training import train_loop as ttl

from torch_parity_util import _jax_leaf, to_numpy

ARCHS = ("h2o-danube-1.8b", "qwen1.5-4b", "yi-9b", "phi-3-vision-4.2b")
VLM = "phi-3-vision-4.2b"
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


def _vlm_batch(cfg, batch=2, seq=16, seed=4):
    """A VLM batch from numpy: tokens (B, seq - n_img), patch embeddings
    (B, n_img, d_model) f32, in both packages."""
    rng = np.random.RandomState(seed)
    n_img = cfg.num_image_tokens
    toks = rng.randint(0, cfg.vocab_size, (batch, seq - n_img)).astype(np.int32)
    patches = rng.normal(size=(batch, n_img, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)},
            {"tokens": torch.from_numpy(toks), "patch_embeds": torch.from_numpy(patches)})


def test_vlm_forward_takes_the_patch_prefix_as_the_reference():
    """Reduced phi-3-vision (8 patch positions) on the bridged dense weights:
    ``make_inputs(g, 2, 16)`` gives 8 text tokens; the logits have 16
    positions and equal the reference's within 1e-5 of the largest |logit|,
    and the hidden states too; without the patches the text positions see
    another context."""
    jm, _, tm, _, tp = trees(VLM)
    cfg = tm.config
    assert tm.input_fields == jm.input_fields == ("tokens", "patch_embeds")
    g = torch.Generator()
    g.manual_seed(0)
    made = tm.make_inputs(g, 2, 16)
    jmade = jm.make_inputs(jax.random.PRNGKey(0), 2, 16)
    assert {k: tuple(v.shape) for k, v in made.items()} == {
        k: tuple(v.shape) for k, v in jmade.items()}
    assert made["tokens"].shape == (2, 8) and made["tokens"].dtype == torch.int32
    jb, tb = _vlm_batch(cfg)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    want, _ = jm.forward(jp, jb)
    with torch.inference_mode():
        got, _ = tm.forward(tp, tb)
        hidden, _ = tm.forward(tp, tb, return_hidden=True)
        text, _ = tm.forward(tp, {"tokens": tb["tokens"]})
    jhidden, _ = jm.forward(jp, jb, return_hidden=True)
    assert got.shape == (2, 16, cfg.vocab_size)
    top = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * top)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jhidden)).max()))
    assert float((got[:, 8:] - text).abs().max()) > 1e-3


def test_vlm_train_step_on_a_patch_batch_matches_reference():
    """One ``make_train_step`` step with a patch batch: the loss is the CE of
    the trailing text positions, equal to the reference's within 1e-5, and
    the gradient norm within 1e-4."""
    jm, _, tm, _, tp = trees(VLM)
    jb, tb = _vlm_batch(tm.config, seed=5)
    kw = dict(warmup_steps=1, total_steps=20, remat=True)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    js = jtl.TrainState(params=jp, opt=jopt.adamw_init(jp, "float32"),
                        step=jnp.zeros((), jnp.int32), admm=None, grad_err=None,
                        rng=jax.random.PRNGKey(0))
    _, jmet = jax.jit(jtl.make_train_step(jm, jtl.TrainConfig(**kw)))(js, jb)
    state, _ = ttl.init_train_state(tm, TrainConfig(**kw),
                                    params=jax.tree_util.tree_map(torch.clone, tp))
    _, tmet = ttl.make_train_step(tm, TrainConfig(**kw))(state, tb)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    with torch.no_grad():
        hidden, _ = tm.forward(tp, tb, return_hidden=True)
        text_only = float(ttl.chunked_ce(hidden[:, 8:], tm.head_matrix(tp), tb["tokens"]))
    np.testing.assert_allclose(float(tmet["loss"]), text_only, rtol=1e-6)
