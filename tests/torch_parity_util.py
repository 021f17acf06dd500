"""Shared helpers of the PyTorch-port parity tests: one reduced qwen2 built
in both packages from the same numpy weights."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced as jax_reduced
from repro import forms as jforms
from repro.forms import FormsLinearParams as JaxForms
from repro.models.registry import build as jax_build
from repro_torch import forms as tforms
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_reduced as torch_reduced
from repro_torch.models.registry import build as torch_build

ARCH = "qwen2-1.5b"
FORMS_META = ("k", "m", "orig_shape", "policy", "out_dtype", "encoding", "bits")


def configs(dtype="float32"):
    return (dataclasses.replace(jax_reduced(ARCH), dtype=dtype),
            dataclasses.replace(torch_reduced(ARCH), dtype=dtype))


def to_numpy(tree):
    """A JAX params tree as nested numpy dicts (and lists, as xLSTM's
    blocks); compressed leaves become the bridge's ``{"mags", "signs",
    "scale", "meta"}`` dicts."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    if isinstance(tree, JaxForms):
        meta = {f: getattr(tree, f) for f in FORMS_META}
        return {"mags": np.asarray(tree.mags), "signs": np.asarray(tree.signs),
                "scale": np.asarray(tree.scale), "meta": meta}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def models(dtype="float32", seed=0):
    """(jax model, jax params, port model, port params) with the same weights,
    built once per test process (callers must not mutate them).

    The reference inits its QKV biases to zero; they get small random values
    here so the bias path is exercised.
    """
    jcfg, tcfg = configs(dtype)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    attn = dict(jp["blocks"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(rng.normal(0, 0.05, attn[name].shape).astype(np.float32))
    jp = {**jp, "blocks": {**jp["blocks"], "attn": attn}}
    tm = torch_build(tcfg, device="cpu")
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    return jm, jp, tm, tp


@functools.lru_cache(maxsize=None)
def compressed(m=8, bits=8):
    """Both packages' own FORMS trees and reports for :func:`models`'
    weights (the reference's eager compression is the slow part: done once
    per process)."""
    _, jp, _, tp = models()
    jc, jrep = jforms.compress_tree(jp, jforms.FormsSpec(m=m, bits=bits))
    tc, trep = tforms.compress_tree(tp, tforms.FormsSpec(m=m, bits=bits))
    return jc, jrep, tc, trep


def _jax_leaf(leaf):
    return JaxForms(mags=jnp.asarray(leaf.mags.numpy()), signs=jnp.asarray(leaf.signs.numpy()),
                    scale=jnp.asarray(leaf.scale.numpy()),
                    **{f: getattr(leaf, f) for f in FORMS_META})


@functools.lru_cache(maxsize=None)
def shared_codes(m=8, bits=8):
    """(jax tree, port tree): the port's FORMS tree of :func:`models`'
    weights and the same codes as reference leaves.  The model and serving
    tests take this pair; ``test_torch_forms`` shows the codes equal the
    reference's own compression, without paying for it in every process."""
    _, _, _, tp = models()
    tc, _ = tforms.compress_tree(tp, tforms.FormsSpec(m=m, bits=bits))

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, tforms.FormsLinearParams):
            return _jax_leaf(t)
        return jnp.asarray(t.numpy())

    return conv(tc), tc


def port_to_jax(tree):
    """A port params tree (dicts, lists, FORMS leaves, CPU tensors) as the
    reference's, the same numbers and codes."""
    if isinstance(tree, dict):
        return {k: port_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [port_to_jax(v) for v in tree]
    if isinstance(tree, tforms.FormsLinearParams):
        return _jax_leaf(tree)
    return jnp.asarray(tree.numpy())


def prefill_and_stepwise(model, params, prompt, to, slot=1, slots=2, max_len=16):
    """(prefill logits (V,), stepwise decode's last logits (V,)) of
    ``prompt`` at ``slot`` of a 2-slot f32 dense cache, in either package
    (``to``: ``torch.from_numpy`` or ``jnp.asarray``): the reference's
    ``test_prefill_matches_stepwise_all_families`` for a model prefilled at
    the exact prompt length."""
    port = to is torch.from_numpy
    f32 = torch.float32 if port else jnp.float32
    cache = model.init_cache(slots, max_len, dtype=f32)
    toks = np.asarray(prompt, np.int32)[None, :]
    pre, _ = model.prefill(params, to(toks), cache, slot, len(prompt))
    cache = model.init_cache(slots, max_len, dtype=f32)
    pos = np.zeros(slots, np.int32)
    for t in prompt:
        tb = np.zeros((slots, 1), np.int32)
        tb[slot, 0] = t
        lg, cache = model.decode_step(params, to(tb), cache, to(pos.copy()))
        pos[slot] += 1
    return np.asarray(pre[0]), np.asarray(lg[slot, 0])


def engine_requests(cls, n=3, new=6, vocab=256):
    rng = np.random.RandomState(0)
    return [cls(uid=i, prompt=rng.randint(0, vocab, rng.randint(3, 12)), max_new_tokens=new)
            for i in range(n)]


def result_tokens(results):
    return {r.uid: list(r.tokens) for r in results}
