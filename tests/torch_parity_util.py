"""Shared helpers of the PyTorch-port parity tests: one reduced qwen2 built
in both packages from the same numpy weights."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

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
    """A JAX params tree as nested numpy dicts; compressed leaves become the
    bridge's ``{"mags", "signs", "scale", "meta"}`` dicts."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
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
