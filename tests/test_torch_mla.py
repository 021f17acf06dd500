"""PyTorch port vs the JAX package: MLA and multi-token prediction
(deepseek-v3, the MoE family).

The reduced deepseek-v3 (2 layers, MLA with q_lora 32, kv_lora 16, nope /
rope / v 16 / 8 / 16, one shared and 8 routed experts top-2, the MTP
module) in float32 from the reference's init weights carried across
through numpy.  Tolerances:

* ``forward``'s logits and ``mtp_logits`` within 1e-5, the load-balance
  loss (the MTP block's share included) within 1e-6: both packages run
  the same f32 products, summed in other orders;
* ``compress_tree`` code for code, the MTP module's unstacked ``(E, K,
  N)`` expert leaves and ``mtp/proj`` included, the routers dense;
* prefill against stepwise absorbed decode, and both against the
  reference's, within 1e-4 on an f32 latent cache (the two forms sum the
  same products in other orders: 1.6e-7 measured); on the bf16 latent
  cache the port's own two forms within 4e-3, the rounding of the cached
  latents (2^-9 of each, on logits of ~0.3: 1.2e-3 measured);
* greedy tokens equal: the port's paged and dense engines and the
  reference's engine; the speculative and the fleet engines against the
  reference's (capacity factor 64, so a verify or a chunk drops no token
  that sequential decode keeps, as the reference's own tests run them).

Every comparison with the reference's serving runs both packages on f32
caches: the reference's absorbed decode on a bf16 cache asks XLA's CPU
backend for a bf16 x bf16 -> f32 dot, which not every CPU build runs
("Unsupported element type for DotThunk"; the reference's own deepseek
serving tests fail there for it).  The port's bf16 latent caches are held
against its own expanded prefill, and paged against dense.
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
from repro.models import moe as jmoe
from repro.models.registry import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import forms as tforms
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import build as torch_build
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

from torch_parity_util import _jax_leaf, to_numpy

ARCH = "deepseek-v3-671b"
EXPERTS = ("w_gate", "w_up", "w_down")


@functools.lru_cache(maxsize=None)
def built(capacity_factor=None):
    """(jax model, port model) of the float32 reduced config."""
    extra = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    return (jax_build(dataclasses.replace(jax_reduced(ARCH), dtype="float32", **extra)),
            torch_build(dataclasses.replace(get_reduced(ARCH), dtype="float32", **extra),
                        device="cpu"))


@functools.lru_cache(maxsize=None)
def models():
    """(jax model, jax params, port model, port params): the reference's
    init at PRNGKey(0), carried across."""
    jm, tm = built()
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, params_from_numpy(to_numpy(jp), device="cpu")


@functools.lru_cache(maxsize=None)
def compressed():
    """Both packages' own FORMS trees of the same weights."""
    _, jp, _, tp = models()
    jc, _ = jforms.compress_tree(jp, jforms.FormsSpec(m=8, bits=8))
    tc, _ = tforms.compress_tree(tp, tforms.FormsSpec(m=8, bits=8))
    return jc, tc


def f32_caches(model, dtype):
    """``model`` (either package's) with its caches made in ``dtype``."""
    init, paged = model.init_cache, model.init_paged_cache
    return dataclasses.replace(
        model, init_cache=lambda b, n: init(b, n, dtype=dtype),
        init_paged_cache=lambda p, s, slots, n: paged(p, s, slots, n, dtype=dtype))


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


def test_config_is_the_references_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_config(ARCH))
    assert dataclasses.asdict(get_reduced(ARCH)) == dataclasses.asdict(jax_reduced(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.mla.q_lora_rank,
            cfg.mla.kv_lora_rank, cfg.num_experts, cfg.experts_per_token,
            cfg.vocab_size, cfg.mtp) == (61, 7168, 128, 1536, 512, 256, 8, 129280, True)


def test_forward_logits_aux_and_mtp_match_reference():
    jm, jp, tm, tp = models()
    # the port's own init has the reference's tree: the MTP block unstacked
    assert _shapes(tm.init(0)) == _shapes(tp)
    assert tp["mtp"]["block"]["moe"]["w_up"].ndim == 3
    toks = np.random.RandomState(0).randint(0, 256, (2, 24)).astype(np.int32)
    want, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
        hidden, haux = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, return_hidden=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taux["mtp_logits"].numpy(), np.asarray(jaux["mtp_logits"]),
                               rtol=1e-5, atol=1e-5)
    assert abs(float(taux["moe_aux_loss"]) - float(jaux["moe_aux_loss"])) <= 1e-6
    # return_hidden: the MTP module's hidden states, whose head product is
    # its logits (as the reference's return_hidden keys them)
    assert set(haux) == {"moe_aux_loss", "mtp_hidden"}
    np.testing.assert_allclose((haux["mtp_hidden"] @ tp["head"]).numpy(),
                               taux["mtp_logits"].numpy(), rtol=1e-6, atol=1e-6)


def test_compress_tree_code_for_code_with_the_mtp_module():
    jc, tc = compressed()
    jleaves, tleaves = jforms.compressed_paths(jc), tforms.compressed_paths(tc)
    assert sorted(tleaves) == sorted(jleaves)
    for path, leaf in tleaves.items():
        want = jleaves[path]
        assert torch.equal(leaf.mags, torch.from_numpy(np.array(want.mags))), path
        assert torch.equal(leaf.signs, torch.from_numpy(np.array(want.signs))), path
        np.testing.assert_allclose(leaf.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
    cfg = get_reduced(ARCH)
    for name in ("q_down", "q_up", "kv_down", "kv_up", "wo"):
        assert tleaves[f"blocks/mla/{name}"].mags.ndim == 3          # (L, Kp, N)
        assert tleaves[f"mtp/block/mla/{name}"].mags.ndim == 2       # one matrix
    for name in EXPERTS:
        assert tleaves[f"mtp/block/moe/{name}"].mags.shape[0] == cfg.num_experts
    assert "mtp/proj" in tleaves and "head" in tleaves
    # the routers and the norms stay dense in both packages
    for path in ("blocks/moe/router", "mtp/block/moe/router", "blocks/mla/q_norm",
                 "mtp/block/mla/kv_norm"):
        assert path not in tleaves and path not in jleaves
    assert tuple(tc["mtp"]["block"]["moe"]["router"].shape) == (cfg.d_model, cfg.num_experts)


def _prompt_logits_stepwise(model, params, prompt, slot=1, slots=2, max_len=32):
    """Prefill logits of ``prompt`` at ``slot`` of a dense cache, and the
    last logits and the cache of stepping it token by token through
    decode (either package)."""
    to = torch.from_numpy if isinstance(model, type(built()[1])) else jnp.asarray
    cache = model.init_cache(slots, max_len)
    pre, _ = model.prefill(params, to(prompt[None]), cache, slot, len(prompt))
    cache = model.init_cache(slots, max_len)
    pos = np.zeros(slots, np.int32)
    for t in prompt:
        tb = np.zeros((slots, 1), np.int32)
        tb[slot, 0] = t
        lg, cache = model.decode_step(params, to(tb), cache, to(pos.copy()))
        pos[slot] += 1
    return np.asarray(pre[0]), np.asarray(lg[slot, 0]), cache


def test_prefill_matches_stepwise_absorbed_decode_and_the_reference():
    """The expanded prefill against the absorbed decode, at a capacity
    that drops no token, as the reference's own MoE test holds it: on the
    bf16 latent cache the port's two forms, on an f32 one both packages'
    (the same FORMS codes)."""
    _, tc = compressed()
    jm, tm = built(64.0)
    prompt = np.array([5, 9, 2, 7, 1, 33, 8], np.int32)
    with torch.inference_mode():
        pre, step, cache = _prompt_logits_stepwise(tm, tc, prompt)
        np.testing.assert_allclose(pre, step, atol=4e-3)
        assert set(cache) == {"c_kv", "k_rope"} and cache["c_kv"].dtype == torch.bfloat16
        assert cache["c_kv"].shape == (2, 2, 32, 16) and cache["k_rope"].shape == (2, 2, 32, 8)
        pre, step, cache = _prompt_logits_stepwise(f32_caches(tm, torch.float32), tc, prompt)
    np.testing.assert_allclose(pre, step, atol=1e-4)
    jpre, jstep, jcache = _prompt_logits_stepwise(f32_caches(jm, jnp.float32), _to_jax(tc),
                                                  prompt)
    np.testing.assert_allclose(pre, jpre, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(step, jstep, rtol=1e-4, atol=1e-4)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), atol=1e-5)


def test_a_verify_row_past_the_view_is_dropped():
    """A multi-token absorbed decode whose rows run past the latent view
    writes the rows inside it and drops the rest, as the reference's
    scatter does: the attention output and the view's rows agree."""
    jm, jp, tm, tp = models()
    cfg = tm.config
    bp = tmoe.layer_params(tp["blocks"], 0)["mla"]
    jbp = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["mla"])
    rng = np.random.RandomState(4)
    b, s, t = 2, 8, 4
    x = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
    c_kv = rng.normal(size=(b, s, cfg.mla.kv_lora_rank)).astype(np.float32)
    k_rope = rng.normal(size=(b, s, cfg.mla.qk_rope_head_dim)).astype(np.float32)
    pos = np.array([6, 2], np.int32)                # row 0: positions 8 and 9 drop
    grid = pos[:, None] + np.arange(t, dtype=np.int32)[None]     # as _decode_core gives it
    view = {"c_kv": torch.from_numpy(c_kv.copy()), "k_rope": torch.from_numpy(k_rope.copy())}
    with torch.inference_mode():
        out, new = tmoe.mla_decode(bp, torch.from_numpy(x), cfg, view, torch.from_numpy(grid),
                                   torch.float32)
    jout, jnew = jmoe.mla_decode(jbp, jnp.asarray(x), jm.config,
                                 {"c_kv": jnp.asarray(c_kv), "k_rope": jnp.asarray(k_rope)},
                                 jnp.asarray(grid), jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for name, arr in (("c_kv", c_kv), ("k_rope", k_rope)):
        np.testing.assert_allclose(new[name].numpy(), np.asarray(jnew[name]), rtol=1e-5,
                                   atol=1e-6)
        want = arr.copy()
        for row in range(b):
            for j in range(t):
                if pos[row] + j < s:
                    want[row, pos[row] + j] = new[name][row, j].numpy()
        np.testing.assert_array_equal(view[name].numpy(), want)


def _requests(cls, n=3, new=6):
    rng = np.random.RandomState(0)
    return [cls(uid=i, prompt=rng.randint(0, 256, rng.randint(5, 14)), max_new_tokens=new)
            for i in range(n)]


def _tokens(results):
    return {r.uid: list(r.tokens) for r in results}


def test_greedy_tokens_paged_dense_and_reference_are_equal():
    """The compressed tree served: the reference's engine and the port's
    paged and dense ones on f32 caches give the same tokens, and the
    port's on its bf16 latent caches give them too."""
    jc, tc = compressed()
    jm, _, tm, _ = models()
    kw = dict(max_len=48, batch_slots=2, forms=True)
    want = _tokens(JEngine(f32_caches(jm, jnp.float32), jc, page_size=8, **kw)
                   .run(_requests(JRequest)))
    for model in (f32_caches(tm, torch.float32), tm):
        paged = TEngine(model, tc, device="cpu", page_size=8, **kw)
        dense = TEngine(model, tc, device="cpu", page_size=0, **kw)
        assert set(paged.cache.pool) == {"c_kv", "k_rope"} and paged.cache.dense == {}
        got = _tokens(paged.run(_requests(TRequest)))
        assert got == want and all(len(v) == 6 for v in got.values())
        assert _tokens(dense.run(_requests(TRequest))) == want


@pytest.mark.parametrize("engine", ["speculative", "fleet"])
def test_speculative_and_fleet_engines_equal_the_references(engine):
    """As the reference's own tests run deepseek: capacity factor 64, the
    speculative engine with a 4-bit draft and K=4, the fleet with 4-token
    chunks under an 8-token round budget."""
    jm, tm = built(64.0)
    _, jp, _, tp = models()
    if engine == "speculative":
        kw = dict(max_len=32, batch_slots=2, page_size=8, speculate=True, draft_k=4,
                  draft_bits=4)
        reqs = lambda cls: [cls(uid=i, prompt=np.array([1 + i, 2, 3]), max_new_tokens=6)
                            for i in range(3)]
    else:
        kw = dict(max_len=32, batch_slots=2, page_size=4,
                  slo={"prefill_chunk": 4, "step_token_budget": 8})
        reqs = lambda cls: [cls(uid=i, prompt=(np.arange(1 + i, 4 + i * 4) % 64)
                                .astype(np.int32), max_new_tokens=5) for i in range(3)]
    jeng = JEngine(f32_caches(jm, jnp.float32), jp, **kw)
    teng = TEngine(f32_caches(tm, torch.float32), tp, device="cpu", **kw)
    want = _tokens(jeng.run(reqs(JRequest)))
    got = _tokens(teng.run(reqs(TRequest)))
    assert got == want
    if engine == "speculative":
        assert teng.speculative and teng.stats()["speculate"]["drafted"] > 0
        assert teng.stats()["speculate"] == jeng.stats()["speculate"]
    else:
        slo = teng.stats()["slo"]
        assert slo["chunked_prefill"]["tokens"] == sum(len(r.prompt) for r in reqs(TRequest))
        assert slo["chunked_prefill"] == jeng.stats()["slo"]["chunked_prefill"]
