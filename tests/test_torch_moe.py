"""PyTorch port vs the JAX package: the MoE family (olmoe-1b-7b, GQA/MHA).

The reduced olmoe (2 layers, 8 experts, top-2) in float32 from the
reference's init weights carried across through numpy: full-sequence
logits within 1e-5 and the load-balance aux loss within 1e-6, with the
capacity-based dispatch dropping tokens; the stacked expert leaves
``(L, E, K, N)`` compressed per (layer, expert), code for code against the
reference's ``compress_tree``, carried through ``compressed_paths``, the
bridge and the checkpoint codec; paged greedy tokens through both engines
with exact-length prefill; prefill and decode logits within 1e-4 (the bf16
paged cache); an olmoe config given MLA and MTP builds (their parity is
``tests/test_torch_mla.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import forms as jforms
from repro.checkpoint import manager as jckpt
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models.registry import build as jax_build
from repro.serving import kv_cache as JKV
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import forms as tforms
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs import MLAConfig, get_config, get_reduced
from repro_torch.models import layers as TL
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import build as torch_build
from repro_torch.serving import kv_cache as TKV
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

from torch_parity_util import _jax_leaf, to_numpy

ARCH = "olmoe-1b-7b"
EXPERTS = ("w_gate", "w_up", "w_down")


@functools.lru_cache(maxsize=None)
def models():
    """(jax model, jax params, port model, port params): the reference's
    init at PRNGKey(0), float32, carried across."""
    jm = jax_build(dataclasses.replace(jax_reduced(ARCH), dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(dataclasses.replace(get_reduced(ARCH), dtype="float32"), device="cpu")
    return jm, jp, tm, params_from_numpy(to_numpy(jp), device="cpu")


@functools.lru_cache(maxsize=None)
def compressed():
    """Both packages' own FORMS trees of the same weights."""
    _, jp, _, tp = models()
    jc, _ = jforms.compress_tree(jp, jforms.FormsSpec(m=8, bits=8))
    tc, _ = tforms.compress_tree(tp, tforms.FormsSpec(m=8, bits=8))
    return jc, tc


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tforms.FormsLinearParams):
        return _jax_leaf(tree)
    return jnp.asarray(tree.numpy())


def test_config_is_the_references_field_for_field():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_config(ARCH))
    assert dataclasses.asdict(get_reduced(ARCH)) == dataclasses.asdict(jax_reduced(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_experts, cfg.experts_per_token,
            cfg.moe_d_ff, cfg.vocab_size, cfg.tie_embeddings) == (16, 2048, 64, 8, 1024,
                                                                  50304, False)


def test_forward_logits_and_aux_loss_match_reference(monkeypatch):
    jm, jp, tm, tp = models()
    routed = []
    top_k = tmoe.top_k

    def spy(probs, k):
        out = top_k(probs, k)
        routed.append(out[1])
        return out

    monkeypatch.setattr(tmoe, "top_k", spy)
    toks = np.random.RandomState(0).randint(0, 256, (2, 24)).astype(np.int32)
    want, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert abs(float(taux["moe_aux_loss"]) - float(jaux["moe_aux_loss"])) <= 1e-6
    # the capacity binds: some expert gets more (token, expert) pairs than
    # cap = max(4, int(1.25 * 48 * 2 / 8)) = 15, so the dropping path runs
    cfg = tm.config
    cap = max(4, int(cfg.capacity_factor * 48 * cfg.experts_per_token / cfg.num_experts))
    loads = [torch.bincount(idx.reshape(-1), minlength=cfg.num_experts) for idx in routed]
    assert len(loads) == cfg.num_layers and max(int(n.max()) for n in loads) > cap


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3], [0.25, 0.25, 0.25, 0.25, 0.0]])
    vals, idx = tmoe.top_k(probs, 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[1, 2, 4], [0, 1, 2]]
    assert torch.equal(vals, torch.from_numpy(np.array(jvals)))


def test_expert_leaves_compress_code_for_code(tmp_path):
    jc, tc = compressed()
    jleaves, tleaves = jforms.compressed_paths(jc), tforms.compressed_paths(tc)
    assert sorted(tleaves) == sorted(jleaves)
    cfg = get_reduced(ARCH)
    for path, leaf in tleaves.items():
        want = jleaves[path]
        assert torch.equal(leaf.mags, torch.from_numpy(np.array(want.mags))), path
        assert torch.equal(leaf.signs, torch.from_numpy(np.array(want.signs))), path
        np.testing.assert_allclose(leaf.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
    _, _, _, tp = models()
    for name in EXPERTS:
        leaf = tleaves[f"blocks/moe/{name}"]
        dense = tp["blocks"]["moe"][name]
        assert leaf.mags.shape[:2] == (cfg.num_layers, cfg.num_experts)
        assert leaf.orig_shape is None and leaf.k == dense.shape[2]
        assert tforms.to_dense(leaf).shape == dense.shape       # (L, E, K, N)
        # one matrix per (layer, expert): each slice is from_dense of its own
        one, _ = tforms.from_dense(dense[1, 3], tforms.FormsSpec(m=8, bits=8))
        assert torch.equal(leaf.mags[1, 3], one.mags) and torch.equal(leaf.signs[1, 3],
                                                                       one.signs)
    # the router stays dense in both packages: the crossbar predicate's
    # "/ro" (xlstm's recurrent weights) matches "blocks/moe/router" too
    assert "blocks/moe/router" not in tleaves
    assert tuple(tc["blocks"]["moe"]["router"].shape) == (cfg.num_layers, cfg.d_model,
                                                          cfg.num_experts)
    # the bridge carries the leaves across, and both checkpoint codecs do
    back = params_from_numpy(to_numpy(jc), device="cpu")
    for path, leaf in tforms.compressed_paths(back).items():
        assert torch.equal(leaf.mags, tleaves[path].mags) and leaf.k == tleaves[path].k
    tckpt.save(str(tmp_path / "port"), tc, step=1)
    jckpt.save(str(tmp_path / "ref"), jc, step=1)
    for d in ("port", "ref"):
        got, _ = tckpt.restore(str(tmp_path / d), tc)
        for path, leaf in tforms.compressed_paths(got).items():
            assert torch.equal(leaf.mags, tleaves[path].mags), (d, path)
            assert torch.equal(leaf.signs, tleaves[path].signs), (d, path)
    jgot, _ = jckpt.restore(str(tmp_path / "port"), jc)
    for path, leaf in jforms.compressed_paths(jgot).items():
        assert np.array_equal(np.asarray(leaf.mags), tleaves[path].mags.numpy()), path


def _requests(cls):
    rng = np.random.RandomState(0)
    return [cls(uid=i, prompt=rng.randint(0, 256, rng.randint(5, 14)), max_new_tokens=8)
            for i in range(3)]


def _tokens(results):
    return {r.uid: list(r.tokens) for r in results}


def test_paged_greedy_tokens_identical_through_both_engines():
    _, tc = compressed()
    jm, _, tm, _ = models()
    widths = []

    def spy(params, tokens, *a):
        widths.append(int(tokens.shape[1]))
        return tm.prefill_paged(params, tokens, *a)

    kw = dict(max_len=64, batch_slots=2, page_size=8, forms=True)
    je = JEngine(jm, _to_jax(tc), **kw)
    te = TEngine(dataclasses.replace(tm, prefill_paged=spy), tc, device="cpu", **kw)
    want = _tokens(je.run(_requests(JRequest)))
    got = _tokens(te.run(_requests(TRequest)))
    assert got == want and all(len(t) == 8 for t in got.values())
    # exact-length prefill: each prompt at its own length, in both packages
    lens = [len(r.prompt) for r in _requests(TRequest)]
    assert not tm.padded_prefill and widths == lens
    assert [te.runner.bucket_for(n) for n in lens] == [je.runner.bucket_for(n) for n in lens]
    assert te.runner.chunk_width(5) == je.runner.chunk_width(5) == 8
    assert te.stats()["pages"] == je.stats()["pages"]


def test_prefill_and_decode_logits_match_reference():
    """Paged prefill, then three greedy decode steps, on the same FORMS
    codes: the bf16 paged cache holds both packages to 1e-4."""
    _, tc = compressed()
    jm, _, tm, _ = models()
    jc = _to_jax(tc)
    prompt = np.random.RandomState(3).randint(0, 256, 11)
    ps, n_tables = 8, TKV.pages_for(64, 8)
    tcache = tm.init_paged_cache(n_tables + 1, ps)
    jcache = jm.init_paged_cache(n_tables + 1, ps, 1, 64)
    table = np.arange(1, n_tables + 1, dtype=np.int32)[None]
    pages = table[0, :TKV.pages_for(len(prompt), ps)]
    assert JKV.pages_for(len(prompt), ps) == len(pages)
    with torch.inference_mode():
        tl, tcache = tm.prefill_paged(tc, torch.from_numpy(prompt[None].astype(np.int32)),
                                      tcache, torch.from_numpy(pages), 0, len(prompt))
    jl, jcache = jm.prefill_paged(jc, jnp.asarray(prompt[None].astype(np.int32)), jcache,
                                  jnp.asarray(pages), 0, len(prompt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    tok, pos = int(np.asarray(jl).argmax()), len(prompt)
    for _ in range(3):
        with torch.inference_mode():
            tl, tcache = tm.decode_paged(tc, torch.tensor([[tok]], dtype=torch.int32), tcache,
                                         torch.tensor([pos], dtype=torch.int32),
                                         torch.from_numpy(table))
        jl, jcache = jm.decode_paged(jc, jnp.asarray([[tok]], jnp.int32), jcache,
                                     jnp.asarray([pos], jnp.int32), jnp.asarray(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        tok, pos = int(np.asarray(jl)[0, 0].argmax()), pos + 1


def test_only_a_layers_expert_slices_are_rebuilt_off_the_cpu():
    """``layers.wload`` rebuilds a layer's (E, K, N) expert slice for the
    expert einsum off the CPU (here: on the meta device); every other FORMS
    leaf there is the polarized-matmul kernel's."""
    _, tc = compressed()

    def on_meta(leaf):
        return dataclasses.replace(leaf, mags=leaf.mags.to("meta"),
                                   signs=leaf.signs.to("meta"), scale=leaf.scale.to("meta"))

    layer = tmoe.layer_params(tc["blocks"], 0)["moe"]
    meta = {name: on_meta(layer[name]) for name in EXPERTS}
    cfg = get_reduced(ARCH)
    assert TL.wload(meta, "w_up", torch.float32).shape == (cfg.num_experts, cfg.d_model,
                                                           cfg.moe_d_ff)
    with pytest.raises(NotImplementedError, match="polarized-matmul kernel"):
        TL.wload({"wq": on_meta(tmoe.layer_params(tc["blocks"], 0)["attn"]["wq"])}, "wq",
                 torch.float32)
    with pytest.raises(NotImplementedError, match="polarized-matmul kernel"):
        TL.wload({"w_up": on_meta(tc["blocks"]["moe"]["w_up"])}, "w_up", torch.float32)
    assert torch.equal(TL.wload(layer, "w_down", torch.float32),
                       tforms.to_dense(layer["w_down"]))


def test_mla_is_refused_naming_its_item():
    """MLA and the MTP module are ported now (``tests/test_torch_mla.py``):
    an olmoe config given them builds, with the latent cache; so do the
    recurrent families (exact-length prefill, no paged path); and the VLM
    prefix, the last item the registry refused, is ported too: a config
    given ``num_image_tokens`` builds and its forward puts the patch
    embeddings before the tokens."""
    mla = dataclasses.replace(get_reduced(ARCH), mla=MLAConfig(), mtp=True, dtype="float32")
    model = torch_build(mla, device="cpu")
    assert set(model.init_cache(1, 8)) == {"c_kv", "k_rope"}
    assert "mtp" in model.init(0)
    for family in ("xlstm", "zamba"):
        recurrent = torch_build(dataclasses.replace(get_reduced(ARCH), family=family),
                                device="cpu")
        assert recurrent.padded_prefill is False and recurrent.supports_paged is False
    vlm_cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), num_image_tokens=4,
                                  dtype="float32")
    vlm = torch_build(vlm_cfg, device="cpu")
    assert vlm.input_fields == ("tokens", "patch_embeds")
    params = vlm.init(0)
    g = torch.Generator()
    g.manual_seed(1)
    batch = vlm.make_inputs(g, 1, 10)
    with torch.no_grad():
        logits, _ = vlm.forward(params, batch)
        text, _ = vlm.forward(params, {"tokens": batch["tokens"]})
        hidden, _ = vlm.forward(params, batch, return_hidden=True)
    assert logits.shape == (1, 10, vlm_cfg.vocab_size) and text.shape == (1, 6, vlm_cfg.vocab_size)
    # the patches come first: the last text position sees them, so it differs
    assert float((logits[:, -1] - text[:, -1]).abs().max()) > 1e-4
    assert hidden.shape == (1, 10, vlm_cfg.d_model)
