"""PyTorch port vs the JAX package: self-speculative serving.

Both packages serve the reduced qwen2 of ``torch_parity_util`` from the same
bridged weights (float32, as ``tests/test_serving_speculative.py`` runs the
reference).  Greedy speculative tokens must equal the reference's
speculative engine and the port's plain engine, and ``spec_stats()`` must
equal the reference's, for dense and FORMS targets, FORMS and int drafts, a
layer-skipped draft and the prefix cache.  Each case builds its reference
engine once per test process.  The draft derivation, the int grid and the
page commit/rollback are held bit for bit; temperature acceptance is held
to the target softmax by chi-square (as ``tests/test_torch_sampling.py``),
since ``torch.Generator`` cannot draw what ``jax.random`` draws.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro import forms as jforms
from repro.serving import kv_cache as JKV
from repro.serving import quant_weights as JQ
from repro.serving import speculate as JSP
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import forms as tforms
from repro_torch.bridge import params_from_numpy
from repro_torch.serving import kv_cache as TKV
from repro_torch.serving import quant_weights as TQ
from repro_torch.serving import speculate as TSP
from repro_torch.serving.engine import ModelRunner
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.engine import sample_on_device

from torch_parity_util import models, shared_codes, to_numpy

COMMON = dict(max_len=32, batch_slots=2, page_size=8)
# (forms target, prefix cache + shared prompt prefix, engine options)
CASES = {
    "dense-target-forms-draft": (False, False, dict(draft_k=2, draft_bits=4)),
    "forms-target-forms-draft": (True, False, dict(draft_k=3, draft_bits=4)),
    "forms-target-int-draft-skip2": (True, False, dict(draft_k=2, draft_bits=8,
                                                       draft_mode="int",
                                                       draft_layer_step=2)),
    "forms-target-prefix-cache": (True, True, dict(draft_k=3, draft_bits=4)),
}


def _requests(cls, shared_prefix=0, n=4, new=8, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, shared_prefix)
    return [cls(uid=i, prompt=np.concatenate([base, rng.randint(0, 256, rng.randint(2, 12))]),
                max_new_tokens=new) for i in range(n)]


def _tokens(results):
    return {r.uid: list(r.tokens) for r in results}


def _trees(forms):
    jm, jp, tm, tp = models()
    if forms:
        jp, tp = shared_codes()
    return jm, jp, tm, tp


@functools.lru_cache(maxsize=None)
def _served(case):
    """The case served by the reference's and the port's speculative engines
    and by the port's plain engine (once per process)."""
    forms, prefix, kw = CASES[case]
    jm, jp, tm, tp = _trees(forms)
    shared = 8 if prefix else 0
    opts = dict(COMMON, forms=forms, prefix_cache=prefix)
    je = JEngine(jm, jp, speculate=True, **opts, **kw)
    te = TEngine(tm, tp, device="cpu", speculate=True, **opts, **kw)
    plain = TEngine(tm, tp, device="cpu", **opts)
    return (je, _tokens(je.run(_requests(JRequest, shared))),
            te, _tokens(te.run(_requests(TRequest, shared))),
            _tokens(plain.run(_requests(TRequest, shared))))


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_equal_reference_and_plain_engine(case):
    je, want, te, got, plain = _served(case)
    assert te.speculative and isinstance(te.runner, TSP.SpeculativeRunner)
    assert got == want == plain
    assert all(len(t) == 8 for t in got.values())
    assert te.stats()["pages"] == je.stats()["pages"]
    if case.endswith("skip2"):
        # the draft keeps every other layer: its depth halves
        assert te.runner.draft_model.config.num_layers == 1 == \
            je.runner.draft_model.config.num_layers
    if case.endswith("prefix-cache"):
        assert te.stats()["prefix_hits"] == je.stats()["prefix_hits"] > 0
        assert list(te.scheduler.admissions) == list(je.scheduler.admissions)


@pytest.mark.parametrize("case", list(CASES))
def test_spec_stats_equal_reference(case):
    je, _, te, _, _ = _served(case)
    got, want = te.stats()["speculate"], je.stats()["speculate"]
    for key in ("rounds", "drafted", "accepted", "slot_k"):
        assert got[key] == want[key], (key, got, want)
    assert got["tokens_per_round"] == pytest.approx(want["tokens_per_round"])
    assert te.runner.rounds == len(te.runner.round_widths)
    assert set(te.runner.round_widths) <= set(range(1, 4))


def test_cache_bytes_count_the_draft_pool():
    je, _, te, _, _ = _served("forms-target-forms-draft")
    assert te.cache_bytes() == je.cache_bytes() == 2 * te.cache.nbytes()


@pytest.mark.parametrize("new,prompt_len", [(3, 5), (7, 5), (40, 28), (40, 30)],
                         ids=["budget-3", "budget-7", "to-max-len", "prompt-at-max-len-2"])
def test_round_edges_give_the_plain_engine_tokens(new, prompt_len):
    """A budget that ends inside a round, and requests that run to max_len
    - 1, where a round's draft and verify rows pass the slot's reserved
    pages (they land on scratch): the speculative tokens are the plain
    engine's."""
    _, _, tm, tp = _trees(True)

    def reqs():
        rng = np.random.RandomState(3)
        return [TRequest(uid=i, prompt=rng.randint(0, 256, prompt_len), max_new_tokens=new)
                for i in range(3)]

    plain = _tokens(TEngine(tm, tp, device="cpu", forms=True, **COMMON).run(reqs()))
    spec = TEngine(tm, tp, device="cpu", forms=True, speculate=True, draft_k=4,
                   draft_bits=8, draft_mode="int", **COMMON)
    got = _tokens(spec.run(reqs()))
    assert got == plain
    assert all(len(t) == min(new, COMMON["max_len"] - prompt_len) for t in got.values())
    assert spec.stats()["pages"]["used"] == 0


def test_temperature_speculation_is_deterministic_per_seed():
    _, _, tm, tp = _trees(True)

    def run(seed):
        eng = TEngine(tm, tp, device="cpu", forms=True, speculate=True, draft_k=3,
                      rng_seed=seed, **COMMON)
        reqs = _requests(TRequest)
        for r in reqs:
            r.temperature = 1.0
        return _tokens(eng.run(reqs))

    a, b, c = run(7), run(7), run(8)
    assert a == b and a != c
    assert all(len(t) == 8 and all(0 <= v < 256 for v in t) for t in a.values())


def test_adaptive_k_shrinks_and_grows_with_acceptance():
    """A hopeless draft (4-bit FORMS of the untrained dense target) shrinks
    every slot's K to the floor; an int8 draft of the FORMS target keeps it
    at the ceiling.  Admission resets a slot's state."""
    _, _, tm, tp = models()
    _, tc = shared_codes()
    reqs = lambda: _requests(TRequest, n=2, new=20)   # noqa: E731
    bad = TEngine(tm, tp, device="cpu", speculate=True, draft_k=4, draft_bits=4,
                  max_len=64, batch_slots=2, page_size=8)
    resets, reset = [], bad.runner.reset_slot
    bad.runner.reset_slot = lambda slot: (resets.append(slot), reset(slot))
    bad.run(reqs())
    assert sorted(resets) == [0, 1]
    st = bad.stats()["speculate"]
    assert st["acceptance"] < 0.3 and set(st["slot_k"].values()) == {1}, st
    good = TEngine(tm, tc, device="cpu", forms=True, speculate=True, draft_k=4,
                   draft_bits=8, draft_mode="int", max_len=64, batch_slots=2, page_size=8)
    good.run(reqs())
    st = good.stats()["speculate"]
    assert st["acceptance"] > 0.9 and set(st["slot_k"].values()) == {4}, st
    bad.runner.reset_slot(0)
    assert 0 not in bad.runner.spec_stats()["slot_k"]


def test_speculate_config_validation():
    with pytest.raises(ValueError, match="draft mode"):
        TSP.SpeculateConfig(mode="nope")
    with pytest.raises(ValueError, match="k must be"):
        TSP.SpeculateConfig(k=0)
    with pytest.raises(ValueError, match="k_min"):
        TSP.SpeculateConfig(k=2, k_min=3)
    with pytest.raises(ValueError, match="layer_step"):
        TSP.SpeculateConfig(layer_step=0)
    assert dataclasses.asdict(TSP.SpeculateConfig()) == dataclasses.asdict(JSP.SpeculateConfig())


# ---------------------------------------------------------------------------
# draft derivation and the int grid, bit for bit
# ---------------------------------------------------------------------------


def test_make_draft_tree_codes_equal_reference_and_requantize():
    """A 4-bit draft of the compressed target: the codes are re-quantized
    from the float projection (on the 4-bit grid, not the 8-bit leaves) and
    equal the reference's bit for bit."""
    jc, tc = shared_codes()
    jd, jrep = JSP.make_draft_tree(jc, jforms.FormsSpec(m=8, bits=4))
    with torch.inference_mode():
        td, trep = TSP.make_draft_tree(tc, tforms.FormsSpec(m=8, bits=4))
    want = jforms.compressed_paths(jd)
    got = tforms.compressed_paths(td)
    assert sorted(got) == sorted(want) and trep.num_compressed == jrep.num_compressed > 0
    for path, leaf in got.items():
        for plane in ("mags", "signs", "scale"):
            np.testing.assert_array_equal(getattr(leaf, plane).numpy(),
                                          np.asarray(getattr(want[path], plane)), path)
        assert leaf.bits == 4 and int(leaf.mags.max()) <= 15
    assert int(tc["blocks"]["attn"]["wq"].mags.max()) > 15


def test_make_draft_skips_layers_like_reference():
    jm, jp, tm, tp = models()
    cfg = TSP.SpeculateConfig(layer_step=2, mode="int", bits=8)
    jdm, jdp, _ = JSP.make_draft(jm, jp, JSP.SpeculateConfig(layer_step=2, mode="int", bits=8))
    with torch.inference_mode():
        tdm, tdp, _ = TSP.make_draft(tm, tp, cfg)
    assert tdm.config.num_layers == jdm.config.num_layers == 1
    assert tdm.device == tm.device
    for name in ("wq", "wo"):
        for part in ("q", "s"):
            np.testing.assert_array_equal(tdp["blocks"]["attn"][name][part].numpy(),
                                          np.asarray(jdp["blocks"]["attn"][name][part]))
    assert tdp["embed"] is tp["embed"]


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_tree_leaves_equal_reference(bits):
    _, jp, _, tp = models()
    jq, jb, ja = JQ.quantize_tree(jp, bits=bits)
    tq, tb, ta = TQ.quantize_tree(tp, bits=bits)
    assert (tb, ta) == (jb, ja)
    for grp, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("gate", "up", "down"))):
        for name in names:
            got, want = tq["blocks"][grp][name], jq["blocks"][grp][name]
            assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
            np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
            np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert torch.equal(tq["embed"], tp["embed"])   # not a projection: untouched


@pytest.mark.parametrize("shape,batch_dims", [((8, 16), None), ((3, 8, 16), None),
                                              ((3, 3, 8, 16), None), ((2, 4, 8, 16), 2)])
def test_quantize_leaf_axes_equal_reference(shape, batch_dims):
    w = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = JQ.quantize_leaf(jnp.asarray(w), bits=4, batch_dims=batch_dims)
    got = TQ.quantize_leaf(torch.from_numpy(w), bits=4, batch_dims=batch_dims)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(TQ.dequantize_leaf(got, torch.float32).numpy(),
                                  np.asarray(JQ.dequantize_leaf(want, jnp.float32)))
    with pytest.raises(ValueError, match="bits"):
        TQ.quantize_leaf(torch.from_numpy(w), bits=1)


def test_bridge_carries_int_grid_leaves_with_their_dtypes():
    _, jp, _, _ = models()
    jq, _, _ = JQ.quantize_tree(jp, bits=8)
    tq = params_from_numpy(to_numpy(jq), device="cpu")
    leaf = tq["blocks"]["mlp"]["down"]
    assert leaf["q"].dtype == torch.int8 and leaf["s"].dtype == torch.float32
    np.testing.assert_array_equal(leaf["q"].numpy(), np.asarray(jq["blocks"]["mlp"]["down"]["q"]))


def test_int_grid_tree_serves_like_reference():
    """The int-grid tree decodes through ``layers.linear`` (dequantize +
    matmul): prefill logits equal the reference's."""
    jm, jp, tm, tp = models()
    jq, _, _ = JQ.quantize_tree(jp, bits=8)
    tq, _, _ = TQ.quantize_tree(tp, bits=8)
    toks = np.random.RandomState(0).randint(0, 256, (1, 16)).astype(np.int32)
    want, _ = jm.forward(jq, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _ = tm.forward(tq, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# commit / rollback, bit for bit
# ---------------------------------------------------------------------------


def _pools(seed=0):
    pool = np.random.RandomState(seed).randn(2, 6, 4, 3).astype(np.float32)
    return (JKV.PagedKVCache(pool={"k": jnp.asarray(pool)}, dense={}, page_size=4),
            TKV.PagedKVCache(pool={"k": torch.from_numpy(pool.copy())}, page_size=4))


def test_commit_token_equals_reference():
    jc, tc = _pools()
    tables = np.array([[1, 2], [3, 0], [4, 5]], np.int32)
    tok = np.random.RandomState(1).randn(2, 3, 3).astype(np.float32)
    pos = np.array([1, 3, 9], np.int32)           # the last one is past the table
    jc = JKV.commit_token(jc, {"k": jnp.asarray(tok)}, jnp.asarray(tables), jnp.asarray(pos))
    tc = TKV.commit_token(tc, {"k": torch.from_numpy(tok)}, torch.from_numpy(tables),
                          torch.from_numpy(pos))
    got, want = tc.pool["k"].numpy(), np.asarray(jc.pool["k"])
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])   # scratch (0) is never read


def test_commit_tokens_and_rollback_equal_reference():
    """A random pool: T=4 rows per slot committed, then rolled back to keep
    = 1, 3 and 0 rows.  Rejected rows are zeroed; kept rows, other slots'
    rows and other pages equal the reference's bit for bit."""
    jc, tc = _pools(2)
    tables = np.array([[1, 2], [3, 0], [4, 5]], np.int32)
    rows = np.random.RandomState(3).randn(2, 3, 4, 3).astype(np.float32)
    pos = np.array([2, 0, 5], np.int32)
    keep = np.array([1, 3, 0], np.int32)
    jc = JKV.commit_tokens(jc, {"k": jnp.asarray(rows)}, jnp.asarray(tables), jnp.asarray(pos))
    tc = TKV.commit_tokens(tc, {"k": torch.from_numpy(rows)}, torch.from_numpy(tables),
                           torch.from_numpy(pos))
    np.testing.assert_array_equal(tc.pool["k"].numpy()[:, 1:], np.asarray(jc.pool["k"])[:, 1:])
    jc = JKV.rollback_tokens(jc, jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(keep), 4)
    tc = TKV.rollback_tokens(tc, torch.from_numpy(tables), torch.from_numpy(pos),
                             torch.from_numpy(keep), 4)
    got = tc.pool["k"].numpy()
    np.testing.assert_array_equal(got[:, 1:], np.asarray(jc.pool["k"])[:, 1:])
    view = TKV.gather_views(tc, torch.from_numpy(tables))["k"].numpy()
    np.testing.assert_array_equal(view[:, 0, 2:3], rows[:, 0, :1])
    assert not view[:, 0, 3:6].any() and not view[:, 2, 5:8].any()
    np.testing.assert_array_equal(view[:, 1, 0:3], rows[:, 1, :3])
    grid = np.array([[0, 5, 9], [1, 2, 3], [4, 8, 12]], np.int32)
    sel = np.array([[True, False, True], [True, True, False], [False, True, True]])
    for a, b in zip(TKV.resolve_pages(torch.from_numpy(tables), torch.from_numpy(grid), 4,
                                      select=torch.from_numpy(sel)),
                    JKV.resolve_pages(jnp.asarray(tables), jnp.asarray(grid), 4,
                                      select=jnp.asarray(sel))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_multi_token_view_write_drops_rows_past_the_view():
    """A verify's rows that pass the end of the cache view are dropped, as
    JAX's scatter drops them, and the last row in the view keeps the value
    written to it (the dropped writes land there with that value)."""
    from repro_torch.models.layers import write_view

    rng = np.random.RandomState(5)
    view = rng.randn(3, 6, 2).astype(np.float32)
    rows = rng.randn(3, 4, 2).astype(np.float32)
    grid = np.array([[3, 4, 5, 6], [4, 5, 6, 7], [0, 1, 2, 3]], np.int32)
    bidx = np.arange(3)[:, None]
    want = jnp.asarray(view).at[bidx, jnp.asarray(grid)].set(jnp.asarray(rows))
    got = write_view(torch.from_numpy(view.copy()), torch.from_numpy(rows),
                     torch.from_numpy(grid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = np.array([[5], [6], [2]], np.int32)             # T=1: one row dropped
    want = want.at[bidx, jnp.asarray(one)].set(jnp.asarray(rows[:, :1]))
    got = write_view(got, torch.from_numpy(rows[:, :1].copy()), torch.from_numpy(one))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# rejection sampling
# ---------------------------------------------------------------------------


def test_rejection_outcome_probs_equal_p():
    """For any draft/target pair the closed-form outcome of one accept step
    is the target distribution (the reference's property test, on the
    port's helpers)."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=60, deadline=None)
    @given(st.lists(st.floats(-8, 8), min_size=2, max_size=12),
           st.lists(st.floats(-8, 8), min_size=2, max_size=12), st.floats(0.2, 3.0))
    def prop(lt, ld, temp):
        n = min(len(lt), len(ld))
        p = torch.softmax(torch.tensor(lt[:n], dtype=torch.float32) / temp, -1)
        q = torch.softmax(torch.tensor(ld[:n], dtype=torch.float32) / temp, -1)
        np.testing.assert_allclose(TSP.rejection_outcome_probs(p, q).numpy(), p.numpy(),
                                   atol=1e-5)

    prop()


def test_rejection_helpers_equal_reference():
    """The port's residual and outcome distributions equal the reference's
    on the same rows: random pairs, an equal pair (no residual mass) and a
    pair with disjoint support."""
    rng = np.random.RandomState(6)
    lt = rng.uniform(-8, 8, (64, 9)).astype(np.float32)
    ld = rng.uniform(-8, 8, (64, 9)).astype(np.float32)
    ld[0] = lt[0]
    lt[1, :4], ld[1, 4:] = -1e4, -1e4
    p = torch.softmax(torch.from_numpy(lt), -1)
    q = torch.softmax(torch.from_numpy(ld), -1)
    pj, qj = jnp.asarray(p.numpy()), jnp.asarray(q.numpy())
    for port, ref in ((TSP.residual_distribution, JSP.residual_distribution),
                      (TSP.rejection_outcome_probs, JSP.rejection_outcome_probs)):
        np.testing.assert_allclose(port(p, q).numpy(), np.asarray(ref(pj, qj)), atol=1e-6)


@pytest.mark.parametrize("temp", [0.5, 1.0, 2.0])
def test_accept_draws_follow_the_target_softmax(temp):
    """20,000 rows of one decode state: drafts sampled from the draft
    softmax, accepted and corrected by ``_accept``; the first emitted token
    follows softmax(target / T) by chi-square (p >= 1e-4), and greedy rows
    emit the target argmax."""
    rows, kk, v = 20_000, 3, 6
    rng = np.random.RandomState(0)
    lt = torch.from_numpy(rng.uniform(-1, 1, v).astype(np.float32))
    ld = torch.from_numpy(rng.uniform(-1, 1, v).astype(np.float32))
    gen = torch.Generator()
    gen.manual_seed(0)
    temps = torch.full((rows,), temp)
    drafts = torch.stack([sample_on_device(ld.expand(rows, v), temps, gen) for _ in range(kk)])
    logits_t = lt.expand(rows, kk + 1, v)
    draft_lg = ld.expand(kk, rows, v)
    k_el = torch.full((rows,), kk, dtype=torch.int32)
    out, n_emit = TSP._accept(logits_t, draft_lg, drafts, k_el, temps, gen)
    assert ((n_emit >= 1) & (n_emit <= kk + 1)).all()
    counts = np.bincount(out[:, 0].numpy(), minlength=v)
    expected = torch.softmax(lt.double() / temp, -1).numpy() * rows
    assert stats.chisquare(counts, expected).pvalue >= 1e-4, (counts, expected)
    greedy, n_g = TSP._accept(logits_t[:4], draft_lg[:, :4], drafts[:, :4], k_el[:4],
                              torch.zeros(4), gen)
    assert (greedy[torch.arange(4), n_g.long() - 1] == int(lt.argmax())).all()


def test_accept_greedy_equals_reference():
    """Greedy acceptance on random logits with per-slot budgets: the grid
    and the counts are the reference's."""
    rng = np.random.RandomState(4)
    b, kk, v = 5, 3, 7
    lt = rng.randn(b, kk + 1, v).astype(np.float32)
    ld = rng.randn(kk, b, v).astype(np.float32)
    drafts = lt[:, :kk].argmax(-1).T.astype(np.int32)
    drafts[1, 2] = (drafts[1, 2] + 1) % v          # slot 2 rejects its second draft
    k_el = np.array([3, 2, 3, 1, 3], np.int32)
    temps = np.zeros(b, np.float32)
    want, want_n, _ = jax.jit(JSP._accept)(jnp.asarray(lt), jnp.asarray(ld), jnp.asarray(drafts),
                                  jnp.asarray(k_el), jnp.asarray(temps), jax.random.PRNGKey(0))
    got, got_n = TSP._accept(torch.from_numpy(lt), torch.from_numpy(ld), torch.from_numpy(drafts),
                             torch.from_numpy(k_el), torch.from_numpy(temps), torch.Generator())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def test_dense_cache_speculation_falls_back_to_the_plain_runner():
    _, _, tm, tp = _trees(True)
    eng = TEngine(tm, tp, device="cpu", forms=True, speculate=True, max_len=32,
                  batch_slots=2, page_size=0)
    assert not eng.speculative and type(eng.runner) is ModelRunner
    assert "speculate" not in eng.stats()
