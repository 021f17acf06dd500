"""PyTorch port vs the JAX package: serving end to end.

Greedy decoding must give the reference engine's tokens exactly, on the
paged cache and on the dense slot cache, with and without FORMS and with
the prefix cache on and off,
at ``dtype="float32"`` (as ``tests/test_serving_paged.py`` runs the
reference).  Temperature sampling draws from another generator than
``jax.random``, so it is held to determinism per seed, not to JAX's tokens.
"""
import io
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import forms as jforms
from repro.serving import kv_cache as JKV
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import forms as tforms
from repro_torch.launch import serve as tserve
from repro_torch.serving import kv_cache as TKV
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

from torch_parity_util import models, shared_codes


def _requests(cls, n=4, new=6, shared_prefix=0, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, shared_prefix)
    return [cls(uid=i, prompt=np.concatenate([base, rng.randint(0, 256, rng.randint(2, 12))]),
                max_new_tokens=new) for i in range(n)]


def _tokens(results):
    return {r.uid: list(r.tokens) for r in results}


def _serve_both(forms, **kw):
    jm, jp, tm, tp = models()
    if forms:
        jp, tp = shared_codes()   # both engines take the tree as compressed
    shared = kw.pop("shared_prefix", 0)
    common = dict(max_len=32, batch_slots=2, page_size=8, forms=forms, **kw)
    je = JEngine(jm, jp, **common)
    te = TEngine(tm, tp, device="cpu", **common)
    want = _tokens(je.run(_requests(JRequest, shared_prefix=shared)))
    got = _tokens(te.run(_requests(TRequest, shared_prefix=shared)))
    return je, te, want, got


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["no-prefix", "prefix"])
@pytest.mark.parametrize("forms", [False, True], ids=["dense", "forms"])
def test_greedy_tokens_identical_to_reference(forms, prefix_cache):
    je, te, want, got = _serve_both(forms, prefix_cache=prefix_cache,
                                    shared_prefix=8 if prefix_cache else 0)
    assert got == want
    assert all(len(t) == 6 for t in got.values())
    assert te.stats()["max_concurrent"] == je.scheduler.max_concurrent == 2
    assert te.stats()["pages"] == je.stats()["pages"]
    if prefix_cache:
        assert te.stats()["prefix_hits"] == je.stats()["prefix_hits"] > 0


def test_admission_blocks_on_page_budget_like_reference():
    """A pool of one max_len request's pages: admission waits for pages,
    re-admission reuses freed pages, and the tokens still match."""
    je, te, want, got = _serve_both(True, num_pages=5)
    assert got == want
    assert list(te.scheduler.admissions) == list(je.scheduler.admissions)
    assert te.page_allocator.free_pages == te.page_allocator.capacity


def test_temperature_sampling_is_deterministic_per_seed():
    _, _, tm, tp = models()

    def run(seed):
        eng = TEngine(tm, tp, max_len=32, batch_slots=2, page_size=8, rng_seed=seed,
                      device="cpu")
        reqs = _requests(TRequest)
        for r in reqs:
            r.temperature = 1.0
        return _tokens(eng.run(reqs))

    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c
    assert all(0 <= t < 256 for toks in a.values() for t in toks)


def test_unported_options_are_refused():
    _, _, tm, tp = models()
    kw = dict(max_len=32, batch_slots=2, device="cpu")
    for extra in (dict(mesh=object()), dict(draft_plan={"attn/wq": tforms.FormsSpec()}),
                  dict(health=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
            TEngine(tm, tp, **kw, **{"page_size": 8, **extra})
    # the fleet scheduler is ported: slo= builds it (tests/test_torch_fleet.py)
    assert type(TEngine(tm, tp, page_size=8, slo={}, **kw).scheduler).__name__ == \
        "FleetScheduler"
    with pytest.raises(ValueError, match="plan="):
        TEngine(tm, tp, page_size=8, plan={"attn/wq": tforms.FormsSpec()}, **kw)


@pytest.mark.parametrize("forms", [False, True], ids=["dense", "forms"])
def test_dense_slot_cache_tokens_equal_reference_and_paged(forms):
    """``page_size=0`` serves on the dense (layers, slots, max_len, ...)
    cache: greedy tokens equal the reference's dense engine and the port's
    paged engine."""
    jm, jp, tm, tp = models()
    if forms:
        jp, tp = shared_codes()
    common = dict(max_len=32, batch_slots=2, forms=forms)
    je = JEngine(jm, jp, **common)                        # the reference's default: dense
    te = TEngine(tm, tp, device="cpu", page_size=0, **common)
    want = _tokens(je.run(_requests(JRequest)))
    got = _tokens(te.run(_requests(TRequest)))
    paged = _tokens(TEngine(tm, tp, device="cpu", page_size=8, **common)
                    .run(_requests(TRequest)))
    assert not je.paged and not te.paged and te.page_allocator is None
    assert got == want == paged
    assert te.cache_bytes() == je.cache_bytes()
    assert "pages" not in te.stats() and te.stats()["max_concurrent"] == 2


def test_speculate_on_the_dense_cache_falls_back_like_reference():
    jm, jp, tm, tp = models()
    common = dict(max_len=32, batch_slots=2, speculate=True)
    je = JEngine(jm, jp, **common)
    te = TEngine(tm, tp, device="cpu", page_size=0, **common)
    assert not je.speculative and not te.speculative
    got = _tokens(te.run(_requests(TRequest)))
    assert got == _tokens(TEngine(tm, tp, device="cpu", max_len=32, batch_slots=2,
                                  page_size=0).run(_requests(TRequest)))


def test_gather_commit_roundtrip_matches_reference():
    pool = np.zeros((2, 5, 4, 3), np.float32)
    rows = np.arange(2 * 1 * 6 * 3, dtype=np.float32).reshape(2, 1, 6, 3)
    pages = np.array([3, 1], np.int32)
    table = np.array([[3, 1]], np.int32)
    jc = JKV.PagedKVCache(pool={"k": jnp.asarray(pool)}, dense={}, page_size=4)
    tc = TKV.PagedKVCache(pool={"k": torch.from_numpy(pool.copy())}, page_size=4)
    jc = JKV.commit_pages(jc, {"k": jnp.asarray(rows)}, jnp.asarray(pages))
    tc = TKV.commit_pages(tc, {"k": torch.from_numpy(rows)}, torch.from_numpy(pages))
    tok = np.full((2, 1, 1, 3), -1.0, np.float32)
    for pos in (6, 8):   # on the table, then past it (scratch)
        jc = JKV.commit_tokens(jc, {"k": jnp.asarray(tok)}, jnp.asarray(table),
                               jnp.asarray([pos], jnp.int32))
        tc = TKV.commit_tokens(tc, {"k": torch.from_numpy(tok)}, torch.from_numpy(table),
                               torch.tensor([pos], dtype=torch.int32))
        np.testing.assert_array_equal(tc.pool["k"].numpy(), np.asarray(jc.pool["k"]))
    np.testing.assert_array_equal(
        TKV.gather_views(tc, torch.from_numpy(table))["k"].numpy(),
        np.asarray(JKV.gather_views(jc, jnp.asarray(table))["k"]))
    grid = np.array([[0, 5, 9, 40]], np.int32)
    for a, b in zip(TKV.resolve_pages(torch.from_numpy(table), torch.from_numpy(grid), 4),
                    JKV.resolve_pages(jnp.asarray(table), jnp.asarray(grid), 4)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_page_allocator_and_prefix_cache_bookkeeping():
    a = TKV.PageAllocator(5)
    p1, p2 = a.alloc(2), a.alloc(2)
    assert a.alloc(1) is None and a.stats()["failed_allocs"] == 1
    a.share(p1)
    assert a.release(p1) == [] and sorted(a.release(p1)) == sorted(p1)
    assert set(a.alloc(2)) == set(p1)
    a.release(p2)
    with pytest.raises(ValueError, match="released more times than held"):
        a.release(p2)
    pc = TKV.PrefixCache(page_size=4)
    prompt = np.arange(10, dtype=np.int32)
    pc.register(prompt, [7, 8, 9])
    assert pc.match(prompt) == [7, 8] and pc.match(prompt[:6]) == [7]
    pc.evict([8])
    assert pc.match(prompt) == [7]


def test_launcher_serves_on_the_cpu_when_asked():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--reduced", "--device", "cpu", "--forms", "--requests", "3",
                     "--max-new-tokens", "4", "--max-len", "32", "--prefix-cache"])
    text = out.getvalue()
    assert "forms: 7 leaves compressed" in text
    assert "3 requests, 12 tokens" in text and "device=cpu" in text
    assert jforms.FormsSpec().rule == tforms.FormsSpec().rule == "energy"


@pytest.mark.parametrize("flags,expect", [
    (["--forms", "--speculate", "--draft-k", "3", "--draft-bits", "4"],
     ("speculate: k=3, 4-bit forms draft, layer_step=1", "acceptance ")),
    (["--forms", "--speculate", "--draft-mode", "int", "--draft-bits", "8",
      "--draft-layer-step", "2", "--no-adaptive-k"],
     ("speculate: k=4, 8-bit int draft, layer_step=2 (int grid)", "tok/round ")),
    (["--page-size", "0", "--speculate"],
     ("dense slot cache: 4 slots x 32 rows", "speculate: unsupported on the dense cache")),
], ids=["speculate-forms", "speculate-int", "dense-cache"])
def test_launcher_serves_speculatively_and_densely_on_the_cpu(flags, expect):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--reduced", "--device", "cpu", "--requests", "3",
                     "--max-new-tokens", "5", "--max-len", "32"] + flags)
    text = out.getvalue()
    assert "3 requests, 15 tokens" in text and "device=cpu" in text
    for line in expect:
        assert line in text, text
    with pytest.raises(SystemExit, match="item 8"):
        tserve.main(["--reduced", "--device", "cpu", "--speculate", "--auto-draft"])
