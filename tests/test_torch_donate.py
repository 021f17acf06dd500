"""``donate=`` on the port's runners, engine and launcher, against the JAX
package.

The reference donates the cache into its jitted steps (``donate=True``)
or, with ``donate=False``, leaves the caller's cache buffers alive and
returns new ones.  The port updates its cache in place under
``donate=True`` and writes each dispatch into a fresh copy under
``donate=False``.  Greedy tokens do not depend on it, in either package.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

from torch_parity_util import models, shared_codes

MODES = {"paged": dict(page_size=8), "dense": dict(page_size=0),
         "speculative": dict(page_size=8, speculate=True, draft_k=3, draft_bits=4)}


def _requests(cls):
    rng = np.random.RandomState(0)
    return [cls(uid=i, prompt=rng.randint(0, 256, rng.randint(2, 12)), max_new_tokens=6)
            for i in range(4)]


def _tokens(results):
    return {r.uid: list(map(int, r.tokens)) for r in results}


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_tokens_equal_under_either_donate(mode):
    """donate=False serves the donate=True tokens, which are the
    reference's under donate=False (speculative: the plain engine's)."""
    jm, _, tm, _ = models()
    jc, tc = shared_codes()
    common = dict(max_len=32, batch_slots=2, **MODES[mode])
    got = {d: _tokens(TEngine(tm, tc, device="cpu", donate=d, **common)
                      .run(_requests(TRequest))) for d in (True, False)}
    jcommon = {k: v for k, v in common.items() if k not in ("speculate", "draft_k",
                                                             "draft_bits")}
    want = _tokens(JEngine(jm, jc, donate=False, **jcommon).run(_requests(JRequest)))
    assert got[True] == got[False] == want


def _held_leaf(cache):
    return cache.pool["k"] if hasattr(cache, "pool") else cache["k"]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("donate", [True, False])
def test_the_cache_held_before_a_round(mode, donate):
    """With donate=False a reference to the cache (and the draft pool) taken
    before a prefill and a decode round keeps its values and the runner
    rebinds to a fresh copy; with donate=True the held cache has moved."""
    _, _, tm, _ = models()
    _, tc = shared_codes()
    eng = TEngine(tm, tc, device="cpu", max_len=32, batch_slots=2, donate=donate,
                  **MODES[mode])
    r = eng.runner
    caches = [r.cache] + ([r.draft_cache] if eng.speculative else [])
    before = [_held_leaf(c).clone() for c in caches]
    pages = np.array([1], np.int32) if eng.paged else None
    first = r.prefill_slot(0, np.array([5, 6, 7]), pages=pages)
    tables = None
    if eng.paged:
        tables = np.zeros((2, 4), np.int32)
        tables[0, 0] = 1
    r.decode_round(np.array([first, 0], np.int32), np.array([3, 0], np.int32),
                   np.zeros(2, np.float32), block_tables=tables, active=[True, False])
    for held, old in zip(caches, before):
        assert torch.equal(_held_leaf(held), old) is (not donate)
    assert (r.cache is caches[0]) is donate


def test_serve_no_donate_runs():
    """serve --no-donate prints the tokens serve prints without it."""
    outs = []
    for extra in ([], ["--no-donate"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tserve.main(["--reduced", "--forms", "--device", "cpu", "--requests", "2",
                         "--max-new-tokens", "4", *extra])
        outs.append([line for line in buf.getvalue().splitlines() if line.startswith("req ")])
    assert outs[0] == outs[1] and len(outs[0]) == 2
