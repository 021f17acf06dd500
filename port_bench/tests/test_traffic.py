"""The generators: the same seed gives the same inputs; every seed and
every batch holds the same sizes, in another order."""
import numpy as np
import pytest

from port_bench.harness import spec as S
from port_bench.harness import traffic as TR
from port_bench.harness.lmdata import lm_tokens

BIG = 2 ** 31 + 12345        # seeds may pass 32 signed bits


@pytest.mark.parametrize("mix", ["longprompt", "decode"])
@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_batches_are_a_function_of_seed_and_index(mix, seed):
    m = S.load_cell({"longprompt": "qwen2-1.5b.longprompt",
                     "decode": "olmoe-1b-7b.decode"}[mix]).traffic
    a = TR.batch(m, 50304, seed, 3)
    b = TR.batch(m, 50304, seed, 3)
    assert [(p.tolist(), o) for p, o in a] == [(p.tolist(), o) for p, o in b]
    c = TR.batch(m, 50304, seed, 4)
    assert [p.tolist() for p, _ in a] != [p.tolist() for p, _ in c]
    lo, hi = m["prompt_len"]
    olo, ohi = m["out_len"]
    assert len(a) == m["batch_requests"]
    assert all(lo <= len(p) <= hi and olo <= o <= ohi for p, o in a)
    assert all(p.dtype == np.int32 and 0 <= p.min() and p.max() < 50304 for p, _ in a)


def test_every_seed_and_batch_holds_the_same_sizes():
    m = S.load_cell("qwen2-1.5b.longprompt").traffic
    sizes = {tuple(sorted(len(p) for p, _ in TR.batch(m, 1000, s, j)))
             for s in (1, 2, BIG) for j in (0, 5)}
    outs = {tuple(sorted(o for _, o in TR.batch(m, 1000, s, j)))
            for s in (1, 2, BIG) for j in (0, 5)}
    assert len(sizes) == 1 and len(outs) == 1
    orders = {tuple(len(p) for p, _ in TR.batch(m, 1000, s, 0)) for s in (1, 2, BIG)}
    assert len(orders) == 3


def test_warm_batch_covers_every_prefill_shape():
    m = S.load_cell("qwen2-1.5b.longprompt").traffic
    bucket = lambda n: 1 << max(3, (n - 1).bit_length())   # noqa: E731
    warm = TR.warm_batch(m, 1000, 5, bucket)
    assert sorted(bucket(len(p)) for p, _ in warm) == [1024, 2048, 4096]
    exact = TR.warm_batch(S.load_cell("olmoe-1b-7b.decode").traffic, 1000, 5, lambda n: n)
    assert sorted(len(p) for p, _ in exact) == [32, 256]


@pytest.mark.parametrize("seed", [3, BIG])
def test_token_stream_is_a_function_of_seed_and_step(seed):
    m = S.load_cell("qwen2-1.5b.admm-train").traffic
    small = dict(m, batch=2, seq_len=64)
    a, b = lm_tokens(small, 500, seed, 1), lm_tokens(small, 500, seed, 1)
    assert a.shape == (2, 64) and a.dtype == np.int32
    assert (a == b).all()
    assert (a != lm_tokens(small, 500, seed, 2)).any()
    assert (a[0] != a[1]).any()                 # every row differs
