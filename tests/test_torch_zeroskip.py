"""PyTorch port vs the JAX package: input zero-skipping.

The sparsity helpers, the zero-skip routes of the polarized matmul
(``block`` and ``compact``) against the reference's Pallas skip kernel in
interpret mode and its oracle route, fragment sparsification, and the
serving engine with ``zero_skip`` on: greedy tokens, the measured sparsity
in ``stats()`` and the guards.  Inputs come from numpy with a seed; on the
CPU the port runs its plain versions.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import sparsity as JS
from repro.models import layers as JL
from repro.models.registry import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.forms import FormsSpec
from repro_torch.kernels import ops, ref
from repro_torch.kernels import polarized_matmul as pm
from repro_torch.kernels import sparsity as TS
from repro_torch.models import layers as TL
from repro_torch.models.registry import build as torch_build
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

from torch_parity_util import configs, models, shared_codes

RTOL, ATOL = 1e-5, 1e-4     # tests/test_kernels.py's, both sides f32 sums


def _operands(seed, M, K, N, m):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    mags = rng.randint(0, 256, (K, N)).astype(np.uint8)
    signs = np.where(rng.rand(K // m, N) < 0.5, 1, -1).astype(np.int8)
    scale = (rng.rand(1, N) * 0.01).astype(np.float32)
    return x, mags, signs, scale


def _drop_fragments(x, m, frac, seed):
    """Zero a random ``frac`` of the whole m-fragments of each row."""
    M, K = x.shape
    keep = np.random.RandomState(seed).rand(M, K // m) >= frac
    return x * np.repeat(keep, m, axis=1).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# sparsity helpers: equal to the reference's
# ---------------------------------------------------------------------------

def test_sparsity_helpers_equal_reference():
    x = _drop_fragments(np.random.RandomState(0).randn(8, 64).astype(np.float32), 4, 0.6, 1)
    x[:, 40:] = 0.0
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(TS.block_mask(tx, 4, 16).numpy(),
                                  np.asarray(JS.block_mask(jx, 4, 16)))
    assert TS.block_mask(tx, 4, 16).dtype == torch.int32
    xf = x.reshape(8, 16, 4)
    np.testing.assert_array_equal(TS.fragment_live(torch.from_numpy(xf)).numpy(),
                                  np.asarray(JS.fragment_live(jnp.asarray(xf))))
    live = TS.fragment_occupancy(tx, 4)
    np.testing.assert_array_equal(live.numpy(), np.asarray(JS.fragment_occupancy(jx, 4)))
    np.testing.assert_array_equal(TS.compact_order(live).numpy(),
                                  np.asarray(JS.compact_order(jnp.asarray(live.numpy()))))
    for m in (4, 5):    # 5 does not divide K: element counts only
        np.testing.assert_array_equal(TS.sparsity_counts(tx, m).numpy(),
                                      np.asarray(JS.sparsity_counts(jx, m)).astype(np.int64))
    with pytest.raises(ValueError, match="tiled input"):
        TS.block_mask(tx, 3, 16)


def test_sparsity_meter_summary_equals_reference():
    rng = np.random.RandomState(2)
    tm, jm = TS.SparsityMeter(), JS.SparsityMeter()
    for tag, frac in (("down", 0.7), ("wq", 0.0), ("down", 0.3), ("up", 0.5)):
        x = _drop_fragments(rng.randn(3, 32).astype(np.float32), 8, frac, rng.randint(99))
        tm.record(tag, TS.sparsity_counts(torch.from_numpy(x), 8))
        jm.record(tag, JS.sparsity_counts(jnp.asarray(x), 8))
    assert tm.summary() == jm.summary()
    tm.reset()
    assert tm.summary()["overall"]["calls"] == 0


# ---------------------------------------------------------------------------
# the zero-skip routes of the polarized matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["block", "compact"])
@pytest.mark.parametrize("M", [3, 6])
def test_zero_skip_routes_match_reference(mode, M):
    """Port (plain versions) vs the reference's Pallas route (``_kernel_skip``
    in interpret mode for ``block``) and its oracle route, on inputs with
    dead fragments and a whole dead K slice of the port's tiling."""
    K, N, m = 640, 24, 8
    x, mags, signs, scale = _operands(M, M, K, N, m)
    x = _drop_fragments(x, m, 0.7, seed=M)
    x[:, 256:512] = 0.0
    got = ops.polarized_matmul(*_t(x, mags, signs, scale), m=m, zero_skip=mode,
                               zero_skip_keep=0.6).numpy()
    for prefer_ref in (False, True):
        want = np.asarray(jops.polarized_matmul(
            *map(jnp.asarray, (x, mags, signs, scale)), m=m, prefer_ref=prefer_ref,
            zero_skip=mode, zero_skip_keep=0.6))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    spec = FormsSpec(m=m, zero_skip=mode, zero_skip_keep=0.6)
    assert torch.equal(ops.polarized_matmul(*_t(x, mags, signs, scale), spec=spec),
                       torch.from_numpy(got))


def test_compact_falls_back_to_the_dense_product():
    """A dense input exceeds any keep budget: compaction runs the full
    product, exactly the dense route's."""
    x, mags, signs, scale = _t(*_operands(4, 4, 32, 8, 4))
    dense = ops.polarized_matmul(x, mags, signs, scale, m=4)
    y = ops.polarized_matmul(x, mags, signs, scale, m=4, zero_skip="compact",
                             zero_skip_keep=0.25)
    assert torch.equal(y, dense)
    want = np.asarray(jops.polarized_matmul(
        *map(jnp.asarray, (t.numpy() for t in (x, mags, signs, scale))), m=4,
        prefer_ref=True, zero_skip="compact", zero_skip_keep=0.25))
    np.testing.assert_allclose(y.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dead", [0.0, 0.5, 1.0], ids=["all-live", "half-dead", "all-dead"])
def test_plain_skip_equals_plain_dense(dead):
    """The plain skip version with the tile mask of x equals the same tiled
    sum with every tile live (``torch.equal``): a dead tile adds an exact 0."""
    M, K, N, m = 9, 768, 20, 8
    x, mags, signs, scale = _operands(5, M, K, N, m)
    bm, kc = pm.tile_rows(M), pm._KC
    tiles = [(i, k) for i in range(-(-M // bm)) for k in range(K // kc)]
    for i, k in tiles[:int(round(dead * len(tiles)))]:
        x[i * bm:(i + 1) * bm, k * kc:(k + 1) * kc] = 0.0
    tx, tmg, tsg, tsc = _t(x, mags, signs, scale)
    mask = pm.tile_mask(tx)
    assert int((mask == 0).sum()) == int(round(dead * len(tiles)))
    skip = ref.ref_polarized_matmul_skip(tx, tmg, tsg, tsc, mask, m, bm, kc)
    assert torch.equal(skip, ref.ref_polarized_matmul_skip(tx, tmg, tsg, tsc, None, m, bm, kc))
    assert torch.equal(skip, pm.polarized_matmul_skip(tx, tmg, tsg, tsc, m))
    dense = ref.ref_polarized_matmul_fast(tx, tmg, tsg, tsc, m)
    np.testing.assert_allclose(skip.numpy(), dense.numpy(), rtol=RTOL, atol=ATOL)
    if dead == 1.0:
        assert not skip.any()


def test_skip_wrapper_checks_its_mask():
    x, mags, signs, scale = _t(*_operands(6, 4, 512, 8, 8))
    with pytest.raises(ValueError, match="kernel's tiling"):
        pm.polarized_matmul_skip(x, mags, signs, scale, 8, mask=torch.ones(1, 1, dtype=torch.int32))
    before = pm.polarized_matmul_skip.launches
    pm.polarized_matmul_skip(x, mags, signs, scale, 8)
    assert pm.polarized_matmul_skip.launches == before   # CPU: the plain version


def test_sparsify_fragments_bit_identical():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 64).astype(np.float32)
    x[0, 0, 8:16] = x[0, 0, 0:8]                 # a tie at the threshold
    for m, drop in ((4, 0.5), (8, 0.25), (8, 0.0)):
        got = TL.sparsify_fragments(torch.from_numpy(x), m, drop).numpy()
        want = np.asarray(JL.sparsify_fragments(jnp.asarray(x), m, drop))
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="tile into fragments"):
        TL.sparsify_fragments(torch.from_numpy(x), 5, 0.5)


# ---------------------------------------------------------------------------
# serving with zero-skip: both engines, the reduced qwen2 in f32
# ---------------------------------------------------------------------------

SPARSE = dict(mlp_act="relu", act_sparsity=0.5, act_fragment=4)


def _sparse_engines():
    """(jax model, port model, jax tree, port tree): the reduced qwen2 with
    ReLU and 50% fragment sparsification, FORMS m=4 codes shared."""
    jcfg, tcfg = configs()
    jp, tp = shared_codes(m=4)
    return (jax_build(dataclasses.replace(jcfg, **SPARSE)),
            torch_build(dataclasses.replace(tcfg, **SPARSE), device="cpu"), jp, tp)


def _reqs(cls, n=3, new=5):
    return [cls(uid=i, prompt=np.array([1 + i, 2, 3]), max_new_tokens=new) for i in range(n)]


def _tokens(results):
    return {r.uid: list(r.tokens) for r in results}


KW = dict(max_len=32, batch_slots=2, page_size=8)


def test_zero_skip_greedy_tokens_identical():
    """Greedy decode with zero_skip off, block and compact gives the same
    tokens in the port, and the reference engine's with zero_skip="block";
    the stats carry the reference's tags and fragment sparsity."""
    jm, tm, jp, tp = _sparse_engines()
    je = JEngine(jm, jp, forms=True, fragment=4, zero_skip="block", zero_skip_stats=True, **KW)
    want = _tokens(je.run(_reqs(JRequest)))
    runs = {}
    for mode in ("off", "block", "compact"):
        te = TEngine(tm, tp, spec=FormsSpec(m=4), zero_skip=mode, zero_skip_keep=0.75,
                     zero_skip_stats=mode == "block", device="cpu", **KW)
        assert te.spec.zero_skip == mode
        runs[mode] = _tokens(te.run(_reqs(TRequest)))
        if mode == "block":
            got_sp, want_sp = te.stats()["sparsity"], je.stats()["sparsity"]
    assert runs["off"] == runs["block"] == runs["compact"] == want
    assert set(got_sp["layers"]) == set(want_sp["layers"]) >= {"down", "wq", "gate"}
    for tag, s in want_sp["layers"].items():
        assert abs(got_sp["layers"][tag]["fragment_sparsity"] - s["fragment_sparsity"]) <= 1e-3
        assert got_sp["layers"][tag]["calls"] == s["calls"]
    assert got_sp["layers"]["down"]["fragment_sparsity"] > 0.2


def test_zero_skip_stats_off_by_default():
    _, _, tm, tp = models()
    te = TEngine(tm, tp, forms=True, device="cpu", **KW)
    te.run(_reqs(TRequest, 1, new=2))
    assert "sparsity" not in te.stats()


def test_zero_skip_guards():
    """The reference's guards: zero-skip needs FORMS, an unknown mode is
    refused, and an explicit "off" is no request to skip."""
    _, _, tm, tp = models()
    with pytest.raises(ValueError, match="FORMS"):
        TEngine(tm, tp, zero_skip="compact", device="cpu", **KW)
    with pytest.raises(ValueError, match="FORMS"):
        TEngine(tm, tp, zero_skip_stats=True, device="cpu", **KW)
    with pytest.raises(ValueError, match="zero_skip"):
        TEngine(tm, tp, forms=True, zero_skip="banana", device="cpu", **KW)
    assert TEngine(tm, tp, zero_skip="off", device="cpu", **KW).spec is None
