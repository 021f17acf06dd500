"""PyTorch port vs the JAX package: FORMS compression codes and trees.

The same numpy matrices go through ``repro.forms`` and ``repro_torch.forms``;
the codes must agree bit for bit (both round half to even).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import forms as jforms
from repro_torch import forms as tforms
from repro_torch.bridge import forms_leaf_from_numpy, params_from_numpy
from repro_torch.core import fragments as tfrag

from torch_parity_util import compressed, to_numpy


def _planes(p):
    return [np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy()
            for a in (p.mags, p.signs, p.scale)]


@pytest.mark.parametrize("rule", ["sum", "energy"])
@pytest.mark.parametrize("bits", [4, 8, 10])
@pytest.mark.parametrize("K,N,m", [(64, 32, 8), (30, 17, 8), (50, 40, 16), (12, 9, 4)])
def test_from_dense_codes_bit_identical(rule, bits, K, N, m):
    w = np.random.RandomState(K * N + bits).randn(K, N).astype(np.float32)
    jp, jerr = jforms.from_dense(jnp.asarray(w), jforms.FormsSpec(m=m, bits=bits, rule=rule))
    tp, terr = tforms.from_dense(torch.from_numpy(w), tforms.FormsSpec(m=m, bits=bits, rule=rule))
    for a, b in zip(_planes(jp), _planes(tp)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tp.mags.dtype == (torch.uint8 if bits <= 8 else torch.int32)
    assert (tp.k, tp.m, tp.bits) == (jp.k, jp.m, jp.bits)
    np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-5)
    np.testing.assert_array_equal(tforms.to_dense(tp).numpy(), np.asarray(jforms.to_dense(jp)))


def test_compress_tree_matches_leaf_by_leaf():
    jc, jrep, tc, trep = compressed()
    jleaves = jforms.compressed_paths(jc)
    tleaves = tforms.compressed_paths(tc)
    assert sorted(jleaves) == sorted(tleaves) == sorted(jrep.errors)
    for path, jl in jleaves.items():
        tl = tleaves[path]
        for a, b in zip(_planes(jl), _planes(tl)):
            np.testing.assert_array_equal(a, b, err_msg=path)
        assert (tl.k, tl.m, tl.bits, tl.out_dtype) == (jl.k, jl.m, jl.bits, jl.out_dtype)
        np.testing.assert_allclose(trep.errors[path], jrep.errors[path], rtol=1e-5)
    assert (trep.num_compressed, trep.num_skipped) == (jrep.num_compressed, jrep.num_skipped)
    assert (trep.bytes_dense, trep.bytes_compressed) == (jrep.bytes_dense, jrep.bytes_compressed)
    # decompression is exact on both sides
    jd = jforms.decompress_tree(jc)
    td = tforms.decompress_tree(tc)
    np.testing.assert_array_equal(td["blocks"]["mlp"]["down"].numpy(),
                                  np.asarray(jd["blocks"]["mlp"]["down"]))
    # compressing a compressed tree leaves it alone
    again, rep2 = tforms.compress_tree(tc, tforms.FormsSpec(m=8, bits=8))
    assert rep2.num_compressed == 0 and again["blocks"]["attn"]["wq"] is tc["blocks"]["attn"]["wq"]


def test_plan_overrides_and_bridge_of_compressed_tree():
    rng = np.random.RandomState(7)
    tree = {"blocks": {"attn": {"wq": rng.randn(2, 16, 16).astype(np.float32)},
                       "mlp": {"down": rng.randn(2, 20, 8).astype(np.float32)}},
            "final_norm": np.ones(8, np.float32)}
    jp = {"blocks": {"attn": {"wq": jnp.asarray(tree["blocks"]["attn"]["wq"])},
                     "mlp": {"down": jnp.asarray(tree["blocks"]["mlp"]["down"])}},
          "final_norm": jnp.asarray(tree["final_norm"])}
    tp = params_from_numpy(tree, device="cpu")
    jplan = {"attn/wq": jforms.FormsSpec(m=8, bits=4), "mlp/down": jforms.FormsSpec(m=4, bits=10)}
    tplan = {"attn/wq": tforms.FormsSpec(m=8, bits=4), "mlp/down": tforms.FormsSpec(m=4, bits=10)}
    jc, jrep = jforms.compress_tree(jp, jforms.FormsSpec(), plan=jplan)
    tc, trep = tforms.compress_tree(tp, tforms.FormsSpec(), plan=tplan)
    assert trep.bits == jrep.bits == {"blocks/attn/wq": 4, "blocks/mlp/down": 10}
    assert trep.num_skipped == jrep.num_skipped == 1
    # the reference's compressed tree, bridged, equals the port's own
    bridged = params_from_numpy(to_numpy(jc), device="cpu")
    for path, leaf in tforms.compressed_paths(tc).items():
        other = tforms.compressed_paths(bridged)[path]
        assert (other.k, other.m, other.bits) == (leaf.k, leaf.m, leaf.bits)
        for a, b in zip(_planes(leaf), _planes(other)):
            np.testing.assert_array_equal(a, b, err_msg=path)
    with pytest.raises(ValueError, match="matched no compressed leaf"):
        tforms.compress_tree(tp, tforms.FormsSpec(), plan={"attn/wqq": tforms.FormsSpec()})
    with pytest.raises(KeyError):
        tforms.spec_for_path({"attn/wq": tforms.FormsSpec()}, "blocks/mlp/up")


def test_forms_leaf_from_numpy_and_spec_validation():
    w = np.random.RandomState(3).randn(20, 6).astype(np.float32)
    jp, _ = jforms.from_dense(jnp.asarray(w), jforms.FormsSpec(m=8))
    leaf = forms_leaf_from_numpy(np.asarray(jp.mags), np.asarray(jp.signs),
                                 np.asarray(jp.scale), {"k": 20, "m": 8}, device="cpu")
    np.testing.assert_array_equal(tforms.to_dense(leaf).numpy(), np.asarray(jforms.to_dense(jp)))
    with pytest.raises(ValueError, match="unknown FormsLinearParams fields"):
        forms_leaf_from_numpy(leaf.mags, leaf.signs, leaf.scale, {"k": 20, "q": 1}, device="cpu")
    for bad in (dict(bits=7), dict(rule="median"), dict(m=0), dict(zero_skip="x"),
                dict(bk=0), dict(zero_skip_keep=0.0)):
        with pytest.raises(ValueError):
            tforms.FormsSpec(**bad)
    assert ({f.name for f in dataclasses.fields(tforms.FormsSpec)}
            == {f.name for f in dataclasses.fields(jforms.FormsSpec)} - {"prefer_ref"})


def test_conv_matrix_views_match_reference():
    from repro.core import fragments as jfrag
    w = np.random.RandomState(5).randn(3, 2, 4, 5).astype(np.float32)
    for policy in ("W", "H", "C"):
        jm = np.asarray(jfrag.conv_to_matrix(jnp.asarray(w), policy))
        tm = tfrag.conv_to_matrix(torch.from_numpy(w), policy)
        np.testing.assert_array_equal(tm.numpy(), jm)
        np.testing.assert_array_equal(tfrag.matrix_to_conv(tm, w.shape, policy).numpy(), w)
    for path, shape in (("blocks/attn/wq", (2, 4, 4)), ("embed", (8, 4)),
                        ("blocks/attn/bq", (2, 8)), ("final_norm", (4,))):
        assert tfrag.is_crossbar_weight(path, shape) == jfrag.is_crossbar_weight(path, shape)
