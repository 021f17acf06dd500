"""PyTorch port vs the JAX package: ReRAM fault injection, the VECOM
read-back and self-healing serving.

The injector draws the reference's numbers (``np.random.default_rng([seed,
crc32(path)])`` in the reference's order), so both packages corrupt a leaf
code for code: mags, signs and ``LeafFaults`` are held bit for bit for both
encodings and every fault kind, on a 2-D, a stacked and a mixed-precision
leaf, with the port's chunked walk forced on small leaves too.  Serving
runs the reference's reduced fixture (``tests/test_reliability.py``: a
2-layer yi-9b, float32, paged) on the reference's init weights carried
across, with the same FORMS codes in both packages: golden probe logits,
scoreboards, tick event sequences, tokens and the stat line are held to the
reference's.
"""
import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import forms as jforms
from repro import reliability as JR
from repro.configs import get_reduced as jax_reduced
from repro.models.registry import build as jax_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import forms as tforms
from repro_torch import reliability as TR
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as tserve
from repro_torch.models.registry import build as torch_build
from repro_torch.reliability import encoding as TENC
from repro_torch.reliability import faults as TF
from repro_torch.serving.engine import Request, ServingEngine

from torch_parity_util import FORMS_META, _jax_leaf, to_numpy

FAULTS = {
    "zero": dict(seed=1),
    "sigma": dict(sigma=0.1, seed=3),
    "drift_nu_sigma": dict(sigma=0.3, rho=0.2, t=10.0, nu_sigma=0.5, seed=4),
    "drift": dict(t=1000.0, nu=0.05, seed=8),
    "stuck": dict(p_stuck_on=0.05, p_stuck_off=0.03, seed=5),
    "sign_stuck": dict(p_sign_stuck=0.1, seed=6),
    "all": dict(sigma=0.2, t=3.0, nu_sigma=0.1, p_stuck_on=0.01, p_stuck_off=0.01,
                p_sign_stuck=0.05, seed=7),
}
# (leaf mags shape, bits of the leaf, bits of the caller's spec)
LEAVES = {"2d": ((64, 48), 8, 8), "stacked": ((3, 5, 32, 24), 8, 8),
          "mixed_precision": ((2, 40, 16), 4, 8)}


def _leaf_pair(shape, bits, encoding, seed=0, m=8):
    """The same random codes as a reference leaf and a port leaf."""
    rng = np.random.default_rng(seed)
    mags = rng.integers(0, 1 << bits, size=shape).astype(np.uint8)
    signs = (rng.integers(0, 2, size=shape[:-2] + (shape[-2] // m, shape[-1])) * 2 - 1
             ).astype(np.int8)
    scale = rng.random(shape[:-2] + (1, shape[-1])).astype(np.float32)
    meta = dict(k=shape[-2], m=m, bits=bits, encoding=encoding)
    jleaf = jforms.FormsLinearParams(mags=jnp.asarray(mags), signs=jnp.asarray(signs),
                                     scale=jnp.asarray(scale), **meta)
    tleaf = tforms.FormsLinearParams(mags=torch.from_numpy(mags), signs=torch.from_numpy(signs),
                                     scale=torch.from_numpy(scale), **meta)
    return jleaf, tleaf


def _same_leaf(jleaf, tleaf):
    return (np.array_equal(np.asarray(jleaf.mags), tleaf.mags.numpy())
            and np.array_equal(np.asarray(jleaf.signs), tleaf.signs.numpy())
            and str(tleaf.mags.dtype) == "torch." + np.asarray(jleaf.mags).dtype.name)


# ---------------------------------------------------------------------------
# the injector against the reference's, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("leaf", list(LEAVES))
@pytest.mark.parametrize("encoding", ["binary", "vecom"])
def test_inject_leaf_equals_reference_bit_for_bit(encoding, leaf, chunked, monkeypatch):
    if chunked:   # every leaf walked in row chunks of 4 rows
        monkeypatch.setattr(TF, "CHUNK_CELLS", 64)
    shape, bits, spec_bits = LEAVES[leaf]
    jleaf, tleaf = _leaf_pair(shape, bits, encoding)
    planes = TENC.num_planes(tforms.FormsSpec(bits=bits))
    assert chunked == (planes * tleaf.mags.numel() > TF.CHUNK_CELLS)
    for name, kw in FAULTS.items():
        jout, jstats = JR.inject_leaf(jleaf, JR.FaultModel(**kw), "blocks/mlp/up",
                                      spec=jforms.FormsSpec(m=8, bits=spec_bits))
        tout, tstats = TR.inject_leaf(tleaf, TR.FaultModel(**kw), "blocks/mlp/up",
                                      spec=tforms.FormsSpec(m=8, bits=spec_bits))
        assert _same_leaf(jout, tout), name
        assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats), name
        assert tstats.cells == tleaf.mags.numel() * bits // 2
    # the corrupted leaf keeps everything but its planes
    assert {f: getattr(tout, f) for f in FORMS_META} == {f: getattr(tleaf, f) for f in FORMS_META}
    assert tout.scale is tleaf.scale


def test_chunked_draws_equal_one_draw():
    """numpy's Generator fills in C order and consecutive calls continue one
    stream: the chunked walk's premise, held here so that a numpy upgrade
    cannot break it quietly."""
    one = TF._leaf_rng(3, "blocks/attn/wq")
    whole_n, whole_u = one.standard_normal((4, 7, 9)), one.uniform(size=(4, 7, 9))
    two = TF._leaf_rng(3, "blocks/attn/wq")
    parts_n = np.concatenate([two.standard_normal((1, 9)) for _ in range(28)])
    parts_u = np.concatenate([two.uniform(size=(r, 9)) for r in (5, 20, 3)])
    assert np.array_equal(whole_n.reshape(28, 9), parts_n)
    assert np.array_equal(whole_u.reshape(28, 9), parts_u)
    # the walk draws into buffers: standard_normal(out=) and random(out=)
    # continue the stream the reference's standard_normal / uniform(size=) fill
    three = TF._leaf_rng(3, "blocks/attn/wq")
    buf_n, buf_u = np.empty((28, 9)), np.empty((28, 9))
    for r0, r1 in ((0, 6), (6, 27), (27, 28)):
        three.standard_normal(out=buf_n[r0:r1])
    for r0, r1 in ((0, 2), (2, 28)):
        three.random(out=buf_u[r0:r1])
    assert np.array_equal(buf_n, parts_n) and np.array_equal(buf_u, parts_u)


def test_readout_tensordot_is_chunk_invariant_from_four_columns():
    """The chunked read-back sums the planes with tensordot on chunks of at
    least 4 columns, where each element's sum equals the whole array's."""
    spec = tforms.FormsSpec()
    rng = np.random.default_rng(0)
    levels = rng.uniform(-0.5, 3.5, size=(4, 40, 16))
    whole = TENC.assemble_codes(levels, spec)
    for width in (4, 5, 16, 64):
        flat = levels.reshape(4, -1)
        parts = [TENC.assemble_codes(flat[:, i:i + width], spec)
                 for i in range(0, flat.shape[1] - width + 1, width)]
        got = np.concatenate(parts)
        assert np.array_equal(got, whole.reshape(-1)[:got.size])


@pytest.mark.parametrize("encoding", ["binary", "vecom"])
def test_zero_noise_is_the_identity(encoding):
    for leaf in LEAVES.values():
        shape, bits, _ = leaf
        _, tleaf = _leaf_pair(shape, bits, encoding)
        out, rep = TR.inject_leaf(tleaf, TR.FaultModel(), "w")
        assert rep.codes_changed == 0 and rep.stuck_on == rep.stuck_off == 0
        assert torch.equal(out.mags, tleaf.mags) and torch.equal(out.signs, tleaf.signs)
        assert out.mags is not tleaf.mags


def test_vecom_cancels_column_common_drift_exactly():
    w = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), (64, 32))))
    fm = TR.FaultModel(t=1000.0, nu=0.05)     # nu_sigma=0: fully column-common
    fpb, _ = tforms.from_dense(w, tforms.FormsSpec(m=8))
    fpv, _ = tforms.from_dense(w, tforms.FormsSpec(m=8, encoding="vecom"))
    _, rep_b = TR.inject_leaf(fpb, fm, "w")
    out_v, rep_v = TR.inject_leaf(fpv, fm, "w")
    assert rep_b.codes_changed > 0          # binary read-back drifts
    assert rep_v.codes_changed == 0         # the reference columns cancel it
    assert torch.equal(out_v.mags, fpv.mags)
    # and under correlated variation vecom reads back closer
    fm = TR.FaultModel(sigma=0.15, rho=0.9, seed=3)
    (ob, rb), (ov, rv) = TR.inject_leaf(fpb, fm, "w"), TR.inject_leaf(fpv, fm, "w")
    err = lambda o: float((tforms.to_dense(o) - w).abs().mean())  # noqa: E731
    assert rv.mean_abs_dcode < rb.mean_abs_dcode and err(ov) < err(ob)


def test_errors_match_the_reference():
    cases = [dict(rho=1.5), dict(sigma=-0.1), dict(nu_sigma=-1.0),
             dict(p_stuck_on=0.8, p_stuck_off=0.8)]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            JR.FaultModel(**kw)
        with pytest.raises(ValueError) as got:
            TR.FaultModel(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="encoding"):
        tforms.FormsSpec(encoding="gray")
    assert TR.FaultModel().is_identity and not TR.FaultModel(sigma=0.1).is_identity
    tm = torch_build(_tiny_configs()[1], device="cpu")
    dense = tm.init(0)
    with pytest.raises(ValueError, match="DENSE crossbar leaf 'blocks/attn/wk'"):
        TR.inject_tree(dense, TR.FaultModel(sigma=0.1))
    out, rep = TR.inject_tree(dense, TR.FaultModel(sigma=0.1), allow_dense=True)
    assert not rep.leaves and out["blocks"]["attn"]["wq"] is dense["blocks"]["attn"]["wq"]
    _, _, tc = _trees()
    with pytest.raises(ValueError, match=r"paths not found .*'blocks/attn/nope'.*compressed_paths"):
        TR.inject_tree(tc, TR.FaultModel(), paths=["blocks/attn/nope"])


# ---------------------------------------------------------------------------
# whole trees, and serving on the reference's reduced fixture
# ---------------------------------------------------------------------------


def _tiny_configs():
    kw = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
              d_ff=64, vocab_size=64, dtype="float32")
    return (dataclasses.replace(jax_reduced("yi-9b"), **kw),
            dataclasses.replace(get_reduced("yi-9b"), **kw))


@functools.lru_cache(maxsize=None)
def _trees():
    """(jax model, jax FORMS tree, port FORMS tree): the reference's init at
    PRNGKey(0) carried across, compressed by the port, the same codes as
    reference leaves."""
    jcfg, tcfg = _tiny_configs()
    jm = jax_build(jcfg)
    tp = params_from_numpy(to_numpy(jm.init(jax.random.PRNGKey(0))), device="cpu")
    tc, _ = tforms.compress_tree(tp, tforms.FormsSpec(m=8))

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, tforms.FormsLinearParams):
            return _jax_leaf(t)
        return jnp.asarray(t.numpy())

    return jm, conv(tc), tc


def _with_encoding(tree, encoding):
    if isinstance(tree, dict):
        return {k: _with_encoding(v, encoding) for k, v in tree.items()}
    if isinstance(tree, (tforms.FormsLinearParams, jforms.FormsLinearParams)):
        return dataclasses.replace(tree, encoding=encoding)
    return tree


@pytest.mark.parametrize("encoding", ["binary", "vecom"])
def test_inject_tree_equals_reference(encoding):
    _, jc, tc = _trees()
    jc, tc = _with_encoding(jc, encoding), _with_encoding(tc, encoding)
    for kw in (FAULTS["all"], FAULTS["sigma"]):
        jout, jrep = JR.inject_tree(jc, JR.FaultModel(**kw))
        tout, trep = TR.inject_tree(tc, TR.FaultModel(**kw))
        assert list(trep.leaves) == list(jrep.leaves)
        assert {p: dataclasses.asdict(s) for p, s in trep.leaves.items()} == \
            {p: dataclasses.asdict(s) for p, s in jrep.leaves.items()}
        assert trep.summary() == jrep.summary()
        tleaves, jleaves = tforms.compressed_paths(tout), jforms.compressed_paths(jout)
        assert all(_same_leaf(jleaves[p], tleaves[p]) for p in tleaves)
    # paths= restricts the injection; the other leaves pass by reference
    target = sorted(tforms.compressed_paths(tc))[0]
    out, rep = TR.inject_tree(tc, TR.FaultModel(p_stuck_on=0.1, seed=2), paths=[target])
    assert list(rep.leaves) == [target]
    for path, leaf in tforms.compressed_paths(out).items():
        assert (leaf is tforms.compressed_paths(tc)[path]) == (path != target)


COMMON = dict(max_len=64, batch_slots=4, forms=True, page_size=8)


def _requests(cls, n=3, new=8):
    return [cls(uid=i, prompt=np.array([1 + i, 2, 3]), max_new_tokens=new) for i in range(n)]


def _tokens(results):
    return {r.uid: list(r.tokens) for r in results}


def _engines(health, **kw):
    jm, jc, tc = _trees()
    tm = torch_build(_tiny_configs()[1], device="cpu")
    je = JEngine(jm, jc, health=health and JR.HealthConfig(**health), **{**COMMON, **kw})
    te = ServingEngine(tm, tc, health=health and TR.HealthConfig(**health), device="cpu",
                       **{**COMMON, **kw})
    return je, te


def _events(engine):
    return [(e["round"], e["event"], e.get("leaves"), e.get("detail"))
            for e in engine.stats()["health"]["events"]]


def _board(engine):
    return {p: {**e, "replicas": sorted(e["replicas"].values())}
            for p, e in engine.stats()["health"]["flagged"].items()}


@functools.lru_cache(maxsize=None)
def _clean_tokens():
    je, te = _engines(None)
    want = _tokens(je.run(_requests(JRequest)))
    assert _tokens(te.run(_requests(Request))) == want
    return want


def test_golden_probe_logits_match_reference():
    je, te = _engines(dict(probe_every=1))
    assert len(te.health._golden) == len(je.health._golden) == 2
    for got, want in zip(te.health._golden, je.health._golden):
        assert got.dtype == np.float32 and got.shape == want.shape == (1, 64)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert [t.tolist() for t in te.health._prompts] == \
        [np.asarray(t).tolist() for t in je.health._prompts]


@pytest.mark.parametrize("encoding", ["binary", "vecom"])
def test_sigma_zero_serving_token_identical(encoding):
    je, te = _engines(dict(probe_every=1))
    te.runner.params = _with_encoding(te.runner.params, encoding)
    rep = te.inject_faults(TR.FaultModel(sigma=0.0, seed=1))
    assert rep.codes_changed == 0 and len(rep.leaves) == 8   # 7 per layer + the head
    assert _tokens(te.run(_requests(Request))) == _clean_tokens()
    h = te.stats()["health"]
    assert h["probes"] > 0 and h["repairs"] == 0 and h["last_drift"] == 0.0


def test_stuck_faults_flagged_and_repaired_as_the_reference():
    """The reference's ``test_stuck_faults_flagged_and_repaired_within_one_
    probe``: the run-start probe flags exactly the faulted leaf before any
    prefill, repair brings the drift back, tokens equal the clean run's;
    the scoreboard and event sequence equal the reference's."""
    health = dict(probe_every=1, drift_threshold=1e-3)
    je, te = _engines(health)
    leaf = sorted(tforms.compressed_paths(te.params))[1]
    jrep = je.inject_faults(JR.FaultModel(p_stuck_on=0.05, seed=2), paths=[leaf])
    trep = te.inject_faults(TR.FaultModel(p_stuck_on=0.05, seed=2), paths=[leaf])
    assert trep.summary() == jrep.summary() and trep.codes_changed > 0
    want = _tokens(je.run(_requests(JRequest)))
    assert _tokens(te.run(_requests(Request))) == want == _clean_tokens()
    assert _events(te) == _events(je)
    assert _events(te)[0][:3] == (0, "drift", [leaf])
    assert _board(te) == _board(je) and _board(te)[leaf]["bad_codes"] > 0
    h, hj = te.stats()["health"], je.stats()["health"]
    assert (h["repairs"], h["probes"]) == (hj["repairs"], hj["probes"]) == (1, h["probes"])
    assert h["last_drift"] <= 1e-3
    assert h["events"][1]["drift_after"] == 0.0


def test_chaos_fault_mid_run_completes_all_requests_as_the_reference():
    health = dict(probe_every=1, drift_threshold=1e-3)
    je, te = _engines(health, batch_slots=2)
    leaf = sorted(tforms.compressed_paths(te.params))[0]
    je.health.schedule_fault(2, JR.FaultModel(p_stuck_on=0.1, seed=4), paths=[leaf])
    te.health.schedule_fault(2, TR.FaultModel(p_stuck_on=0.1, seed=4), paths=[leaf])
    want = _tokens(je.run(_requests(JRequest, n=4, new=16)))
    got = _tokens(te.run(_requests(Request, n=4, new=16)))
    assert got == want and sorted(got) == [0, 1, 2, 3]
    assert all(len(t) == 16 for t in got.values())
    assert _events(te) == _events(je)
    assert [e[1] for e in _events(te)].count("chaos") == 1
    h = te.stats()["health"]
    assert h["repairs"] >= 1 and h["last_drift"] <= 1e-3


def _serve_lines(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, [ln for ln in buf.getvalue().splitlines() if ln.startswith("[serve]")]


def test_stat_line_equals_the_references():
    health = dict(probe_every=2, drift_threshold=1e-3)
    je, te = _engines(health, stats_every=1)
    leaf = sorted(tforms.compressed_paths(te.params))[2]
    je.inject_faults(JR.FaultModel(p_stuck_on=0.05, seed=2), paths=[leaf])
    te.inject_faults(TR.FaultModel(p_stuck_on=0.05, seed=2), paths=[leaf])
    want, jlines = _serve_lines(lambda: _tokens(je.run(_requests(JRequest))))
    got, tlines = _serve_lines(lambda: _tokens(te.run(_requests(Request))))
    assert got == want and tlines == jlines
    assert len(tlines) == te.stats()["rounds"]
    assert tlines[0].startswith("[serve] round 1, active 3/4, pages ")
    assert "drift 0.00e+00 repairs 1" in tlines[-1]


def test_fleet_scheduler_ticks_health_and_prints_its_stat_line():
    health = dict(probe_every=1, drift_threshold=1e-3)
    slo = dict(prefill_chunk=8, step_token_budget=32)
    je, te = _engines(health, stats_every=2, slo=slo)
    leaf = sorted(tforms.compressed_paths(te.params))[3]
    je.health.schedule_fault(3, JR.FaultModel(p_stuck_off=0.2, seed=9), paths=[leaf])
    te.health.schedule_fault(3, TR.FaultModel(p_stuck_off=0.2, seed=9), paths=[leaf])
    for e in (je, te):
        e.scheduler._now = lambda: 0.0
    want, jlines = _serve_lines(lambda: _tokens(je.run(_requests(JRequest, new=16))))
    got, tlines = _serve_lines(lambda: _tokens(te.run(_requests(Request, new=16))))
    assert got == want and tlines == jlines
    assert any(ln.startswith("[serve]   slo: interactive q=") for ln in tlines)
    assert _events(te) == _events(je)
    assert [e[1] for e in _events(te)] == ["chaos", "drift", "repair"]


def test_speculative_runner_prints_the_stat_line():
    je, te = _engines(None, stats_every=2, speculate=True, draft_bits=4, draft_k=2)
    want, jlines = _serve_lines(lambda: _tokens(je.run(_requests(JRequest))))
    got, tlines = _serve_lines(lambda: _tokens(te.run(_requests(Request))))
    assert got == want and tlines == jlines and tlines
    assert all(" accept " in ln and " tok/round " in ln for ln in tlines)


def test_health_needs_a_compressed_tree_and_surfaces_stats():
    tm = torch_build(_tiny_configs()[1], device="cpu")
    dense = tm.init(0)
    with pytest.raises(ValueError, match="compressed params tree"):
        TR.HealthMonitor(tm, dense, TR.HealthConfig())
    with pytest.raises(ValueError, match="probe_every"):
        TR.HealthConfig(probe_every=-1)
    eng = ServingEngine(tm, dense, max_len=64, batch_slots=2, forms=True, page_size=8,
                        device="cpu", health=TR.HealthConfig())
    assert set(eng.stats()["health"]) == {"probes", "repairs", "last_drift", "flagged",
                                          "events", "events_dropped"}
    with pytest.raises(ValueError, match="no reference copy"):
        eng.health.repair(eng.params, ["blocks/attn/nope"])
    # repair never aliases the reference copy
    leaf = sorted(tforms.compressed_paths(eng.params))[0]
    fixed = tforms.compressed_paths(eng.health.repair(eng.params, [leaf]))[leaf]
    fixed.mags.zero_()
    assert eng.health._reference[leaf]["mags"].any()
    plain = ServingEngine(tm, dense, max_len=64, batch_slots=2, forms=True, device="cpu")
    assert "health" not in plain.stats()


def test_launcher_fault_flags(capsys):
    with pytest.raises(SystemExit, match="add --forms"):
        tserve.main(["--reduced", "--device", "cpu", "--fault-sigma", "0.1"])
    tserve.main(["--reduced", "--forms", "--device", "cpu", "--requests", "2",
                 "--max-new-tokens", "6", "--encoding", "vecom", "--fault-sigma", "0.1",
                 "--fault-stuck", "0.002", "--fault-repair", "--probe-every", "1",
                 "--stats-every", "1"])
    out = capsys.readouterr().out
    assert "(encoding=vecom)" in out
    assert "faults: 7 leaves" in out
    assert "[serve] round 1, active 2/4" in out
    assert "probes " in out and "health[0]: event=drift" in out
