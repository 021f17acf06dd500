"""PyTorch port vs the JAX package: auto mixed precision (forms/autobits).

Both packages run on the reduced qwen2 of ``torch_parity_util`` (float32,
the same bridged weights, the same seeded calibration tokens).  Held:

* the allocator (``solve_bits``, ``uniform_bits_for_budget``,
  ``plan_draft_bits``) fed the reference's own tables, converted field by
  field, returns the reference's bits dicts exactly;
* ``measure_sensitivity`` gives every ``dl[b]`` and ``group_dl[b]`` within
  SENS_RTOL of the reference's (float32 Fisher on a float32 forward: the
  largest difference measured on the CPU was 2.9e-7), with equal geometry
  and leaf order;
* ``plan_auto_bits(validate=True)`` gives the reference's plan after the
  same number of back-off rounds, or parts from it only at a greedy step
  whose two best scores lie within SCORE_RTOL;
* a mixed plan served, and an auto-derived speculative draft, give the
  reference engine's greedy tokens (and ``spec_stats``) exactly;
* plan meta crosses the port's checkpoint codec both ways.
"""
import contextlib
import dataclasses
import functools
import io

import msgpack
import numpy as np
import pytest
import torch

from repro import forms as jforms
from repro.forms import autobits as JAB
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import forms as tforms
from repro_torch.checkpoint import msgpack_lite
from repro_torch.forms import autobits as TAB
from repro_torch.launch import serve as tserve
from repro_torch.serving import speculate as TSP
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

from torch_parity_util import models

SENS_RTOL = 1e-5      # dl and group_dl, port vs reference (measured: 2.9e-7)
NLL_ATOL = 2e-5       # a measured mean NLL (~5.5 nats) in float32, both packages
SCORE_RTOL = 1e-3     # a greedy score is seconds over a difference of two dl
                      # values ~1e-3 of their size, so SENS_RTOL grows ~1e3-fold
BUDGETS = (0.05, 0.005, 0.001)
COMMON = dict(max_len=32, batch_slots=2, page_size=8)


def _count_calls(monkeypatch, module, name):
    """Count the calls of ``module.name`` (a module global its callers look
    up at call time)."""
    calls = [0]
    fn = getattr(module, name)

    def counted(*a, **k):
        calls[0] += 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def _port_spec(jspec):
    return tforms.spec_from_meta(dataclasses.asdict(jspec))


def port_table(jt):
    """The reference's SensitivityTable as the port's, field by field."""
    leaves = {p: TAB.LeafSensitivity(path=ls.path, stack=ls.stack, kp=ls.kp, n=ls.n, m=ls.m,
                                     dl=dict(ls.dl),
                                     group_dl={b: np.asarray(g) for b, g in ls.group_dl.items()})
              for p, ls in jt.leaves.items()}
    return TAB.SensitivityTable(leaves=leaves, spec=_port_spec(jt.spec),
                                calib_tokens=jt.calib_tokens, fwd_flops=jt.hlo_flops,
                                modeled_flops=jt.modeled_flops)


def _synthetic(pkg, spec_cls):
    """The reference's unit-test table (tests/test_autobits.py), in ``pkg``."""
    def leaf(path, kp, n, dl):
        return pkg.LeafSensitivity(path=path, stack=1, kp=kp, n=n, m=8, dl=dict(dl),
                                   group_dl={b: np.asarray([v], np.float32)
                                             for b, v in dl.items()})
    leaves = {"blocks/mlp/gate": leaf("blocks/mlp/gate", 128, 256,
                                      {8: 0.01, 6: 0.011, 4: 0.013, 2: 0.02}),
              "blocks/attn/wq": leaf("blocks/attn/wq", 64, 64,
                                     {8: 0.02, 6: 0.03, 4: 0.08, 2: 0.4}),
              "head": leaf("head", 64, 64, {8: 0.05, 6: 0.3, 4: 1.5, 2: 6.0})}
    return pkg.SensitivityTable(leaves=leaves, spec=spec_cls(m=8, bits=8))


@functools.lru_cache(maxsize=None)
def tables():
    """(reference table, port table) of the reduced qwen2's bridged weights,
    each package's own sweep on the same calibration tokens."""
    jm, jp, tm, tp = models()
    jt = JAB.measure_sensitivity(jm, jp, jforms.FormsSpec(m=8), JAB.AutoBitsConfig())
    calib = TAB.random_calibration(256, TAB.AutoBitsConfig(), "cpu")
    tt = TAB.measure_sensitivity(tm, tp, tforms.FormsSpec(m=8), TAB.AutoBitsConfig(), calib)
    return jt, tt


@functools.lru_cache(maxsize=None)
def plans(budget):
    jm, jp, tm, tp = models()
    jt, tt = tables()
    return (JAB.plan_auto_bits(jm, jp, jforms.FormsSpec(m=8),
                               JAB.AutoBitsConfig(acc_budget=budget), table=jt),
            TAB.plan_auto_bits(tm, tp, tforms.FormsSpec(m=8),
                               TAB.AutoBitsConfig(acc_budget=budget), table=tt))


# ---------------------------------------------------------------------------
# the allocator on the reference's tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", (0.0, 0.01, 0.05, 1.0))
def test_solve_bits_on_reference_tables_equals_reference(budget):
    jt = tables()[0]
    for jtab, ttab in ((jt, port_table(jt)),
                       (_synthetic(JAB, jforms.FormsSpec), _synthetic(TAB, tforms.FormsSpec))):
        assert TAB.solve_bits(ttab, acc_budget=budget) == JAB.solve_bits(jtab, acc_budget=budget)
        assert TAB.uniform_bits_for_budget(ttab, budget) == \
            JAB.uniform_bits_for_budget(jtab, budget)
        target = JAB.uniform_seconds(jtab, 4) * (1 + budget)
        assert TAB.uniform_seconds(ttab, 4) == JAB.uniform_seconds(jtab, 4)
        assert TAB.solve_bits(ttab, seconds_target=target) == \
            JAB.solve_bits(jtab, seconds_target=target)


@pytest.mark.parametrize("match_bits", (2, 4))
def test_plan_draft_bits_on_reference_tables_equals_reference(match_bits):
    jt = tables()[0]
    for jtab, ttab in ((jt, port_table(jt)),
                       (_synthetic(JAB, jforms.FormsSpec), _synthetic(TAB, tforms.FormsSpec))):
        got, want = TAB.plan_draft_bits(ttab, match_bits), JAB.plan_draft_bits(jtab, match_bits)
        assert got.bits == want.bits
        assert (got.predicted_dl, got.modeled_seconds, got.base_seconds, got.matched_uniform) \
            == (want.predicted_dl, want.modeled_seconds, want.base_seconds, want.matched_uniform)
        assert got.histogram() == want.histogram()
        assert got.top_groups() == want.top_groups()


# ---------------------------------------------------------------------------
# the sensitivity sweep and the validated plan
# ---------------------------------------------------------------------------

def test_measure_sensitivity_matches_reference():
    jt, tt = tables()
    assert list(tt.leaves) == list(jt.leaves)          # the greedy's tie order
    assert tt.spec == _port_spec(jt.spec)
    for p, jl in jt.leaves.items():
        tl = tt.leaves[p]
        assert (tl.path, tl.stack, tl.kp, tl.n, tl.m) == (jl.path, jl.stack, jl.kp, jl.n, jl.m)
        assert list(tl.dl) == list(jl.dl) == [8, 6, 4, 2]
        for b in jl.dl:
            assert tl.dl[b] == pytest.approx(jl.dl[b], rel=SENS_RTOL, abs=0)
            np.testing.assert_allclose(tl.group_dl[b], jl.group_dl[b], rtol=SENS_RTOL, atol=0)
            assert tl.group_dl[b].shape == (-(-tl.n // 128),)
        assert tl.dl_rel(2, 8) >= tl.dl_rel(4, 8) >= 0.0
    assert tt.calib_tokens == jt.calib_tokens == 2 * 8 * 32
    assert tt.modeled_flops == jt.modeled_flops


def test_flop_count_on_its_own_terms():
    """``FlopCounterMode`` counts the matmuls and attention products of one
    dense forward (8 x 32 tokens): reckoned here from the reduced config."""
    _, tt = tables()
    cfg = models()[2].config
    t, d, hd = 8 * 32, cfg.d_model, cfg.hd()
    q, kv, f, v = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.d_ff, cfg.vocab_size
    proj = 2 * t * (d * q + 2 * d * kv + q * d + 3 * d * f)
    attn = 2 * 2 * 8 * cfg.num_heads * 32 * 32 * hd      # scores and output
    assert tt.fwd_flops == cfg.num_layers * (proj + attn) + 2 * t * d * v
    assert tt.modeled_flops == 2 * t * sum(ls.stack * ls.kp * ls.n for ls in tt.leaves.values())
    cov = TAB.flop_coverage(tt)
    assert 0.0 < cov <= 1.0 and cov == tt.modeled_flops / tt.fwd_flops
    assert f"covers {cov:.0%} of counted fwd FLOPs" in plans(0.05)[1].summary()


def _greedy_steps(table, budget):
    """The greedy's picks and, per step, the two best scores."""
    base, ladder = table.spec.bits, [8, 6, 4, 2]
    bits, total, out = {p: base for p in table.leaves}, 0.0, []
    while True:
        cands = []
        for p, ls in table.leaves.items():
            i = ladder.index(bits[p])
            if i + 1 >= len(ladder):
                continue
            nb = ladder[i + 1]
            ddl = ls.dl_rel(nb, base) - ls.dl_rel(bits[p], base)
            if total + ddl > budget:
                continue
            dsec = table.leaf_seconds(p, bits[p]) - table.leaf_seconds(p, nb)
            cands.append((dsec / max(ddl, 1e-12), p, nb, ddl))
        if not cands:
            return out
        cands.sort(key=lambda c: -c[0])
        out.append((cands[0][1], [c[0] for c in cands[:2]]))
        _, p, nb, ddl = cands[0]
        bits[p], total = nb, total + ddl


def parts_at_near_tie(jt, tt, budget):
    """Where the two greedies first pick other leaves, the two best scores
    there lie within SCORE_RTOL of each other."""
    for (jp, js), (tp, ts) in zip(_greedy_steps(jt, budget), _greedy_steps(tt, budget)):
        if jp != tp:
            return len(ts) == 2 and abs(ts[0] - ts[1]) <= SCORE_RTOL * ts[0]
    return False


@pytest.mark.parametrize("budget", BUDGETS)
def test_plan_auto_bits_validated_equals_reference(budget, monkeypatch):
    jm, jp, tm, tp = models()
    jt, tt = tables()
    jcalls = _count_calls(monkeypatch, JAB, "solve_bits")
    tcalls = _count_calls(monkeypatch, TAB, "solve_bits")
    want = JAB.plan_auto_bits(jm, jp, jforms.FormsSpec(m=8),
                              JAB.AutoBitsConfig(acc_budget=budget), table=jt)
    got = TAB.plan_auto_bits(tm, tp, tforms.FormsSpec(m=8),
                             TAB.AutoBitsConfig(acc_budget=budget), table=tt)
    assert tcalls[0] == jcalls[0] >= 1                  # the same back-off rounds
    assert got.bits == want.bits or parts_at_near_tie(jt, tt, budget)
    assert got.measured_dl == pytest.approx(want.measured_dl, abs=NLL_ATOL)
    assert got.measured_dl <= budget
    assert got.modeled_seconds <= got.base_seconds
    assert got.modeled_speedup == pytest.approx(want.modeled_speedup, rel=1e-12)
    assert "ReRAM ADC-event model, not GPU time" in got.summary()
    comp, rep = tforms.compress_tree(tp, tforms.FormsSpec(m=8), plan=got.specs())
    assert rep.bits == got.bits


def test_plan_auto_bits_computes_its_own_table_like_reference():
    """Without ``table=`` the port sweeps and plans in one call, from its own
    calibration stream (the reference's seeded draws) on the CPU."""
    jm, jp, tm, tp = models()
    want = plans(0.005)[0]
    got = TAB.plan_auto_bits(tm, tp, tforms.FormsSpec(m=8), TAB.AutoBitsConfig(acc_budget=0.005))
    assert got.bits == want.bits
    assert got.measured_dl == pytest.approx(want.measured_dl, abs=NLL_ATOL)


def test_sweep_of_a_compressed_target_prices_its_float_projection():
    _, _, tm, tp = models()
    comp, _ = tforms.compress_tree(tp, tforms.FormsSpec(m=8))
    calib = TAB.random_calibration(256, TAB.AutoBitsConfig(calib_batches=1), "cpu")
    a = TAB.measure_sensitivity(tm, comp, tforms.FormsSpec(m=8), calib=calib)
    b = TAB.measure_sensitivity(tm, tforms.decompress_tree(comp), tforms.FormsSpec(m=8),
                                calib=calib)
    assert {p: ls.dl for p, ls in a.leaves.items()} == {p: ls.dl for p, ls in b.leaves.items()}


# ---------------------------------------------------------------------------
# the reference's unit cases (tests/test_autobits.py), on both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", (0.0, 0.005, 0.05, 0.5, 100.0))
def test_solve_bits_budget_monotone_and_feasible(budget):
    t, j = _synthetic(TAB, tforms.FormsSpec), _synthetic(JAB, jforms.FormsSpec)
    bits = TAB.solve_bits(t, acc_budget=budget)
    assert bits == JAB.solve_bits(j, acc_budget=budget)
    assert t.plan_dl(bits) <= budget + 1e-12
    more = TAB.solve_bits(t, acc_budget=budget * 2 + 1e-3)
    assert t.plan_seconds(more) <= t.plan_seconds(bits) + 1e-18
    if budget == 0.0:
        assert set(bits.values()) == {8}
    if budget == 100.0:
        assert set(bits.values()) == {2}
    if budget == 0.05:      # the budget goes where it is cheap
        assert bits["blocks/mlp/gate"] < bits["head"] == 8


def test_solve_bits_requires_exactly_one_mode():
    t = _synthetic(TAB, tforms.FormsSpec)
    with pytest.raises(ValueError):
        TAB.solve_bits(t)
    with pytest.raises(ValueError):
        TAB.solve_bits(t, acc_budget=0.1, seconds_target=1.0)


@pytest.mark.parametrize("match", (4, 6, 8))
def test_draft_plan_meets_or_beats_uniform(match):
    t = _synthetic(TAB, tforms.FormsSpec)
    draft = TAB.plan_draft_bits(t, match_bits=match)
    assert draft.matched_uniform == match
    assert draft.predicted_dl <= t.plan_dl({p: match for p in t.leaves}) + 1e-12
    assert draft.modeled_seconds <= TAB.uniform_seconds(t, match) + 1e-12
    if match == 8:          # nothing to buy at the base width
        assert set(draft.bits.values()) == {8} and draft.predicted_dl == 0.0


def test_uniform_bits_for_budget():
    t = _synthetic(TAB, tforms.FormsSpec)
    dl_at = {b: t.plan_dl({p: b for p in t.leaves}) for b in (6, 4, 2)}
    assert TAB.uniform_bits_for_budget(t, 0.0) == 8
    assert TAB.uniform_bits_for_budget(t, dl_at[6] + 1e-9) == 6
    assert TAB.uniform_bits_for_budget(t, dl_at[2] + 1e-9) == 2


@pytest.mark.parametrize("m", (4, 8, 16))
def test_modeled_seconds_scale_with_cells_and_size(m):
    spec = tforms.FormsSpec(m=m, bits=8)
    s = {b: TAB.modeled_leaf_seconds(1, 64, 64, m, b, spec) for b in (8, 4, 2)}
    assert s == {b: JAB.modeled_leaf_seconds(1, 64, 64, m, b, jforms.FormsSpec(m=m))
                 for b in (8, 4, 2)}
    assert s[8] == pytest.approx(2 * s[4]) and s[4] == pytest.approx(2 * s[2])
    assert TAB.modeled_leaf_seconds(2, 64, 64, m, 8, spec) == pytest.approx(2 * s[8])


def test_plan_histogram_top_groups_and_summary():
    t = _synthetic(TAB, tforms.FormsSpec)
    bits = {"blocks/mlp/gate": 2, "blocks/attn/wq": 4, "head": 8}
    plan = TAB.AutoBitsPlan(spec=t.spec, bits=bits, predicted_dl=0.01, acc_budget=0.05,
                            modeled_seconds=t.plan_seconds(bits),
                            base_seconds=TAB.uniform_seconds(t, 8), table=t)
    assert plan.histogram() == {2: 1, 4: 1, 8: 1}
    assert plan.modeled_speedup > 1.0
    top = plan.top_groups(k=1)
    assert top and top[0][0] == "blocks/attn/wq" and top[0][2] == pytest.approx(0.08)
    s = plan.summary()
    assert "1x2b/1x4b/1x8b" in s and "budget 0.05" in s and "ReRAM ADC-event model" in s


@pytest.mark.parametrize("bits,ok", [(2, True), (4, True), (6, True), (16, True), (3, False),
                                     (5, False), (0, False), (17, False)])
def test_with_bits_validates_the_ladder(bits, ok):
    spec = tforms.FormsSpec(m=8, cell_bits=2)
    if ok:
        assert spec.with_bits(bits).quant.cells_per_weight == bits // 2
        assert spec.with_bits(bits).quant.levels == 2 ** bits - 1
    else:
        with pytest.raises(ValueError, match="bits"):
            spec.with_bits(bits)


# ---------------------------------------------------------------------------
# plan meta through the checkpoint codec
# ---------------------------------------------------------------------------

def test_plan_meta_crosses_the_port_codec_both_ways():
    tspec = tforms.FormsSpec(m=8, bits=8, rule="sum", input_bits=12)
    tplan = {"attn/wq": tspec.with_bits(4), "mlp/gate": dataclasses.replace(tspec, bits=2, m=16)}
    meta = TAB.plan_to_meta(tspec, tplan)
    assert meta["plan"]["attn/wq"] == {"bits": 4}
    assert meta["plan"]["mlp/gate"] == {"bits": 2, "m": 16}
    raw = msgpack_lite.packb(meta)
    # the reference reads the port's meta
    jspec, jplan = JAB.plan_from_meta(msgpack.unpackb(raw))
    assert dataclasses.asdict(jspec) == {**dataclasses.asdict(tspec), "prefer_ref": None}
    assert {p: s.bits for p, s in jplan.items()} == {"attn/wq": 4, "mlp/gate": 2}
    # and the port reads the reference's
    jmeta = JAB.plan_to_meta(jspec, jplan)
    spec2, plan2 = TAB.plan_from_meta(msgpack_lite.unpackb(msgpack.packb(jmeta)))
    assert spec2 == tspec and plan2 == tplan
    assert TAB.plan_from_meta(msgpack_lite.unpackb(raw)) == (tspec, tplan)
    with pytest.raises(ValueError, match="prefer_ref"):
        TAB.plan_from_meta({"spec": {**meta["spec"], "prefer_ref": True}, "plan": {}})


def test_plan_meta_rebuilds_the_restore_template():
    """A served plan's meta, through the codec, gives a template whose every
    leaf has the saved tree's width and geometry, in both packages."""
    jm, jp, tm, tp = models()
    got = plans(0.005)[1]
    comp, _ = tforms.compress_tree(tp, got.spec, plan=got.specs())
    raw = msgpack_lite.packb(TAB.plan_to_meta(got.spec, got.specs()))
    spec, plan = TAB.plan_from_meta(msgpack_lite.unpackb(raw))
    template, _ = tforms.compress_tree(tm.init(1), spec, plan=plan)
    jspec, jplan = JAB.plan_from_meta(msgpack.unpackb(raw))
    jtemplate, _ = jforms.compress_tree(jp, jspec, plan=jplan)

    def geometry(leaves):
        return {p: (fp.bits, fp.m, tuple(fp.mags.shape), str(fp.mags.dtype).split(".")[-1])
                for p, fp in leaves.items()}

    want = geometry(tforms.compressed_paths(comp))
    assert geometry(tforms.compressed_paths(template)) == want
    assert geometry(jforms.compressed_paths(jtemplate)) == want
    assert len(set(got.bits.values())) > 1


# ---------------------------------------------------------------------------
# serving a plan, and the auto-derived draft
# ---------------------------------------------------------------------------

def _requests(cls, n=4, new=8, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(uid=i, prompt=rng.randint(0, 256, rng.randint(2, 12)), max_new_tokens=new)
            for i in range(n)]


def _tokens(results):
    return {r.uid: list(r.tokens) for r in results}


def test_mixed_plan_serves_reference_tokens():
    jm, jp, tm, tp = models()
    want_plan, got_plan = plans(0.005)
    assert got_plan.bits == want_plan.bits and len(set(got_plan.bits.values())) > 1
    je = JEngine(jm, jp, forms=True, plan=want_plan.specs(), **COMMON)
    te = TEngine(tm, tp, forms=True, plan=got_plan.specs(), device="cpu", **COMMON)
    assert te.compression_report.bits == je.compression_report.bits == got_plan.bits
    assert _tokens(te.run(_requests(TRequest))) == _tokens(je.run(_requests(JRequest)))


def test_auto_draft_speculation_equals_reference():
    jm, jp, tm, tp = models()
    jt, tt = tables()
    want_plan, got_plan = plans(0.005)
    jd, td = JAB.plan_draft_bits(jt, 4), TAB.plan_draft_bits(tt, 4)
    assert td.bits == jd.bits
    kw = dict(COMMON, forms=True, speculate=True, draft_k=3, draft_bits=4)
    je = JEngine(jm, jp, plan=want_plan.specs(), draft_plan=jd.specs(), **kw)
    te = TEngine(tm, tp, plan=got_plan.specs(), draft_plan=td.specs(), device="cpu", **kw)
    assert te.draft_report.bits == je.draft_report.bits == td.bits
    plain = TEngine(tm, tp, forms=True, plan=got_plan.specs(), device="cpu", **COMMON)
    want = _tokens(je.run(_requests(JRequest)))
    assert _tokens(te.run(_requests(TRequest))) == want == _tokens(plain.run(_requests(TRequest)))
    got_stats, want_stats = te.stats()["speculate"], je.stats()["speculate"]
    for key in ("rounds", "drafted", "accepted", "slot_k"):
        assert got_stats[key] == want_stats[key], (key, got_stats, want_stats)
    assert got_stats["tokens_per_round"] == pytest.approx(want_stats["tokens_per_round"])


def test_int_draft_refuses_a_plan():
    _, _, _, tp = models()
    with pytest.raises(ValueError, match="plan"):
        TSP.make_draft_tree(tp, mode="int", plan={"attn/wq": tforms.FormsSpec(m=8, bits=4)})


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _serve(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--reduced", "--device", "cpu", "--requests", "3", "--max-new-tokens", "5",
                     "--max-len", "32"] + argv)
    return out.getvalue()


@pytest.mark.parametrize("flags,expect", [
    (["--forms", "--auto-bits", "--acc-budget", "0.005"],
     ("auto-bits: 7 leaves [", "ReRAM ADC-event model, not GPU time", "measured dNLL",
      "auto-bits: most sensitive blocks/", "auto-bits parity: matched-budget uniform ",
      "greedy token agreement")),
    (["--forms", "--auto-bits", "--speculate", "--auto-draft", "--draft-bits", "4"],
     ("auto-bits draft: 7 leaves [", "cost-matched to uniform 4b",
      "speculate: k=4, 4-bit forms draft", "acceptance ", "auto-bits parity: ")),
], ids=["auto-bits", "auto-draft"])
def test_launcher_serves_a_plan_on_the_cpu(flags, expect):
    text = _serve(flags)
    assert "3 requests, 15 tokens" in text
    for line in expect:
        assert line in text, text


@pytest.mark.parametrize("flags,message", [
    (["--auto-bits"], "add --forms"),
    (["--forms", "--speculate", "--auto-draft"], "add --auto-bits"),
    (["--forms", "--auto-bits", "--speculate", "--auto-draft", "--draft-mode", "int"],
     "use --draft-mode forms"),
])
def test_launcher_checks_the_auto_bits_flags(flags, message):
    with pytest.raises(SystemExit, match=message):
        _serve(flags)
