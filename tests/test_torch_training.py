"""PyTorch port vs the JAX package: the training path (float32 reduced qwen2).

A JAX ``TrainState`` is carried across with ``bridge.train_state_from_numpy``
after the reference has taken its first steps (so the moments, the int8
codes and the ADMM signs are live), and both packages take the next step on
one JAX ``lm_batch``.  Tolerances, all float32:

* the loss within 1e-5 (relative: the packages sum the same products in
  other orders), the gradient norm within 1e-4, every gradient within 1e-5
  of the largest gradient of the tree;
* AdamW on the reference's own gradients gives its params and moments
  within 1e-6 of each leaf's largest value (elementwise, the same formula);
* the whole step's params within 1e-5 (absolute, at the default learning
  rate 3e-4) and its moments within 1e-5 of each leaf's largest value.
  Adam divides each gradient by its own running scale, so where a gradient
  entry is about as small as the two packages' summation differences (some
  QKV-bias entries are ~1e-7 against differences of ~4e-9) its update
  differs by up to ~1% of the learning rate, ~2e-6 here, which is more than
  1e-5 of a small leaf's largest value (the k bias: ~0.1);
* three more steps with Z-updates within 1e-4;
* the MoE archs (reduced olmoe and deepseek-v3 with its MTP module): one
  step's loss within 1e-5, with the load-balance and MTP terms, and the
  routers' and the MTP module's gradients within 1e-5 of the largest
  gradient of the tree.

int8 moment codes may sit on a rounding edge and differ by 1: they are
counted.  With int8 moments a row's small second moments quantize to code
0, and an entry whose v is then rebuilt from its current gradient alone
takes an update of m/sqrt(v) >> 1 that moves with the last bits of that
gradient: such params (at most 1 in 10^4) are counted, not held at 1e-5.  In bfloat16 the activations are rounded at the same places but
summed in other orders, and the tolerance is that of the bf16 model tests
(3e-2).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import admm as jadmm
from repro.data import synthetic as jdata
from repro.models.registry import build as jax_build
from repro.training import grad_compress as jgc
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.bridge import params_from_numpy, train_state_from_numpy
from repro_torch.configs import get_reduced as torch_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import admm as tadmm
from repro_torch.core import paths
from repro_torch.data import synthetic as tdata
from repro_torch.launch import train as tlaunch
from repro_torch.models.registry import build as torch_build
from repro_torch.training import grad_compress as tgc
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl

from torch_parity_util import models, to_numpy

ADMM_FIELDS = ("z", "u", "signs", "row_mask", "col_mask", "scale")
VARIANTS = {
    "plain": dict(),
    "admm": dict(admm_enabled=True, admm_rho=1e-2, admm_update_every=2),
    "int8": dict(moment_dtype="int8"),
}
BASE = dict(warmup_steps=1, total_steps=20, remat=True)


def _np(x):
    return None if x is None else np.asarray(x)


def jax_state_to_numpy(js, seed=0):
    """A JAX TrainState as the bridge's numpy dict."""
    tree = lambda t: None if t is None else to_numpy(t)  # noqa: E731
    admm = None
    if js.admm is not None:
        admm = {p: {f: _np(getattr(st, f)) for f in ADMM_FIELDS} for p, st in js.admm.items()}
    o = js.opt
    return {"params": to_numpy(js.params),
            "opt": {"step": np.asarray(o.step), "mu": tree(o.mu), "nu": tree(o.nu),
                    "mu_scale": tree(o.mu_scale), "nu_scale": tree(o.nu_scale)},
            "step": np.asarray(js.step), "admm": admm, "grad_err": tree(js.grad_err),
            "seed": seed}


def _batch(step, batch=4, seq=16):
    cfg = jdata.LMStreamConfig(vocab_size=256, seq_len=seq, global_batch=batch)
    toks = np.array(jdata.lm_batch(cfg, step)["tokens"])
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


@functools.lru_cache(maxsize=None)
def reference_run(variant, dtype="float32", warm_steps=2):
    """The reference's model, jitted step and state after ``warm_steps``
    steps (with its Z-update schedule), plus the port's model: built once
    per process, so each variant compiles one JAX train step."""
    jm, jp, tm, _ = models(dtype)
    kw = {**BASE, **VARIANTS[variant]}
    jt, tt = JTrainConfig(**kw), TrainConfig(**kw)
    admm_state, table = None, None
    if jt.admm_enabled:
        admm_state, table = jadmm.init_admm(jp, jadmm.default_constraints(rho=jt.admm_rho))
    js = jtl.TrainState(params=jp, opt=jopt.adamw_init(jp, jt.moment_dtype),
                        step=jnp.zeros((), jnp.int32), admm=admm_state, grad_err=None,
                        rng=jax.random.PRNGKey(0))
    jstep = jax.jit(jtl.make_train_step(jm, jt, table))
    for i in range(warm_steps):
        js, _ = jstep(js, _batch(i)[0])
        js = jtl.maybe_admm_update(js, table, jt, i + 1)
    return jm, jstep, js, table, tm, tt


def _port(tm, tt, js, table):
    ts = train_state_from_numpy(jax_state_to_numpy(js), device="cpu")
    ttable = tadmm.constraint_table(ts.params, tadmm.default_constraints(rho=tt.admm_rho)) \
        if tt.admm_enabled else None
    return ts, ttl.make_train_step(tm, tt, ttable), ttable


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _compare_states(ts, js, tol, int8_edges, check_step=True, params_atol=None,
                    param_outliers=None):
    """Params within ``params_atol`` (absolute) or else ``tol`` of each
    leaf's largest value; moments within ``tol`` of each leaf's largest.
    With ``param_outliers`` (a list) params outside the tolerance are
    counted into it instead of failing."""
    jflat = dict(jadmm.iter_weights(js.params))
    for path, leaf in tadmm.iter_weights(ts.params):
        want = np.asarray(jflat[path])
        if params_atol is None:
            _close(leaf, want, tol, f"params {path}")
        elif param_outliers is not None:
            bad = np.abs(leaf.numpy() - want) > params_atol + tol * np.abs(want)
            param_outliers.append(int(bad.sum()))
        else:
            np.testing.assert_allclose(leaf.numpy(), want, rtol=tol, atol=params_atol,
                                       err_msg=f"params {path}")
    for field in ("mu", "nu", "mu_scale", "nu_scale"):
        jt = getattr(js.opt, field)
        if jt is None:
            continue
        jflat = dict(jadmm.iter_weights(jt))
        for path, leaf in tadmm.iter_weights(getattr(ts.opt, field)):
            want = np.asarray(jflat[path])
            if leaf.dtype == torch.int8:      # codes: off by one on a rounding edge
                diff = np.abs(leaf.numpy().astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1, f"{field} {path}"
                int8_edges.append(int((diff > 0).sum()))
            else:
                _close(leaf, want, tol, f"{field} {path}")
    assert int(ts.opt.step) == int(js.opt.step)
    if check_step:
        assert int(ts.step) == int(js.step)


def _grads(jm, tm, js, ts, table, ttable, jb, tb):
    """Both packages' loss gradients (the penalty included) at one state."""
    def jloss(p):
        h, aux = jm.forward(p, jb, remat=True, return_hidden=True)
        loss = jtl.hidden_loss(jm, p, jb, h, aux)
        return loss if js.admm is None else loss + jadmm.admm_penalty(p, js.admm, table)

    def tloss(p, b, admm_state):
        h, aux = tm.forward(p, b, remat=True, return_hidden=True)
        loss = ttl.hidden_loss(tm, p, b, h, aux)
        return loss if admm_state is None else loss + tadmm.admm_penalty(p, admm_state, ttable)

    return (jax.jit(jax.grad(jloss))(js.params),
            ttl._value_and_grad(tloss, ts.params, tb, ts.admm)[1])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_one_step_from_a_bridged_state_matches_reference(variant):
    jm, jstep, js, table, tm, tt = reference_run(variant)
    ts, tstep, ttable = _port(tm, tt, js, table)
    if variant == "admm":
        assert all(st.signs is not None for st in ts.admm.values())
    jb, tb = _batch(2)

    # the gradients, and the optimizer alone on the reference's gradients
    jg, tg = _grads(jm, tm, js, ts, table, ttable, jb, tb)
    top = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(jg))
    jgf = dict(jadmm.iter_weights(jg))
    for path, g in tadmm.iter_weights(tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgf[path]), rtol=0, atol=1e-5 * top,
                                   err_msg=f"grad {path}")
    ts_opt = train_state_from_numpy(jax_state_to_numpy(js), device="cpu")
    jp_opt, jo_opt = jopt.adamw_update(js.params, jg, js.opt, JTrainConfig(**tt.__dict__))
    tgrads = paths.tree_map(lambda a: torch.from_numpy(np.array(a)), to_numpy(jg))
    tp_opt, to_opt = topt.adamw_update(ts_opt.params, tgrads, ts_opt.opt, tt)
    edges = []
    _compare_states(dataclasses.replace(ts_opt, params=tp_opt, opt=to_opt),
                    dataclasses.replace(js, params=jp_opt, opt=jo_opt), 1e-6, edges,
                    check_step=False)

    # the whole step
    js2, jmet = jstep(js, jb)
    ts2, tmet = tstep(ts, tb)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-6)
    outliers = [] if variant == "int8" else None
    _compare_states(ts2, js2, 1e-5, edges, params_atol=1e-5, param_outliers=outliers)
    if variant == "int8":
        n = sum(p.numel() for p in paths.leaves(ts2.params))
        assert sum(edges) <= 1e-3 * 4 * n, (sum(edges), 4 * n)
        assert sum(outliers) <= 1e-4 * n, (sum(outliers), n)


MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v3-671b")


@functools.lru_cache(maxsize=None)
def reduced_models(arch):
    """A reduced arch (float32) in both packages, the reference's init
    carried across, and the reference's jitted train step."""
    cfg = dataclasses.replace(jax_reduced(arch), dtype="float32")
    jm = jax_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(dataclasses.replace(torch_reduced(arch), dtype="float32"), device="cpu")
    jstep = jax.jit(jtl.make_train_step(jm, JTrainConfig(**BASE)))
    return jm, jp, tm, params_from_numpy(to_numpy(jp), device="cpu"), jstep


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_carries_the_aux_and_mtp_terms(arch):
    """One step of the reduced MoE archs from the bridged init: the loss
    adds ``0.01 * moe_aux_loss`` (and with deepseek's MTP module ``0.3 *``
    its shift-2 CE) as the reference's does, so the loss agrees within
    1e-5 and the routers and the MTP module get the reference's gradients
    (within 1e-5 of the largest gradient of the tree)."""
    jm, jp, tm, tp, jstep = reduced_models(arch)
    jb, tb = _batch(0, batch=2)
    with torch.no_grad():
        hidden, aux = tm.forward(tp, tb, return_hidden=True)
        bare = float(ttl.chunked_ce(hidden, tm.head_matrix(tp), tb["tokens"]))
        full = float(ttl.hidden_loss(tm, tp, tb, hidden, aux))
    assert float(aux["moe_aux_loss"]) > 0.5 and ("mtp_hidden" in aux) == (arch != "olmoe-1b-7b")
    assert full - bare >= 0.01 * float(aux["moe_aux_loss"]) - 1e-6

    def jloss(p):
        h, a = jm.forward(p, jb, remat=True, return_hidden=True)
        return jtl.hidden_loss(jm, p, jb, h, a)

    def tloss(p, b):
        h, a = tm.forward(p, b, remat=True, return_hidden=True)
        return ttl.hidden_loss(tm, p, b, h, a)

    jg = jax.jit(jax.grad(jloss))(jp)
    _, tg = ttl._value_and_grad(tloss, tp, tb)
    top = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(jg))
    jgf = dict(jadmm.iter_weights(jg))
    checked = 0
    for path, g in tadmm.iter_weights(tg):
        if "router" in path or path.startswith("mtp/"):
            np.testing.assert_allclose(g.numpy(), np.asarray(jgf[path]), rtol=0,
                                       atol=1e-5 * top, err_msg=f"grad {path}")
            checked += 1
    assert checked >= (1 if arch == "olmoe-1b-7b" else 10)
    state, _ = ttl.init_train_state(tm, TrainConfig(**BASE), params=tp)
    _, tmet = ttl.make_train_step(tm, TrainConfig(**BASE))(state, tb)
    js = jtl.TrainState(params=jp, opt=jopt.adamw_init(jp, "float32"),
                        step=jnp.zeros((), jnp.int32), admm=None, grad_err=None,
                        rng=jax.random.PRNGKey(0))
    _, jmet = jstep(js, jb)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["loss"]), full, rtol=1e-5)


RECURRENT_ARCHS = ("xlstm-350m", "zamba2-2.7b")


def _reference_grads_f64(arch, params, batch):
    """The reference's loss gradients in float64 (its model at dtype
    float64, under the ``jax.enable_x64`` context), leaf by leaf."""
    with jax.enable_x64(True):
        model = jax_build(dataclasses.replace(jax_reduced(arch), dtype="float64"))
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)
        b = {"tokens": jnp.asarray(np.asarray(batch["tokens"]), jnp.int32)}

        def loss(p):
            h, a = model.forward(p, b, remat=True, return_hidden=True)
            return jtl.hidden_loss(model, p, b, h, a)

        return {k: np.asarray(v) for k, v in jadmm.iter_weights(jax.grad(loss)(p64))}


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_train_step_matches_reference(arch):
    """One ``make_train_step`` step of the reduced recurrent archs (xlstm's
    list-shaped tree; zamba's stacked Mamba blocks and shared attention)
    from the bridged init, AdamW at the default learning rate.

    The loss within 1e-5 and the gradient norm within 1e-4, as the dense
    step.  xlstm's gradients within 1e-5 of the largest gradient, as the
    dense step's.  zamba's fast SSM decays make its f32 gradients
    ill-conditioned (the decay ratios are differences of cumulative
    log-decays, ROADMAP §3): the reference's own f32 gradients lie up to
    ~6e-5 of the largest gradient from its float64 ones (its model run at
    dtype float64), so each leaf of the port's f32 gradients is held at
    least as close to those float64 gradients as the reference's f32 leaf
    is, plus 1e-6 of the largest gradient.  The params after the
    step within 1e-5 (absolute), except params whose gradient is below 1e-6
    of the largest: Adam's first step m/(sqrt(v) + eps) follows such a
    gradient's last bits, so those are counted, at most 1 in 10^4 (the
    int8 rule of ``test_one_step_from_a_bridged_state_matches_reference``).
    xlstm's moments within 1e-5 of each leaf's largest value; zamba's are
    its gradients scaled, held through them."""
    jm, jp, tm, tp, jstep = reduced_models(arch)
    jb, tb = _batch(0, batch=2)

    def jloss(p):
        h, a = jm.forward(p, jb, remat=True, return_hidden=True)
        return jtl.hidden_loss(jm, p, jb, h, a)

    def tloss(p, b):
        h, a = tm.forward(p, b, remat=True, return_hidden=True)
        return ttl.hidden_loss(tm, p, b, h, a)

    jg = dict(jadmm.iter_weights(jax.jit(jax.grad(jloss))(jp)))
    tg = dict(tadmm.iter_weights(ttl._value_and_grad(tloss, tp, tb)[1]))
    top = max(float(np.abs(g).max()) for g in jg.values())
    g64 = _reference_grads_f64(arch, jp, jb) if arch == "zamba2-2.7b" else None
    for path, g in tg.items():
        if g64 is None:
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[path]), rtol=0,
                                       atol=1e-5 * top, err_msg=f"grad {path}")
            continue
        port_err = np.abs(g.numpy() - g64[path]).max()
        ref_err = np.abs(np.asarray(jg[path]) - g64[path]).max()
        assert port_err <= ref_err + 1e-6 * top, (path, port_err, ref_err)

    tcfg = TrainConfig(**BASE)
    state, _ = ttl.init_train_state(tm, tcfg, params=tp)
    ts, tmet = ttl.make_train_step(tm, tcfg)(state, tb)
    js = jtl.TrainState(params=jp, opt=jopt.adamw_init(jp, "float32"),
                        step=jnp.zeros((), jnp.int32), admm=None, grad_err=None,
                        rng=jax.random.PRNGKey(0))
    js, jmet = jstep(js, jb)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    assert isinstance(ts.params["blocks"], list) == (arch == "xlstm-350m")
    jflat = dict(jadmm.iter_weights(js.params))
    n = outliers = 0
    for path, leaf in tadmm.iter_weights(ts.params):
        want, got = np.asarray(jflat[path]), leaf.numpy()
        bad = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
        assert (np.abs(np.asarray(jg[path])[bad]) < 1e-6 * top).all(), path
        outliers += int(bad.sum())
        n += got.size
    assert outliers <= 1e-4 * n, (outliers, n)
    if g64 is None:
        _compare_states(ts, js, 1e-5, [], params_atol=1e-5, param_outliers=[])


def test_lm_loss_with_aux_matches_reference():
    """The materialized-logits loss carries the same two terms."""
    rng = np.random.RandomState(5)
    logits = rng.normal(size=(2, 9, 32)).astype(np.float32)
    mtp = rng.normal(size=(2, 9, 32)).astype(np.float32)
    toks = rng.randint(0, 32, (2, 9)).astype(np.int32)
    for aux in ({}, {"moe_aux_loss": 1.25}, {"moe_aux_loss": 1.25, "mtp_logits": mtp}):
        want = jtl.lm_loss(jnp.asarray(logits), jnp.asarray(toks),
                           {k: jnp.asarray(v) for k, v in aux.items()})
        got = ttl.lm_loss(torch.from_numpy(logits), torch.from_numpy(toks),
                          {k: torch.as_tensor(v) for k, v in aux.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(got) > float(ttl.lm_loss(torch.from_numpy(logits), torch.from_numpy(toks)))


def test_three_steps_and_z_updates_stay_with_reference():
    """From the bridged ADMM state (after the fresh Z-update of step 2):
    three steps each, with the frozen-sign Z-update after step 4 between
    them, stay within 1e-4; the Z-update's signs and masks are equal."""
    jm, jstep, js, table, tm, tt = reference_run("admm")
    ts, tstep, ttable = _port(tm, tt, js, table)
    jt = JTrainConfig(**{**BASE, **VARIANTS["admm"]})
    for i in (2, 3, 4):
        jb, tb = _batch(i)
        js, jmet = jstep(js, jb)
        ts, tmet = tstep(ts, tb)
        js = jtl.maybe_admm_update(js, table, jt, i + 1)
        ts = ttl.maybe_admm_update(ts, ttable, tt, i + 1)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
    _compare_states(ts, js, 1e-4, [])
    for path, st in ts.admm.items():
        jst = js.admm[path]
        np.testing.assert_array_equal(st.signs.numpy(), np.asarray(jst.signs))
        np.testing.assert_array_equal(st.row_mask.numpy(), np.asarray(jst.row_mask))
        _close(st.z, jst.z, 1e-4, f"z {path}")
        _close(st.u, jst.u, 1e-4, f"u {path}")


def test_bf16_step_matches_reference():
    jm, jstep, js, table, tm, tt = reference_run("plain", "bfloat16", warm_steps=1)
    ts, tstep, _ = _port(tm, tt, js, table)
    jb, tb = _batch(1)
    js2, jmet = jstep(js, jb)
    ts2, tmet = tstep(ts, tb)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=3e-2)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=3e-2)
    jflat = dict(jadmm.iter_weights(js2.params))
    for path, leaf in tadmm.iter_weights(ts2.params):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jflat[path]), atol=3e-2,
                                   err_msg=path)


# ---------------------------------------------------------------------------
# pieces of the step
# ---------------------------------------------------------------------------

def test_chunked_ce_equals_lm_loss_on_materialised_logits():
    _, jp, tm, tp = models()
    _, tb = _batch(0)
    with torch.no_grad():
        hidden, _ = tm.forward(tp, tb, return_hidden=True)
        logits, _ = tm.forward(tp, tb)
        want = ttl.lm_loss(logits, tb["tokens"])
        for chunk in (7, 16, 8192):
            got = ttl.chunked_ce(hidden, tm.head_matrix(tp), tb["tokens"], chunk=chunk)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    jh = jnp.asarray(hidden.numpy())
    jwant = jtl.chunked_ce(jh, jnp.asarray(tp["embed"].numpy()).T, jnp.asarray(tb["tokens"].numpy()))
    np.testing.assert_allclose(float(want), float(jwant), rtol=1e-6)


def test_training_head_is_the_tied_embedding_not_the_serving_copy():
    _, _, tm, tp = models()
    served = tm.serving_params(tp)
    assert tm.head_matrix(served) is not served["head_cast"]
    assert torch.equal(tm.head_matrix(served), tp["embed"].T)


@pytest.mark.parametrize("remat", [False, True])
def test_microbatch_accumulation_matches_full_batch(remat):
    _, _, tm, tp = models()
    tb = _batch(0, batch=8)[1]
    out = {}
    for n in (1, 4):
        tt = TrainConfig(microbatches=n, remat=remat)
        state, _ = ttl.init_train_state(tm, tt, params=paths.tree_map(torch.clone, tp))
        state, met = ttl.make_train_step(tm, tt)(state, tb)
        out[n] = (float(met["loss"]), state.params)
    assert abs(out[1][0] - out[4][0]) < 2e-3
    for a, b in zip(paths.leaves(out[1][1]), paths.leaves(out[4][1])):
        assert float((a - b).abs().max()) < 2e-3


def test_cosine_schedule_and_clip_match_reference():
    kw = dict(learning_rate=3e-4, warmup_steps=10, total_steps=100)
    jlr, tlr = jopt.cosine_schedule(JTrainConfig(**kw)), topt.cosine_schedule(TrainConfig(**kw))
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        assert float(tlr(torch.tensor(s))) == float(jlr(jnp.asarray(s)))
    g = {"a": np.random.RandomState(0).randn(30, 4).astype(np.float32),
         "b": {"c": np.random.RandomState(1).randn(7).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        jg, jn = jopt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        tg, tn = topt.clip_by_global_norm(paths.tree_map(torch.from_numpy, g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        np.testing.assert_allclose(tg["a"].numpy(), np.asarray(jg["a"]), rtol=1e-6)
        np.testing.assert_allclose(tg["b"]["c"].numpy(), np.asarray(jg["b"]["c"]), rtol=1e-6)


def test_bf16_compression_is_the_reference_bit_for_bit():
    g = {"w": np.random.RandomState(2).randn(64, 9).astype(np.float32) * 1e-3}
    e = {"w": np.random.RandomState(3).randn(64, 9).astype(np.float32) * 1e-6}
    for mode in ("none", "bf16", "bf16_ef"):
        jg, je = jgc.apply_compression({"w": jnp.asarray(g["w"])}, mode,
                                       {"w": jnp.asarray(e["w"])})
        tg, te = tgc.apply_compression({"w": torch.from_numpy(g["w"])}, mode,
                                       {"w": torch.from_numpy(e["w"])})
        assert np.array_equal(tg["w"].numpy(), np.asarray(jg["w"]))
        assert np.array_equal(te["w"].numpy(), np.asarray(je["w"]))


def test_int8_error_feedback_keeps_its_invariants():
    """The residual is exactly what rounding lost, codes stay in [-127,
    127], and the stochastic rounding is unbiased over seeds."""
    g = {"w": torch.from_numpy(np.random.RandomState(4).randn(256).astype(np.float32))}
    e = {"w": torch.zeros(256)}
    draws = []
    for seed in range(200):
        gen = torch.Generator().manual_seed(seed)
        q, scales, err = tgc.compress_int8_ef(g, e, gen)
        deq = q["w"].float() * scales["w"]
        assert q["w"].dtype == torch.int8 and int(q["w"].abs().max()) <= 127
        assert torch.equal(g["w"] - deq, err["w"])
        draws.append(deq)
    mean = torch.stack(draws).mean(0)
    step = float(scales["w"])
    assert float((mean - g["w"]).abs().max()) < 0.15 * step
    out, new_err = tgc.apply_compression(g, "int8_ef", e, torch.Generator().manual_seed(0))
    assert float((out["w"] - g["w"]).abs().max()) <= step


def test_lm_data_is_deterministic_and_follows_the_table():
    for vocab, seed in ((256, 0), (1000, 3)):
        np.testing.assert_array_equal(tdata._transition_table(vocab, seed),
                                      jdata._transition_table(vocab, seed))
    cfg = tdata.LMStreamConfig(vocab_size=256, seq_len=64, global_batch=8, seed=1)
    a, b = tdata.lm_batch(cfg, 5, "cpu")["tokens"], tdata.lm_batch(cfg, 5, "cpu")["tokens"]
    assert torch.equal(a, b) and a.dtype == torch.int32 and a.shape == (8, 64)
    assert not torch.equal(a, tdata.lm_batch(cfg, 6, "cpu")["tokens"])
    assert int(a.min()) >= 0 and int(a.max()) < 256
    table = tdata._transition_table(256, 1)
    prev, nxt = a[:, :-1].numpy(), a[:, 1:].numpy()
    follows = (table[prev] == nxt[..., None]).any(-1).mean()
    assert follows >= 0.85, follows          # 10% noise, some of it on the table by chance


def test_launcher_runs_on_cpu_and_refuses_without_a_card(capsys, monkeypatch):
    tlaunch.main(["--reduced", "--steps", "4", "--admm", "--admm-every", "2",
                  "--seq-len", "16", "--global-batch", "4", "--log-every", "2",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and "loss" in lines[0] and "viol" in lines[0]
    assert all(np.isfinite(float(ln.split("loss")[1].split()[0])) for ln in lines)
    assert "tokens/s" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--reduced", "--steps", "1"])


def test_optimizer_state_round_trips_through_the_bridge():
    """The bridge carries int8 codes, their scales and the ADMM masks
    across unchanged."""
    _, _, js, _, _, _ = reference_run("int8")
    ts = train_state_from_numpy(jax_state_to_numpy(js), device="cpu")
    jmu = dict(jadmm.iter_weights(js.opt.mu))
    for path, leaf in tadmm.iter_weights(ts.opt.mu):
        assert leaf.dtype == torch.int8
        assert np.array_equal(leaf.numpy(), np.asarray(jmu[path]))
    assert dataclasses.is_dataclass(ts) and ts.admm is None


def test_sgd_momentum_matches_reference():
    g = {"a": np.random.RandomState(5).randn(6, 3).astype(np.float32)}
    p = {"a": np.random.RandomState(6).randn(6, 3).astype(np.float32)}
    jp, jg = (jax.tree_util.tree_map(jnp.asarray, t) for t in (p, g))
    js = jopt.sgd_init(jp)
    tp = paths.tree_map(lambda a: torch.from_numpy(a.copy()), p)
    ts = topt.sgd_init(tp)
    for _ in range(3):
        jp, js = jopt.sgd_update(jp, jg, js, lr=0.1)
        tp, ts = topt.sgd_update(tp, paths.tree_map(torch.from_numpy, g), ts, lr=0.1)
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]), rtol=1e-6)
    np.testing.assert_allclose(ts.momentum["a"].numpy(), np.asarray(js.momentum["a"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
