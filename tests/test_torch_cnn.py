"""PyTorch port vs the JAX package: the paper's CNN pipeline.

The image stream, ``models/cnn.py`` (forward at both parities of XLA's
SAME padding, the NHWC flatten, ``collect_activations``, the crossbar
shapes), one SGD step with and without the ADMM penalty, the ADMM
Z-update and ``project_hard`` on conv and FC matrices, ``compress_tree``
on conv leaves, the compressed tree's forward, ``apply_simulated`` on an
FC leaf and the mean EIC: each from the same numpy weights and inputs in
both packages.  Then the port's own pipeline on ``tiny_cnn()`` at the
reference's step counts, held to ``tests/test_system.py``'s thresholds.

Tolerances: float results within 1e-5 of the largest |value| (both sum
the same products in other orders; f32); the projections, the codes, the
EIC and the bit-serial accumulators exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import forms as jforms
from repro.configs import paper_cnns as jcfgs
from repro.core import admm as jadmm
from repro.core import quantization as JQ
from repro.core import zeroskip as JZ
from repro.core.pruning import PruneSpec as JPruneSpec
from repro.data import synthetic as jdata
from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro.training import optimizer as jopt
from repro_torch import forms as tforms
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import paper_cnns as tcfgs
from repro_torch.core import admm as tadmm
from repro_torch.core import crossbar as txbar
from repro_torch.core import polarization as tpol
from repro_torch.core import quantization as TQ
from repro_torch.core import zeroskip as TZ
from repro_torch.core.pruning import PruneSpec as TPruneSpec
from repro_torch.data import synthetic as tdata
from repro_torch.kernels import ops as tops
from repro_torch.launch import cnn_pipeline
from repro_torch.models import cnn as tcnn

from torch_parity_util import port_to_jax, to_numpy

TOL = 1e-5
RHO = 5e-3


def mixed_cnn(image_size: int, cls=tcfgs.CNNConfig):
    """Every layer kind: conv at stride 1 and 2, a res block without and one
    with a projection (stride 2), pool, two FC layers.  At 16 the stride-2
    layers meet even sizes (SAME pads (0, 1)), at 17 odd ones ((1, 1)); the
    pool after them brings the reference's size count back to the real one
    (it counts ``size // stride``, the conv gives ``ceil``), and the flatten
    sees 2 x 2 x 8."""
    return cls(name=f"mixed{image_size}", image_size=image_size, in_channels=3,
               num_classes=5,
               arch=(("conv", 4, 3, 1), ("conv", 6, 3, 2), ("res", 6, 1), ("res", 8, 2),
                     ("pool",), ("fc", 12), ("fc", 5)))


CONFIGS = {"mixed16": 16, "mixed17": 17, "lenet5": None, "tiny": None}


def configs(name):
    """(reference config, port config) by test name."""
    if name.startswith("mixed"):
        size = CONFIGS[name]
        return mixed_cnn(size, jcfgs.CNNConfig), mixed_cnn(size)
    if name == "lenet5":
        return jcfgs.LENET5, tcfgs.LENET5
    return jcfgs.tiny_cnn(), tcfgs.tiny_cnn()


@functools.lru_cache(maxsize=None)
def bridged(name, seed=0):
    """The reference's init for ``name`` and the same numbers in the port."""
    jc, tc = configs(name)
    jp = jax.jit(lambda key: jcnn.init(jc, key))(jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_numpy(to_numpy(jp), device="cpu")


def images(cfg, batch, seed=3):
    rng = np.random.RandomState(seed)
    img = rng.normal(size=(batch, cfg.image_size, cfg.image_size, cfg.in_channels))
    lab = rng.randint(0, cfg.num_classes, batch)
    return img.astype(np.float32), lab.astype(np.int32)


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _equal(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


# ---------------------------------------------------------------- the data


def test_image_blob_equals_the_reference_for_the_same_labels():
    """The blob is a pure function of the labels: the reference's batch less
    its own noise (redrawn from its keys) equals the port's blob of the
    reference's labels within 1e-6."""
    cfg = jdata.ImageStreamConfig(image_size=16, channels=3, num_classes=10, batch=32, seed=4)
    img, lab = jax.jit(jdata.image_batch, static_argnums=0)(cfg, 7)
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 1), 7)
    _, k2 = jax.random.split(key)
    noise = 0.3 * jax.random.normal(k2, (cfg.batch, 16, 16, 3))
    want = np.asarray(img - noise)
    blob = tdata.class_blob(torch.from_numpy(np.array(lab)), 16, 10)
    for c in range(3):
        np.testing.assert_allclose(blob.numpy(), want[..., c], rtol=0, atol=1e-6)
    assert float(blob.max()) > 0.9 and float(blob.min()) >= 0.0


def test_image_stream_shapes_and_determinism():
    cfg = tdata.ImageStreamConfig(image_size=16, channels=1, num_classes=10, batch=8)
    jimg, jlab = jax.eval_shape(lambda: jdata.image_batch(jdata.ImageStreamConfig(16, 1, 10, 8),
                                                          0))
    img, lab = tdata.image_batch(cfg, 0, device="cpu")
    assert img.shape == jimg.shape and lab.shape == jlab.shape
    assert img.dtype == torch.float32 and lab.dtype == torch.int32
    img2, lab2 = tdata.image_batch(cfg, 0, device="cpu")
    assert torch.equal(img, img2) and torch.equal(lab, lab2)
    img3, _ = tdata.image_batch(cfg, 1, device="cpu")
    assert not torch.equal(img, img3)
    assert int(lab.min()) >= 0 and int(lab.max()) < 10
    # the noise is the rest: about 0.3 of spread around the blob
    resid = img[..., 0] - tdata.class_blob(lab, 16, 10)
    assert 0.2 < float(resid.std()) < 0.4


# ------------------------------------------------------------- the model


def test_same_padding_is_xlas():
    """(before, after) = (total // 2, rest) with total = max((ceil(H/s) - 1) s
    + k - H, 0): (0, 1) for a 3 x 3 stride-2 conv on an even size, (1, 1) on
    an odd one, none for a 1 x 1 projection."""
    assert tcnn.same_padding(32, 3, 2) == (0, 1)
    assert tcnn.same_padding(17, 3, 2) == (1, 1)
    assert tcnn.same_padding(16, 3, 1) == (1, 1)
    assert tcnn.same_padding(28, 5, 1) == (2, 2)
    assert tcnn.same_padding(16, 1, 2) == (0, 0)
    x = torch.arange(2 * 3 * 8 * 8, dtype=torch.float32).reshape(2, 8, 8, 3)
    w = np.random.RandomState(0).randn(3, 3, 3, 4).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x.numpy()), jnp.asarray(w), (2, 2), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tcnn._conv(x.permute(0, 3, 1, 2), torch.from_numpy(w), 2).permute(0, 2, 3, 1)
    _close(got, want, "stride-2 conv")
    shifted = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), torch.from_numpy(w).permute(
        3, 2, 0, 1), stride=2, padding=1).permute(0, 2, 3, 1)
    assert shifted.shape == got.shape and not torch.allclose(shifted, got)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_reference(name):
    jc, tc, jp, tp = bridged(name)
    img, _ = images(tc, 2)
    want, _ = jforward(jc)(jp, jnp.asarray(img))
    got, acts = tcnn.forward(tc, tp, torch.from_numpy(img))
    assert acts == []
    _close(got, want, name)


@pytest.mark.parametrize("name", ["mixed17", "lenet5"])
def test_collected_activations_match_reference(name):
    """Names in the reference's order, NHWC inputs of the convs and res
    blocks, the flattened inputs of the FC layers."""
    jc, tc, jp, tp = bridged(name)
    img, _ = images(tc, 2)
    _, jacts = jforward(jc, True)(jp, jnp.asarray(img))
    _, tacts = tcnn.forward(tc, tp, torch.from_numpy(img), collect_activations=True)
    assert [n for n, _ in tacts] == [n for n, _ in jacts]
    for (n, a), (_, b) in zip(tacts, jacts):
        _close(a, b, n)


def test_flatten_is_nhwc():
    """The first FC layer reads the pooled (2, 2, 8) map flattened in
    (h, w, c) order, as the reference's output of the layers before it."""
    jc, tc, jp, tp = bridged("mixed16")
    img, _ = images(tc, 2)
    _, acts = tcnn.forward(tc, tp, torch.from_numpy(img), collect_activations=True)
    flat = dict(acts)["fc5"]
    pooled, _ = jforward(dataclasses.replace(jc, arch=jc.arch[:5]))(jp, jnp.asarray(img))
    assert pooled.shape == (2, 2, 2, 8) and flat.shape == (2, 2 * 2 * 8)
    _close(flat, np.asarray(pooled).reshape(2, -1), "flatten")


@pytest.mark.parametrize("name", ["mixed16", "lenet5"])
def test_crossbar_weight_shapes_match_reference(name):
    jc, tc, jp, tp = bridged(name)
    assert sorted(tcnn.crossbar_weight_shapes(tc, tp)) == sorted(
        jcnn.crossbar_weight_shapes(jc, jp))
    tcomp, _ = tforms.compress_tree(tp, tforms.FormsSpec(m=8, rule="sum"))
    jcomp = port_to_jax(tcomp)
    assert sorted(tcnn.crossbar_weight_shapes(tc, tcomp)) == sorted(
        jcnn.crossbar_weight_shapes(jc, jcomp))


def test_init_has_the_references_shapes_and_scales():
    for name in ("mixed17", "lenet5"):
        jc, tc, jp, _ = bridged(name)
        g = torch.Generator()
        g.manual_seed(0)
        tp = tcnn.init(tc, g)
        assert {k: tuple(v.shape) for k, v in tp.items()} == {
            k: tuple(v.shape) for k, v in jp.items()}
        for k, v in tp.items():
            if k.endswith("_b"):
                assert not v.any()
            else:
                ratio = float(v.std()) / float(np.asarray(jp[k]).std())
                assert 0.7 < ratio < 1.4, (k, ratio)
    # the published widths: the reference's shapes (``eval_shape``, nothing
    # drawn), 14.98 M and 11.24 M params
    for jc, tc, n in ((jcfgs.VGG16, tcfgs.VGG16, 14_978_250),
                      (jcfgs.RESNET18, tcfgs.RESNET18, 11_241_162)):
        want = jax.eval_shape(lambda: jcnn.init(jc, jax.random.PRNGKey(0)))
        g = torch.Generator()
        g.manual_seed(0)
        tp = tcnn.init(tc, g)
        assert {k: tuple(v.shape) for k, v in tp.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
        assert sum(v.numel() for v in tp.values()) == n, tc.name


# ------------------------------------------------------------ training


@functools.lru_cache(maxsize=None)
def jforward(jc, collect=False):
    """The reference's forward, jitted (eager JAX compiles op by op); the
    activations' names are kept from the trace."""
    names = []

    def arrays(p, x):
        logits, acts = jcnn.forward(jc, p, x, collect_activations=collect)
        names[:] = [n for n, _ in acts]
        return logits, [a for _, a in acts]

    fn = jax.jit(arrays)

    def call(p, x):
        logits, acts = fn(p, x)
        return logits, list(zip(names, acts))
    return call


def _reference_step(jc, jp, opt, img, lab, admm_state=None, table=None):
    """The reference pipeline's SGD step (its ``loss_fn``, jitted)."""
    def step(p, o, st):
        def loss_fn(pp):
            logits, _ = jcnn.forward(jc, pp, img)
            ll = jax.nn.log_softmax(logits)
            task = -jnp.mean(jnp.take_along_axis(ll, lab[:, None], 1))
            if st is not None:
                task = task + jadmm.admm_penalty(pp, st, table)
            return task

        loss, g = jax.value_and_grad(loss_fn)(p)
        return (*jopt.sgd_update(p, g, o, lr=cnn_pipeline.LR), loss)

    return jax.jit(step)(jp, opt, admm_state)


def _reference_update(jp, state, table, refresh_signs):
    """Eager, as the reference's train loop calls it: under ``jit`` XLA
    rounds the quantization scale otherwise (1 ulp)."""
    return jadmm.admm_update(jp, state, table, refresh_signs=refresh_signs)


def _constraints(pkg):
    if pkg == "jax":
        return jadmm.default_constraints(prune=JPruneSpec(alpha=0.75, beta=0.75),
                                         forms=jforms.FormsSpec(m=8, bits=8, rule="sum"),
                                         rho=RHO)
    return tadmm.default_constraints(prune=TPruneSpec(alpha=0.75, beta=0.75),
                                     forms=tforms.FormsSpec(m=8, bits=8, rule="sum"), rho=RHO)


ADMM_FIELDS = ("z", "u", "signs", "row_mask", "col_mask", "scale")


def _jax_state(tstate):
    """A port ADMM state as the reference's (same numbers)."""
    j = lambda a: None if a is None else jnp.asarray(a.numpy())  # noqa: E731
    return {p: jadmm.AdmmLayerState(**{f: j(getattr(st, f)) for f in ADMM_FIELDS})
            for p, st in tstate.items()}


@functools.lru_cache(maxsize=None)
def port_run(name):
    """The port's fresh Z-update at the bridged init, ``project_hard`` and
    ``compress_tree`` (the reference's are held to these bit for bit on
    ``tiny_cnn()`` by :func:`admm_run`)."""
    _, _, _, tp = bridged(name)
    tstate, table = tadmm.init_admm(tp, _constraints("torch"))
    fresh = tadmm.admm_update(tp, tstate, table, refresh_signs=True)
    projected = tadmm.project_hard(tp, fresh, table)
    compressed, _ = tforms.compress_tree(projected, tforms.FormsSpec(m=8, bits=8, rule="sum"))
    return {"fresh": fresh, "table": table, "projected": projected, "compressed": compressed}


def _state_equal(tstate, jstate):
    assert set(tstate) == set(jstate)
    for path, st in tstate.items():
        for f in ADMM_FIELDS:
            _equal(getattr(st, f), getattr(jstate[path], f), f"{path} {f}")


@pytest.mark.parametrize("name", ["mixed17", "lenet5"])
def test_sgd_step_with_and_without_penalty_matches_reference(name):
    """Two SGD-momentum steps from the bridged init on one numpy batch, the
    second with the ADMM penalty of a fresh Z-update (the port's state
    carried across): each loss and every param within 1e-5."""
    jc, tc, jp, tp0 = bridged(name)
    tp = {k: v.clone() for k, v in tp0.items()}
    img, lab = images(tc, 8, seed=5)
    jimg, jlab, timg, tlab = jnp.asarray(img), jnp.asarray(lab), *map(torch.from_numpy,
                                                                        (img, lab))
    jp1, jo, jloss = _reference_step(jc, jp, jopt.sgd_init(jp), jimg, jlab)
    tp, to, tloss = cnn_pipeline.sgd_step(tc, tp, cnn_pipeline.sgd_init(tp), timg, tlab)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    for k in tp:
        _close(tp[k], jp1[k], f"step 1 {k}")

    tstate, ttable = port_run(name)["fresh"], port_run(name)["table"]
    jstate, jtable = _jax_state(tstate), jadmm.constraint_table(jp, _constraints("jax"))
    assert set(ttable) == set(jtable) == {k for k in tp if not k.endswith("_b")}
    assert float(tadmm.admm_penalty(tp, tstate, ttable)) > 0
    jp2, _, jloss2 = _reference_step(jc, jp1, jo, jimg, jlab, jstate, jtable)
    tp, _, tloss2 = cnn_pipeline.sgd_step(tc, tp, to, timg, tlab, tstate, ttable)
    np.testing.assert_allclose(float(tloss2), float(jloss2), rtol=TOL)
    for k in tp:
        _close(tp[k], jp2[k], f"step 2 {k}")


@functools.lru_cache(maxsize=None)
def admm_run():
    """On ``tiny_cnn()`` (conv K = 9 padded to 16 at m=8, and 72; FC 256 x 64
    and 64 x 10): the reference's fresh Z-update (sign refresh) at its
    init, one SGD step with the penalty, then a frozen Z-update,
    ``project_hard`` and ``compress_tree``, eager as its pipeline calls
    them (under ``jit`` XLA rounds the quantization scale otherwise);
    the port's the same on the bridged weights."""
    jc, tc, jp, tp = bridged("tiny")
    img, lab = images(tc, 8, seed=6)
    jstate, jtable = jadmm.init_admm(jp, _constraints("jax"))
    tstate, ttable = tadmm.init_admm(tp, _constraints("torch"))
    out = {"fresh": (tadmm.admm_update(tp, tstate, ttable, refresh_signs=True),
                     _reference_update(jp, jstate, jtable, True))}
    jp1, _, _ = _reference_step(jc, jp, jopt.sgd_init(jp), jnp.asarray(img), jnp.asarray(lab),
                                out["fresh"][1], jtable)
    tp1 = params_from_numpy(to_numpy(jp1), device="cpu")
    out["frozen"] = (tadmm.admm_update(tp1, out["fresh"][0], ttable, refresh_signs=False),
                     _reference_update(jp1, out["fresh"][1], jtable, False))
    out["projected"] = (tadmm.project_hard(tp1, out["frozen"][0], ttable),
                        jadmm.project_hard(jp1, out["frozen"][1], jtable))
    out["compressed"] = (
        tforms.compress_tree(out["projected"][0], tforms.FormsSpec(m=8, bits=8, rule="sum")),
        jforms.compress_tree(out["projected"][1], jforms.FormsSpec(m=8, bits=8, rule="sum")))
    assert set(ttable) == set(jtable)
    out["tables"] = (ttable, jtable)
    return out


def test_admm_updates_and_projection_are_the_references_bit_for_bit():
    """The fresh Z-update (prune, polarize with the sum rule, quantize) and
    the frozen one on conv matrices (K = kh kw cin) and FC matrices: Z, U,
    signs, masks and scales equal; ``project_hard`` equal; every
    constrained matrix polarized."""
    run = admm_run()
    _state_equal(*run["fresh"])
    _state_equal(*run["frozen"])
    tproj, jproj = run["projected"]
    for k in tproj:
        _equal(tproj[k], jproj[k], k)
    ttable = run["tables"][0]
    assert any(tproj[p].ndim == 4 for p in ttable)
    for path, c in ttable.items():
        mat = tadmm._as_matrix(tproj[path], c)
        assert bool(tpol.is_polarized(mat, 8)), path
        assert float((mat == 0).float().mean()) >= 0.4, path   # 0.75 x 0.75 kept


def test_compress_tree_on_conv_leaves_code_for_code():
    (tcomp, trep), (jcomp, jrep) = admm_run()["compressed"]
    assert trep.num_compressed == jrep.num_compressed and trep.num_skipped == jrep.num_skipped
    assert trep.bytes_compressed == jrep.bytes_compressed
    conv = 0
    for k, leaf in tcomp.items():
        ref = jcomp[k]
        if isinstance(leaf, tforms.FormsLinearParams):
            assert (leaf.k, leaf.m, leaf.orig_shape, leaf.policy) == (
                ref.k, ref.m, ref.orig_shape, ref.policy), k
            conv += leaf.orig_shape is not None
            for f in ("mags", "signs", "scale"):
                _equal(getattr(leaf, f), getattr(ref, f), f"{k} {f}")
            assert trep.errors[k] < 1e-5 and jrep.errors[k] < 1e-5
        else:
            _equal(leaf, ref, k)
    assert conv >= 2
    restored = tforms.decompress_tree(tcomp)
    for k, v in restored.items():
        _close(v, np.asarray(admm_run()["projected"][1][k]), k)


@pytest.mark.parametrize("name", ["mixed17", "lenet5"])
def test_compressed_forward_matches_reference(name):
    """The compressed tree's forward: conv leaves rebuilt, FC leaves through
    the polarized matmul (the plain version on the CPU), within 1e-5 of the
    reference's on the same codes, and of the dense projected tree's."""
    jc, tc, _, _ = bridged(name)
    run = port_run(name)
    tcomp = run["compressed"]
    img, _ = images(tc, 4, seed=7)
    want, _ = jforward(jc)(port_to_jax(tcomp), jnp.asarray(img))
    got, _ = tcnn.forward(tc, tcomp, torch.from_numpy(img))
    _close(got, want, name)
    dense, _ = tcnn.forward(tc, run["projected"], torch.from_numpy(img))
    _close(got, dense.numpy(), "compressed vs dense")


def _bitserial(pkg_q, pkg_ops, leaf, x, spec):
    x2 = x.reshape(-1, x.shape[-1])
    pad = leaf.mags.shape[0] - x2.shape[1]
    if isinstance(x2, torch.Tensor):
        x2 = torch.nn.functional.pad(x2, (0, pad))
    else:
        x2 = jnp.pad(x2, ((0, 0), (0, pad)))
    codes, _ = pkg_q.quantize_activations(x2, spec.input_bits)
    cells = pkg_q.slice_to_cells(leaf.mags, spec.quant)
    return pkg_ops.bitserial_crossbar(codes, cells, leaf.signs, spec=spec)


@pytest.mark.parametrize("name", ["mixed17", "lenet5"])
def test_apply_simulated_on_fc_leaves_and_eic_match_reference(name):
    """``apply_simulated`` on the last FC leaf (K not a multiple of m:
    LeNet-5's 84 x 10 pads K to 88, the mixed net's 12 x 5 to 16) at its
    collected inputs: the accumulators and the EIC equal the reference's, y
    within 1e-6 (one f32 product of the integer result and two scales);
    the mean EIC over every collected activation equal."""
    jc, tc, _, _ = bridged(name)
    tcomp = port_run(name)["compressed"]
    img, _ = images(tc, 4, seed=8)
    _, acts = tcnn.forward(tc, port_run(name)["projected"], torch.from_numpy(img),
                           collect_activations=True)
    tspec, jspec = tforms.FormsSpec(m=8, bits=8, rule="sum"), jforms.FormsSpec(m=8, bits=8,
                                                                             rule="sum")
    n, a = acts[-1]
    leaf, jleaf, ja = tcomp[n], port_to_jax(tcomp)[n], jnp.asarray(a.numpy())
    assert n.startswith("fc") and leaf.k % 8 and leaf.mags.shape[0] == -(-leaf.k // 8) * 8
    y, eic, xs = tforms.apply_simulated(leaf, a, tspec)
    jy, jeic, jxs = jax.jit(jforms.apply_simulated, static_argnums=2)(jleaf, ja, jspec)
    _equal(eic, jeic, n)
    _equal(xs, jxs, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=0, err_msg=n)
    acc, eic2 = _bitserial(TQ, tops, leaf, a, tspec)
    jacc, _ = jax.jit(lambda lf, x: _bitserial(JQ, jops, lf, x, jspec))(jleaf, ja)
    _equal(acc, jacc, n)
    _equal(eic2, eic, n)
    want = np.mean([JZ.eic_stats(JQ.quantize_activations(jnp.asarray(a.numpy()).reshape(
        a.shape[0], -1), 16)[0], 8, 16).mean_eic for _, a in acts])
    got = cnn_pipeline.mean_eic(tc, port_run(name)["projected"], torch.from_numpy(img),
                                tspec)
    assert got == float(want) and got < 16


# ------------------------------------------------------------ the pipeline


@pytest.fixture(scope="module")
def pipeline():
    """The port's pipeline on ``tiny_cnn()`` at the reference's step counts
    (``tests/test_system.py``: m = 4), on the CPU."""
    return cnn_pipeline.train_forms_cnn(fragment=4, device="cpu")


def test_pipeline_meets_the_system_tests_thresholds(pipeline):
    t = pipeline
    assert t["acc_pre"] > 0.6, "pretraining failed to learn the task"
    assert t["acc_post"] > t["acc_pre"] - 0.15, (t["acc_pre"], t["acc_post"])
    assert set(t["phase_s"]) == {"pretrain", "accuracy_pre", "admm", "finetune",
                                 "accuracy_post"}
    for path, c in t["table"].items():
        mat = tadmm._as_matrix(t["projected"][path], c)
        assert bool(tpol.is_polarized(mat, c.polarize.m)), path
    shapes = tcnn.crossbar_weight_shapes(t["cfg"], t["projected"])
    rep = txbar.reduction_report(shapes, shapes, txbar.CrossbarSpec(rows=128, cols=128),
                                 t["spec"].quant, baseline_bits=16)
    assert rep.quant_factor == 2.0 and rep.polarization_factor == 2.0 and rep.total >= 2.0
    img, _ = tdata.image_batch(t["ds"], 2000, device="cpu")
    _, acts = tcnn.forward(t["cfg"], t["projected"], img, collect_activations=True)
    saved = [TZ.eic_stats(TQ.quantize_activations(a.reshape(a.shape[0], -1), 16)[0], 4,
                          16).savings for _, a in acts]
    assert max(saved) > 0.15, saved


def test_pipeline_in_situ_fc_matches_dense(pipeline):
    """``test_system.py``'s in-situ check: the bit-serial FC layer within 5%
    (relative L2) of the float one, the EIC below the worst case."""
    t = pipeline
    w = t["projected"]["fc4"]
    fp, _ = tforms.from_dense(w, t["spec"])
    g = torch.Generator()
    g.manual_seed(1)
    x = torch.randn((8, w.shape[0]), generator=g).abs()
    y, eic, _ = tforms.apply_simulated(fp, x, t["spec"])
    rel = float(torch.linalg.norm(y - x @ w) / torch.linalg.norm(x @ w))
    assert rel < 0.05 and float(eic.float().mean()) < 16.0


def test_launcher_runs_on_cpu_and_refuses_without_a_card(capsys, monkeypatch):
    cnn_pipeline.main(["--fragment", "8", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "=== FORMS pipeline, fragment size 8 ===" and out[-1] == "OK"
    assert any(line.startswith("compressed-tree forward: argmax agreement") for line in out)
    assert any(line.startswith("modeled FPS vs original ISAAC") for line in out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cnn_pipeline.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdata.image_batch(tdata.ImageStreamConfig(8, 1, 10, 2), 0)
