"""The paper's full pipeline (Fig 1) on a CNN, end to end.

pretrain -> crossbar-aware structured pruning + fragment polarization +
ReRAM quantization (all via ADMM) -> hard projection -> projected
fine-tuning -> ``compress_tree`` (the uint8 + signs deployment artifact)
-> bit-serial in-situ inference with zero-skipping -> report: accuracy,
crossbar reduction, EIC savings and the modeled FPS speedup (Figs 13/14).

  python -m repro_torch.launch.cnn_pipeline [--fragment 8] [--device cpu]

The port of the reference's ``benchmarks/common.py::trained_forms_cnn`` and
``examples/forms_pipeline_cnn.py``, with their settings, printing the
example's lines.  :func:`train_forms_cnn` is the training half, for any
:class:`~repro_torch.configs.paper_cnns.CNNConfig` and step counts.  The
data are the port's image stream (its draws differ from the reference's).
``--device`` defaults to ``cuda`` and the launcher fails without a card
unless ``--device cpu`` is given.  The crossbar reduction and the FPS
speedup are the paper's ReRAM model, not times of the device.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.paper_cnns import CNNConfig, tiny_cnn
from repro_torch.core import admm as admm_mod
from repro_torch.core import crossbar as xbar
from repro_torch.core import paths
from repro_torch.core import perfmodel as pm
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.pruning import PruneSpec
from repro_torch.core.quantization import quantize_activations
from repro_torch.core.zeroskip import eic_stats
from repro_torch.data.synthetic import ImageStreamConfig, image_batch
from repro_torch.forms import FormsSpec, apply_simulated, compress_tree, decompress_tree
from repro_torch.models import cnn as cnn_mod
from repro_torch.training.optimizer import sgd_init, sgd_update

LR = 0.05
BATCH = 64


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cnn_loss(cfg: CNNConfig, params, img: torch.Tensor, lab: torch.Tensor,
             admm_state=None, table=None) -> torch.Tensor:
    """Mean cross-entropy of the logits on ``lab``, plus the ADMM penalty
    when a state is given (the reference pipeline's ``loss_fn``)."""
    logits, _ = cnn_mod.forward(cfg, params, img)
    ll = torch.log_softmax(logits, dim=-1)
    task = -torch.mean(ll.gather(1, lab.long()[:, None]))
    if admm_state is not None:
        task = task + admm_mod.admm_penalty(params, admm_state, table)
    return task


def sgd_step(cfg: CNNConfig, params, opt, img: torch.Tensor, lab: torch.Tensor,
             admm_state=None, table=None, lr: float = LR):
    """One SGD-momentum step on :func:`cnn_loss`, written into ``params``
    and the momentum.  Returns (params, opt, loss before the step)."""
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = cnn_loss(cfg, live, img, lab, admm_state, table)
    grads = torch.autograd.grad(loss, list(live.values()))
    params, opt = sgd_update(params, dict(zip(live, grads)), opt, lr=lr)
    return params, opt, loss.detach()


def train_forms_cnn(cfg: Optional[CNNConfig] = None, fragment: int = 8,
                    prune_keep: float = 0.75, pretrain_steps: int = 120,
                    admm_steps: int = 240, finetune_steps: int = 100,
                    admm_every: int = 30, seed: int = 0, lr: float = LR,
                    device: Union[str, torch.device, None] = DEFAULT_DEVICE
                    ) -> Dict[str, Any]:
    """Pretrain + ADMM + hard projection + projected fine-tune (paper Fig
    1/4: the flow retrains with the structure frozen after projection), as
    the reference's ``trained_forms_cnn`` (its defaults; ``cfg`` defaults
    to ``tiny_cnn()``).  SGD-momentum at ``lr`` (the reference's 0.05; a
    deep net without normalization, as ResNet-18 here, diverges at that rate
    from random weights and takes a smaller one); the ADMM Z-update every
    ``admm_every`` steps refreshes the signs for the first 60% of the ADMM
    steps.  Returns the config, the stream, the ADMM-trained and the
    projected params, the ADMM state and table, both accuracies, the spec
    and each phase's wall seconds (``phase_s``, the device synchronized)."""
    cfg = cfg or tiny_cnn()
    dev = resolve_device(device)
    ds = ImageStreamConfig(image_size=cfg.image_size, channels=cfg.in_channels,
                           num_classes=cfg.num_classes, batch=BATCH, seed=seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = cnn_mod.init(cfg, gen)

    def sgd(p, admm_state, table, opt, step):
        img, lab = image_batch(ds, step, dev)
        return sgd_step(cfg, p, opt, img, lab, admm_state, table, lr=lr)[:2]

    @torch.no_grad()
    def accuracy(p, steps=6):
        hits = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(steps):
            img, lab = image_batch(ds, 5000 + i, dev)
            logits, _ = cnn_mod.forward(cfg, p, img)
            hits += (logits.argmax(-1) == lab).sum()
        return int(hits) / (steps * BATCH)

    phase_s: Dict[str, float] = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        _sync(dev)
        now = time.perf_counter()
        phase_s[name] = now - t
        t = now

    opt = sgd_init(params)
    for i in range(pretrain_steps):
        params, opt = sgd(params, None, None, opt, i)
    lap("pretrain")
    acc_pre = accuracy(params)
    lap("accuracy_pre")

    spec = FormsSpec(m=fragment, bits=8, rule="sum")  # paper's sign rule
    cfn = admm_mod.default_constraints(
        prune=PruneSpec(alpha=prune_keep, beta=prune_keep), forms=spec, rho=5e-3)
    admm_state, table = admm_mod.init_admm(params, cfn)
    for i in range(admm_steps):
        params, opt = sgd(params, admm_state, table, opt, 200 + i)
        if (i + 1) % admm_every == 0:
            admm_state = admm_mod.admm_update(params, admm_state, table,
                                              refresh_signs=(i < admm_steps * 0.6))
    lap("admm")
    # a copy: the fine-tune updates in place, and the leaves the projection
    # passes through (the biases) would otherwise be the ADMM params' own
    projected = paths.tree_map(torch.clone, admm_mod.project_hard(params, admm_state, table))
    fopt = sgd_init(projected)
    for i in range(finetune_steps):
        projected, fopt = sgd(projected, None, None, fopt, 600 + i)
        projected = admm_mod.project_hard(projected, admm_state, table)
    lap("finetune")
    acc_post = accuracy(projected)
    lap("accuracy_post")
    return dict(cfg=cfg, ds=ds, params=params, projected=projected,
                admm_state=admm_state, table=table, acc_pre=acc_pre,
                acc_post=acc_post, fragment=fragment, spec=spec, phase_s=phase_s,
                images=(pretrain_steps + admm_steps + finetune_steps) * BATCH)


def mean_eic(cfg: CNNConfig, params, img: torch.Tensor, spec: FormsSpec) -> float:
    """Mean EIC over the inputs of every crossbar layer on ``img``: each
    layer's activations quantized to ``spec.input_bits``-bit codes."""
    with torch.no_grad():
        _, acts = cnn_mod.forward(cfg, params, img, collect_activations=True)
    eics = []
    for _, a in acts:
        codes, _ = quantize_activations(a.reshape(a.shape[0], -1), spec.input_bits)
        eics.append(eic_stats(codes, spec.m, spec.input_bits).mean_eic)
    return float(np.mean(eics))


def evaluate(t: Dict[str, Any]) -> Dict[str, Any]:
    """The pipeline's second half on a trained ``t`` (the example's checks):
    the crossbar reduction; ``compress_tree`` and its exact inverse;
    bit-serial in-situ inference through the first FC leaf of the
    compressed tree against the float product; the compressed tree's
    forward against the projected tree's (argmax agreement); the mean EIC
    on real activations; the modeled FPS.  On the card the compression
    launches the polarization kernel once per crossbar leaf, the FC leaves
    the polarized matmul and the bit-serial crossbar kernel."""
    spec, cfg = t["spec"], t["cfg"]
    # the example's choice: the first FC weight by name
    name = min(k for k in t["projected"] if k.startswith("fc") and not k.endswith("_b"))
    dev = t["projected"][name].device
    shapes = cnn_mod.crossbar_weight_shapes(cfg, t["projected"])
    rep = xbar.reduction_report(shapes, shapes, xbar.CrossbarSpec(), spec.quant,
                                baseline_bits=16)
    # the deployment artifact: every crossbar weight becomes FormsLinearParams
    with torch.no_grad():
        compressed, crep = compress_tree(t["projected"], spec)
    restored = decompress_tree(compressed)
    resid = max(float((a - b).abs().max())
                for a, b in zip(paths.leaves(t["projected"]), paths.leaves(restored)))

    # in-situ (bit-serial) inference through one FC layer of the compressed tree
    w = t["projected"][name]
    g = torch.Generator()
    g.manual_seed(0)
    x = torch.randn((16, w.shape[0]), generator=g).abs().to(dev)
    y_sim, _, _ = apply_simulated(compressed[name], x, spec)
    sim_rel = float(torch.linalg.norm(y_sim - x @ w) / torch.linalg.norm(x @ w))

    # full compressed-tree forward parity (fc through the polarized kernel)
    img, _ = image_batch(t["ds"], 9000, dev)
    with torch.no_grad():
        logits_dense, _ = cnn_mod.forward(cfg, t["projected"], img)
        logits_forms, _ = cnn_mod.forward(cfg, compressed, img)
    agree = float((logits_dense.argmax(-1) == logits_forms.argmax(-1)).float().mean())
    eic = mean_eic(cfg, t["projected"], img, spec)
    fps = pm.fps_speedup(rep.prune_factor, rep.quant_factor, fragment=spec.m, mean_eic=eic)
    return dict(rep=rep, compressed=compressed, crep=crep, resid=resid, fc=name,
                sim_rel=sim_rel, agree=agree, mean_eic=eic, fps=fps)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fragment", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    m = args.fragment

    print(f"=== FORMS pipeline, fragment size {m} ===")
    t = train_forms_cnn(fragment=m, device=dev)
    print(f"accuracy: pretrained {t['acc_pre']:.3f} -> FORMS {t['acc_post']:.3f}")
    e = evaluate(t)
    rep, crep, sp, eic = e["rep"], e["crep"], e["fps"], e["mean_eic"]
    input_bits = t["spec"].input_bits
    print(f"crossbar reduction: {rep.total:.1f}x "
          f"(quant {rep.quant_factor:.0f}x, polarization "
          f"{rep.polarization_factor:.0f}x vs split mapping)")
    print(f"compress_tree: {crep.summary()}")
    print(f"decompress_tree exact-inverse residual: {e['resid']:.2e}")
    print(f"bit-serial crossbar sim vs float: rel-L2 {e['sim_rel']:.4f} "
          f"(conversion err {crep.errors[e['fc']]:.4f})")
    print(f"compressed-tree forward: argmax agreement {e['agree']*100:.1f}%")
    print(f"mean EIC {eic:.1f}/{input_bits} -> zero-skip saves "
          f"{(1 - eic/input_bits)*100:.0f}% of input cycles")
    print(f"modeled FPS vs original ISAAC: pruned/quant-ISAAC "
          f"{sp['pruned_quantized_isaac']:.1f}x, FORMS "
          f"{sp['forms_model_opt']:.1f}x, FORMS+zero-skip "
          f"{sp['forms_full_zero_skip']:.1f}x")
    print("OK")


if __name__ == "__main__":
    main()
