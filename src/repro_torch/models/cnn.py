"""CNNs for the paper's own benchmarks (LeNet-5 / VGG-16 / ResNet-18 class).

These are the models the FORMS pipeline compresses (Tables I/II).  The
params tree is the reference's (``repro/models/cnn.py``): ``conv{i}``,
``res{i}_conv1``/``_conv2``/``_proj`` kernels in HWIO ``(kh, kw, cin,
cout)`` — exactly the crossbar 2-D view after the polarization policy
reshape (``core/fragments.conv_to_matrix``) — and ``fc{i}`` (in, out) with
``fc{i}_b``.  Images are NHWC at the public functions, as the reference's.

Inside, the convolutions run in NCHW on ``F.conv2d``: the reference
computes its conv outside any Pallas kernel (``lax.conv_general_dilated``),
so a library conv is its counterpart.  XLA's ``padding="SAME"`` pads
``total = max((ceil(H/s) - 1) s + k - H, 0)`` with ``total // 2`` before
and the rest after — asymmetric at stride 2 on an even size, where
``F.conv2d(padding=k//2)`` would shift the windows — so every conv pads
explicitly with ``F.pad`` and convolves at padding 0.  The first FC layer
flattens in NHWC order, as the reference's rows are laid out.

A FORMS-compressed conv leaf is rebuilt with ``forms.to_dense`` (as the
reference's ``_dense``); a compressed FC leaf goes through ``forms.apply``,
the polarized-matmul kernel on the card.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnns import CNNConfig
from repro_torch.forms import FormsLinearParams
from repro_torch.forms import apply as forms_apply
from repro_torch.forms import to_dense as forms_to_dense

Params = Dict[str, Any]


def _dense(w) -> torch.Tensor:
    """Read a weight that may be FORMS-compressed."""
    return forms_to_dense(w) if isinstance(w, FormsLinearParams) else w


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w, stride: int = 1) -> torch.Tensor:
    """SAME conv of NCHW ``x`` with an HWIO kernel."""
    w = _dense(w)
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = same_padding(x.shape[2], kh, stride)
    left, right = same_padding(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _matmul(x: torch.Tensor, w) -> torch.Tensor:
    """FC matmul; compressed weights route through the polarized kernel."""
    if isinstance(w, FormsLinearParams):
        return forms_apply(w, x)
    return x @ w


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def init(cfg: CNNConfig, generator: torch.Generator) -> Params:
    """He-normal kernels and zero biases on the generator's device (the
    reference's shapes and scales; the draws are torch's)."""
    dev = generator.device
    normal = lambda shape: torch.randn(shape, generator=generator, device=dev)  # noqa: E731
    params: Params = {}
    c = cfg.in_channels
    size = cfg.image_size
    flat = None
    for i, spec in enumerate(cfg.arch):
        kind = spec[0]
        if kind == "conv":
            _, cout, ksz, stride = spec
            fan_in = ksz * ksz * c
            params[f"conv{i}"] = normal((ksz, ksz, c, cout)) * (2.0 / fan_in) ** 0.5
            c = cout
            size = size // stride
        elif kind == "res":
            _, cout, stride = spec
            params[f"res{i}_conv1"] = normal((3, 3, c, cout)) * (2.0 / (9 * c)) ** 0.5
            params[f"res{i}_conv2"] = normal((3, 3, cout, cout)) * (2.0 / (9 * cout)) ** 0.5
            if stride != 1 or c != cout:
                params[f"res{i}_proj"] = normal((1, 1, c, cout)) * (2.0 / c) ** 0.5
            c = cout
            size = size // stride
        elif kind == "pool":
            size = size // 2
        elif kind == "fc":
            _, out = spec
            fan_in = c if flat is not None else size * size * c
            params[f"fc{i}"] = normal((fan_in, out)) * (2.0 / fan_in) ** 0.5
            params[f"fc{i}_b"] = torch.zeros((out,), device=dev)
            c, flat = out, True
        else:
            raise ValueError(spec)
    return params


def forward(cfg: CNNConfig, params: Params, x: torch.Tensor,
            collect_activations: bool = False
            ) -> Tuple[torch.Tensor, List[Tuple[str, torch.Tensor]]]:
    """x: (B, H, W, C) -> logits (B, classes).

    ``collect_activations`` returns ``(name, input)`` of every crossbar-
    mapped layer in the reference's order — the NHWC input of each
    ``conv{i}``/``res{i}``, the flattened input of each ``fc{i}`` — the
    activation population the EIC/zero-skip analysis needs.
    """
    acts: List[Tuple[str, torch.Tensor]] = []
    h = x.permute(0, 3, 1, 2)
    flat = False
    for i, spec in enumerate(cfg.arch):
        kind = spec[0]
        if kind == "conv":
            if collect_activations:
                acts.append((f"conv{i}", _nhwc(h)))
            h = torch.relu(_conv(h, params[f"conv{i}"], spec[3]))
        elif kind == "res":
            _, cout, stride = spec
            if collect_activations:
                acts.append((f"res{i}", _nhwc(h)))
            r = torch.relu(_conv(h, params[f"res{i}_conv1"], stride))
            r = _conv(r, params[f"res{i}_conv2"], 1)
            sc = h if f"res{i}_proj" not in params else _conv(h, params[f"res{i}_proj"], stride)
            h = torch.relu(r + sc)
        elif kind == "pool":
            h = F.max_pool2d(h, 2, 2)
        elif kind == "fc":
            if not flat:
                h = _nhwc(h).reshape(h.shape[0], -1)
                flat = True
            if collect_activations:
                acts.append((f"fc{i}", h))
            h = _matmul(h, params[f"fc{i}"]) + params[f"fc{i}_b"]
            if i != len(cfg.arch) - 1:
                h = torch.relu(h)
    return h, acts


def crossbar_weight_shapes(cfg: CNNConfig, params: Params) -> List[Tuple[int, int]]:
    """2-D (K, N) crossbar-view shapes of every weight (for crossbar counting),
    in the params dict's order."""
    del cfg
    shapes = []
    for name, w in params.items():
        if name.endswith("_b"):
            continue
        if isinstance(w, FormsLinearParams):
            shape = w.orig_shape if w.orig_shape is not None else (w.k, w.n)
        else:
            shape = tuple(w.shape)
        if len(shape) == 4:
            kh, kw, cin, cout = shape
            shapes.append((kh * kw * cin, cout))
        elif len(shape) == 2:
            shapes.append(tuple(shape))
    return shapes
