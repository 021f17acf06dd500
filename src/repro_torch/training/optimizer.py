"""Optimizers written to the reference's formulas: AdamW (float32, bfloat16
or int8 moments), SGD-momentum, the cosine schedule and global-norm clipping.

``torch.optim.AdamW`` places eps and the decoupled decay differently and has
no int8 moments, so the update is written out as the JAX package writes it.
Optimizer state is a plain tree shaped like the params.  The step, the
learning rate, the bias corrections and the clip scale stay device tensors:
an update never reads a value back to the host.

Unlike the reference's pure functions, :func:`adamw_update` and
:func:`sgd_update` write the new params and moments into the given tensors
(and return them): at full width that saves a second copy of the params and
both moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.paths import leaves, tree_map

Params = Any


def cosine_schedule(cfg: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``learning_rate``, then a half cosine to 0 at
    ``total_steps``; takes and returns device tensors."""
    warm_steps = max(cfg.warmup_steps, 1)
    span = max(cfg.total_steps - cfg.warmup_steps, 1)

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = cfg.learning_rate * step / warm_steps
        prog = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
        cos = 0.5 * cfg.learning_rate * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < cfg.warmup_steps, warm, cos)
    return lr


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@dataclasses.dataclass
class AdamWState:
    """Adam moments, optionally quantized to int8 (codes plus a per-row f32
    scale over the last axis) or kept in bf16."""

    step: torch.Tensor
    mu: Params
    nu: Params
    mu_scale: Optional[Params]   # None unless int8 moments
    nu_scale: Optional[Params]


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization (scale over the last axis)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-20) / 127.0
    q = (x / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def adamw_init(params: Params, moment_dtype: str = "float32") -> AdamWState:
    some = leaves(params)
    dev = some[0].device if some else torch.device("cpu")
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if moment_dtype == "int8":
        zq = lambda p: torch.zeros(p.shape, dtype=torch.int8, device=p.device)
        zs = lambda p: torch.zeros(tuple(p.shape[:-1]) + (1,) if p.ndim else (1,),
                                   dtype=torch.float32, device=p.device)
        return AdamWState(step=step, mu=tree_map(zq, params), nu=tree_map(zq, params),
                          mu_scale=tree_map(zs, params), nu_scale=tree_map(zs, params))
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(moment_dtype)
    if dt is None:
        raise ValueError(f"moment_dtype must be float32, bfloat16 or int8, got "
                         f"{moment_dtype!r}")
    zeros = lambda: tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                             params)
    return AdamWState(step=step, mu=zeros(), nu=zeros(), mu_scale=None, nu_scale=None)


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: AdamWState, cfg: TrainConfig,
                 lr_fn: Optional[Callable] = None) -> Tuple[Params, AdamWState]:
    """One AdamW step, written into ``params`` and the state's moments."""
    lr_fn = lr_fn or cosine_schedule(cfg)
    step = state.step + 1
    lr = lr_fn(step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    int8 = state.mu_scale is not None
    flat = [leaves(t) for t in (params, grads, state.mu, state.nu)]
    scales = ([leaves(state.mu_scale), leaves(state.nu_scale)] if int8
              else [[None] * len(flat[0])] * 2)
    for p, g, m, v, ms, vs in zip(*flat, *scales):
        g = g.float()
        m32 = _dq8(m, ms) if int8 else m.float()
        v32 = _dq8(v, vs) if int8 else v.float()
        m32 = b1 * m32 + (1 - b1) * g
        v32 = b2 * v32 + (1 - b2) * torch.square(g)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + 1e-8) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        if int8:
            for q, s, x in ((m, ms, m32), (v, vs, v32)):
                xq, xs = _q8(x)
                q.copy_(xq)
                s.copy_(xs)
        else:
            m.copy_(m32)
            v.copy_(v32)
    return params, dataclasses.replace(state, step=step)


@dataclasses.dataclass
class SGDState:
    step: torch.Tensor
    momentum: Params


def sgd_init(params: Params) -> SGDState:
    some = leaves(params)
    dev = some[0].device if some else torch.device("cpu")
    return SGDState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    momentum=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                            device=p.device), params))


@torch.no_grad()
def sgd_update(params: Params, grads: Params, state: SGDState, lr: float,
               momentum: float = 0.9) -> Tuple[Params, SGDState]:
    """One SGD-momentum step, written into ``params`` and the momentum."""
    for p, g, m in zip(leaves(params), leaves(grads), leaves(state.momentum)):
        m.copy_(momentum * m + g.float())
        p.copy_(p.float() - lr * m)
    return params, SGDState(step=state.step + 1, momentum=state.momentum)

