"""Train step: loss, gradient accumulation, ADMM regularization, AdamW.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``.
``TrainState`` carries the params, the optimizer moments, the ADMM (Z, U)
variables, the gradient-compression error buffer and the generator of the
compression noise.  The forward and backward passes are plain PyTorch with
autograd, as the reference's are plain ``jnp`` under ``jax.value_and_grad``;
the one kernel of the training path is the polarization projection of the
ADMM Z-update (:func:`maybe_admm_update`).

A step launches work and returns: the loss, the gradient norm and the
learning rate in ``metrics`` are device scalars, and nothing in the step
reads a value back to the host.  The params and moments are updated in
place (see ``training/optimizer.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TrainConfig
from repro_torch.core import admm as admm_mod
from repro_torch.core import paths
from repro_torch.models.registry import Model
from repro_torch.training import grad_compress, optimizer as opt

Params = Any


@dataclasses.dataclass
class TrainState:
    params: Params
    opt: opt.AdamWState
    step: torch.Tensor                           # int32 device scalar
    admm: Optional[Dict[str, admm_mod.AdmmLayerState]]
    grad_err: Optional[Params]
    rng: torch.Generator                         # draws int8_ef rounding noise


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy from materialized logits (small-scale path)."""
    s = tokens.shape[1]
    logits = logits[:, -s:, :]
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1, :].float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None])[..., 0].mean()


CE_CHUNK = 8192  # tokens per chunk of the memory-efficient CE


def _chunk_nll(hx: torch.Tensor, tx: torch.Tensor, mx: torch.Tensor,
               head: torch.Tensor) -> torch.Tensor:
    lg = (hx @ head).float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, tx[:, None])[:, 0]
    return torch.sum((lse - ll) * mx)


def chunked_ce(hidden: torch.Tensor, head: torch.Tensor, tokens: torch.Tensor,
               shift: int = 1, chunk: int = CE_CHUNK) -> torch.Tensor:
    """Memory-efficient next-token CE: logits are computed per token chunk
    and recomputed in the backward pass, so the peak is chunk x vocab.
    ``shift``: targets are tokens[t + shift].  Chunk sums are added in
    order, as the reference's scan adds them."""
    s = tokens.shape[1]
    d = hidden.shape[-1]
    h = hidden[:, -s:, :][:, :-shift, :].reshape(-1, d)
    t = tokens[:, shift:].reshape(-1).long()
    n = h.shape[0]
    c = min(chunk, n)
    pad = (-n) % c
    mask = torch.ones((n + pad,), dtype=torch.float32, device=h.device)
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        t = torch.nn.functional.pad(t, (0, pad))
        mask[n:] = 0.0
    head = head.to(hidden.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, n + pad, c):
        args = (h[i:i + c], t[i:i + c], mask[i:i + c], head)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *args, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + _chunk_nll(*args)
    return total / max(n, 1)


def hidden_loss(model: Model, params: Params, batch: Dict[str, torch.Tensor],
                hidden: torch.Tensor) -> torch.Tensor:
    """Training loss from the final hidden states (never materializes the
    full logits).  The dense family has no auxiliary losses; the
    reference's MoE and multi-token-prediction terms come with those
    families."""
    return chunked_ce(hidden, model.head_matrix(params), batch["tokens"], shift=1)


def _value_and_grad(loss_fn: Callable, params: Params, *args) -> Tuple[torch.Tensor, Params]:
    """(loss, grads) of ``loss_fn(params, *args)`` with respect to every
    leaf of the params tree (leaves are taken as views, not copies)."""
    live = {p: t.detach().requires_grad_(True) for p, t in paths.iter_leaves(params)}
    loss = loss_fn(paths.rebuild(params, live), *args)
    grads = torch.autograd.grad(loss, list(live.values()))
    return loss.detach(), paths.rebuild(params, dict(zip(live, grads)))


def make_train_step(model: Model, tcfg: TrainConfig,
                    constraint_table: Optional[Dict[str, admm_mod.LayerConstraint]] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the train step (gradient accumulation over ``microbatches``).

    With ADMM on and no ``constraint_table`` the default constraints (at
    ``admm_rho``) of the first state's params are used.
    """
    lr_fn = opt.cosine_schedule(tcfg)
    table = constraint_table

    def loss_fn(params, batch, admm_state):
        hidden, _ = model.forward(params, batch, remat=tcfg.remat, return_hidden=True)
        loss = hidden_loss(model, params, batch, hidden)
        if admm_state is not None:
            loss = loss + admm_mod.admm_penalty(params, admm_state, table)
        return loss

    def microbatch_grads(params, batch, admm_state):
        n = tcfg.microbatches
        if n <= 1:
            return _value_and_grad(loss_fn, params, batch, admm_state)
        splits = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
        loss_sum = 0.0
        grad_sum = paths.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                      device=p.device), params)
        for i in range(n):
            loss, grads = _value_and_grad(loss_fn, params, {k: v[i] for k, v in splits.items()},
                                          admm_state)
            grad_sum = paths.tree_map(torch.add, grad_sum, grads)
            loss_sum = loss_sum + loss
        return loss_sum / n, paths.tree_map(lambda g: g / n, grad_sum)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        nonlocal table
        if state.admm is not None and table is None:
            table = admm_mod.constraint_table(
                state.params, admm_mod.default_constraints(rho=tcfg.admm_rho))
        loss, grads = microbatch_grads(state.params, batch, state.admm)
        grads, new_err = grad_compress.apply_compression(
            grads, tcfg.grad_compression, state.grad_err, state.rng)
        grads, gnorm = opt.clip_by_global_norm(grads, tcfg.grad_clip)
        params, new_opt = opt.adamw_update(state.params, grads, state.opt, tcfg, lr_fn)
        new_state = TrainState(params=params, opt=new_opt, step=state.step + 1,
                               admm=state.admm, grad_err=new_err, rng=state.rng)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr_fn(new_opt.step)}

    return step_fn


def init_train_state(model: Model, tcfg: TrainConfig, seed: Optional[int] = None,
                     constraint_fn: Optional[admm_mod.ConstraintFn] = None,
                     params: Optional[Params] = None
                     ) -> Tuple[TrainState, Optional[Dict[str, admm_mod.LayerConstraint]]]:
    """Params (``model.init(seed)`` unless given), optimizer, ADMM and
    error-feedback state on the model's device, and the ADMM constraint
    table (None without ADMM)."""
    seed = tcfg.seed if seed is None else seed
    if params is None:
        params = model.init(seed)
    admm_state, table = None, None
    if tcfg.admm_enabled:
        constraint_fn = constraint_fn or admm_mod.default_constraints(rho=tcfg.admm_rho)
        admm_state, table = admm_mod.init_admm(params, constraint_fn)
    grad_err = (grad_compress.init_error_state(params)
                if tcfg.grad_compression.endswith("_ef") else None)
    rng = torch.Generator(device=model.device)
    rng.manual_seed(seed + 1)
    state = TrainState(params=params, opt=opt.adamw_init(params, tcfg.moment_dtype),
                       step=torch.zeros((), dtype=torch.int32, device=model.device),
                       admm=admm_state, grad_err=grad_err, rng=rng)
    return state, table


def maybe_admm_update(state: TrainState, table, tcfg: TrainConfig,
                      host_step: int) -> TrainState:
    """ADMM Z/U update every ``admm_update_every`` steps (``host_step`` is the
    number of steps taken).  Signs are re-elected every
    ``admm_sign_refresh_every`` Z-updates (the paper's every-M-epochs sign
    re-election), and on the first Z-update, which has none yet."""
    if state.admm is None or host_step == 0:
        return state
    if host_step % tcfg.admm_update_every != 0:
        return state
    z_updates = host_step // tcfg.admm_update_every
    refresh = z_updates % max(tcfg.admm_sign_refresh_every, 1) == 0
    new_admm = admm_mod.admm_update(state.params, state.admm, table, refresh_signs=refresh)
    return dataclasses.replace(state, admm=new_admm)


def restore_template(state: TrainState, table, tcfg: TrainConfig, step: int) -> TrainState:
    """``state`` (a fresh :func:`init_train_state`) shaped as a checkpoint
    taken after ``step`` steps: once a Z-update has run, every ADMM layer
    holds its signs, masks and scale, so the template gets placeholders
    for them (:func:`~repro_torch.core.admm.with_structure`)."""
    if state.admm is None or step < tcfg.admm_update_every:
        return state
    return dataclasses.replace(state, admm=admm_mod.with_structure(state.admm, table))
