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

The step runs on a device mesh (``make_train_step(..., ctx=)``: explicit
SPMD, one process per device, the state placed with
``distributed.sharding.place_train_state``; without ``ctx`` a world of
one, where every collective is a no-op): every rank takes its rows of the
global batch and holds its shards.  The forward gathers each FSDP leaf
in its block and makes the model-axis collectives (``models/layers``);
the loss is the global mean (``chunked_ce`` reduces the vocab-split
log-sum-exp over ``model`` and the token sums over the batch axes); the
gradients of replicated leaves are summed over the batch axes (each rank's
loss carries its share of the global mean) and the FSDP leaves' come
reduce-scattered from their gathers; the ADMM penalty is summed once per
leaf and its gradient ``rho * (W - Z + U)`` added to each rank's shard;
then compression, clipping and AdamW run on the shards.  The metrics are
equal on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import admm as admm_mod
from repro_torch.core import paths
from repro_torch.distributed.context import (ParallelContext, checkpointed, current_context,
                                             parallel_context, set_shard, shard_of)
from repro_torch.models import layers as L
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


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0].mean()


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            aux: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Next-token cross entropy from materialized logits (small-scale path),
    plus the MoE load-balance term (``0.01 * aux["moe_aux_loss"]``) and the
    multi-token-prediction term (``0.3 *`` the CE of ``aux["mtp_logits"]``
    at position t against token t+2) when ``aux`` holds them."""
    aux = aux or {}
    s = tokens.shape[1]
    loss = _nll(logits[:, -s:, :][:, :-1, :], tokens[:, 1:])
    if "moe_aux_loss" in aux:
        loss = loss + 0.01 * aux["moe_aux_loss"]
    if "mtp_logits" in aux:
        loss = loss + 0.3 * _nll(aux["mtp_logits"][:, -s:, :][:, :-2, :], tokens[:, 2:])
    return loss


CE_CHUNK = 8192  # tokens per chunk of the memory-efficient CE


def _chunk_nll(hx: torch.Tensor, tx: torch.Tensor, mx: torch.Tensor,
               head: torch.Tensor) -> torch.Tensor:
    lg = (hx @ head).float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, tx[:, None])[:, 0]
    return torch.sum((lse - ll) * mx)


def _chunk_nll_vocab(hx: torch.Tensor, tx: torch.Tensor, mx: torch.Tensor,
                     head: torch.Tensor) -> torch.Tensor:
    """:func:`_chunk_nll` with the head's vocab columns split over
    ``model``: the log-sum-exp of the rank's logits completed over the
    model axis (the max, then the sum of exponentials), and the target
    logit taken from the rank that holds it."""
    ctx = current_context()
    hx = ctx.copy_to(hx, "model")
    lg = (hx @ head).float()
    v_loc = lg.shape[-1]
    top = ctx.all_reduce(lg.detach().amax(dim=-1), "model", "max")
    lse = top + torch.log(ctx.all_reduce(torch.exp(lg - top[:, None]).sum(dim=-1), "model"))
    t = tx - ctx.coord("model") * v_loc
    mine = (t >= 0) & (t < v_loc)
    ll = torch.gather(lg, -1, t.clamp(0, v_loc - 1)[:, None])[:, 0]
    ll = ctx.all_reduce(torch.where(mine, ll, torch.zeros_like(ll)), "model")
    return torch.sum((lse - ll) * mx)


def chunked_ce(hidden: torch.Tensor, head: torch.Tensor, tokens: torch.Tensor,
               shift: int = 1, chunk: int = CE_CHUNK) -> torch.Tensor:
    """Memory-efficient next-token CE: logits are computed per token chunk
    and recomputed in the backward pass, so the peak is chunk x vocab.
    ``shift``: targets are tokens[t + shift].  Chunk sums are added in
    order, as the reference's scan adds them.  On a mesh ``hidden`` and
    ``tokens`` are this rank's rows: a head split over ``model`` along the
    vocab takes :func:`_chunk_nll_vocab`, and the sum and the count are
    summed over the batch axes, so the loss is the global mean."""
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
    ctx = current_context()
    sh = shard_of(head)
    split = (ctx is not None and ctx.axis_size("model") > 1 and sh is not None
             and sh.on_model(-1))
    fn = _chunk_nll_vocab if split else _chunk_nll
    head = head.to(hidden.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, n + pad, c):
        args = (h[i:i + c], t[i:i + c], mask[i:i + c], head)
        if torch.is_grad_enabled():
            total = total + checkpointed(fn, *args)
        else:
            total = total + fn(*args)
    nb = ctx.axis_size("batch") if ctx is not None else 1
    if nb > 1:
        total = ctx.all_reduce(total, "batch")
    return total / max(n * nb, 1)


def hidden_loss(model: Model, params: Params, batch: Dict[str, torch.Tensor],
                hidden: torch.Tensor, aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Training loss from the final hidden states (never materializes the
    full logits), with the auxiliary terms ``forward`` returned in ``aux``:
    ``0.01 *`` the MoE load-balance loss, and ``0.3 *`` the shift-2 CE of
    the multi-token-prediction module's hidden states."""
    head = model.head_matrix(params)
    loss = chunked_ce(hidden, head, batch["tokens"], shift=1)
    if "moe_aux_loss" in aux:
        loss = loss + 0.01 * aux["moe_aux_loss"]
    if "mtp_hidden" in aux:
        loss = loss + 0.3 * chunked_ce(aux["mtp_hidden"], head, batch["tokens"], shift=2)
    return loss


def _value_and_grad(loss_fn: Callable, params: Params, *args) -> Tuple[torch.Tensor, Params]:
    """(loss, grads) of ``loss_fn(params, *args)`` with respect to every
    leaf of the params tree (leaves are taken as views, not copies, and
    keep their mesh layouts)."""
    live = {p: set_shard(t.detach().requires_grad_(True), shard_of(t))
            for p, t in paths.iter_leaves(params)}
    loss = loss_fn(paths.rebuild(params, live), *args)
    grads = torch.autograd.grad(loss, list(live.values()))
    return loss.detach(), paths.rebuild(params, dict(zip(live, grads)))


def shard_batch(batch: Dict[str, torch.Tensor], ctx: ParallelContext
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch: the ``coord("batch")``-th of
    ``axis_size("batch")`` equal blocks (model ranks share them)."""
    nb, c = ctx.axis_size("batch"), ctx.coord("batch")
    if nb == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % nb:
            raise ValueError(f"a global batch of {v.shape[0]} rows does not split over "
                             f"the {nb}-way batch axes")
        n = v.shape[0] // nb
        out[k] = v[c * n:(c + 1) * n]
    return out


def _is_fsdp(p: torch.Tensor, ctx: ParallelContext) -> bool:
    sh = shard_of(p)
    return sh is not None and bool(set(sh.axes()) & set(ctx.batch_axes))


@torch.no_grad()
def reduce_grads(params: Params, grads: Params, ctx: ParallelContext) -> Params:
    """Every rank's gradients summed over the batch axes: the FSDP leaves'
    were reduce-scattered by their gathers' backward, the others are summed
    here (one all-reduce per dtype).  The result carries the params'
    layouts."""
    flat_p = paths.leaves(params)
    flat_g = paths.leaves(grads)
    if ctx.axis_size("batch") > 1:
        buckets: Dict[torch.dtype, list] = {}
        for i, (p, g) in enumerate(zip(flat_p, flat_g)):
            if not _is_fsdp(p, ctx):
                buckets.setdefault(g.dtype, []).append(i)
        for idx in buckets.values():
            summed = ctx.all_reduce(torch.cat([flat_g[i].reshape(-1) for i in idx]), "batch")
            for i, piece in zip(idx, summed.split([flat_g[i].numel() for i in idx])):
                flat_g[i] = piece.view_as(flat_g[i])
    marked = {path: set_shard(g, shard_of(p))
              for (path, p), g in zip(paths.iter_leaves(params), flat_g)}
    return paths.rebuild(params, marked)


def make_train_step(model: Model, tcfg: TrainConfig,
                    constraint_table: Optional[Dict[str, admm_mod.LayerConstraint]] = None,
                    ctx: Optional[ParallelContext] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build the train step (gradient accumulation over ``microbatches``).

    With ADMM on and no ``constraint_table`` the default constraints (at
    ``admm_rho``) of the first state's params are used.  ``ctx`` (a
    ``ParallelContext`` over a live mesh) runs the step of the module
    docstring on that mesh, for a state placed there; without it the mesh
    is a world of one, where every collective and the batch split are
    no-ops.  The step takes the global batch, the same on every rank;
    ``step.grads(state, batch)`` gives the loss and the reduced gradients.
    """
    lr_fn = opt.cosine_schedule(tcfg)
    table = constraint_table
    ctx = ctx if ctx is not None else ParallelContext.for_shape({"data": 1, "model": 1})

    def loss_fn(params, batch):
        # on a mesh: one FSDP gather of the embedding/head for the forward and the loss
        params = L.gathered_top(params)
        hidden, aux = model.forward(params, batch, remat=tcfg.remat, return_hidden=True)
        return hidden_loss(model, params, batch, hidden, aux)

    def microbatch_grads(params, batch):
        n = tcfg.microbatches
        if n <= 1:
            return _value_and_grad(loss_fn, params, batch)
        splits = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
        loss_sum = 0.0
        grad_sum = paths.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                      device=p.device), params)
        for i in range(n):
            loss, grads = _value_and_grad(loss_fn, params, {k: v[i] for k, v in splits.items()})
            grad_sum = paths.tree_map(torch.add, grad_sum, grads)
            loss_sum = loss_sum + loss
        return loss_sum / n, paths.tree_map(lambda g: g / n, grad_sum)

    def grads_fn(state: TrainState, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Params]:
        """This rank's loss (the global one) and reduced gradient shards,
        the ADMM penalty and its gradient included."""
        loss, grads = microbatch_grads(state.params, shard_batch(batch, ctx))
        grads = reduce_grads(state.params, grads, ctx)
        if state.admm is not None:
            with torch.no_grad():
                loss = loss + admm_mod.admm_penalty(state.params, state.admm, table)
                by_path = dict(paths.iter_leaves(grads))
                for path, g in admm_mod.penalty_grads(state.params, state.admm, table):
                    by_path[path].add_(g)
        return loss, grads

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        nonlocal table
        with obs.span("rt.train.step"), parallel_context(ctx):
            if state.admm is not None and table is None:
                table = admm_mod.constraint_table(
                    state.params, admm_mod.default_constraints(rho=tcfg.admm_rho))
            loss, grads = grads_fn(state, batch)
            grads, new_err = grad_compress.apply_compression(
                grads, tcfg.grad_compression, state.grad_err, state.rng, like=state.params)
            grads, gnorm = opt.clip_by_global_norm(grads, tcfg.grad_clip, like=state.params)
            params, new_opt = opt.adamw_update(state.params, grads, state.opt, tcfg, lr_fn)
        new_state = TrainState(params=params, opt=new_opt, step=state.step + 1,
                               admm=state.admm, grad_err=new_err, rng=state.rng)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr_fn(new_opt.step)}

    step_fn.grads = lambda state, batch: _in(ctx, grads_fn, state, batch)
    return step_fn


def _in(ctx: ParallelContext, fn: Callable, *args):
    with parallel_context(ctx):
        return fn(*args)


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
                      host_step: int, ctx: Optional[ParallelContext] = None) -> TrainState:
    """ADMM Z/U update every ``admm_update_every`` steps (``host_step`` is the
    number of steps taken).  Signs are re-elected every
    ``admm_sign_refresh_every`` Z-updates (the paper's every-M-epochs sign
    re-election), and on the first Z-update, which has none yet.  On a mesh
    (``ctx``) each rank updates its shards."""
    if state.admm is None or host_step == 0:
        return state
    if host_step % tcfg.admm_update_every != 0:
        return state
    z_updates = host_step // tcfg.admm_update_every
    refresh = z_updates % max(tcfg.admm_sign_refresh_every, 1) == 0
    scope = parallel_context(ctx) if ctx is not None else contextlib.nullcontext()
    with obs.span("rt.train.z_update", z_update=z_updates), scope:
        new_admm = admm_mod.admm_update(state.params, state.admm, table,
                                        refresh_signs=refresh)
    return dataclasses.replace(state, admm=new_admm)


def restore_template(state: TrainState, table, tcfg: TrainConfig, step: int) -> TrainState:
    """``state`` (a fresh :func:`init_train_state`) shaped as a checkpoint
    taken after ``step`` steps: once a Z-update has run, every ADMM layer
    holds its signs, masks and scale, so the template gets placeholders
    for them (:func:`~repro_torch.core.admm.with_structure`)."""
    if state.admm is None or step < tcfg.admm_update_every:
        return state
    return dataclasses.replace(state, admm=admm_mod.with_structure(state.admm, table))
