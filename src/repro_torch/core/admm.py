"""ADMM-regularized optimization (paper §III-D, Fig 4).

The constrained problem

    min  L(W)   s.t.  W_i in S_i (prune), P_i (polarize), Q_i (quantize)

is split with auxiliary Z_i and dual U_i (scaled form).  Each training step
optimizes the augmented loss

    L(W) + sum_i rho_i/2 ||W_i - Z_i + U_i||_F^2            (Eq. 4)

and every ``update_every`` steps the Z/U update runs

    Z_i <- proj_{S/P/Q}(W_i + U_i)                          (Eq. 6)
    U_i <- U_i + W_i - Z_i

The constraint sets compose by sequential projection (prune -> polarize ->
quantize): the pruning masks freeze the structure, the polarization signs
refresh every ``sign_refresh_every`` Z-updates and quantization comes last.

State is keyed by the same ``"blocks/mlp/gate"`` paths as the reference.  A
scan-stacked leaf ``(L, K, N)`` is projected whole: the reference vmaps the
2-D projection over L, here every step of it takes the stack (one
polarization-kernel launch per leaf, scales and masks per layer).  The
fresh ``sum``/``energy`` polarization runs through
``kernels.ops.admm_polarize`` (the CUDA kernel on the card); the frozen one
is plain torch.

On a training mesh (an ambient ``distributed.context`` and params held in
shards that carry their layouts) every function works on each rank's own
shard.  The sign election is per (fragment, column), so where K splits at
whole fragments the projection runs on the local shard (the kernel on the
rank's piece), the per-column quantization max is max-reduced over the
ranks that split K, and the penalty's and the metrics' sums over the ranks
the leaf is split on; a leaf whose split cuts a fragment (or that prunes,
or is not a 2-D/stacked matrix) is gathered, projected whole and cut back.
The state's layouts are :func:`state_specs`'.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.core import fragments as fragmod
from repro_torch.core import paths
from repro_torch.core import polarization as polmod
from repro_torch.core import pruning as prunemod
from repro_torch.core import quantization as quantmod
from repro_torch.core.fragments import FragmentSpec
from repro_torch.core.pruning import PruneSpec
from repro_torch.core.quantization import QuantSpec
from repro_torch.distributed.context import (LeafShard, ParallelContext, current_context,
                                             local_slice, set_shard, shard_of)

Params = Any


@dataclasses.dataclass(frozen=True)
class LayerConstraint:
    """Which FORMS constraints apply to one weight tensor."""

    prune: Optional[PruneSpec] = None
    polarize: Optional[FragmentSpec] = None
    quantize: Optional[QuantSpec] = None
    rho: float = 1e-3
    sign_rule: str = "sum"  # "sum" (paper) | "energy" (exact projection)


ConstraintFn = Callable[[str, Tuple[int, ...]], Optional[LayerConstraint]]


def default_constraints(
    prune: Optional[PruneSpec] = None,
    polarize: Optional[FragmentSpec] = FragmentSpec(m=8),
    quantize: Optional[QuantSpec] = QuantSpec(bits=8),
    rho: float = 1e-3,
    sign_rule: str = "sum",
    forms: Optional[Any] = None,   # a repro_torch.forms.FormsSpec
) -> ConstraintFn:
    """Constraint policy: apply to every crossbar-mappable weight.  ``forms``
    (a FormsSpec) supplies the polarize/quantize sets and the sign rule, so
    training constrains toward the grid ``compress_tree`` projects onto."""
    if forms is not None:
        polarize = forms.fragment
        quantize = forms.quant
        sign_rule = forms.rule

    def fn(path: str, shape: Tuple[int, ...]) -> Optional[LayerConstraint]:
        if not fragmod.is_crossbar_weight(path, shape):
            return None
        return LayerConstraint(prune=prune, polarize=polarize,
                               quantize=quantize, rho=rho, sign_rule=sign_rule)

    return fn


#: (path, leaf) of every leaf of a params tree, in the reference's order
iter_weights = paths.iter_leaves


@dataclasses.dataclass
class AdmmLayerState:
    """Per-layer ADMM variables."""

    z: torch.Tensor
    u: torch.Tensor
    signs: Optional[torch.Tensor]        # (F, N) frozen fragment signs or None
    row_mask: Optional[torch.Tensor]     # frozen prune masks or None
    col_mask: Optional[torch.Tensor]
    scale: Optional[torch.Tensor]        # quant scale or None


def _as_matrix(w: torch.Tensor, c: LayerConstraint) -> torch.Tensor:
    """2-D (or scan-stacked (L, K, N)) crossbar view of a weight tensor."""
    if w.ndim == 3:
        return w
    policy = c.polarize.policy if c.polarize else "W"
    return fragmod.conv_to_matrix(w, policy)


def _from_matrix(mat: torch.Tensor, shape, c: LayerConstraint) -> torch.Tensor:
    if len(shape) == 4:
        policy = c.polarize.policy if c.polarize else "W"
        return fragmod.matrix_to_conv(mat, tuple(shape), policy)
    return mat


def constraint_table(params_like: Params, constraint_fn: ConstraintFn
                     ) -> Dict[str, LayerConstraint]:
    """Static constraint table of a params tree (any leaves with ``shape``)."""
    table: Dict[str, LayerConstraint] = {}
    for path, leaf in iter_weights(params_like):
        if not hasattr(leaf, "shape"):
            continue
        c = constraint_fn(path, tuple(leaf.shape))
        if c is not None:
            table[path] = c
    return table


def init_admm(params: Params, constraint_fn: ConstraintFn
              ) -> Tuple[Dict[str, AdmmLayerState], Dict[str, LayerConstraint]]:
    """ADMM state and static constraint table for a params tree.  Z starts as
    a copy of W (the optimizer updates W in place), U at zero."""
    table = constraint_table(params, constraint_fn)
    by_path = dict(iter_weights(params))
    state = {path: AdmmLayerState(z=by_path[path].detach().clone(),
                                  u=torch.zeros_like(by_path[path]),
                                  signs=None, row_mask=None, col_mask=None, scale=None)
             for path in table}
    return state, table


def _project_fresh(mat: torch.Tensor, c: LayerConstraint, amax_reduce=None):
    """Projection with freshly elected structure; (K, N) or (L, K, N)."""
    lead, (k, n) = tuple(mat.shape[:-2]), mat.shape[-2:]
    dev = mat.device
    out = mat
    row_mask = torch.ones(lead + (k,), dtype=torch.bool, device=dev)
    col_mask = torch.ones(lead + (n,), dtype=torch.bool, device=dev)
    if c.prune is not None:
        out, row_mask, col_mask = prunemod.project_prune(out, c.prune)
    if c.polarize is not None:
        out, signs = polmod.project_polarize(out, c.polarize.m, rule=c.sign_rule)
    else:
        signs = torch.ones(lead + (1, n), dtype=mat.dtype, device=dev)
    scale = torch.ones(lead + (1, n), dtype=torch.float32, device=dev)
    if c.quantize is not None:
        scale = quantmod.scale_for(out, c.quantize, amax_reduce)
        out = quantmod.project_quantize(out, c.quantize, scale)
    return out, signs, row_mask, col_mask, scale


def _project_frozen(mat: torch.Tensor, signs, row_mask, col_mask, c: LayerConstraint,
                    amax_reduce=None):
    """Projection with frozen structure; (K, N) or (L, K, N)."""
    out = mat
    if c.prune is not None:
        out = prunemod.apply_masks(out, row_mask, col_mask)
    if c.polarize is not None:
        out, _ = polmod.project_polarize(out, c.polarize.m, rule="frozen", signs=signs)
    scale = torch.ones(tuple(mat.shape[:-2]) + (1, mat.shape[-1]), dtype=torch.float32,
                       device=mat.device)
    if c.quantize is not None:
        scale = quantmod.scale_for(out, c.quantize, amax_reduce)
        out = quantmod.project_quantize(out, c.quantize, scale)
    return out, scale


def project_layer(mat: torch.Tensor, c: LayerConstraint, st: AdmmLayerState,
                  refresh_signs: bool = True, amax_reduce=None
                  ) -> Tuple[torch.Tensor, AdmmLayerState]:
    """Sequential projection prune -> polarize -> quantize of ``mat`` (K, N)
    or a stack (L, K, N) (fragments never cross layers); ``amax_reduce``
    completes the quantization max of a shard (``quantization.scale_for``)."""
    if refresh_signs or st.signs is None:
        out, signs, row_mask, col_mask, scale = _project_fresh(mat, c, amax_reduce)
    else:
        out, scale = _project_frozen(mat, st.signs, st.row_mask, st.col_mask, c,
                                     amax_reduce)
        signs, row_mask, col_mask = st.signs, st.row_mask, st.col_mask
    return out, dataclasses.replace(st, signs=signs, row_mask=row_mask,
                                    col_mask=col_mask, scale=scale)


def with_structure(state: Dict[str, AdmmLayerState],
                   table: Dict[str, LayerConstraint]) -> Dict[str, AdmmLayerState]:
    """``state`` with zero placeholders, of the shapes and dtypes a fresh
    projection gives, for the signs, masks and scale of every layer that
    has none yet: the structure of the state after its first Z-update, as
    a checkpoint restore template needs it (the placeholders are
    overwritten by the restore)."""
    out: Dict[str, AdmmLayerState] = {}
    for path, st in state.items():
        if st.signs is not None:
            out[path] = st
            continue
        c = table[path]
        mat = _as_matrix(st.z, c)
        lead, (k, n) = tuple(mat.shape[:-2]), mat.shape[-2:]
        f = c.polarize.num_fragments(k) if c.polarize is not None else 1
        zeros = lambda shape, dtype: torch.zeros(lead + shape, dtype=dtype,  # noqa: E731
                                                 device=mat.device)
        out[path] = dataclasses.replace(
            st, signs=zeros((f, n), mat.dtype), row_mask=zeros((k,), torch.bool),
            col_mask=zeros((n,), torch.bool), scale=zeros((1, n), torch.float32))
    return out


# ---------------------------------------------------------------------------
# shards (a training mesh)
# ---------------------------------------------------------------------------

def _placement(w: Any) -> Tuple[Optional[ParallelContext], Optional[LeafShard]]:
    """(context, layout) of a param leaf held in shards, else (None, None)."""
    ctx = current_context()
    sh = shard_of(w)
    if ctx is None or sh is None or ctx.entry_size(sh.axes()) == 1:
        return None, None
    return ctx, sh


def state_specs(sh: LeafShard, c: LayerConstraint,
                ctx: ParallelContext) -> Dict[str, Optional[Tuple[Any, ...]]]:
    """The layouts (one entry per dim) of one leaf's ADMM variables when
    the leaf's layout is ``sh``: Z and U its own; the fragment signs
    ``(.., F, N)`` split F as K where K splits at whole fragments (else F
    whole) and N as N; the masks as K and N; the scale ``(.., 1, N)`` as N
    (whole for a per-tensor scale).  A leaf that is not a 2-D or stacked
    matrix keeps all but Z and U whole (None)."""
    spec = tuple(sh.spec)
    if len(sh.shape) not in (2, 3):
        return {"z": spec, "u": spec, "signs": None, "row_mask": None, "col_mask": None,
                "scale": None}
    lead, (k_e, n_e) = spec[:-2], spec[-2:]
    f_e = k_e if c.polarize is not None and _k_aligned(sh, c, ctx) else None
    per_col = c.quantize is None or c.quantize.per_channel
    return {"z": spec, "u": spec, "signs": lead + (f_e, n_e), "row_mask": lead + (k_e,),
            "col_mask": lead + (n_e,), "scale": lead + (None, n_e if per_col else None)}


def _k_aligned(sh: LeafShard, c: LayerConstraint, ctx: ParallelContext) -> bool:
    k_e = sh.spec[-2]
    if k_e is None or c.polarize is None:
        return True
    return sh.shape[-2] % (ctx.entry_size(k_e) * c.polarize.m) == 0


def _on_shard(sh: LeafShard, c: LayerConstraint, ctx: ParallelContext) -> bool:
    """Whether the projection runs on the local shard as it is."""
    return len(sh.shape) in (2, 3) and c.prune is None and _k_aligned(sh, c, ctx)


def _whole(t: torch.Tensor, spec, ctx: ParallelContext) -> torch.Tensor:
    """The global tensor of a shard (every split dim gathered)."""
    for dim, entry in enumerate(spec):
        if entry is not None and ctx.entry_size(entry) > 1:
            names = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
            t = ctx.all_gather(t, ctx.logical_of(names), dim)
    return t


def _piece(t: Optional[torch.Tensor], spec, ctx: ParallelContext):
    if t is None or spec is None:
        return t
    return local_slice(t, spec, ctx).contiguous()


def _amax_reduce(sh: LeafShard, ctx: ParallelContext):
    kax, nax = sh.dim_axes(-2), sh.dim_axes(-1)
    return lambda amax, per_channel: ctx.reduce_over(amax, kax if per_channel else kax + nax,
                                                     "max")


def _project_shard(mat: torch.Tensor, c: LayerConstraint, st: AdmmLayerState,
                   refresh: bool, ctx: ParallelContext, sh: LeafShard
                   ) -> Tuple[torch.Tensor, AdmmLayerState]:
    """:func:`project_layer` of this rank's shard ``mat`` of a leaf laid
    out as ``sh``: on the shard where it may run there, else gathered,
    projected whole and cut back (see :func:`state_specs`)."""
    if _on_shard(sh, c, ctx):
        return project_layer(mat, c, st, refresh_signs=refresh,
                             amax_reduce=_amax_reduce(sh, ctx))
    specs = state_specs(sh, c, ctx)
    whole = _whole(mat, sh.spec, ctx)
    frozen = {f: (getattr(st, f) if getattr(st, f) is None or specs[f] is None
                  else _whole(getattr(st, f), specs[f], ctx))
              for f in ("signs", "row_mask", "col_mask")}
    wst = dataclasses.replace(st, **frozen)
    zmat, wst = project_layer(_as_matrix(whole, c), c, wst, refresh_signs=refresh)
    z = _piece(_from_matrix(zmat, sh.shape, c), sh.spec, ctx)
    cut = {f: _piece(getattr(wst, f), specs[f], ctx)
           for f in ("signs", "row_mask", "col_mask", "scale")}
    return z, dataclasses.replace(st, **cut)


def penalty_grads(params: Params, state: Dict[str, AdmmLayerState],
                  table: Dict[str, LayerConstraint]) -> Iterator[Tuple[str, torch.Tensor]]:
    """The penalty's gradient, ``rho * (W - Z + U)``, leaf by leaf as
    (path, gradient): on a mesh the train step adds each to the rank's
    reduced gradient shard as it comes (the penalty is summed once per
    leaf, so a batch reduction must not count it once per rank)."""
    by_path = dict(iter_weights(params))
    for path, st in state.items():
        # one leaf-sized temporary: the step's peak is near when this runs
        diff = torch.sub(by_path[path].float(), st.z.float())
        yield path, diff.add_(st.u.float()).mul_(table[path].rho)


def admm_penalty(params: Params, state: Dict[str, AdmmLayerState],
                 table: Dict[str, LayerConstraint]) -> torch.Tensor:
    """sum_i rho_i/2 ||W_i - Z_i + U_i||^2 — added to the task loss (Eq. 4).
    On a mesh each leaf's partial sum is summed over exactly the axes the
    leaf is split on."""
    by_path = dict(iter_weights(params))
    total = 0.0
    for path, st in state.items():
        w = by_path[path]
        diff = w.float() - st.z.float() + st.u.float()
        term = 0.5 * table[path].rho * torch.sum(torch.square(diff))
        ctx, sh = _placement(w)
        if sh is not None:
            term = ctx.reduce_over(term, sh.axes())
        total = total + term
    return torch.as_tensor(total)


@torch.no_grad()
def admm_update(params: Params, state: Dict[str, AdmmLayerState],
                table: Dict[str, LayerConstraint],
                refresh_signs: bool = True) -> Dict[str, AdmmLayerState]:
    """Z/U update (Eq. 6): Z = proj(W + U); U += W - Z."""
    by_path = dict(iter_weights(params))
    new_state: Dict[str, AdmmLayerState] = {}
    for path, st in state.items():
        c = table[path]
        w = by_path[path]
        ctx, sh = _placement(w)
        if sh is not None:
            z, st = _project_shard(w + st.u, c, st, refresh_signs, ctx, sh)
            new_state[path] = _marked(dataclasses.replace(st, z=z, u=st.u + w - z), sh, c,
                                      ctx)
            continue
        zmat, st = project_layer(_as_matrix(w + st.u, c), c, st,
                                 refresh_signs=refresh_signs)
        z = _from_matrix(zmat, w.shape, c)
        u = st.u + w - z
        new_state[path] = dataclasses.replace(st, z=z, u=u)
    return new_state


def _marked(st: AdmmLayerState, sh: LeafShard, c: LayerConstraint,
            ctx: ParallelContext) -> AdmmLayerState:
    """``st``'s shards marked with their layouts (:func:`state_specs`)."""
    specs = state_specs(sh, c, ctx)
    shape = tuple(sh.shape)
    if len(shape) in (2, 3):
        lead, (k, n) = shape[:-2], shape[-2:]
        f = c.polarize.num_fragments(k) if c.polarize is not None else 1
        scale_n = n if c.quantize is None or c.quantize.per_channel else 1
        shapes = {"z": shape, "u": shape, "signs": lead + (f, n), "row_mask": lead + (k,),
                  "col_mask": lead + (n,), "scale": lead + (1, scale_n)}
    else:
        shapes = {"z": shape, "u": shape}
    for name, shp in shapes.items():
        t = getattr(st, name)
        if t is not None and specs[name] is not None and t.ndim == len(shp):
            set_shard(t, LeafShard(tuple(specs[name]), tuple(shp)))
    return st


@torch.no_grad()
def project_hard(params: Params, state: Dict[str, AdmmLayerState],
                 table: Dict[str, LayerConstraint]) -> Params:
    """Final hard projection of W onto the constraint sets (end of training);
    returns a new tree (on a mesh: each rank's shards, marked)."""
    projected = dict(iter_weights(params))
    for path, st in state.items():
        c = table[path]
        w = projected[path]
        ctx, sh = _placement(w)
        if sh is not None:
            z, _ = _project_shard(w, c, st, st.signs is None, ctx, sh)
            projected[path] = set_shard(z, sh)
            continue
        zmat, _ = project_layer(_as_matrix(w, c), c, st,
                                refresh_signs=st.signs is None)
        projected[path] = _from_matrix(zmat, w.shape, c)
    return paths.rebuild(params, projected)


@torch.no_grad()
def constraint_metrics(params: Params, state: Dict[str, AdmmLayerState],
                       table: Dict[str, LayerConstraint]) -> Dict[str, torch.Tensor]:
    """Aggregate feasibility metrics (for logging / tests), as device scalars
    that are not read back here; on a mesh, of the whole leaves."""
    by_path = dict(iter_weights(params))
    viol = dist = spars = 0.0
    for path, st in state.items():
        c = table[path]
        w, z = by_path[path].float(), st.z
        ctx, sh = _placement(by_path[path])
        if sh is not None and not _on_shard(sh, c, ctx):
            w, z, sh = _whole(w, sh.spec, ctx), _whole(z, sh.spec, ctx), None
        mat = _as_matrix(w, c)
        if c.polarize is not None:   # a stack: the mean of its layers' fractions
            if sh is None:
                viol = viol + polmod.polarization_violation(mat, c.polarize.m).mean()
            else:
                bad, tot = polmod.violation_sums(mat, c.polarize.m)
                axes = sh.dim_axes(-2) + sh.dim_axes(-1)
                viol = viol + (ctx.reduce_over(bad, axes)
                               / torch.clamp(ctx.reduce_over(tot, axes), min=1e-12)).mean()
        if sh is None:
            dist = dist + (torch.linalg.vector_norm(w - z)
                           / torch.clamp(torch.linalg.vector_norm(w), min=1e-12))
            spars = spars + prunemod.sparsity(mat)
        else:
            num = ctx.reduce_over(torch.sum(torch.square(w - z)), sh.axes())
            den = ctx.reduce_over(torch.sum(torch.square(w)), sh.axes())
            dist = dist + torch.sqrt(num) / torch.clamp(torch.sqrt(den), min=1e-12)
            zeros = ctx.reduce_over((mat == 0).sum().float(), sh.axes())
            spars = spars + zeros / math.prod(sh.shape)
    n = max(len(state), 1)
    return {"polarization_violation": torch.as_tensor(viol) / n,
            "wz_distance": torch.as_tensor(dist) / n,
            "sparsity": torch.as_tensor(spars) / n}
