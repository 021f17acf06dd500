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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import fragments as fragmod
from repro_torch.core import paths
from repro_torch.core import polarization as polmod
from repro_torch.core import pruning as prunemod
from repro_torch.core import quantization as quantmod
from repro_torch.core.fragments import FragmentSpec
from repro_torch.core.pruning import PruneSpec
from repro_torch.core.quantization import QuantSpec

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


def _project_fresh(mat: torch.Tensor, c: LayerConstraint):
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
        scale = quantmod.scale_for(out, c.quantize)
        out = quantmod.project_quantize(out, c.quantize, scale)
    return out, signs, row_mask, col_mask, scale


def _project_frozen(mat: torch.Tensor, signs, row_mask, col_mask, c: LayerConstraint):
    """Projection with frozen structure; (K, N) or (L, K, N)."""
    out = mat
    if c.prune is not None:
        out = prunemod.apply_masks(out, row_mask, col_mask)
    if c.polarize is not None:
        out, _ = polmod.project_polarize(out, c.polarize.m, rule="frozen", signs=signs)
    scale = torch.ones(tuple(mat.shape[:-2]) + (1, mat.shape[-1]), dtype=torch.float32,
                       device=mat.device)
    if c.quantize is not None:
        scale = quantmod.scale_for(out, c.quantize)
        out = quantmod.project_quantize(out, c.quantize, scale)
    return out, scale


def project_layer(mat: torch.Tensor, c: LayerConstraint, st: AdmmLayerState,
                  refresh_signs: bool = True) -> Tuple[torch.Tensor, AdmmLayerState]:
    """Sequential projection prune -> polarize -> quantize of ``mat`` (K, N)
    or a stack (L, K, N) (fragments never cross layers)."""
    if refresh_signs or st.signs is None:
        out, signs, row_mask, col_mask, scale = _project_fresh(mat, c)
    else:
        out, scale = _project_frozen(mat, st.signs, st.row_mask, st.col_mask, c)
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


def admm_penalty(params: Params, state: Dict[str, AdmmLayerState],
                 table: Dict[str, LayerConstraint]) -> torch.Tensor:
    """sum_i rho_i/2 ||W_i - Z_i + U_i||^2 — added to the task loss (Eq. 4)."""
    by_path = dict(iter_weights(params))
    total = 0.0
    for path, st in state.items():
        diff = by_path[path].float() - st.z.float() + st.u.float()
        total = total + 0.5 * table[path].rho * torch.sum(torch.square(diff))
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
        zmat, st = project_layer(_as_matrix(w + st.u, c), c, st, refresh_signs=refresh_signs)
        z = _from_matrix(zmat, w.shape, c)
        u = st.u + w - z
        new_state[path] = dataclasses.replace(st, z=z, u=u)
    return new_state


@torch.no_grad()
def project_hard(params: Params, state: Dict[str, AdmmLayerState],
                 table: Dict[str, LayerConstraint]) -> Params:
    """Final hard projection of W onto the constraint sets (end of training);
    returns a new tree."""
    projected = dict(iter_weights(params))
    for path, st in state.items():
        c = table[path]
        w = projected[path]
        zmat, _ = project_layer(_as_matrix(w, c), c, st,
                                refresh_signs=st.signs is None)
        projected[path] = _from_matrix(zmat, w.shape, c)
    return paths.rebuild(params, projected)


@torch.no_grad()
def constraint_metrics(params: Params, state: Dict[str, AdmmLayerState],
                       table: Dict[str, LayerConstraint]) -> Dict[str, torch.Tensor]:
    """Aggregate feasibility metrics (for logging / tests), as device scalars
    that are not read back here."""
    by_path = dict(iter_weights(params))
    viol = dist = spars = 0.0
    for path, st in state.items():
        c = table[path]
        w = by_path[path].float()
        mat = _as_matrix(w, c)
        if c.polarize is not None:   # a stack: the mean of its layers' fractions
            viol = viol + polmod.polarization_violation(mat, c.polarize.m).mean()
        dist = dist + (torch.linalg.vector_norm(w - st.z)
                       / torch.clamp(torch.linalg.vector_norm(w), min=1e-12))
        spars = spars + prunemod.sparsity(mat)
    n = max(len(state), 1)
    return {"polarization_violation": torch.as_tensor(viol) / n,
            "wz_distance": torch.as_tensor(dist) / n,
            "sparsity": torch.as_tensor(spars) / n}
