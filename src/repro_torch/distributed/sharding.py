"""Logical-axis sharding rules -> specs, with the reference's fallback.

The JAX package's ``distributed/sharding.py``, held to it spec for spec on
the CPU.  A spec is a tuple with one entry per leading dim (None, an axis
name or a tuple of names; trailing Nones dropped), the counterpart of a
``PartitionSpec``; a :class:`Sharding` pairs it with its context, as a
``NamedSharding`` pairs a spec with its mesh.

* Parameter specs come from :func:`param_spec`'s path+shape rules; every
  rule is divisibility-checked against the mesh, and a dim that does not
  divide replicates (qwen2's 12 heads on a 16-way model axis).
* FORMS leaves co-shard their (mags, signs, scale) planes along N, shard K
  only at whole fragments, and never shard the scale's row axis
  (:func:`forms_param_spec`).
* Cache specs come from :func:`cache_logical_axes`: slots (or pages) over
  the data axes, heads over the model axis, or the sequence when the KV
  heads do not divide it (context-parallel decode).

* Train-state specs (:func:`train_state_shardings`): the AdamW moments,
  error-feedback buffer and ADMM Z/U follow their param's spec, the int8
  moments' row scales and the ADMM signs, masks and scales their param's
  along the dims they share (``core.admm.state_specs``); the step and the
  generator are replicated.

The port runs the mesh as explicit SPMD (``distributed/context.py``):
:func:`reshard_state` cuts every rank's local piece by its coordinates and
marks it with its layout, and :func:`whole_leaf` puts a leaf's pieces back
together (the checkpoint writer's view; :func:`gather_global` a tree's).
The reference's ``constrain`` annotates GSPMD layouts of activations;
explicit SPMD decides the layout of an activation where its collective is
made (``models/layers.py``), and ``grad_boundary``'s bf16 cotangent is
``layers.model_entry``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.core.paths import path_str
from repro_torch.distributed.context import (LeafShard, ParallelContext,  # noqa: F401
                                             current_context, local_slice, padded_spec,
                                             parallel_context, set_shard)
from repro_torch.forms.linear import FormsLinearParams

PyTree = Any
Spec = Tuple[Any, ...]


class Sharding:
    """A spec on a context: the port's ``NamedSharding``."""

    __slots__ = ("ctx", "spec")

    def __init__(self, ctx: ParallelContext, spec: Sequence[Any]):
        self.ctx = ctx
        self.spec: Spec = tuple(spec)

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, Sharding) and self.spec == other.spec
                and self.ctx.shape == other.ctx.shape)

    def __hash__(self) -> int:
        return hash(self.spec)

    def __repr__(self) -> str:
        return f"Sharding({self.spec}, mesh={self.ctx.shape})"


def _trim(entries: Sequence[Any]) -> Spec:
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _checked_spec(logical: Sequence[Optional[str]], shape: Sequence[int],
                  ctx: ParallelContext) -> Spec:
    entries = []
    for dim, name in zip(shape, logical):
        if name is None:
            entries.append(None)
            continue
        size = ctx.axis_size(name)
        if size <= 1 or dim % size != 0:
            entries.append(None)   # fallback: replicate this dim
        else:
            entries.append(ctx.resolve(name))
    return _trim(entries)


# ---------------------------------------------------------------------------
# Parameter sharding rules (the reference's table, verbatim)
# ---------------------------------------------------------------------------

# (path regex, logical spec per trailing dim). Scanned block params carry a
# leading L axis handled by rank-padding below. Longest match wins.
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings / heads: shard the vocab dim
    (r"(^|/)embed$", ("model", None)),
    (r"(^|/)head$", (None, "model")),
    (r"(^|/)pos_embed$", (None, None)),
    # attention projections
    (r"attn/wq(/q|/s)?$", (None, "model")),
    (r"attn/wk(/q|/s)?$", (None, "model")),
    (r"attn/wv(/q|/s)?$", (None, "model")),
    (r"attn/wo(/q|/s)?$", ("model", None)),
    (r"attn/b[qkv]$", ("model",)),
    # MLA projections
    (r"mla/q_down$", (None, None)),
    (r"mla/q_up$", (None, "model")),
    (r"mla/kv_down$", (None, None)),
    (r"mla/kv_up$", (None, "model")),
    (r"mla/wo$", ("model", None)),
    # MLP
    (r"mlp/gate(/q|/s)?$", (None, "model")),
    (r"mlp/up(/q|/s)?$", (None, "model")),
    (r"mlp/down(/q|/s)?$", ("model", None)),
    # MoE: experts over the model axis
    (r"moe/router$", (None, None)),
    (r"moe/w_gate$", ("model", None, None)),
    (r"moe/w_up$", ("model", None, None)),
    (r"moe/w_down$", ("model", None, None)),
    (r"moe/shared_gate$", (None, "model")),
    (r"moe/shared_up$", (None, "model")),
    (r"moe/shared_down$", ("model", None)),
    # SSM (mamba2) projections: shard the inner dim
    (r"ssm/in_proj$", (None, "model")),
    (r"ssm/out_proj$", ("model", None)),
    (r"ssm/(conv_w|conv_b|a_log|dt_bias|d_skip|norm)$", None),
    # xLSTM projections
    (r"(mlstm|slstm)/w(q|k|v|i|f|o|z)$", (None, "model")),
    (r"(mlstm|slstm)/wout$", ("model", None)),
    (r"(mlstm|slstm)/(b.|norm.*)$", None),
    # norms, biases, scalars: replicate
    (r"(norm|bias|b_gate|scale)", None),
)


def param_spec(path: str, shape: Tuple[int, ...], scanned: bool = False) -> Spec:
    """Logical spec of a parameter by naming convention (replicate default)."""
    logical: Optional[Tuple[Optional[str], ...]] = None
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            logical = spec
            break
    rank = len(shape)
    offset = 1 if scanned else 0
    entries: list = [None] * rank
    if logical is not None:
        # align logical spec to the trailing dims (skips scan/L axes)
        for i, name in enumerate(reversed(logical)):
            pos = rank - 1 - i
            if pos >= offset and name is not None:
                entries[pos] = name
    return _trim(entries)


FSDP_THRESHOLD = 1 << 22   # leaves above 4M elements get FSDP sharding

# tree prefixes whose params carry a leading scan (layer) axis
SCANNED_PREFIXES: Tuple[str, ...] = ("blocks", "enc_blocks", "dec_blocks",
                                     "groups")


def _batch_entry(ctx: ParallelContext) -> Any:
    axes = ctx.batch_axes
    return axes if len(axes) > 1 else axes[0]


def _fsdp_extend(entries: list, shape: Sequence[int], ctx: ParallelContext,
                 threshold: Optional[int] = None) -> list:
    """Additionally shard one unsharded dim over the data axes (ZeRO-3/FSDP):
    leaves above ``threshold`` elements (default: ``FSDP_THRESHOLD`` as it
    is at the call), on their largest unsharded dim that divides."""
    threshold = FSDP_THRESHOLD if threshold is None else threshold
    n_elems = 1
    for d in shape:
        n_elems *= int(d)
    if n_elems < threshold:
        return entries
    size = ctx.axis_size("batch")
    if size <= 1:
        return entries
    # pick the largest unsharded, divisible dim
    best, best_dim = -1, -1
    for i, (d, e) in enumerate(zip(shape, entries)):
        if e is None and d % size == 0 and d > best:
            best, best_dim = d, i
    if best_dim >= 0:
        entries = list(entries)
        entries[best_dim] = _batch_entry(ctx)
    return entries


def _is_forms_leaf(x) -> bool:
    return isinstance(x, FormsLinearParams)


def _dense_entries(pstr: str, shape: Tuple[int, ...], ctx: ParallelContext,
                   scanned: bool, fsdp: bool) -> list:
    spec = param_spec(pstr, shape, scanned=scanned)
    logical = spec + (None,) * (len(shape) - len(spec))
    entries = []
    for dim, name in zip(shape, logical):
        if name is None:
            entries.append(None)
        else:
            size = ctx.axis_size(name)
            entries.append(ctx.resolve(name) if size > 1 and dim % size == 0 else None)
    if fsdp:
        entries = _fsdp_extend(entries, shape, ctx)
    return entries


def forms_param_spec(pstr: str, leaf: FormsLinearParams, ctx: ParallelContext,
                     scanned: bool = False, fsdp: bool = True,
                     threshold: Optional[int] = None) -> Tuple[Spec, Spec, Spec]:
    """(mags, signs, scale) specs of one compressed leaf, co-sharded:

    * the N (output-column) entry is the same on all three planes;
    * the sign plane ``(Kp/m, N)`` shards its fragment axis iff the
      magnitude K axis shards, which needs ``Kp % (axis_size * m) == 0``
      (every device holds whole fragments); anything else, the FSDP
      extension included, replicates K;
    * the scale ``(..., 1, N)`` never shards its row axis.

    Leading (scan / expert) axes follow the dense rules, shared by the
    three planes; every rule reads the leaf's own ``m`` and shapes, so a
    mixed-precision tree shards leaf by leaf.
    """
    shape = tuple(leaf.mags.shape)
    spec = param_spec(pstr, shape, scanned=scanned)
    logical = spec + (None,) * (len(shape) - len(spec))
    lead = []
    for dim, name in zip(shape[:-2], logical[:-2]):
        size = ctx.axis_size(name) if name is not None else 1
        lead.append(ctx.resolve(name)
                    if name is not None and size > 1 and dim % size == 0 else None)
    (kp, n), (k_name, n_name) = shape[-2:], logical[-2:]
    k_entry = None
    if k_name is not None:
        size = ctx.axis_size(k_name)
        if size > 1 and kp % (size * leaf.m) == 0:
            k_entry = ctx.resolve(k_name)
    n_entry = None
    if n_name is not None:
        size = ctx.axis_size(n_name)
        if size > 1 and n % size == 0:
            n_entry = ctx.resolve(n_name)
    threshold = FSDP_THRESHOLD if threshold is None else threshold
    if fsdp and leaf.mags.numel() >= threshold:
        fsize = ctx.axis_size("batch")
        if fsize > 1:
            entry = _batch_entry(ctx)
            # K preferred (usually the larger unsharded dim); same
            # m-granularity rule as the model-axis path
            if k_entry is None and kp % (fsize * leaf.m) == 0:
                k_entry = entry
            elif n_entry is None and n % fsize == 0:
                n_entry = entry
    # one entry per dim, as the reference's P(*lead, k, n) (not trimmed)
    mags = (*lead, k_entry, n_entry)
    signs = (*lead, k_entry, n_entry)
    scale = (*lead, None, n_entry)
    return mags, signs, scale


def forms_leaf_shardings(pstr: str, leaf: FormsLinearParams, ctx: ParallelContext,
                         scanned: bool = False, fsdp: bool = True) -> FormsLinearParams:
    """The co-sharded :class:`Sharding` trio of one compressed leaf, packed
    as a ``FormsLinearParams`` whose plane fields hold shardings (it zips
    with the data leaf in :func:`reshard_state`)."""
    mags, signs, scale = forms_param_spec(pstr, leaf, ctx, scanned=scanned, fsdp=fsdp)
    return dataclasses.replace(leaf, mags=Sharding(ctx, mags), signs=Sharding(ctx, signs),
                               scale=Sharding(ctx, scale), shard=None)


def _walk(tree: Any, fn, prefix: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over a params tree (nested dicts and lists), with
    a FORMS leaf taken whole; dicts keep their key order."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, prefix + (i,)) for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(path_str(prefix), tree)


def _scanned(pstr: str, scanned_prefixes: Tuple[str, ...] = SCANNED_PREFIXES) -> bool:
    return any(seg in pstr.split("/") for seg in scanned_prefixes)


def params_shardings(params: PyTree, ctx: ParallelContext,
                     scanned_prefixes: Tuple[str, ...] = SCANNED_PREFIXES,
                     fsdp: bool = True, prefix: Tuple = ()) -> PyTree:
    """:class:`Sharding` tree of a parameter tree (divisibility-checked):
    model-axis specs from the naming rules, leaves of ``FSDP_THRESHOLD``
    elements or more also over the data axes with ``fsdp=True``
    (:func:`_fsdp_extend`), and the co-sharded trio of
    :func:`forms_param_spec` for every compressed leaf.  ``prefix`` is the
    path of ``params`` in its whole tree (a subtree's own rules)."""
    def one(pstr: str, leaf: Any) -> Any:
        scanned = _scanned(pstr, scanned_prefixes)
        if _is_forms_leaf(leaf):
            return forms_leaf_shardings(pstr, leaf, ctx, scanned=scanned, fsdp=fsdp)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        entries = _dense_entries(pstr, tuple(leaf.shape), ctx, scanned, fsdp)
        return Sharding(ctx, _trim(entries))
    return _walk(params, one, prefix)


def train_state_shardings(state: Any, ctx: ParallelContext, table: Any = None,
                          fsdp: bool = True) -> Any:
    """The :class:`Sharding` tree of a ``training.train_loop.TrainState``
    (whole leaves, e.g. a fresh ``init_train_state``), in its own types:
    the params' from :func:`params_shardings`; the moments and the
    error-feedback buffer as their params; the int8 moments' row scales
    ``(.., 1)`` as their params but the last dim; the ADMM variables from
    ``core.admm.state_specs`` (``table``: the constraint table); the step
    and the generator replicated (None)."""
    from repro_torch.core import admm as admm_mod
    from repro_torch.core.paths import iter_leaves, map_with_path
    psh = params_shardings(state.params, ctx, fsdp=fsdp)
    spec_of = {path: sh.spec for path, sh in iter_leaves(psh)}
    shape_of = {path: tuple(p.shape) for path, p in iter_leaves(state.params)}

    def like(tree, last_whole=False):
        def one(path, leaf):
            if leaf is None:
                return None
            spec = padded_spec(spec_of[path], len(shape_of[path]))
            if last_whole and spec:
                spec = spec[:-1] + (None,)
            return Sharding(ctx, _trim(spec))
        return None if tree is None else map_with_path(one, tree)

    o = state.opt
    opt = dataclasses.replace(o, step=None, mu=like(o.mu), nu=like(o.nu),
                              mu_scale=like(o.mu_scale, True), nu_scale=like(o.nu_scale, True))
    admm = None
    if state.admm is not None:
        if table is None:
            raise ValueError("the ADMM state's shardings need its constraint table")
        admm = {}
        for path, st in state.admm.items():
            shape = shape_of[path]
            sh = LeafShard(padded_spec(spec_of[path], len(shape)), shape)
            specs = admm_mod.state_specs(sh, table[path], ctx)
            admm[path] = dataclasses.replace(st, **{
                f: (None if getattr(st, f) is None or specs[f] is None
                    else Sharding(ctx, _trim(specs[f]))) for f in specs})
    return dataclasses.replace(state, params=psh, opt=opt, step=None, admm=admm,
                               grad_err=like(state.grad_err), rng=None)


def place_train_state(state: Any, ctx: ParallelContext, table: Any = None,
                      fsdp: bool = True) -> Any:
    """Each rank's pieces of a whole train state (the same on every rank,
    e.g. ``init_train_state`` from one seed) under
    :func:`train_state_shardings`."""
    return reshard_state(state, train_state_shardings(state, ctx, table, fsdp=fsdp))


# ---------------------------------------------------------------------------
# Serving cache sharding
# ---------------------------------------------------------------------------

def cache_logical_axes(pstr: str, shape: Tuple[int, ...],
                       ctx: ParallelContext) -> Tuple[Optional[str], ...]:
    """Logical axes of one decode-cache leaf (the reference's rules).

    Slot (batch) dims ride the data axes, head dims the model axis; GQA
    caches whose KV heads do not divide the model axis shard the SEQUENCE
    dim over it instead (context-parallel decode).  Page-pool leaves
    (``pool/...``) shard their page dim over the data axes and their head
    dims over the model axis; the page-row dim never shards, and a head
    grid that does not divide replicates.  Every entry is still
    divisibility-checked by the caller.
    """
    last = pstr.split("/")[-1]
    if "pool/" in pstr:
        if len(shape) == 5:     # (L, P, page, KV, hd)
            if shape[3] % max(ctx.axis_size("model"), 1) != 0:
                return (None, "batch", None, None, None)
            return (None, "batch", None, "model", None)
        if len(shape) == 4:     # (L, P, page, r) MLA latents
            tail = "model" if "c_kv" in pstr else None
            return (None, "batch", None, tail)
        return (None, "batch") + (None,) * (len(shape) - 2)
    if "enc_out" in pstr:                       # whisper (B, S, d)
        return ("batch", None, "model")
    if last.startswith("layer") or ("layer" in pstr and len(shape) <= 4):
        # xlstm recurrent states: leading dim is batch
        return ("batch",) + (None,) * (len(shape) - 1)
    if len(shape) == 5:     # (L, B, S, KV, hd) or (L, B, H, state, hd)
        if "ssm" in pstr:
            return (None, "batch", "model", None, None)
        if shape[3] % max(ctx.axis_size("model"), 1) != 0:
            # context-parallel fallback (see docstring)
            return (None, "batch", "model", None, None)
        return (None, "batch", None, "model", None)
    if len(shape) == 4:     # (L,B,S,r) MLA latents / (L,B,K-1,d_in) conv
        tail = "model" if ("conv" in pstr or "c_kv" in pstr) else None
        return (None, "batch", None, tail)
    if len(shape) == 3:
        return (None, "batch", None)
    if len(shape) == 2:
        return ("batch", None)
    return tuple(None for _ in shape)


def cache_tree(cache: Any) -> Any:
    """A cache as the nested tree its paths name: a paged cache's pools
    under ``pool/``, its slot-addressed leaves under ``dense/``; a dense
    cache as it is (an sLSTM state's tuple as a list)."""
    from repro_torch.serving.kv_cache import PagedKVCache
    if isinstance(cache, PagedKVCache):
        return {"dense": dict(cache.dense), "pool": dict(cache.pool)}
    if isinstance(cache, dict):
        return {k: cache_tree(v) for k, v in cache.items()}
    if isinstance(cache, (tuple, list)):
        return [cache_tree(v) for v in cache]
    return cache


def _like_cache(cache: Any, tree: Any) -> Any:
    """``tree`` (walked from :func:`cache_tree`) in ``cache``'s own types."""
    from repro_torch.serving.kv_cache import PagedKVCache
    if isinstance(cache, PagedKVCache):
        return dataclasses.replace(cache, pool=dict(tree["pool"]), dense=dict(tree["dense"]))
    if isinstance(cache, dict):
        return {k: _like_cache(v, tree[k]) for k, v in cache.items()}
    if isinstance(cache, (tuple, list)):
        return type(cache)(_like_cache(v, t) for v, t in zip(cache, tree))
    return tree


def cache_shardings(cache: Any, ctx: ParallelContext) -> Any:
    """:class:`Sharding` per cache leaf (:func:`cache_logical_axes`,
    divisibility-checked), in the cache's own structure."""
    def one(pstr: str, leaf: Any) -> Any:
        if not isinstance(leaf, torch.Tensor):
            return leaf
        logical = cache_logical_axes(pstr, tuple(leaf.shape), ctx)
        return Sharding(ctx, _checked_spec(logical, tuple(leaf.shape), ctx))
    return _like_cache(cache, _walk(cache_tree(cache), one))


def batch_sharding(ctx: ParallelContext, rank: int = 2,
                   extra: Tuple[Optional[str], ...] = ()) -> Sharding:
    """Sharding of (batch, ...) arrays: batch over ('pod', 'data')."""
    spec = [ctx.resolve("batch")] + [None] * (rank - 1)
    for i, name in enumerate(extra):
        spec[1 + i] = ctx.resolve(name)
    return Sharding(ctx, spec)


def replicated(ctx: ParallelContext) -> Sharding:
    return Sharding(ctx, ())


# ---------------------------------------------------------------------------
# placing trees
# ---------------------------------------------------------------------------

def local_shard(t: torch.Tensor, spec: Sequence[Any], ctx: ParallelContext) -> torch.Tensor:
    """This rank's piece of ``t`` under ``spec``, as its own tensor, marked
    with its layout when any dim is split (a replicated leaf is ``t``
    itself: no copy)."""
    spec = tuple(spec)
    if all(e is None for e in spec):
        return t
    piece = local_slice(t, spec, ctx).clone()
    return set_shard(piece, LeafShard(spec + (None,) * (t.ndim - len(spec)), tuple(t.shape)))


def _place(leaf: Any, sh: Any) -> Any:
    if isinstance(sh, Sharding):
        return local_shard(leaf, sh.spec, sh.ctx)
    if isinstance(sh, FormsLinearParams):
        planes = [(leaf.mags, sh.mags), (leaf.signs, sh.signs), (leaf.scale, sh.scale)]
        shard = tuple(LeafShard(s.spec + (None,) * (t.ndim - len(s.spec)), tuple(t.shape))
                      for t, s in planes)
        # a compressed leaf is marked even where it is whole on every rank
        # (the reference commits it to the mesh all the same)
        local = [t if all(e is None for e in s.spec) else local_slice(t, s.spec, s.ctx).clone()
                 for t, s in planes]
        return dataclasses.replace(leaf, mags=local[0], signs=local[1], scale=local[2],
                                   shard=shard)
    return leaf


def _zip(tree: Any, shardings: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zip(v, None if shardings is None else shardings[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        sh = [None] * len(tree) if shardings is None else shardings
        return type(tree)(_zip(v, s) for v, s in zip(tree, sh))
    if tree is None:
        return None
    if _is_state_node(tree):
        return dataclasses.replace(tree, **{
            f.name: _zip(getattr(tree, f.name),
                         None if shardings is None else getattr(shardings, f.name))
            for f in dataclasses.fields(tree)})
    return _place(tree, shardings)


def _is_state_node(tree: Any) -> bool:
    """A dataclass of a train state (TrainState, AdamWState, an ADMM
    layer's state), walked field by field; a FORMS leaf is placed whole."""
    return (dataclasses.is_dataclass(tree) and not isinstance(tree, type)
            and not isinstance(tree, FormsLinearParams))


def reshard_state(state: PyTree, shardings: PyTree) -> PyTree:
    """Every leaf of ``state`` cut to this rank's piece under its sharding
    (a paged cache's pools included).  The input must hold whole (global)
    leaves: each rank reads the same global tree and keeps its own part."""
    from repro_torch.serving.kv_cache import PagedKVCache
    if isinstance(state, PagedKVCache):
        return dataclasses.replace(state, pool=_zip(state.pool, shardings.pool),
                                   dense=_zip(state.dense, shardings.dense))
    return _zip(state, shardings)


def place_leaf(path: Tuple, leaf: Any, ctx: ParallelContext) -> Any:
    """This rank's piece of the whole serving ``leaf`` at ``path`` of a
    params tree (a FORMS leaf, a tensor, or a subtree such as an int-grid
    ``{"q", "s"}`` leaf), cut as ``params_shardings(tree, ctx, fsdp=False)``
    would cut it."""
    return reshard_state(leaf, params_shardings(leaf, ctx, fsdp=False, prefix=tuple(path)))


def sharded_leaf_count(shardings: PyTree) -> int:
    """How many param leaves (a FORMS leaf counted once per plane) have any
    sharded dim: the count the serve launcher's mesh line prints."""
    n = 0

    def visit(t: Any) -> None:
        nonlocal n
        if isinstance(t, dict):
            for v in t.values():
                visit(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                visit(v)
        elif isinstance(t, FormsLinearParams):
            for s in (t.mags, t.signs, t.scale):
                visit(s)
        elif isinstance(t, Sharding) and any(e is not None for e in t.spec):
            n += 1
    visit(shardings)
    return n


def is_placed(params: PyTree) -> bool:
    """Whether a params tree holds local pieces already (a sharded restore,
    or :func:`reshard_state`'s output)."""
    found = False

    def one(pstr: str, leaf: Any) -> Any:
        nonlocal found
        found = found or getattr(leaf, "shard", None) is not None
        return leaf
    _walk(params, one)
    return found


def placed_shardings(params: PyTree, ctx: ParallelContext) -> PyTree:
    """The :class:`Sharding` tree a placed params tree was cut with, read
    off the layouts its leaves carry (whole leaves: replicated)."""
    def one(pstr: str, leaf: Any) -> Any:
        sh = getattr(leaf, "shard", None)
        if isinstance(leaf, FormsLinearParams):
            trio = sh if sh is not None else (None, None, None)
            specs = [Sharding(ctx, _trim(s.spec) if s is not None else ()) for s in trio]
            return dataclasses.replace(leaf, mags=specs[0], signs=specs[1], scale=specs[2],
                                       shard=None)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return Sharding(ctx, _trim(sh.spec) if sh is not None else ())
    return _walk(params, one)


def whole_leaf(t: Any, ctx: ParallelContext) -> Any:
    """The global tensor of a leaf that carries a layout, on its device
    (every split dim gathered; every rank takes part and gets it whole); a
    FORMS leaf whole and unmarked, each of its planes gathered over the
    axes that split it; a leaf without a layout (or without a context) as
    it is."""
    from repro_torch.core.admm import _whole
    sh = getattr(t, "shard", None)
    if sh is None or ctx is None:
        return t
    with torch.no_grad():
        if isinstance(t, FormsLinearParams):
            mags, signs, scale = (_whole(p, s.spec, ctx)
                                  for p, s in zip((t.mags, t.signs, t.scale), sh))
            return dataclasses.replace(t, mags=mags, signs=signs, scale=scale, shard=None)
        return _whole(t, sh.spec, ctx)


def gather_global(tree: PyTree, device: Any = "cpu",
                  ctx: Optional[ParallelContext] = None) -> PyTree:
    """The whole tree of a placed state, copied to ``device`` (host memory
    by default): every tensor leaf through :func:`whole_leaf`, any other
    leaf (a generator) as it is."""
    ctx = ctx if ctx is not None else current_context()

    def one(t: Any) -> Any:
        if not isinstance(t, torch.Tensor):
            return t
        return whole_leaf(t, ctx).detach().to(device, copy=True)

    def walk(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if t is None:
            return None
        if _is_state_node(t):
            return dataclasses.replace(t, **{f.name: walk(getattr(t, f.name))
                                             for f in dataclasses.fields(t)})
        return one(t)
    return walk(tree)
