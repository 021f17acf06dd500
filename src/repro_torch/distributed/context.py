"""The mesh context of explicit SPMD: one process per device.

The reference places arrays with ``NamedSharding`` and lets GSPMD partition
its jitted steps.  The port's kernels are launched on raw pointers, which
no tensor-propagation machinery can see, so the port runs the mesh as
explicit SPMD: every process (rank) holds only its local shards, runs its
kernels on them and makes the collectives that the layouts imply, itself.

* :class:`ParallelContext` — axis sizes (``data``/``model``, and ``pod``
  on a multi-pod mesh) and the logical-axis mapping of the reference
  (``batch -> (pod, data)``, ``model -> model``, ``tokens -> both``).
  Built over a live ``DeviceMesh`` (:meth:`ParallelContext.for_mesh`), it
  also knows this rank's coordinates and process groups and makes the
  collectives; built over axis sizes alone (:meth:`ParallelContext.
  for_shape`), it computes specs without any process.
* :class:`RecordingContext` — a context over a mesh's axis sizes
  (``RecordingContext.for_config(MeshConfig(...))``) with no process
  group: its collectives return a tensor of the output's shape on the
  input's device and dtype, and add their operand bytes under the HLO
  kind (``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``all-to-all``).  The dry run traces rank 0's step through it on fake
  tensors (``launch/dryrun.py``).
* :func:`parallel_context` — the ambient context that the model layers
  read, as the reference's ``constrain`` reads its own (None: one device);
  :func:`checkpointed` keeps it for a block recomputed in the backward pass.
* :class:`LeafShard` — a leaf's layout: its spec (one entry per dim: None,
  an axis name or a tuple of names) and its global shape.  A sharded FORMS
  leaf carries the trio of its planes in ``FormsLinearParams.shard``, a
  sharded dense tensor one under the ``shard`` attribute
  (:func:`shard_of`, :func:`set_shard`).

Every collective is differentiable (a ``torch.autograd.Function`` pair), so
the same layers train on a mesh: activations are replicated over
``model``, and each collective's backward is its conjugate for that layout
(a gather's is the member's slice, a sum's the identity, ``copy_to``'s a
sum, ``split``'s a gather, an all-to-all's the reverse exchange, an FSDP
gather's a reduce-scatter).  ``torch.distributed.nn``'s all-reduce would
sum a replicated cotangent again (``tp`` times the gradient).  Nothing here
catches a collective's failure, and a world of one skips every collective
(an axis of size 1 has nothing to exchange).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Entry = Any   # None, an axis name, or a tuple of axis names
MODEL_AXIS = "model"


def _names(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class ParallelContext:
    """Mesh axis sizes + the logical-axis mapping (+ this rank's groups)."""

    def __init__(self, shape: Dict[str, int], mesh: Any = None):
        self.shape: Dict[str, int] = {a: int(n) for a, n in shape.items()}
        names = tuple(self.shape)
        self.batch_axes: Tuple[str, ...] = tuple(a for a in ("pod", "data") if a in names)
        self.model_axes: Tuple[str, ...] = tuple(a for a in ("model",) if a in names)
        self.mesh = mesh
        self._coords: Dict[str, int] = {a: 0 for a in names}
        self._groups: Dict[str, Tuple[Any, List[int]]] = {}
        if mesh is not None:
            self._coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            for logical in ("batch", "model", "tokens"):
                self._groups[logical] = self._make_group(self._axes(logical))

    @classmethod
    def for_mesh(cls, mesh: Any) -> "ParallelContext":
        """Over a live ``torch.distributed.device_mesh.DeviceMesh``; every
        rank of the mesh must call it (it makes process groups)."""
        return cls(dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)), mesh=mesh)

    @classmethod
    def for_shape(cls, shape: Dict[str, int]) -> "ParallelContext":
        """Over axis sizes alone (specs without processes), e.g.
        ``for_shape({"data": 2, "model": 4})``."""
        return cls(shape)

    # -- the reference's interface --------------------------------------

    def _axes(self, logical: str) -> Tuple[str, ...]:
        if logical == "batch":
            return self.batch_axes
        if logical == "model":
            return self.model_axes
        if logical == "tokens":   # MoE dispatch: tokens over every axis
            return self.batch_axes + self.model_axes
        raise ValueError(f"unknown logical axis {logical!r}")

    def resolve(self, logical: Optional[str]) -> Entry:
        if logical is None:
            return None
        axes = self._axes(logical)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes

    def axis_size(self, logical: str) -> int:
        size = 1
        for a in self._axes(logical):
            size *= self.shape[a]
        return size

    def entry_size(self, entry: Entry) -> int:
        size = 1
        for a in _names(entry):
            size *= self.shape[a]
        return size

    # -- this rank --------------------------------------------------------

    def entry_coord(self, entry: Entry) -> int:
        """This rank's index along a spec entry (row-major over its axes)."""
        idx = 0
        for a in _names(entry):
            idx = idx * self.shape[a] + self._coords[a]
        return idx

    def coord(self, logical: str) -> int:
        return self.entry_coord(self._axes(logical))

    def _make_group(self, axes: Tuple[str, ...]) -> Tuple[Any, List[int]]:
        """The group of ranks that differ from this one only along ``axes``
        (ranks in coordinate order).  A group over several axes is made
        with ``new_group`` by every rank, for every such group, in one
        order, as torch.distributed requires."""
        mesh = self.mesh
        me = int(torch.distributed.get_rank())
        if not axes:
            return None, [me]
        names = list(mesh.mesh_dim_names)
        others = [a for a in names if a not in axes]
        perm = [names.index(a) for a in others] + [names.index(a) for a in axes]
        grid = mesh.mesh.permute(perm).reshape(-1, self.entry_size(axes)).tolist()
        if len(axes) == 1:
            row = next(r for r in grid if me in r)
            return mesh.get_group(axes[0]), row
        mine = None
        for row in grid:
            g = torch.distributed.new_group(row)
            if me in row:
                mine = (g, row)
        return mine

    @property
    def rank(self) -> int:
        return int(torch.distributed.get_rank()) if self.mesh is not None else 0

    def _group(self, logical: str):
        if self.mesh is None:
            raise RuntimeError(
                f"a collective over {logical!r} (size {self.axis_size(logical)}) needs a "
                "context over a live mesh (ParallelContext.for_mesh), not axis sizes alone")
        return self._groups[logical][0]

    # -- collectives -------------------------------------------------------
    #
    # Each one is differentiable, with the conjugate its layout implies: the
    # port's activations are replicated over ``model`` (every member of the
    # group holds the same tensor and the same cotangent), so a gather's
    # backward is this member's slice, a sum's is the identity, and an
    # identity whose consumers are partial (a replicated activation entering
    # a weight this rank holds only some columns of) sums its cotangent.

    def all_gather(self, t: torch.Tensor, logical: str, dim: int) -> torch.Tensor:
        """Concatenate the group's tensors along ``dim``, in coordinate order.
        Backward: this member's slice of the cotangent."""
        if self.axis_size(logical) == 1:
            return t
        return _Gather.apply(t, self, logical, dim)

    def all_reduce(self, t: torch.Tensor, logical: str, op: str = "sum") -> torch.Tensor:
        """The group's sum (or max) of ``t``, as a new tensor.  Backward of
        the sum: the identity (the result is used alike on every member);
        the max carries no gradient."""
        if self.axis_size(logical) == 1:
            return t
        if op == "max":
            with torch.no_grad():
                return _reduce(t, self._group(logical), op)
        return _Sum.apply(t, self, logical)

    def copy_to(self, t: torch.Tensor, logical: str) -> torch.Tensor:
        """The identity, whose backward sums the cotangent over the group
        (Megatron's *f*), in the cotangent's own dtype."""
        if self.axis_size(logical) == 1:
            return t
        return _Copy.apply(t, self, logical)

    def split(self, t: torch.Tensor, logical: str, dim: int) -> torch.Tensor:
        """This member's equal share of ``t`` along ``dim`` (``t`` alike on
        every member).  Backward: the members' cotangents gathered."""
        if self.axis_size(logical) == 1:
            return t
        return _Split.apply(t, self, logical, dim)

    def gather_shards(self, t: torch.Tensor, logical: str, dim: int) -> torch.Tensor:
        """FSDP's gather of a parameter shard along ``dim``; backward:
        the cotangent reduce-scattered (summed) over the group."""
        if self.axis_size(logical) == 1:
            return t
        return _GatherShards.apply(t, self, logical, dim)

    def broadcast(self, t: torch.Tensor, logical: str, src_coord: int) -> torch.Tensor:
        """``t`` of the group member at coordinate ``src_coord``, on every
        member (``t`` is overwritten on the others)."""
        if self.axis_size(logical) == 1:
            return t
        t = t.contiguous()
        torch.distributed.broadcast(t, group=self._group(logical), group_src=int(src_coord))
        return t

    def all_to_all(self, t: torch.Tensor, logical: str) -> torch.Tensor:
        """Split dim 0 into one chunk per member, send chunk i to member i,
        and concatenate what arrives in coordinate order.  Backward: the
        reverse exchange (the same one) of the cotangent."""
        if self.axis_size(logical) == 1:
            return t
        return _AllToAll.apply(t, self, logical)

    def logical_of(self, axes: Sequence[str]) -> str:
        """The logical name of a set of mesh axes (a leaf's shard axes):
        ``model``, ``batch`` or ``tokens`` (all of them)."""
        got = set(axes)
        for logical in ("model", "batch", "tokens"):
            if got == set(self._axes(logical)):
                return logical
        raise ValueError(f"axes {sorted(got)} are not a group of this mesh "
                         f"({tuple(self.shape)}): model, all batch axes, or all axes")

    def reduce_over(self, t: torch.Tensor, axes: Sequence[str], op: str = "sum"
                    ) -> torch.Tensor:
        """:meth:`all_reduce` over a set of mesh axes (none: ``t`` itself)."""
        axes = tuple(axes)
        if self.entry_size(axes) == 1:
            return t
        return self.all_reduce(t, self.logical_of(axes), op)

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order (host objects, any group size)."""
        if self.mesh is None:
            return [obj]
        out: List[Any] = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(out, obj)
        return out


# the HLO names of collectives, the JAX package's analyzer's kinds
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")


class RecordingContext(ParallelContext):
    """A context over a mesh's axis sizes that records its collectives
    instead of making them (see the module docstring).  It stands for rank
    0 (every coordinate 0) and is its own process group; the autograd
    pairs are the live mesh's, so a traced train step records the
    backward's conjugate collectives too.  ``bytes_by_kind``/
    ``count_by_kind`` hold the operand bytes and calls per kind;
    :meth:`reset` zeroes them."""

    def __init__(self, shape: Dict[str, int]):
        super().__init__(shape)
        self._lock = threading.Lock()
        self.reset()

    @classmethod
    def for_config(cls, cfg: Any) -> "RecordingContext":
        """Over a ``configs.base.MeshConfig``'s axes: ``(pod, data, model)``
        on a multi-pod mesh, else ``(data, model)``, as ``launch/mesh``
        names them."""
        if cfg.pods > 1:
            return cls({"pod": cfg.pods, "data": cfg.data, "model": cfg.model})
        return cls({"data": cfg.data, "model": cfg.model})

    def reset(self) -> None:
        with self._lock:
            self.bytes_by_kind: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}
            self.count_by_kind: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}

    def record(self, kind: str, t: torch.Tensor) -> None:
        with self._lock:
            self.bytes_by_kind[kind] += t.numel() * t.element_size()
            self.count_by_kind[kind] += 1

    def _group(self, logical: str) -> "RecordingContext":
        return self


# ---------------------------------------------------------------------------
# the collectives' autograd pairs
# ---------------------------------------------------------------------------

_OPS = {"sum": "SUM", "max": "MAX"}


def _reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    out = t.contiguous().clone()
    if isinstance(group, RecordingContext):
        group.record("all-reduce", out)
    else:
        torch.distributed.all_reduce(out, op=getattr(torch.distributed.ReduceOp, _OPS[op]),
                                     group=group)
    return out


def _gather(t: torch.Tensor, pc: ParallelContext, logical: str, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(pc.axis_size(logical))]
    group = pc._group(logical)
    if isinstance(group, RecordingContext):
        group.record("all-gather", t)
    else:
        torch.distributed.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _mine(t: torch.Tensor, pc: ParallelContext, logical: str, dim: int) -> torch.Tensor:
    n = pc.axis_size(logical)
    step = t.shape[dim] // n
    return t.narrow(dim, pc.coord(logical) * step, step)


def _reduce_scatter(t: torch.Tensor, pc: ParallelContext, logical: str,
                    dim: int) -> torch.Tensor:
    src = t.movedim(dim, 0).contiguous()
    n = pc.axis_size(logical)
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    group = pc._group(logical)
    if isinstance(group, RecordingContext):
        group.record("reduce-scatter", src)
    else:
        torch.distributed.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _a2a(t: torch.Tensor, pc: ParallelContext, logical: str) -> torch.Tensor:
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    group = pc._group(logical)
    if isinstance(group, RecordingContext):
        group.record("all-to-all", t)
    else:
        torch.distributed.all_to_all_single(out, t.contiguous(), group=group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pc, logical, dim):
        ctx.args = (pc, logical, dim)
        return _gather(t, pc, logical, dim)

    @staticmethod
    def backward(ctx, g):
        return _mine(g, *ctx.args).contiguous(), None, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pc, logical):
        return _reduce(t, pc._group(logical))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pc, logical):
        ctx.args = (pc, logical)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        pc, logical = ctx.args
        return _reduce(g, pc._group(logical)), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pc, logical, dim):
        ctx.args = (pc, logical, dim)
        return _mine(t, pc, logical, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pc, logical, dim):
        ctx.args = (pc, logical, dim)
        return _gather(t, pc, logical, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, pc, logical):
        ctx.args = (pc, logical)
        return _a2a(t, pc, logical)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args), None, None


_STATE = threading.local()


def current_context() -> Optional[ParallelContext]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def parallel_context(ctx: Optional[ParallelContext]) -> Iterator[Optional[ParallelContext]]:
    """Make ``ctx`` the ambient context of the model layers (None: one device)."""
    prev = current_context()
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev


def checkpointed(fn, *args):
    """``torch.utils.checkpoint`` (non-reentrant, no RNG state) of
    ``fn(*args)`` whose recompute in the backward pass runs under the
    forward's ambient context: autograd runs a CUDA backward on its own
    device thread, where this thread-local context is not set, so a
    recomputed sharded block would otherwise take the one-device path."""
    ctx = current_context()
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), parallel_context(ctx)))


def model_ctx() -> Optional[ParallelContext]:
    """The ambient context when its model axis has more than one member."""
    ctx = current_context()
    if ctx is None or ctx.axis_size("model") <= 1:
        return None
    return ctx


# ---------------------------------------------------------------------------
# leaf layouts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafShard:
    """A sharded leaf's spec (one entry per dim) and global shape."""

    spec: Tuple[Entry, ...]
    shape: Tuple[int, ...]

    def layer(self) -> "LeafShard":
        """The layout of one slice along the leading (layer) axis."""
        return LeafShard(self.spec[1:], self.shape[1:])

    def transpose(self) -> "LeafShard":
        """The layout of the leaf's transpose over its last two dims."""
        sp, sh = list(self.spec), list(self.shape)
        sp[-2:], sh[-2:] = sp[-2:][::-1], sh[-2:][::-1]
        return LeafShard(tuple(sp), tuple(sh))

    def on_model(self, dim: int) -> bool:
        """Whether ``dim`` is split over the model axis."""
        return MODEL_AXIS in _names(self.spec[dim])

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the leaf is split over (none: replicated)."""
        return tuple(a for e in self.spec for a in _names(e))

    def dim_axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that split ``dim``."""
        return _names(self.spec[dim])

    def only_model(self) -> None:
        """Serving runs tensor-parallel weights only: a data-axis entry
        (FSDP) is refused by name."""
        for e in self.spec:
            extra = set(_names(e)) - {MODEL_AXIS}
            if extra:
                raise NotImplementedError(
                    f"a weight sharded over {sorted(extra)} (spec {self.spec}) is an FSDP "
                    "layout; serving runs weights tensor-parallel over 'model' and "
                    "replicated over the data axes (shard_tree(..., fsdp=False))")


def padded_spec(spec: Sequence[Entry], ndim: int) -> Tuple[Entry, ...]:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def shard_of(leaf: Any) -> Any:
    """The layout a leaf carries: a FORMS leaf's (mags, signs, scale) trio,
    a dense tensor's :class:`LeafShard`, or None (whole on every rank)."""
    return getattr(leaf, "shard", None)


def set_shard(t: torch.Tensor, shard: Optional[LeafShard]) -> torch.Tensor:
    """Mark a dense tensor with its layout (the tensor is returned)."""
    if shard is not None:
        t.shard = shard
    return t


def local_slice(t: torch.Tensor, spec: Sequence[Entry], ctx: ParallelContext,
                coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """This rank's piece of the global tensor ``t`` under ``spec``: along
    each sharded dim, the contiguous block at the rank's coordinate
    (``coords`` overrides the rank's own, for a context without a mesh)."""
    c = ctx._coords if coords is None else {**ctx._coords, **coords}
    out = t
    for dim, entry in enumerate(padded_spec(spec, t.ndim)):
        if entry is None:
            continue
        n = ctx.entry_size(entry)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {n} ways "
                             f"(spec {tuple(spec)})")
        idx = 0
        for a in _names(entry):
            idx = idx * ctx.shape[a] + c[a]
        step = t.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out


def gather_fsdp(t: Any) -> Any:
    """A parameter leaf with its FSDP dims (split over the batch axes)
    gathered, under the ambient context: each such dim through
    :meth:`ParallelContext.gather_shards`, whose backward reduce-scatters
    the gradient.  The result keeps its model-axis layout; any other leaf
    comes back as it is."""
    sh = shard_of(t)
    ctx = current_context()
    if sh is None or ctx is None or not isinstance(t, torch.Tensor):
        return t
    batch = set(ctx.batch_axes)
    out, spec = t, list(sh.spec)
    for dim, entry in enumerate(sh.spec):
        names = set(_names(entry))
        if not names & batch:
            continue
        if names != batch:
            raise ValueError(f"dim {dim} of a leaf of spec {sh.spec} splits over "
                             f"{sorted(names)}: an FSDP dim takes all batch axes "
                             f"{sorted(batch)} and nothing else")
        out = ctx.gather_shards(out, "batch", dim)
        spec[dim] = None
    if out is t:
        return t
    return set_shard(out, LeafShard(tuple(spec), sh.shape)
                     if any(e is not None for e in spec) else None)
