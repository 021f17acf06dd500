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
* :func:`parallel_context` — the ambient context that the model layers
  read, as the reference's ``constrain`` reads its own (None: one device).
* :class:`LeafShard` — a leaf's layout: its spec (one entry per dim: None,
  an axis name or a tuple of names) and its global shape.  A sharded FORMS
  leaf carries the trio of its planes in ``FormsLinearParams.shard``, a
  sharded dense tensor one under the ``shard`` attribute
  (:func:`shard_of`, :func:`set_shard`).

Nothing here catches a collective's failure, and a world of one skips every
collective (an axis of size 1 has nothing to exchange).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

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
            for logical in ("batch", "model"):
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

    def all_gather(self, t: torch.Tensor, logical: str, dim: int) -> torch.Tensor:
        """Concatenate the group's tensors along ``dim``, in coordinate order."""
        n = self.axis_size(logical)
        if n == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(n)]
        torch.distributed.all_gather(parts, t.contiguous(), group=self._group(logical))
        return torch.cat(parts, dim=dim)

    def all_reduce(self, t: torch.Tensor, logical: str, op: str = "sum") -> torch.Tensor:
        """The group's sum (or max) of ``t``, as a new tensor."""
        if self.axis_size(logical) == 1:
            return t
        out = t.contiguous().clone()
        red = {"sum": torch.distributed.ReduceOp.SUM,
               "max": torch.distributed.ReduceOp.MAX}[op]
        torch.distributed.all_reduce(out, op=red, group=self._group(logical))
        return out

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
        and concatenate what arrives in coordinate order."""
        if self.axis_size(logical) == 1:
            return t
        out = torch.empty_like(t)
        torch.distributed.all_to_all_single(out, t.contiguous(), group=self._group(logical))
        return out

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order (host objects, any group size)."""
        if self.mesh is None:
            return [obj]
        out: List[Any] = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(out, obj)
        return out


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
