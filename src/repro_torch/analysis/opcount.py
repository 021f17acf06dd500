"""Per-rank cost of one traced step: FLOPs, bytes, peak memory, collectives.

The counterpart of the JAX package's ``analysis/hlo.py``.  The reference
parses the post-SPMD HLO of one compiled program; the port runs explicit
SPMD (one process per device), so one rank's step is traced eagerly on
fake tensors (``FakeTensorMode``: shapes, no storage, no kernel) and
counted op by op as it is dispatched:

* **FLOPs** from ``FlopCounterMode``'s formulas (mm, bmm, addmm, baddbmm,
  convolution, attention): the matrix work only, as the reference's
  analyzer counts ``dot``/``convolution`` and ignores elementwise FLOPs;
* **bytes**: operands plus result of every aten op that is not a view
  (the reference's op-level estimator).  Eager PyTorch reads and writes
  HBM at every op, so this is the program's traffic, not only a bound;
  ops that move no data (allocations, views and aliases, metadata
  queries) count nothing, and an in-place indexed write (``index_put_``,
  ``index_add_``, ``scatter_``...) its indices and twice its values, the
  reference's rule for ``dynamic-update-slice``;
* **peak live bytes**: a storage's bytes are added when an op creates it
  and subtracted when it dies (``weakref.finalize`` on its
  ``untyped_storage()``, whose Python object lives as long as the
  storage); the storages of the step's arguments are not counted, so the
  peak is the temporary memory above them;
* **collective operand bytes by kind** (:data:`COLLECTIVE_KINDS`), which
  the recording context (``distributed/context.RecordingContext``) adds
  as the step calls its collectives.

Two parts of the reference have no counterpart: the HLO parser and the
while-loop trip-count scaling.  An eager trace runs every layer, so
nothing needs scaling.  The bytes are eager op-level traffic, not XLA's
post-fusion bytes.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.distributed.context import COLLECTIVE_KINDS  # noqa: F401


# ops that move no data: allocations without a write, aliases (those the
# schema does not mark as views too); an op with no tensor result (a
# metadata query such as ``prim.device``) moves none either
_NO_TRAFFIC = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "lift_fresh_copy", "_unsafe_view",
    "_reshape_alias", "resize_", "set_",
}


# in-place indexed writes: a read-modify-write of the updated region only
# (the reference's rule for ``dynamic-update-slice``), not of the whole
# destination
_INDEXED_WRITES = {
    "index_put_", "_index_put_impl_", "index_add_", "index_copy_", "index_fill_",
    "scatter_", "scatter_add_", "scatter_reduce_", "masked_scatter_",
}


@dataclasses.dataclass
class CollectiveStats:
    """Per-kind collective operand bytes (per device, per step)."""

    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


@dataclasses.dataclass
class ModuleCost:
    """Per-device cost of one traced step."""

    flops: float
    bytes: float
    collectives: CollectiveStats


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements take (a view's, not its storage's)."""
    return t.numel() * t.element_size()


def tree_bytes(tree: Any) -> int:
    """The bytes of every tensor in a nested structure of dicts, lists,
    tuples and dataclasses (a FORMS leaf's planes included)."""
    return sum(tensor_bytes(t) for t in _tensors(tree))


def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _is_view(func) -> bool:
    return bool(getattr(func, "is_view", False))


class OpCounter(TorchDispatchMode):
    """Counts the bytes and the live memory of every aten op dispatched
    under it (see the module docstring).  Enter it inside a
    ``FakeTensorMode`` and a ``FlopCounterMode``; :meth:`exclude` the
    step's arguments first, so their storages count as arguments, not as
    temporaries.  ``ops`` lists the ops dispatched, in order (the program
    as traced)."""

    def __init__(self, record_ops: bool = False):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.ops: list = [] if record_ops else None
        self._tracked: Dict[int, int] = {}
        self._known: set = set()
        self._lock = threading.Lock()

    # -- storages ----------------------------------------------------------

    def exclude(self, tree: Any) -> None:
        """Mark the storages of every tensor in ``tree`` as arguments."""
        for t in _tensors(tree):
            self._mark_known(t.untyped_storage())

    def _mark_known(self, s) -> None:
        key = s._cdata
        with self._lock:
            if key in self._known or key in self._tracked:
                return
            self._known.add(key)
        weakref.finalize(s, self._forget, key)

    def _forget(self, key: int) -> None:
        with self._lock:
            self._known.discard(key)

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        with self._lock:
            if key in self._known or key in self._tracked:
                return
            n = int(s.nbytes())
            self._tracked[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._release, key)

    def _release(self, key: int) -> None:
        with self._lock:
            self.live -= self._tracked.pop(key, 0)

    # -- dispatch ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if self.ops is not None:
            self.ops.append(str(func))
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if outs and not _is_view(func) and name not in _NO_TRAFFIC:
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            if name in _INDEXED_WRITES:
                # the indices once, the written values read and written
                moved = sum(tensor_bytes(t) for t in ins[1:]) + tensor_bytes(ins[-1])
            else:
                moved = sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs)
            with self._lock:
                self.bytes += moved
        for t in outs:
            self._track(t)
        return out
