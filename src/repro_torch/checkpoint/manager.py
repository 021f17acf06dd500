"""Checkpoints: atomic, async, keep-k, preemption-aware, in the JAX
package's format.

One directory per step, ``step_{step:08d}/``, holding ``tree.msgpack``
(the metadata: a description of the tree, the leaf count, the step, each
leaf's dtype name and the caller's ``extra`` dict) and ``arrays.npz``
(leaf ``i`` as ``leaf_{i}``).  Leaves are numbered in the order of the
reference's flattened pytree: dict keys sorted, ``None`` an empty subtree,
dataclass fields in their declaration order (the reference registers them
in that order), and of a ``FormsLinearParams`` only ``mags``, ``signs``
and ``scale`` (its static fields come from the restore template, as in
the reference).  A dtype numpy lacks is stored as a same-width uint view
and named in ``meta["dtypes"]`` (``bfloat16`` as ``uint16``), so either
package reads the other's checkpoints.  The metadata goes through
``msgpack_lite`` (the card's machine has neither ``msgpack`` nor
``ml_dtypes``).

A ``torch.Generator`` leaf (``TrainState.rng``) is stored as the
reference's ``uint32[2]`` key: saving draws a 64-bit seed from the
generator and re-seeds it with that seed, and restoring seeds a fresh
generator with it, so the run that saved and a run resumed from the file
go on from one generator state.  (The two packages' draws differ all the
same: ``torch.Generator`` is not ``jax.random``.)

Writes go to a temp dir that is renamed into place, so a killed writer
never leaves a partial checkpoint.  ``CheckpointManager.save_async``
copies every leaf to host memory before it returns (the port's optimizer
and ADMM update in place, so the next step would change a shared buffer)
and writes on a background thread.  ``install_preemption_handler`` turns
SIGTERM into save-and-exit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import shutil
import signal
import tempfile
import threading
from typing import Any, Callable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite
from repro_torch.forms.linear import FormsLinearParams

Tree = Any

_TREE_FILE = "tree.msgpack"
_ARRAY_FILE = "arrays.npz"
# numpy can't hold these dtypes: stored as a same-width uint view
_VIEWS = {torch.bfloat16: (torch.int16, np.uint16, "bfloat16")}
# the pytree fields of a dataclass whose other fields are static metadata
_DATA_FIELDS = {FormsLinearParams: ("mags", "signs", "scale")}
_SEED_LIMIT = 2 ** 63 - 1


def _fields(node: Any) -> Tuple[str, ...]:
    return _DATA_FIELDS.get(type(node)) or tuple(f.name for f in dataclasses.fields(node))


def _is_node(tree: Any) -> bool:
    return (isinstance(tree, (dict, list, tuple))
            or (dataclasses.is_dataclass(tree) and not isinstance(tree, type)))


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves of ``tree`` in the reference's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    if _is_node(tree):
        return [leaf for f in _fields(tree) for leaf in tree_leaves(getattr(tree, f))]
    return [tree]


def _rebuild(template: Tree, leaves: Iterator[Any]) -> Tree:
    """``template``'s structure with its leaves taken from ``leaves`` in
    flatten order."""
    if template is None:
        return None
    if isinstance(template, dict):
        new = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: new[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    if _is_node(template):
        return dataclasses.replace(template, **{f: _rebuild(getattr(template, f), leaves)
                                                for f in _fields(template)})
    return next(leaves)


def describe(tree: Tree) -> str:
    """A readable description of the tree's structure (``*`` per leaf),
    stored as ``meta["treedef"]``; nothing reads it back."""
    def walk(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if _is_node(t):
            return (type(t).__name__ + "("
                    + ", ".join(f"{f}={walk(getattr(t, f))}" for f in _fields(t)) + ")")
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _reseed(gen: torch.Generator) -> int:
    """Draw a seed from ``gen`` and re-seed it with that seed."""
    seed = int(torch.randint(0, _SEED_LIMIT, (1,), generator=gen, device=gen.device)[0])
    gen.manual_seed(seed)
    return seed


def _encode(leaf: Any) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf (sharing no memory with it) and its dtype name."""
    if isinstance(leaf, torch.Generator):
        seed = _reseed(leaf)
        return np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32), "uint32"
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True).contiguous()
        if host.dtype in _VIEWS:
            as_int, as_uint, name = _VIEWS[host.dtype]
            return host.view(as_int).numpy().view(as_uint), name
        try:
            arr = host.numpy()
        except TypeError as e:
            raise TypeError(f"cannot checkpoint a {host.dtype} leaf: {e}") from e
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=True)
    if arr.dtype.kind not in "biufc":
        raise TypeError(f"cannot checkpoint a leaf of numpy dtype {arr.dtype}")
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, name: str, template: Any, device: Optional[torch.device]):
    """A stored leaf as the template leaf's kind, on ``device`` (default:
    the template leaf's device, else the CPU)."""
    if device is None:
        device = getattr(template, "device", torch.device("cpu"))
    if name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)
    else:
        try:
            target = np.dtype(name)
        except TypeError as e:
            raise ValueError(f"checkpoint leaf of dtype {name!r}: the port reads numpy "
                             f"dtypes and bfloat16 only") from e
        if arr.dtype != target:
            arr = arr.view(target)
        t = torch.from_numpy(np.array(arr, copy=True))
    if isinstance(template, torch.Generator):
        if t.numel() != 2:
            raise ValueError(f"a generator leaf holds a uint32[2] key, got shape "
                             f"{tuple(t.shape)}")
        hi, lo = (int(v) & 0xFFFFFFFF for v in t.reshape(-1).tolist())
        gen = torch.Generator(device=device)
        gen.manual_seed((hi << 32) | lo)
        return gen
    return t.to(device)


def _write(path: str, arrays: List[np.ndarray], dtypes: List[str], treedef: str,
           step: int, extra_meta: Optional[dict]) -> str:
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=path)
    try:
        np.savez(os.path.join(tmp, _ARRAY_FILE),
                 **{f"leaf_{i}": a for i, a in enumerate(arrays)})
        meta = {"treedef": treedef, "num_leaves": len(arrays), "step": int(step),
                "dtypes": dtypes, "extra": extra_meta or {}}
        with open(os.path.join(tmp, _TREE_FILE), "wb") as f:
            f.write(msgpack_lite.packb(meta))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _snapshot(tree: Tree) -> Tuple[List[np.ndarray], List[str], str]:
    leaves = tree_leaves(tree)
    encoded = [_encode(x) for x in leaves]
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves):
        torch.cuda.synchronize()
    return [a for a, _ in encoded], [n for _, n in encoded], describe(tree)


def save(path: str, tree: Tree, step: int, extra_meta: Optional[dict] = None) -> str:
    """Synchronous atomic save; returns the final checkpoint directory.

    ``extra_meta`` (a dict of str, int, float, bool, None, lists and dicts,
    e.g. ``dataclasses.asdict(spec)`` of a FORMS spec) is stored in
    ``tree.msgpack`` and read back by :func:`read_meta`, so a reader can
    rebuild the restore template (``forms.spec_from_meta``)."""
    arrays, dtypes, treedef = _snapshot(tree)
    return _write(path, arrays, dtypes, treedef, step, extra_meta)


def _step_dir(path: str, step: Optional[int]) -> Tuple[str, int]:
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    return os.path.join(path, f"step_{step:08d}"), step


def restore(path: str, template: Tree, step: Optional[int] = None,
            device: Union[str, torch.device, None] = None,
            shardings: Optional[Tree] = None) -> Tuple[Tree, int]:
    """Restore the given (or latest) step into the template's structure.

    Each leaf lands on ``device`` when given, else on its template leaf's
    device; a generator leaf comes back as a fresh generator seeded from
    the stored key.  Shapes must match the template's; dtypes are the
    stored ones.  The reference's ``shardings=`` comes with distribution
    and is refused until then."""
    if shardings is not None:
        raise NotImplementedError("shardings= is not ported yet (ROADMAP queue 1, item 13)")
    d, step = _step_dir(path, step)
    dev = None if device is None else torch.device(device)
    with open(os.path.join(d, _TREE_FILE), "rb") as f:
        meta = msgpack_lite.unpackb(f.read())
    leaves = tree_leaves(template)
    with np.load(os.path.join(d, _ARRAY_FILE)) as data:
        if len(leaves) != len(data.files):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, template has "
                             f"{len(leaves)}")
        new = []
        for i, tmpl in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            want = (2,) if isinstance(tmpl, torch.Generator) else tuple(np.shape(tmpl))
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf {i}: shape {tuple(arr.shape)} != {want}")
            new.append(_decode(arr, meta["dtypes"][i], tmpl, dev))
    return _rebuild(template, iter(new)), step


def read_meta(path: str, step: Optional[int] = None) -> dict:
    """The metadata dict of the given (or latest) checkpoint step, with the
    ``extra`` dict passed to :func:`save`."""
    d, _ = _step_dir(path, step)
    with open(os.path.join(d, _TREE_FILE), "rb") as f:
        return msgpack_lite.unpackb(f.read())


def _steps(path: str) -> List[int]:
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(path)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def latest_step(path: str) -> Optional[int]:
    steps = _steps(path)
    return steps[-1] if steps else None


def gc_old(path: str, keep: int) -> List[str]:
    """Delete all but the newest ``keep`` checkpoints; returns removed dirs."""
    removed = []
    for s in _steps(path)[:-keep] if keep > 0 else []:
        d = os.path.join(path, f"step_{s:08d}")
        shutil.rmtree(d, ignore_errors=True)
        removed.append(d)
    return removed


class CheckpointManager:
    """Async keep-k checkpointing with preemption support.  A failed
    background write raises from the next :meth:`wait` (and so from the
    next save)."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def save_async(self, tree: Tree, step: int) -> None:
        """Copy every leaf to host memory now, then write on a thread."""
        arrays, dtypes, treedef = _snapshot(tree)
        self.wait()

        def _write_bg():
            try:
                _write(self.path, arrays, dtypes, treedef, step, None)
                gc_old(self.path, self.keep)
            except BaseException as e:  # raised again by wait()
                self._error = e

        with self._lock:
            self._thread = threading.Thread(target=_write_bg, daemon=True)
            self._thread.start()

    def save_sync(self, tree: Tree, step: int) -> str:
        self.wait()
        out = save(self.path, tree, step)
        gc_old(self.path, self.keep)
        return out

    def wait(self) -> None:
        with self._lock:
            t = self._thread
        if t is not None:
            t.join()
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(f"the background checkpoint write failed: {err}") from err

    def restore_latest(self, template: Tree) -> Tuple[Tree, int]:
        self.wait()
        return restore(self.path, template)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.path)


class PreemptionHandler:
    """What :func:`install_preemption_handler` installs.  Inside
    :meth:`critical` a SIGTERM is held and acted upon when the block ends:
    the port's train step updates its state in place, so a save in the
    middle of one would mix two steps."""

    def __init__(self, save_fn: Callable[[], None]):
        self.save_fn = save_fn
        self._busy = False
        self._pending = False

    def _fire(self) -> None:
        self.save_fn()
        os._exit(0)

    def __call__(self, signum, frame) -> None:
        if self._busy:
            self._pending = True
        else:
            self._fire()

    @contextlib.contextmanager
    def critical(self) -> Iterator[None]:
        self._busy = True
        try:
            yield
        finally:
            self._busy = False
        if self._pending:
            self._fire()


def install_preemption_handler(save_fn: Callable[[], None]) -> PreemptionHandler:
    """SIGTERM -> checkpoint -> exit(0).  Returns the handler, whose
    ``critical()`` block defers the save to the block's end."""
    handler = PreemptionHandler(save_fn)
    signal.signal(signal.SIGTERM, handler)
    return handler
