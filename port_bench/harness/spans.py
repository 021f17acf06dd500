"""The benchmark's own spans around calls into the program's layers,
installed in traced runs only.

A span wraps a module or class attribute: it opens a
``torch.profiler.record_function`` range named ``pb.<span>`` (so the
trace attributes the kernels launched inside to that layer), adds the
host time of the call when asked (for calls that end in a host read, so
the host clock covers the device work), and, while ``recording`` is on,
stores the work of each call as the span computes it from the call's
arguments.  Work may hold device scalars (data-dependent counts); they are
read once, after the traced slice (:meth:`Spans.work`).

Each span is a file of its own, ``spans/<span>.py``, found by name: its
``TARGET`` (``"module:attr"`` or ``"module:Class.attr"``), the flags
``HOST``, ``MARKER`` and ``SYNC``, the spans it ``NEEDS`` (whose state its
work reads), and optional ``when``, ``before``, ``after`` and ``work``
functions.  Each per-layer metric names the spans it reads (``SPANS``);
a traced run installs the union of those of its cell's metrics.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import importlib.util
import pathlib
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

Work = Tuple[Any, Any]
PREFIX = "pb."


class Spans:
    """``markers=True`` (on the card) puts a one-element fill kernel on
    the stream at each end of a call wrapped with ``marker=True``, so the
    trace can place kernels whose launch it does not record.  ``state``
    carries what an outer call tells the spans inside it (the real prompt
    length of a prefill, the active slots of a decode round)."""

    def __init__(self, markers: bool = False):
        self.host_s: Dict[str, float] = collections.defaultdict(float)
        self.counters: Dict[str, float] = collections.defaultdict(float)
        self.state: Dict[str, Any] = {}
        self.recording = False
        self.names: List[str] = []
        self._work: Dict[str, List[Work]] = collections.defaultdict(list)
        self._undo: List[Tuple[Any, str, Any]] = []
        self._mark = None
        if markers:
            import torch
            self._mark = torch.zeros(1, device="cuda")

    def wrap(self, owner: Any, attr: str, name: str, *, host: bool = False,
             marker: bool = False, sync: bool = False,
             when: Optional[Callable[..., bool]] = None,
             before: Optional[Callable[..., None]] = None,
             work_fn: Optional[Callable[..., Optional[Work]]] = None,
             after: Optional[Callable[..., None]] = None) -> None:
        """Replace ``owner.attr`` with a spanned call.  ``when(*args, **kw)``
        picks the calls to span (all by default); ``sync`` synchronizes the
        device on both sides inside the timed span; ``before(spans, *args,
        **kw)`` runs first, ``work_fn(spans, out, *args, **kw)`` and
        ``after(spans, out, *args, **kw)`` after the call."""
        import torch

        fn = getattr(owner, attr)
        spans = self
        mark = self._mark if marker else None
        sync_fn = torch.cuda.synchronize if sync and torch.cuda.is_available() else None

        @functools.wraps(fn)
        def spanned(*args, **kw):
            if when is not None and not when(*args, **kw):
                return fn(*args, **kw)
            if before is not None:
                before(spans, *args, **kw)
            with torch.profiler.record_function(name):
                if sync_fn is not None:
                    sync_fn()
                t0 = time.perf_counter()
                if mark is not None:
                    mark.fill_(0.0)
                out = fn(*args, **kw)
                if mark is not None:
                    mark.fill_(1.0)
                if sync_fn is not None:
                    sync_fn()
                if host:
                    spans.host_s[name] += time.perf_counter() - t0
            if spans.recording and work_fn is not None:
                w = work_fn(spans, out, *args, **kw)
                if w is not None:
                    spans._work[name].append(w)
            if after is not None:
                after(spans, out, *args, **kw)
            return out

        self._undo.append((owner, attr, fn))
        self.names.append(name)
        setattr(owner, attr, spanned)

    def uninstall(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()

    @contextlib.contextmanager
    def record(self):
        """Store work while the block runs (the traced slice)."""
        self.recording = True
        try:
            yield
        finally:
            self.recording = False

    def work(self, name: str) -> List[Tuple[float, float]]:
        """The recorded (flops, bytes) of every call of ``name``, device
        scalars read to host numbers."""
        out = []
        for f, b in self._work.get(name, []):
            out.append((float(f), float(b)))
        return out


# ---------------------------------------------------------------------------
# the rows a call's inputs need, where the program pads them
# ---------------------------------------------------------------------------

def real_rows(spans: Spans, rows: int) -> int:
    """How many of a call's ``rows`` (ordered slot-major) carry real
    tokens: inside a prefill, at most the prompt's length (the program may
    pad it to a bucket); inside a decode round whose rows are the slots
    times a per-slot count, the active slots' rows; else all of them."""
    n = spans.state.get("prefill_len")
    if n is not None:
        return min(int(rows), int(n))
    active = spans.state.get("active")
    if active is not None and rows % len(active) == 0:
        return rows // len(active) * sum(active)
    return int(rows)


def real_mask(spans: Spans, rows: int, device):
    """The rows of :func:`real_rows` as a boolean tensor on ``device``, or
    None where every row is real.  Made on the device from what the outer
    call left (no copy from the host and no read back, which would stall
    the host behind the device in the traced slice)."""
    import torch
    n = spans.state.get("prefill_len")
    if n is not None:
        return torch.arange(int(rows), device=device) < int(n)
    active = spans.state.get("active_on_device")
    if active is not None and rows % active.numel() == 0:
        return active.to(device).repeat_interleave(rows // active.numel())
    return None


# ---------------------------------------------------------------------------
# span files
# ---------------------------------------------------------------------------

def span_module(name: str, bench_dir: pathlib.Path):
    """``spans/<name>.py``, loaded by path."""
    path = pathlib.Path(bench_dir) / "spans" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_span_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def closure(names: Iterable[str], bench_dir: pathlib.Path) -> List[Tuple[str, Any]]:
    """The spans ``names`` and every span they need, each once, a needed
    span before the spans that need it."""
    out: Dict[str, Any] = {}

    def visit(name: str) -> None:
        if name in out:
            return
        mod = span_module(name, bench_dir)
        for dep in getattr(mod, "NEEDS", ()):
            visit(dep)
        out[name] = mod

    for n in names:
        visit(n)
    return list(out.items())


def _target(spec: str):
    """``"module:attr"`` or ``"module:Class.attr"`` -> (owner, attr)."""
    module, _, path = spec.partition(":")
    owner = importlib.import_module(module)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, attr


def install(names: Iterable[str], bench_dir: pathlib.Path, markers: bool = False,
            state: Optional[Dict[str, Any]] = None) -> Spans:
    """A :class:`Spans` with the spans ``names`` (and those they need)
    wrapped around their targets; ``state`` seeds what the spans read of
    the cell (such as the FORMS fragment size)."""
    sp = Spans(markers=markers)
    sp.state.update(state or {})
    for name, mod in closure(names, bench_dir):
        owner, attr = _target(mod.TARGET)
        sp.wrap(owner, attr, PREFIX + name, host=getattr(mod, "HOST", False),
                marker=getattr(mod, "MARKER", False), sync=getattr(mod, "SYNC", False),
                when=getattr(mod, "when", None), before=getattr(mod, "before", None),
                work_fn=getattr(mod, "work", None), after=getattr(mod, "after", None))
    return sp
