"""The port's tracer: spans and counters on the serving and training path.

Spans are off by default.  Off, a span's call site costs one check of a
module flag and returns a shared null context (no clock read, nothing
recorded), and a :func:`spanned` function has no wrapper at all.  On
(:func:`enable`), each span records its name, start, end, the index of the
span open around it (its parent; -1 at the top) and its attributes, and
while a ``torch.profiler`` session is active it also opens
``torch.profiler.record_function(name)``.  A span without a ``uid``
attribute takes its parent's, so the spans of one request's admission share
its id.  Spans are recorded from one thread at a time (autograd's device
thread runs while the thread that called ``backward`` waits).

Edges are read with ``time.perf_counter_ns()``; :func:`enable` takes one
anchor pair ``(perf_counter_ns, time_ns)`` and :func:`drain` gives every
span on the Unix-epoch clock that ``torch.profiler`` (Kineto) stamps its
host events with, so a profiled call's idle gaps line up with the spans.
A span measures host time: work queued on the device runs after it, so a
span covers device time only where it ends in a read from the device.

Counters (:func:`count`) are always on: one dict increment.
:func:`counters` also shows each kernel wrapper's own ``.launches`` count as
``kernel.<name>``.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import json
import os
import sys
import threading
import time
import types
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

_on = False
_anchor = (0, 0)                  # (perf_counter_ns, time_ns) taken by enable()
_records: List[list] = []         # [name, start, end, parent, attrs, thread id]
_open: List[int] = []             # indices of the open spans, innermost last
_counts: Dict[str, int] = collections.defaultdict(int)
_null = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled
_thread = threading.local()     # the OS thread id, read once per thread (a system call)
_sites: Dict[int, Tuple[str, Callable]] = {}   # id -> (span name, function) of spanned()
_swapped: List[Tuple[Any, str, Any]] = []      # (owner, attribute, value) wrapped by enable()

#: the kernel wrappers whose ``.launches`` :func:`counters` reads
KERNELS = (("repro_torch.kernels.polarized_matmul",
            ("polarized_matmul", "polarized_matmul_tc", "polarized_matmul_skip",
             "polarized_matmul_tc_skip")),
           ("repro_torch.kernels.bitserial_crossbar", ("bitserial_crossbar",)),
           ("repro_torch.kernels.admm_polarize", ("admm_polarize",)))


class Span(NamedTuple):
    """A finished span, its edges in Unix-epoch nanoseconds; ``parent`` is
    the index of the enclosing span in the same drained list, or -1."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    attrs: Dict[str, Any]
    tid: int


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        tid = getattr(_thread, "id", None)
        if tid is None:
            tid = _thread.id = threading.get_native_id()
        self.rec = [name, 0, 0, -1, attrs, tid]
        self.rf = None

    def __enter__(self):
        # each edge is read just before the profiler's range opens or closes
        if _profiling():
            self.rf = torch.profiler.record_function(self.rec[0])
        if _open:
            self.rec[3] = _open[-1]
            up = _records[_open[-1]][4]
            if "uid" in up and "uid" not in self.rec[4]:
                self.rec[4]["uid"] = up["uid"]
        _open.append(len(_records))
        _records.append(self.rec)
        self.rec[1] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        _open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def enable() -> None:
    """Switch spans on (again), take the clock anchor, and put a spanning
    wrapper in place of each :func:`spanned` function in the modules and
    classes of its package (around a wrapper of another tool that holds it
    as ``__wrapped__``)."""
    global _on, _anchor
    _anchor = (time.perf_counter_ns(), time.time_ns())
    _on = True
    if _swapped:
        return
    roots = {f.__module__.split(".")[0] for _, f in _sites.values()}
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or mod_name.split(".")[0] not in roots:
            continue
        owners = [mod] + [v for v in vars(mod).values()
                          if isinstance(v, type) and v.__module__ == mod_name]
        for owner in owners:
            for attr, v in list(vars(owner).items()):
                name = _site(v)
                if name is not None:
                    _swapped.append((owner, attr, v))
                    setattr(owner, attr, _wrap(name, v))


def disable() -> None:
    """Switch spans off and put back what :func:`enable` wrapped; what was
    recorded stays until :func:`drain`."""
    global _on
    _on = False
    while _swapped:
        owner, attr, v = _swapped.pop()
        setattr(owner, attr, v)


def span(name: str, **attrs):
    """A context manager recording the span ``name`` with ``attrs`` when
    spans are on; the shared null context when they are off."""
    if not _on:
        return _null
    return _Span(name, attrs)


def spanned(name: str) -> Callable:
    """Decorator: while spans are on, each call of the function (of a module
    or a class) is the span ``name``; the function is returned as it is, so
    it costs nothing while they are off.  A call inside a span of the same
    name (an override calling the method it overrides) is part of it."""
    def deco(fn: Callable) -> Callable:
        _sites[id(fn)] = (name, fn)
        return fn
    return deco


def _site(v: Any):
    """The span name of a spanned function, or of a wrapper around one."""
    while isinstance(v, types.FunctionType):
        hit = _sites.get(id(v))
        if hit is not None and hit[1] is v:
            return hit[0]
        v = v.__dict__.get("__wrapped__")
    return None


def _wrap(name: str, fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if not _on or (_open and _records[_open[-1]][0] == name):
            return fn(*args, **kw)
        with _Span(name, {}):
            return fn(*args, **kw)
    return wrapper


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    _counts[name] += n


def counters() -> Dict[str, int]:
    """A snapshot of the counters, with ``kernel.<name>`` for each kernel
    wrapper's ``.launches``."""
    out = dict(_counts)
    for module, names in KERNELS:
        mod = importlib.import_module(module)
        for name in names:
            out[f"kernel.{name}"] = getattr(mod, name).launches
    return out


def self_times() -> Dict[str, Tuple[float, float]]:
    """Seconds by span name of the finished spans not yet drained:
    ``(total, self)``, self being each span's duration minus what its
    child spans cover."""
    total: Dict[str, float] = collections.defaultdict(float)
    own: Dict[str, float] = collections.defaultdict(float)
    for name, t0, t1, parent, *_ in _records:
        if not t1:
            continue
        d = (t1 - t0) / 1e9
        total[name] += d
        own[name] += d
        if parent >= 0:
            own[_records[parent][0]] -= d
    return {n: (total[n], own[n]) for n in total}


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """The recorded spans on the epoch clock and a counter snapshot; the
    spans are cleared.  Call it with no span open."""
    if _open:
        raise RuntimeError(f"drain() inside {len(_open)} open span(s)")
    p0, e0 = _anchor
    out = [Span(n, t0 - p0 + e0, t1 - p0 + e0, parent, attrs, tid)
           for n, t0, t1, parent, attrs, tid in _records]
    _records.clear()
    return out, counters()


def write_chrome(path: str) -> int:
    """Drain the spans into a Chrome/Perfetto trace at ``path`` (complete
    events in microseconds on the epoch clock, the counters under
    ``"counters"``); returns the number of spans written."""
    spans, counts = drain()
    pid = os.getpid()
    events = [{"name": s.name, "ph": "X", "cat": "rt", "pid": pid, "tid": s.tid,
               "ts": s.start_ns / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {**s.attrs, "parent": s.parent}} for s in spans]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms", "counters": counts}, f,
                  default=str)
    return len(events)
