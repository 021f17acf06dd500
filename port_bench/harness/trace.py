"""Reading a ``torch.profiler`` trace of one steady slice of a run: the
device's busy time (the union of its kernels, copies and fills), the device
time of the kernels launched inside each of the benchmark's own ranges,
the busiest device operations and the longest idle gaps by what the host
was doing.

The raw Kineto events are read, not the profiler's event tree (building
that tree costs minutes for a call of some seconds).  A kernel belongs to
a call of a range when it runs, on the one stream, between the first and
the last kernel that the host launched inside that call (a launch is
matched to its kernel by correlation id).  The kernels that the program
launches through ``ctypes`` leave no launch the profiler records, so the
spans put a marker kernel at each end of a call (``Spans(markers=True)``),
and those kernels are attributed by their place between the markers."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

RANGE_PREFIX = "pb."          # every range the benchmark opens starts so
RUNNER_RANGES = ("pb.prefill_slot", "pb.decode_round", "pb.train_step", "pb.z_update")
TOP = 10


@dataclasses.dataclass
class TraceReading:
    wall_s: float                       # the traced slice on the host clock
    busy_s: float                       # union of device activity
    range_device_s: Dict[str, float]    # device time launched inside each pb.* range
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    summary: str = ""                   # what was read, for the run's log

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.wall_s)


@dataclasses.dataclass
class Events:
    """The parts of a trace the reading uses (nanoseconds)."""
    kernels: List[Tuple[int, int, int, str]]     # (correlation, start, end, name)
    launches: Dict[int, int]                     # correlation -> host launch start
    ranges: List[Tuple[str, int, int]]           # pb.* ranges
    ops: List[Tuple[int, int, str]]              # host ops (start, end, name)


def profile_call(fn: Callable[[], object], on_card: bool = True):
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA activity; the CPU
    alone off the card, for tests) and return (its result, the host wall
    of the slice in seconds, the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    return out, wall, prof


def kineto_events(prof) -> Events:
    """The profiler's raw events, sorted into :class:`Events`: device
    activity; the host's launch calls (runtime or driver events, which
    carry a link to the op they ran under); the benchmark's ranges; and
    the other host ops."""
    ev = Events(kernels=[], launches={}, ranges=[], ops=[])
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if not name.startswith(RANGE_PREFIX):       # a range drawn on the device
                ev.kernels.append((e.correlation_id(), e.start_ns(), e.end_ns(), name))
        elif e.linked_correlation_id() > 0:
            ev.launches[e.correlation_id()] = e.start_ns()
        elif name.startswith(RANGE_PREFIX):
            ev.ranges.append((name, e.start_ns(), e.end_ns()))
        else:
            ev.ops.append((e.start_ns(), e.end_ns(), name))
    return ev


def merge(intervals: np.ndarray) -> np.ndarray:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], axis=1)


def _inside(points: np.ndarray, spans: List[Tuple[int, int]]) -> np.ndarray:
    """Which points lie inside one of the (non-overlapping) spans."""
    if not spans or len(points) == 0:
        return np.zeros(len(points), dtype=bool)
    sp = np.array(sorted(spans), dtype=np.float64)
    j = np.searchsorted(sp[:, 0], points, side="right") - 1
    return (j >= 0) & (points <= sp[np.clip(j, 0, None), 1])


def _range_device_s(start: np.ndarray, end: np.ndarray, launch: np.ndarray,
                    calls: List[Tuple[int, int]]) -> float:
    """Seconds of the kernels that ran inside the calls of one range: each
    call's device span runs from the first to the last end of the kernels
    launched inside it; every kernel within a span counts."""
    if not calls or len(start) == 0:
        return 0.0
    cs = np.array(calls, dtype=np.float64)
    j = np.searchsorted(cs[:, 0], launch, side="right") - 1
    mine = np.isfinite(launch) & (j >= 0) & (launch <= cs[np.clip(j, 0, None), 1])
    if not mine.any():
        return 0.0
    lo = np.full(len(cs), np.inf)
    hi = np.full(len(cs), -np.inf)
    np.minimum.at(lo, j[mine], start[mine])
    np.maximum.at(hi, j[mine], end[mine])
    spans = np.stack([lo, hi], axis=1)[np.isfinite(lo)]
    spans = spans[np.argsort(spans[:, 0])]
    i = np.searchsorted(spans[:, 0], start, side="right") - 1
    inside = (i >= 0) & (end <= spans[np.clip(i, 0, None), 1])
    return float((end - start)[inside].sum()) / 1e9


def read(ev: Events, wall_s: float, ranges: Sequence[str]) -> TraceReading:
    """A :class:`TraceReading` of the events."""
    k = ev.kernels
    start = np.array([x[1] for x in k], dtype=np.float64)
    end = np.array([x[2] for x in k], dtype=np.float64)
    merged = merge(np.stack([start, end], axis=1) if k else np.zeros((0, 2)))
    busy_ns = float((merged[:, 1] - merged[:, 0]).sum()) if len(merged) else 0.0

    launch = np.array([ev.launches.get(x[0], np.nan) for x in k], dtype=np.float64)
    dur = end - start
    by_range: Dict[str, List[Tuple[int, int]]] = {}
    for name, s, e in ev.ranges:
        by_range.setdefault(name, []).append((s, e))
    range_s = {name: _range_device_s(start, end, launch, sorted(by_range.get(name, [])))
               for name in ranges}

    by_name: Dict[str, float] = {}
    for (_, s, e, name), d in zip(k, dur):
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    summary = (f"{len(k)} device events, {int(np.isfinite(launch).sum())} with a host "
               f"launch; {len(ev.ranges)} ranges; {len(ev.ops)} host ops; device s in "
               + ", ".join(f"{n} {v:.4f}" for n, v in range_s.items()))
    return TraceReading(wall_s=wall_s, busy_s=busy_ns / 1e9, range_device_s=range_s,
                        device_ops=[(n[:120], ns / 1e9) for n, ns in ops],
                        idle_gaps=_idle_gaps(merged, by_range, ev.ops), summary=summary)


def _idle_gaps(merged: np.ndarray, by_range: Dict[str, List[Tuple[int, int]]],
               ops: Sequence[Tuple[int, int, str]]) -> List[Tuple[str, float]]:
    """Idle time between device activity summed by the runner range the
    host was in at the gap's middle ("host outside the runner" otherwise),
    then the longest single gaps labelled with the innermost host op that
    covered their middle; at most :data:`TOP` entries."""
    if len(merged) < 2:
        return []
    g0, g1 = merged[:-1, 1], merged[1:, 0]
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    mids, lens = (g0 + g1) / 2, (g1 - g0) / 1e9
    left = np.ones(len(mids), dtype=bool)
    sums: Dict[str, float] = {}
    for name in RUNNER_RANGES:
        hit = _inside(mids, by_range.get(name, [])) & left
        if hit.any():
            sums[f"{name} (all gaps)"] = float(lens[hit].sum())
        left &= ~hit
    if left.any():
        sums["host outside the runner (all gaps)"] = float(lens[left].sum())
    out = sorted(sums.items(), key=lambda kv: -kv[1])[:3]
    cs = np.array([o[0] for o in ops], dtype=np.float64)
    ce = np.array([o[1] for o in ops], dtype=np.float64)
    for i in np.argsort(-lens)[:TOP - len(out)]:
        cover = np.flatnonzero((cs <= mids[i]) & (ce >= mids[i])) if len(cs) else []
        inner = ops[cover[np.argmax(cs[cover])]][2] if len(cover) else "no host op"
        out.append((f"gap under {inner}"[:120], float(lens[i])))
    return out
