"""The program's own spans and counters (``repro_torch.obs``) over one more
``ServingEngine.run`` call: the window's last batch (``spans/last_batch.py``)
served again with the tracer on, after the window has closed and before the
profiled call.  The window and the profiled call run with the tracer off,
so the window's wall and the benchmark's own spans read what they read
without this file, and the trace reading meets no device-side copy of a
program range to take for a kernel.

The hook is the harness's ``Spans.record``, which ``serve_offline.measure``
calls once, between the window and the profiled call.  After the traced
call each span name's total and self seconds go to ``host_s`` (``<name>``
and ``<name>.self``), the seconds of the spans under each parent by name
to ``host_s["<parent>/<child>"]``, the number of spans to
``counters["calls.<name>"]``, and each program counter's increase over the
call to ``counters``; the spans are drained.  ``measure`` has copied the
window's ``host_s`` and ``counters`` by then, so the readers take these
from the spans object (``m.spans``).  A program without the tracer adds
nothing."""
import dataclasses

TARGET = "port_bench.harness.spans:Spans.record"
NEEDS = ("last_batch",)


def _obs():
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs


def before(spans, *args, **kw):
    obs = _obs()
    last = spans.state.pop("last_batch", None)
    engine = last[0]() if last is not None else None
    if obs is None or engine is None:
        return
    obs.drain()
    start = obs.counters()
    obs.enable()
    try:
        engine.run([dataclasses.replace(r) for r in last[1]])
    finally:
        obs.disable()
        spans.state.pop("last_batch", None)     # what this call left there
    for name, (total, own) in obs.self_times().items():
        spans.host_s[name] += total
        spans.host_s[name + ".self"] += own
    drained, now = obs.drain()
    for s in drained:
        spans.counters["calls." + s.name] += 1
        if s.parent >= 0:
            key = f"{drained[s.parent].name}/{s.name}"
            spans.host_s[key] += (s.end_ns - s.start_ns) / 1e9
    for name, n in now.items():
        spans.counters[name] += n - start.get(name, 0)
