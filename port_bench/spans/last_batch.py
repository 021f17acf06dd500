"""The engine (by a weak reference) and the requests of each
``ServingEngine.run`` call of the window, kept in ``state["last_batch"]``
for ``spans/program.py``, which serves the last of them again once the
window has closed.  It times and records nothing, and keeps nothing from
the profiled call."""
import weakref

TARGET = "repro_torch.serving.engine:ServingEngine.run"


def before(spans, engine, requests, *args, **kw):
    if not spans.recording:
        spans.state["last_batch"] = (weakref.ref(engine), list(requests))
