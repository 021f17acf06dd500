"""Host ms the runner spends issuing one decode step: the program's
decode-round spans (``rt.runner.decode_round``) less the host reads inside
them (``rt.runner.host_read``, where the host waits for the device), over
the decode steps the rounds ran (``decode.steps``), in the traced call of
``spans/program.py`` (the window's last batch again, the tracer on)."""
SPANS = ("program",)


def read(m):
    sp = m.spans
    if sp is None:
        return None
    steps = sp.counters.get("decode.steps", 0)
    rounds = sp.host_s.get("rt.runner.decode_round")
    if not steps or rounds is None:
        return None
    waits = sp.host_s.get("rt.runner.decode_round/rt.runner.host_read", 0.0)
    return 1e3 * (rounds - waits) / steps
