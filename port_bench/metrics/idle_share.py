"""Share of the profiled call's or train step's wall time in which no
kernel, copy or fill ran on the device."""
SPANS = ()


def read(m):
    if m.trace is None or m.trace.wall_s <= 0:
        return None
    return 100.0 * m.trace.idle_share
