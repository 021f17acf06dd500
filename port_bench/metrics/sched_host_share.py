"""Share of the traced run's window that the host spends outside the
runner's calls (``ModelRunner.prefill_slot`` / ``decode_round``, each
ending in a host read): the scheduler's own time, in percent."""
SPANS = ("prefill_slot", "decode_round")
RUNNER = ("pb.prefill_slot", "pb.decode_round")


def read(m):
    inside = sum(m.host_s.get(n, 0.0) for n in RUNNER)
    if not inside or m.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - inside / m.window_s)
