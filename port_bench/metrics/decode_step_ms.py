"""Host wall of the runner's decode rounds over the decode steps they ran
(a round is ``decode_block`` steps for every slot), over the traced run's
window."""
SPANS = ("decode_round",)


def read(m):
    steps = m.counters.get("decode_steps", 0)
    if not steps:
        return None
    return 1e3 * m.host_s["pb.decode_round"] / steps
