"""Host wall of the runner's prefill calls (each returns its first token
to the host) per 1,000 real prompt tokens, over the traced run's window."""
SPANS = ("prefill_slot",)


def read(m):
    toks = m.counters.get("prefill_tokens", 0)
    if not toks:
        return None
    return 1e3 * m.host_s["pb.prefill_slot"] / toks * 1e3
