"""Share of the rows the runner's bulk prefills computed that are bucket
padding, in percent: 100 (1 - real prompt tokens / rows), the program's
counters ``prefill.tokens`` and ``prefill.rows`` over the traced call of
``spans/program.py``."""
SPANS = ("program",)


def read(m):
    sp = m.spans
    rows = sp.counters.get("prefill.rows", 0) if sp is not None else 0
    if not rows:
        return None
    return 100.0 * (1.0 - sp.counters.get("prefill.tokens", 0) / rows)
