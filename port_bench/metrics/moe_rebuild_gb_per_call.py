"""GB of dense expert weights the MoE FFN rebuilds from their FORMS codes
per model call: the program's counter ``moe.rebuild_bytes`` over the model
calls of the traced call of ``spans/program.py``, its bulk prefills
(``rt.runner.prefill`` spans) and decode steps (``decode.steps``)."""
SPANS = ("program",)


def read(m):
    sp = m.spans
    if sp is None:
        return None
    calls = sp.counters.get("calls.rt.runner.prefill", 0) + sp.counters.get("decode.steps", 0)
    rebuilt = sp.counters.get("moe.rebuild_bytes", 0)
    if not calls or not rebuilt:
        return None
    return rebuilt / 1e9 / calls
