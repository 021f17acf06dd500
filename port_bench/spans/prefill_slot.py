"""The runner's bulk prefill of one slot
(``serving/engine.ModelRunner.prefill_slot``), which returns the first
token to the host: its host time, the real prompt tokens, and the prompt's
length for the spans inside it (the program may pad the prompt to a
bucket; the work counted is the prompt's)."""
TARGET = "repro_torch.serving.engine:ModelRunner.prefill_slot"
HOST = True


def before(spans, runner, slot, prompt, *args, **kw):
    spans.state["prefill_len"] = len(prompt)


def after(spans, out, runner, slot, prompt, *args, **kw):
    spans.counters["prefill_tokens"] += len(prompt)
    spans.state.pop("prefill_len", None)
