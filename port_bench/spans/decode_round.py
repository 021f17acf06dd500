"""The runner's decode round (``serving/engine.ModelRunner.decode_round``:
``decode_block`` steps for every slot, one host read): its host time, the
steps it ran, and the active slots for the spans inside it (the program
decodes every slot; the work counted is the active slots').  The slots'
mask goes to the device with the round's own inputs, before its first
kernel."""
TARGET = "repro_torch.serving.engine:ModelRunner.decode_round"
HOST = True


def before(spans, runner, *args, active=None, **kw):
    spans.state["active"] = None if active is None else [bool(a) for a in active]
    spans.state["active_on_device"] = None
    if active is not None and spans.recording:
        import torch
        spans.state["active_on_device"] = torch.tensor(spans.state["active"],
                                                       device=runner.device)


def after(spans, out, *args, **kw):
    spans.counters["decode_steps"] += int(out[0].shape[0])
    spans.state.pop("active", None)
    spans.state.pop("active_on_device", None)
