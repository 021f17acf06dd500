"""The ADMM Z/U update (``training/train_loop.maybe_admm_update`` ->
``core/admm.admm_update`` -> the polarization kernel): the host time of
each update that is due, the device synchronized on both sides."""
TARGET = "repro_torch.training.train_loop:maybe_admm_update"
HOST = True
SYNC = True


def when(state, table, tcfg, host_step, *args, **kw):
    return (state.admm is not None and host_step > 0
            and host_step % tcfg.admm_update_every == 0)


def after(spans, out, *args, **kw):
    spans.counters["z_updates"] += 1
