"""Host wall of each ADMM Z/U update in the traced run's window
(``training/train_loop.maybe_admm_update`` -> ``core/admm.admm_update`` ->
the polarization kernel), the device synchronized on both sides."""
SPANS = ("z_update",)


def read(m):
    n = m.counters.get("z_updates", 0)
    if not n:
        return None
    return 1e3 * m.host_s["pb.z_update"] / n
