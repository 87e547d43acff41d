"""device_idle_share: 1 minus the union of the device's rows (kernels,
copies, sets) over the traced slice's wall time, one card, one stream."""


def read(run):
    sl = run.slice
    if sl is None or sl.wall_s <= 0 or not sl.rows:
        return None
    return 1.0 - sl.busy_s / sl.wall_s
