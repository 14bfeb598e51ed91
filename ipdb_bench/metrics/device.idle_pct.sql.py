"""Share of the traced window in which no operation ran on the device."""


def read(r):
    tr = r.get("trace")
    if tr is None or tr.window_s <= 0 or tr.n_device_events == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
