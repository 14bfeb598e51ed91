"""Mean host time of one decode step of the model over every slot: the
launches of the tick, which the host paces (the device's share is
``device.idle_pct.sql``'s complement)."""


def read(r):
    s = r["spans"].get("model.tick")
    return None if not s or not s[1] else 1e3 * s[0] / s[1]
