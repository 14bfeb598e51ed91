"""Mean host time of one sampling round: the grammar masks built on the
host, their copy, kernel 3 and the tokens' copy back, which waits for the
tick's work on the device."""


def read(r):
    s = r["spans"].get("engine.sample")
    return None if not s or not s[1] else 1e3 * s[0] / s[1]
