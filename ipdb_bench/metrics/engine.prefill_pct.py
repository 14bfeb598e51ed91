"""Share of the batcher's host time inside the engine's prefills."""


def read(r):
    run = r["spans"].get("batcher.run")
    pre = r["spans"].get("engine.prefill")
    if not run or not pre or run[0] <= 0:
        return None
    return 100.0 * pre[0] / run[0]
