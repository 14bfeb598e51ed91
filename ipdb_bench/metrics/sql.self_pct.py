"""Share of the window outside the executor's calls: the SQL front end,
the predict operator and the inference service (host clock)."""


def read(r):
    span = r["spans"].get("executor.complete_many")
    if not span or r["window_s"] <= 0:
        return None
    return 100.0 * (r["window_s"] - span[0]) / r["window_s"]
