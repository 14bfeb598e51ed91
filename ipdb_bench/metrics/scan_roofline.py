"""Kernel 7 (the selective scan, prefill and decode)'s share of its
roofline: the least time of its calls (``harness/costs.py``) over the
device time launched inside its wrapper."""
from ipdb_bench.harness import costs

WRAPS, PEAK = "selective_scan", "fp32"


def count(cost, u, dt, A, *_, **__):
    costs.selective_scan(cost, u, A.shape[1])


def read(r):
    return costs.roofline_share(r, "scan_roofline")
