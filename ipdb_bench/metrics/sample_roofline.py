"""Kernel 3 (grammar-masked sampling)'s share of its roofline: the least time
of its calls (``harness/costs.py``) over the device time launched inside
its wrapper."""
from ipdb_bench.harness import costs

WRAPS, PEAK = "constrained_sample", "fp32"


def count(cost, logits, mask, noise=None, **_):
    costs.constrained_sample(cost, logits, mask, noise)


def read(r):
    return costs.roofline_share(r, "sample_roofline")
