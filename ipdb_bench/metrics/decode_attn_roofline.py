"""Kernel 2 (dense decode attention)'s share of its roofline: the least time
of its calls (``harness/costs.py``) over the device time launched inside
its wrapper."""
from ipdb_bench.harness import costs

WRAPS, PEAK = "decode_attention", "bf16"


def count(cost, q, k_cache, v_cache, slot_positions, q_positions):
    costs.decode_attention(cost, q, k_cache, slot_positions)


def read(r):
    return costs.roofline_share(r, "decode_attn_roofline")
