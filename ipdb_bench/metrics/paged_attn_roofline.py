"""Kernel A (paged decode attention)'s share of its roofline: the least time
of its calls (``harness/costs.py``) over the device time launched inside
its wrapper."""
from ipdb_bench.harness import costs

WRAPS, PEAK = "decode_attention_paged", "bf16"


def count(cost, q, k_pool, v_pool, block_tables, q_position):
    costs.decode_attention_paged(cost, q, k_pool, block_tables, q_position)


def read(r):
    return costs.roofline_share(r, "paged_attn_roofline")
