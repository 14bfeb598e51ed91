"""The yardstick's arithmetic: the card's peaks, the least bytes and
operations of each kernel call, and a model's FLOPs.

Frozen copies, so that a change to the program cannot change the
yardstick:

* the peaks: ``chip_smoke.py`` lines 252-255 (NVIDIA's H100 SXM data sheet,
  dense rates);
* the bytes and operations of kernel 2 (``chip_smoke.py::check_decode``,
  line 641), A (``check_decode_paged``, line 1081), 3 (``check_sample``,
  line 995) and 7 (``check_scan``, line 1313), applied here to the
  arguments of each call on the timed path instead of synthetic shapes;
* ``model_flops``: ``repro_torch/launch/dryrun.py::model_flops`` (line 64,
  2·N a token served) with the attention's products of
  ``chip_smoke.py::model_flops`` (line 2365) over each token's real context.

Data-dependent counts (a decode call's valid slots, the pages a paged call
reads, the tokens a mask allows) are reduced on the device, once for all
the calls that read the same tensors, so that counting never waits for
the device; they are read after the traced window.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bf16": 989e12,             # dense tensor core
              "fp32": 67e12}              # fp32 outside the tensor cores


class KernelCost:
    """The least bytes and operations of the calls a wrapper made: a host
    part from shapes alone, and device parts, each a count on the device
    (a 0-d tensor) times host coefficients of bytes and operations.  A
    count that several calls share (one tick's valid slots, read by every
    layer) is computed once and counted as often as it is used."""

    def __init__(self, peak: str):
        self.peak = peak
        self.calls = 0
        self.host_bytes = 0.0
        self.host_flops = 0.0
        #: key -> [count tensor, bytes a unit, flops a unit, uses]
        self.terms: Dict[tuple, list] = {}

    def add(self, nbytes: float = 0.0, flops: float = 0.0) -> None:
        self.calls += 1
        self.host_bytes += float(nbytes)
        self.host_flops += float(flops)

    def count(self, anchor, tag: str, make: Callable[[], torch.Tensor],
              per_bytes: float, per_flops: float) -> None:
        """Add `make()` (a 0-d count on the device) times the coefficients.
        Calls that pass the same `anchor` tensor, unwritten since, share
        one count; the term holds the anchor, so that no later tensor can
        take its place in memory.  `anchor` None: a count of this call
        alone."""
        if anchor is None:
            key = (tag, "call", self.calls)
        else:
            key = (tag, id(anchor), anchor._version)
        term = self.terms.get(key)
        if term is None:
            self.terms[key] = [make(), per_bytes, per_flops, 1, anchor]
        else:
            term[3] += 1

    def totals(self):
        b, f = self.host_bytes, self.host_flops
        for t, pb, pf, n, _ in self.terms.values():
            v = float(t) * n
            b += v * pb
            f += v * pf
        return b, f

    def least_seconds(self) -> float:
        b, f = self.totals()
        return max(b / HBM_BYTES_PER_S, f / PEAK_FLOPS[self.peak])


def decode_attention(cost: KernelCost, q, k_cache, slot_positions) -> None:
    """Kernel 2: q and out once, the K and V of each valid slot once, the
    slot positions and the query positions."""
    B, H, D = q.shape
    KV, s = k_cache.shape[2], q.element_size()
    L = slot_positions.shape[1]
    cost.add(2 * B * H * D * s + B * L * 4 + B * 4)
    cost.count(slot_positions, "slots", lambda: (slot_positions >= 0).sum(),
               2 * KV * D * s, 4 * H * D)


def decode_attention_paged(cost: KernelCost, q, k_pool, block_tables,
                           q_position) -> None:
    """Kernel A: the K and V of each token the rows attend to once, a page
    shared by many rows' tables counted once; q, out, the tables and the
    positions."""
    B, H, D = q.shape
    KV, P, ps = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    s = q.element_size()
    NB = block_tables.shape[1]

    def tokens():
        need = (q_position.to(torch.int64)[:, None] + 1
                - ps * torch.arange(NB, device=q.device)[None, :]
                ).clamp(0, ps)
        tab = block_tables.to(torch.int64)
        live = (need > 0) & (tab >= 0) & (tab < P)
        pages = torch.where(live, tab, torch.full_like(need, P))
        per_page = torch.zeros(P + 1, dtype=torch.int64, device=q.device)
        per_page.scatter_reduce_(0, pages.reshape(-1),
                                 (need * live).reshape(-1), "amax")
        return per_page[:P].sum()
    # one tick's layers share its tables and positions
    cost.add(2 * B * H * D * s + block_tables.numel() * 4 + B * 4)
    cost.count(block_tables, "pages", tokens, 2 * KV * D * s, 0)
    cost.count(block_tables, "pairs", lambda: (q_position.to(torch.int64)
                                               + 1).sum(), 0, 4 * H * D)


def constrained_sample(cost: KernelCost, logits, mask, noise) -> None:
    """Kernel 3: the whole mask, a logit (and its float64 noise) where the
    mask allows the entry, the tokens out; ~3 float32 operations an
    allowed entry."""
    B, V = logits.shape
    per = logits.element_size() + (8 if noise is not None else 0)
    cost.add(B * V + B * 4)
    cost.count(None, "allowed", lambda: mask.sum(dtype=torch.int64), per, 3)


def selective_scan(cost: KernelCost, u, N: int) -> None:
    """Kernel 7: u, dt and y once, the B and C rows, A and D, the state read
    and written; ~6 float32 operations per (t, d, n)."""
    Bz, S, Di = u.shape
    s = u.element_size()
    cost.add(Bz * S * Di * (s + 4 + 4) + 2 * Bz * S * N * s
             + Di * N * 4 + Di * 4 + 2 * Bz * Di * N * 4,
             6 * Bz * S * Di * N)


def roofline_share(reading: dict, metric: str):
    """A kernel metric's share of its roofline, in %: the least time of the
    calls its wrapper made over the device time launched inside the
    wrapper's ranges; None where the run made no call or traced none."""
    cost = reading["kernels"].get(metric)
    trace = reading.get("trace")
    dev = trace.by_range.get("kernel." + metric, 0.0) if trace else 0.0
    if cost is None or not cost.calls or dev <= 0:
        return None
    return 100.0 * cost.least_seconds() / dev


def attention_flops(layers: int, heads: int, head_dim: int,
                    first: int, last: int) -> float:
    """The score and value products (2 of 2 flops) of the tokens at
    positions first+1 .. last of one sequence, each over its causal
    context: 4·H·D a (query, key) pair, per attention layer."""
    if last <= first:
        return 0.0
    pairs = (last * (last + 1) - first * (first + 1)) // 2
    return 4.0 * layers * heads * head_dim * pairs


def serve_flops(n_params: int, tokens: int) -> float:
    """2·N a token through the weights (``dryrun.model_flops``)."""
    return 2.0 * n_params * tokens
