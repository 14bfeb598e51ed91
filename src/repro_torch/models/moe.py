"""Mixture-of-experts block: top-k routing with grouped, capacity-bounded
dispatch (port of ``repro/models/moe.py``).

Routing and capacity are the JAX block's: tokens are split into
`num_groups` groups; within a group every (token, choice) pair, flattened
token-major and choice-minor, gets its position in its expert's queue by a
running count; choices at position >= C are dropped and the gates are
renormalised over the surviving choices.  Every row the block sees is
routed and takes capacity, left-pad prefill rows and idle decode slots
included.

The expert FFN differs in layout, not in result.  The JAX block scatters
the choices into an ``(E * C, M)`` capacity buffer and multiplies all of it;
here the kept choices are sorted by expert (dropped ones last) and the three
products (gate, up, down) run on those compacted rows through the grouped
matmul ``gmm_fn`` (``kernels.ops.gmm`` by default), so an expert with no
choice costs nothing.  Each output row is one input row times its expert's
weights, so the order of rows inside a group changes nothing.  Nothing here
reads a device value on the host.

The training path differentiates the block (``launch/steps.py``): the
grouped matmul by its backward kernel, and the dispatch without atomics:
each token's rows are its K copies put in expert order by ``index_copy_``
(whose backward is a gather), so a token's input gradient is its K rows
gathered back through the inverse permutation and summed over K in a fixed
order, as JAX's transpose of ``jnp.repeat`` does.

Expert and tensor parallelism come from the distribution layer
(``launch/mesh.py::moe_constraint_fns``) through JAX's two hooks, with
explicit collectives in place of GSPMD's sharding constraints:
``dispatch_cs`` takes the token rows entering the expert products (its
backward sums their gradient over `model`), ``combine_cs`` the
choice-ordered expert outputs before the K-weighted sum (summed over
`model`, so the sum over K keeps the one-device order).  Every model rank
routes the same tokens (a data rank's tokens are replicated over `model`).
  EP (num_experts % 16 == 0): the rank's weights hold its E/m experts
      from ``first_expert`` on; it dispatches only their kept choices
      (``group_sizes`` covers its own experts; the other rows are skipped)
      and its outputs are zero elsewhere.
  TP (mixtral): the rank's weights hold every expert's d_ff slice; the
      down products are partial sums.
Capacity groups never span data ranks: the train step routes a data
rank's tokens in its share of ``pick_num_groups(tokens, data shards)``.
``pick_num_groups`` is a copy of the JAX package's
(``tests/test_torch_isolation.py`` holds it equal).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KOPS


def Identity(x):
    """The hooks' default: no collective."""
    return x


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pick_num_groups(num_tokens: int, data_shards: int, target_group: int = 4096) -> int:
    """Choose a group count that (a) divides the token count, (b) is a
    multiple of the data-axis size when possible, (c) keeps groups ≈4k."""
    g = max(1, num_tokens // target_group)
    if g >= data_shards:
        g = (g // data_shards) * data_shards
    elif num_tokens % data_shards == 0 and num_tokens >= 4 * data_shards:
        g = data_shards          # decode-sized batches: one group per shard
    while num_tokens % g:
        g -= 1
    return max(1, g)


def capacity(tokens_per_group: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert and group, as the JAX block sizes them."""
    c = max(4, _round_up(int(tokens_per_group * top_k * capacity_factor
                             / num_experts + 0.999), 4))
    return min(c, tokens_per_group * top_k)


def _route(x, router, top_k):
    """fp32 router logits → (top-k gates renormalised by softmax, expert
    ids), both (T, K).  torch.topk puts the larger logit first, as
    jax.lax.top_k does; on an exact tie jax puts the lower index first,
    which random fp32 weights never produce."""
    logits = x.float() @ router.float()
    top_logits, top_idx = torch.topk(logits, top_k, dim=-1, sorted=True)
    return torch.softmax(top_logits, dim=-1), top_idx


def moe_block(x, params, *, num_experts: int, top_k: int,
              capacity_factor: float, num_groups: int = 1,
              compute_dtype=torch.bfloat16, gmm_fn=None,
              dispatch_cs=Identity, combine_cs=Identity,
              first_expert: int = 0):
    """x (T, M) token-major; params: router (M, E), w_gate/w_up (E', M, F'),
    w_down (E', F', M): all E experts, or (expert parallelism) the E'
    experts from `first_expert` on, each of full or (tensor parallelism)
    sliced width F'.  Returns (T, M) in x.dtype."""
    gmm_fn = gmm_fn or KOPS.gmm
    T, M = x.shape
    E, K, G = num_experts, top_k, num_groups
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    C = capacity(Tg, E, K, capacity_factor)

    gates, idx = _route(x, params["router"], K)                 # (T, K)
    # position of each choice in its expert's queue, per group
    # (one-hot (G, E, TgK): the running count is a scan along the last dim)
    ig = idx.reshape(G, 1, Tg * K)
    oh = torch.arange(E, device=x.device)[None, :, None] == ig
    pos = torch.cumsum(oh, dim=2, dtype=torch.int32).gather(1, ig)[:, 0] - 1
    keep = (pos < C).reshape(T * K)
    # an expert keeps the first min(count, C) choices of each group
    group_sizes = oh.sum(2).clamp_(max=C).sum(0).to(torch.int32)  # (E,)

    # kept choices sorted by expert, dropped ones (key E) after them: row i
    # of xs is the token of choice order[i], put in place by index_copy_
    # (xs[inv[j]] = choice j's token), whose backward gathers each choice's
    # row back and sums a token's K rows, where indexing's would accumulate
    key = torch.where(keep, idx.reshape(T * K), E)
    El = params["w_gate"].shape[0]
    if El != E:
        # expert parallelism: this rank's experts first, all else after
        key = key - first_expert
        key = torch.where((key >= 0) & (key < El), key, El)
        group_sizes = group_sizes[first_expert:first_expert + El]
    order = torch.argsort(key, stable=True)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * K, device=x.device))
    rows = dispatch_cs(x).to(compute_dtype)[:, None].expand(
        T, K, M).reshape(T * K, M)
    xs = torch.empty_like(rows).index_copy_(0, inv, rows)       # (T*K, M)
    wg, wu, wd = (params[k].to(compute_dtype)
                  for k in ("w_gate", "w_up", "w_down"))
    h = F.silu(gmm_fn(xs, wg, group_sizes)) * gmm_fn(xs, wu, group_sizes)
    ys = gmm_fn(h, wd, group_sizes)                             # 0 past kept
    y = combine_cs(torch.empty_like(ys).index_copy_(0, order, ys))  # choice order

    w = (gates.reshape(T * K) * keep).reshape(T, K)             # drop overflow
    denom = torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    out = (y.float().reshape(T, K, M) * (w / denom)[..., None]).sum(1)
    return out.to(x.dtype)


def moe_block_reference(x, params, *, num_experts, top_k, **_):
    """Oracle: every token through every expert, no capacity drops (the
    JAX package's, for tests bounding moe_block's dropping error)."""
    gates, idx = _route(x, params["router"], top_k)
    xf = x.float()
    h = F.silu(torch.einsum("tm,emh->teh", xf, params["w_gate"].float()))
    h = h * torch.einsum("tm,emh->teh", xf, params["w_up"].float())
    all_out = torch.einsum("teh,ehm->tem", h, params["w_down"].float())
    sel = torch.gather(all_out, 1, idx[..., None].expand(-1, -1, x.shape[1]))
    return (sel * gates[..., None]).sum(1).to(x.dtype)
