"""Plain PyTorch versions of the Hopper kernels' functions.

They mirror ``repro/kernels/ref.py`` (``flash_attention_ref``,
``decode_attention_ref``, ``decode_attention_paged_ref``,
``decode_attention_paged_quant_ref``, ``constrained_sample_ref``,
``gmm_ref``, ``selective_scan_ref``) and
``repro/models/layers.py::prefix_suffix_attention`` (``quant`` makes
``decode_attention_paged_ref`` the plain version of the int8-page kernel),
but take the natural
layouts the CUDA kernels read directly — q ``(B, S, H, D)``, caches
``(B, L, KV, D)``, page pools ``(KV, P, ps, D)`` — so no GQA fold copy is
made on either path.  The wrappers in ``kernels/ops.py`` run these for CPU
tensors; ``chip_smoke.py`` holds each kernel against them on the card.

Paged-layout conventions (the JAX package's): block j of row b is page
``block_tables[b, j]`` (-1 = no page), and its token t sits at absolute
position ``j * ps + t``.  ``quant`` (dict or None) holds a layer's int8
shadow pools ``kq``/``vq`` (KV, P, ps, D), fp32 per-(kv-head, page) scales
``kscale``/``vscale`` (KV, P) and the frozen flags ``flags`` (P,): a page
with ``flags > 0`` is read as ``int8 * scale`` rounded to the pool's dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(q_positions, kv_positions, *, causal=True, window=0,
                   prefix_len=0):
    """(B, Sq), (B, Skv) absolute positions → (B, Sq, Skv) bool mask of
    VALID entries.  kv position -1 marks padding; prefix_len > 0 makes
    positions < prefix_len bidirectionally visible (prefix-LM)."""
    kp = kv_positions[:, None, :]
    qp = q_positions[:, :, None]
    present = kp >= 0
    if not causal:
        return present.expand(-1, q_positions.shape[1], -1)
    ok = present & (kp <= qp)
    if window > 0:
        ok &= kp > qp - window
    if prefix_len > 0:
        ok |= present & (kp < prefix_len)
    return ok


#: the kv block of the JAX package's blockwise ``layers.flash_attention``,
#: which the SQL path's prefill runs (see flash_attention_ref)
FLASH_KV_BLOCK = 1024


def empty_row_divisor(skv: int, kv_block: int) -> int:
    """Skv rounded up to a multiple of kv_block (flash_attention_ref)."""
    return -(-skv // kv_block) * kv_block


def flash_attention_ref(q, k, v, q_positions, kv_positions, *, causal=True,
                        window=0, prefix_len=0, kv_block=FLASH_KV_BLOCK):
    """q (B, Sq, H, D); k, v (B, Skv, KV, D); GQA via H = KV·G; positions
    (B, S) int.  fp32 softmax over the masked scores.  Returns
    (B, Sq, H, D) in q.dtype.

    A query row with no visible key (a left-pad row, position -1) is the
    sum of V over the Skv keys divided by Skv rounded up to `kv_block`:
    what the blockwise ``layers.flash_attention`` of the JAX package gives
    it, where every key of its zero-padded kv blocks weighs the same.
    kv_block=1 gives the mean of V, as ``layers.prefix_suffix_attention``
    without a prefix does.  Pad rows are never read by the dense family,
    but the MoE family routes them: they take expert capacity."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qf, k.float()) / math.sqrt(D)
    ok = attention_mask(q_positions, kv_positions, causal=causal,
                        window=window, prefix_len=prefix_len)
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqj,bjkd->bqkgd", p, v.float())
    empty_v = v.float().sum(1) / empty_row_divisor(Skv, kv_block)  # (B,KV,D)
    o = torch.where((~ok.any(-1))[:, :, None, None, None],
                    empty_v[:, None, :, None, :], o)
    return o.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, slot_positions, q_position):
    """q (B, H, D); caches (B, L, KV, D); slot_positions (B, L) absolute
    position of each cache slot (-1 = empty); q_position (B,).  A slot is
    valid when 0 <= spos <= qpos.  Returns (B, H, D) in q.dtype."""
    B, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, D) / math.sqrt(D)
    s = torch.einsum("bkgd,blkd->bkgl", qf, k_cache.float())
    ok = (slot_positions >= 0) & (slot_positions <= q_position[:, None])
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgl,blkd->bkgd", p, v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)


def constrained_sample_ref(logits, mask, noise=None, *, temperature=1.0):
    """argmax(mask ? logits/T + noise : NEG_INF) per row, lowest index on
    ties.  Follows the serving engine's numpy sampler bit for bit: the
    logits are divided (not multiplied by 1/T) in float32, and the Gumbel
    noise is added in float64, as numpy promotes it.  Greedy (noise None)
    stays in float32.  logits (B, V) float; mask (B, V) int8; noise (B, V)
    float64 or None.  Returns (B,) int32."""
    # a 0-dim tensor divisor keeps true division on every device (CUDA turns
    # division by a host scalar into a multiply by its reciprocal)
    t = torch.tensor(temperature, dtype=torch.float32, device=logits.device)
    x = logits.float() / t
    if noise is not None:
        x = x.double() + noise.double()
    x = torch.where(mask != 0, x, torch.full_like(x, NEG_INF))
    return torch.argmax(x, dim=-1).to(torch.int32)


def gmm_ref(x, w, group_sizes):
    """Grouped matmul: x (T, M) rows sorted by expert, w (E, M, N),
    group_sizes (E,) int with sum <= T: rows [start_e, start_e + gs_e) of
    x times w[e], accumulated in fp32 and rounded to x.dtype; rows past the
    sum are 0.  A loop over the non-empty groups (their bounds read on the
    host).  Returns (T, N)."""
    T, N = x.shape[0], w.shape[2]
    out = torch.zeros(T, N, dtype=x.dtype, device=x.device)
    ends = torch.cumsum(group_sizes.long(), 0).tolist()
    start = 0
    for e, end in enumerate(ends):
        if end > start:
            out[start:end] = (x[start:end].float() @ w[e].float()).to(x.dtype)
        start = end
    return out


def selective_scan_ref(u, dt, A, B, C, D, h0=None, h_out=None):
    """The Mamba-1 selective scan, one step at a time in float32:
    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) B_t,  y_t = h_t . C_t
    + D * u_t.  u, dt (Bz, S, Di); A (Di, N); B, C (Bz, S, N); D (Di,);
    h0 (Bz, Di, N) or None (zeros).  Returns (y (Bz, S, Di) float32, h
    (Bz, Di, N) float32); with `h_out` the final state is copied into it
    and h_out returned (it may be h0)."""
    Bz, S, Di = u.shape
    uf, dtf, Af = u.float(), dt.float(), A.float()
    Bf, Cf = B.float(), C.float()
    h = (torch.zeros(Bz, Di, A.shape[1], device=u.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t, :, None] * Af)                # (Bz, Di, N)
        h = a * h + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + uf * D.float()
    if h_out is None:
        return y, h
    h_out.copy_(h)
    return y, h_out


def gather_pages(pool, pages, quant_q=None, quant_scale=None, flags=None):
    """pool (KV, P, ps, D) → (KV, *pages.shape, ps, D) for page ids
    `pages` (clipped to the pool, as the JAX gathers do).  With the int8
    arguments, frozen pages are replaced by their dequantized shadow,
    rounded to the pool dtype: ``(int8 * scale).astype(pool.dtype)``."""
    safe = pages.long().clamp(0, pool.shape[1] - 1)
    out = pool[:, safe]
    if quant_q is not None:
        dq = (quant_q[:, safe].float()
              * quant_scale[:, safe][..., None, None]).to(pool.dtype)
        frozen = (flags[safe] > 0)[None, ..., None, None]
        out = torch.where(frozen, dq, out)
    return out


def _paged_kv(k_pool, v_pool, pages, quant):
    q = quant or {}
    k = gather_pages(k_pool, pages, q.get("kq"), q.get("kscale"),
                     q.get("flags"))
    v = gather_pages(v_pool, pages, q.get("vq"), q.get("vscale"),
                     q.get("flags"))
    return k, v


def decode_attention_paged_ref(q, k_pool, v_pool, block_tables, q_position,
                               quant=None):
    """q (B, H, D); pools (KV, P, ps, D); block_tables (B, NB) int32;
    q_position (B,); quant: int8 frozen pages (module docstring) or None.
    Token t of block j is valid when the block has a page and
    j * ps + t <= qpos.  Gathers the row's pages into a dense view and
    reuses the dense oracle.  Returns (B, H, D) in q.dtype."""
    B = q.shape[0]
    KV, _, ps, D = k_pool.shape
    NB = block_tables.shape[1]
    k, v = _paged_kv(k_pool, v_pool, block_tables, quant)  # (KV,B,NB,ps,D)
    k = k.permute(1, 2, 3, 0, 4).reshape(B, NB * ps, KV, D)
    v = v.permute(1, 2, 3, 0, 4).reshape(B, NB * ps, KV, D)
    pos = torch.arange(NB * ps, dtype=torch.int32,
                       device=q.device).expand(B, -1)
    valid = (block_tables >= 0).repeat_interleave(ps, dim=1)
    pos = torch.where(valid, pos, torch.full_like(pos, -1))
    return decode_attention_ref(q, k, v, pos, q_position)


def prefix_suffix_attention_ref(q, k_prefix, v_prefix, k_suf, v_suf,
                                positions, prefix_len):
    """Shared-prefix prefill attention.  q (B, S, H, D) suffix queries;
    k_prefix/v_prefix (Lp, KV, D): ONE copy of the shared prefix KV,
    broadcast across the batch; k_suf/v_suf (B, S, KV, D); positions
    (B, S) absolute (-1 = pad); prefix_len: valid prefix tokens (<= Lp).
    Prefix tokens are visible to every non-pad query; the suffix part is
    causal.  One softmax over [prefix ++ suffix].  Returns (B, S, H, D)."""
    B, S, H, D = q.shape
    KV = k_suf.shape[2]
    G = H // KV
    qf = q.float().reshape(B, S, KV, G, D) / math.sqrt(D)
    ss = torch.einsum("bskgd,btkd->bkgst", qf, k_suf.float())
    ok_s = (positions[:, None, :] >= 0) & \
           (positions[:, None, :] <= positions[:, :, None])       # (B, S, T)
    ss = torch.where(ok_s[:, None, None], ss, torch.full_like(ss, NEG_INF))
    Lp = k_prefix.shape[0]
    if Lp:
        sp = torch.einsum("bskgd,lkd->bkgsl", qf, k_prefix.float())
        ar = torch.arange(Lp, device=q.device)
        ok_p = (ar[None, None, :] < prefix_len) & \
               (positions[:, :, None] >= 0)                       # (B, S, Lp)
        sp = torch.where(ok_p[:, None, None], sp,
                         torch.full_like(sp, NEG_INF))
        m = torch.maximum(sp.amax(dim=-1), ss.amax(dim=-1))       # (B,KV,G,S)
        pp = torch.exp(sp - m[..., None])
        psx = torch.exp(ss - m[..., None])
        denom = torch.clamp(pp.sum(-1) + psx.sum(-1), min=1e-30)
        o = torch.einsum("bkgsl,lkd->bskgd", pp, v_prefix.float()) \
            + torch.einsum("bkgst,btkd->bskgd", psx, v_suf.float())
    else:
        m = ss.amax(dim=-1)
        psx = torch.exp(ss - m[..., None])
        denom = torch.clamp(psx.sum(-1), min=1e-30)
        o = torch.einsum("bkgst,btkd->bskgd", psx, v_suf.float())
    o = o / denom.permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, S, H, D).to(q.dtype)


def flash_attention_prefix_ref(q, k, v, positions, k_pool, v_pool,
                               prefix_table, prefix_len, quant=None):
    """Paged prefill attention: the suffix's own q/k/v (B, S, H|KV, D) and
    positions (B, S), plus the shared prefix read from pool pages
    `prefix_table` (npre,) — gathered once, never per row — of which the
    first `prefix_len` tokens are valid."""
    KV, _, ps, D = k_pool.shape
    kp, vp = _paged_kv(k_pool, v_pool, prefix_table, quant)  # (KV,npre,ps,D)
    kp = kp.permute(1, 2, 0, 3).reshape(-1, KV, D)
    vp = vp.permute(1, 2, 0, 3).reshape(-1, KV, D)
    return prefix_suffix_attention_ref(q, kp, vp, k, v, positions,
                                       prefix_len)
