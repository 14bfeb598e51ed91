"""Plain PyTorch versions of the Hopper kernels' functions.

They mirror ``repro/kernels/ref.py`` (``flash_attention_ref``,
``decode_attention_ref``, ``decode_attention_paged_ref``,
``decode_attention_paged_quant_ref``, ``constrained_sample_ref``,
``gmm_ref``, ``selective_scan_ref``) and
``repro/models/layers.py::prefix_suffix_attention`` (``quant`` makes
``decode_attention_paged_ref`` the plain version of the int8-page kernel)
and the training path's attention, the JAX package's ``custom_vjp``
(``layers._flash_fwd`` / ``_flash_bwd``: ``flash_attention_fwd_ref`` with
its lse, ``flash_attention_bwd_ref``, and ``flash_attention_grad_ref`` that
joins them), but take the natural
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
    return flash_attention_fwd_ref(q, k, v, q_positions, kv_positions,
                                   causal=causal, window=window,
                                   prefix_len=prefix_len,
                                   kv_block=kv_block)[0]


def flash_attention_fwd_ref(q, k, v, q_positions, kv_positions, *,
                            causal=True, window=0, prefix_len=0,
                            kv_block=FLASH_KV_BLOCK):
    """flash_attention_ref's output and the fp32 log-sum-exp of each row's
    masked scores, (B, Sq, H): what the JAX package's forward rule
    (``layers._flash_fwd``) keeps for the backward.  A row with no visible
    key has lse NEG_INF: the JAX forward's ``m + log(l)`` is -1e30 + log of
    the padded key count, which rounds to -1e30 in float32."""
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
    empty = ~ok.any(-1)                                           # (B, Sq)
    empty_v = v.float().sum(1) / empty_row_divisor(Skv, kv_block)  # (B,KV,D)
    o = torch.where(empty[:, :, None, None, None],
                    empty_v[:, None, :, None, :], o)
    lse = torch.logsumexp(s, dim=-1).permute(0, 3, 1, 2)         # (B,Sq,KV,G)
    lse = torch.where(empty[:, :, None, None], torch.full_like(lse, NEG_INF),
                      lse)
    return (o.reshape(B, Sq, H, D).to(q.dtype).contiguous(),
            lse.reshape(B, Sq, H).contiguous())


def flash_attention_bwd_ref(q, k, v, q_positions, kv_positions, out, lse, g,
                            *, causal=True, window=0, prefix_len=0):
    """The gradient of flash attention as the JAX package's hand-written
    backward computes it (``layers._flash_bwd``): delta = rowsum(dO · O),
    P = exp(S - lse) with masked scores NEG_INF, dS = P (dP - delta), then
    dq = dS K · scale, dk = dS^T (Q · scale) and dv = P^T dO, each kv
    head's summed over its G query heads.  q (B, Sq, H, D); k, v (B, Skv,
    KV, D); out, g (B, Sq, H, D) the forward's output and its gradient; lse
    (B, Sq, H) float32 from flash_attention_fwd_ref.  Returns (dq, dk, dv)
    in the dtypes of q, k and v.

    It is not the gradient of flash_attention_ref by autograd.  A row with
    no visible key has lse NEG_INF, so P = exp(NEG_INF - NEG_INF) = 1 for
    every key of that row (not the 1/n of its forward): such a row adds dO
    to every key's dv, as the JAX backward does."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, KV, G, D) * scale
    gf = g.float().reshape(B, Sq, KV, G, D)
    kf, vf = k.float(), v.float()
    delta = (gf * out.float().reshape(B, Sq, KV, G, D)).sum(-1)  # (B,Sq,KV,G)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qf, kf)
    ok = attention_mask(q_positions, kv_positions, causal=causal,
                        window=window, prefix_len=prefix_len)
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    lse_r = lse.float().reshape(B, Sq, KV, G).permute(0, 2, 3, 1)  # (B,KV,G,Sq)
    p = torch.exp(s - lse_r[..., None])
    dp = torch.einsum("bqkgd,bjkd->bkgqj", gf, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqj,bjkd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqj,bqkgd->bjkd", ds, qf)
    dv = torch.einsum("bkgqj,bqkgd->bjkd", p, gf)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def differentiable_attention(fwd, bwd):
    """An autograd.Function over the attention forward `fwd` (returning the
    output and its lse) with `bwd` (q, k, v, positions, out, lse, g ->
    dq, dk, dv) as its backward: the plain pair here, the kernels' pair in
    ops.  Applied as (q, k, v, q_positions, kv_positions, causal, window,
    prefix_len, kv_block)."""

    class _Attention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, q_positions, kv_positions, causal, window,
                    prefix_len, kv_block):
            out, lse = fwd(q, k, v, q_positions, kv_positions, causal=causal,
                           window=window, prefix_len=prefix_len,
                           kv_block=kv_block)
            ctx.save_for_backward(q, k, v, q_positions, kv_positions, out,
                                  lse)
            ctx.mask = dict(causal=causal, window=window,
                            prefix_len=prefix_len)
            return out

        @staticmethod
        def backward(ctx, g):
            return (*bwd(*ctx.saved_tensors, g, **ctx.mask),) + (None,) * 6

    return _Attention


_FlashAttentionRef = differentiable_attention(flash_attention_fwd_ref,
                                              flash_attention_bwd_ref)


def flash_attention_grad_ref(q, k, v, q_positions, kv_positions, *,
                             causal=True, window=0, prefix_len=0,
                             kv_block=FLASH_KV_BLOCK):
    """flash_attention_ref, differentiable by flash_attention_bwd_ref: the
    plain version of the training path's attention (the JAX package's
    ``custom_vjp``)."""
    return _FlashAttentionRef.apply(q, k, v, q_positions, kv_positions,
                                    causal, window, prefix_len, kv_block)


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


def decode_attention_lse_ref(q, k_cache, v_cache, slot_positions,
                             q_position):
    """decode_attention_ref and each (row, head)'s log-sum-exp of its
    scaled scores over the valid slots, (B, H) float32, -inf where the row
    has none (kernel (a)'s plain version).  Returns (out, lse)."""
    B, H, D = q.shape
    KV = k_cache.shape[2]
    qf = q.float().reshape(B, KV, H // KV, D) / math.sqrt(D)
    s = torch.einsum("bkgd,blkd->bkgl", qf, k_cache.float())
    ok = (slot_positions >= 0) & (slot_positions <= q_position[:, None])
    lse = torch.logsumexp(torch.where(ok[:, None, None, :], s,
                                      torch.full_like(s, -math.inf)), -1)
    return (decode_attention_ref(q, k_cache, v_cache, slot_positions,
                                 q_position), lse.reshape(B, H))


def decode_attention_hd_scores_ref(q, k_cache, scale):
    """Kernel (b)'s first launch: scale * q . k over the columns given,
    q (B, H, D), k_cache (B, L, KV, D) → (B, H, L) float32."""
    B, H, D = q.shape
    KV = k_cache.shape[2]
    s = torch.einsum("bkgd,blkd->bkgl", q.float().reshape(B, KV, H // KV, D),
                     k_cache.float()) * scale
    return s.reshape(B, H, -1)


def decode_attention_hd_out_ref(scores, v_cache, slot_positions, q_position):
    """Kernel (b)'s second launch: the softmax of the summed scores over the
    valid slots (a row with none: uniform, as softmax over all -1e30
    scores) times v_cache's columns, in v_cache's dtype (the second einsum
    of ``repro/models/layers.py::decode_attention``), and each (row,
    head)'s log-sum-exp of its scores over the valid slots, (B, H) float32,
    -inf where the row has none (by which the partials of ranks over slot
    ranges combine).  Returns (out, lse)."""
    B, H, L = scores.shape
    KV = v_cache.shape[2]
    ok = ((slot_positions >= 0)
          & (slot_positions <= q_position[:, None]))[:, None, :]
    s = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(s, dim=-1).reshape(B, KV, H // KV, L)
    o = torch.einsum("bkgl,blkd->bkgd", p, v_cache.float())
    lse = torch.logsumexp(torch.where(ok, scores, torch.full_like(
        scores, -math.inf)), -1)
    return o.reshape(B, H, -1).to(v_cache.dtype), lse


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


def gmm_bwd_ref(x, w, group_sizes, dy):
    """The gradient of gmm_ref for the output gradient dy (T, N): dx (T, M)
    with rows [start_e, start_e + gs_e) = dy rows times w[e]^T and rows
    past the sum 0; dw (E, M, N) with dw[e] = x_e^T dy_e over expert e's
    rows, 0 for an empty expert.  Sums in fp32, rounded to x's and w's
    dtypes."""
    dx = torch.zeros_like(x)
    dw = torch.zeros_like(w)
    ends = torch.cumsum(group_sizes.long(), 0).tolist()
    start = 0
    for e, end in enumerate(ends):
        if end > start:
            d = dy[start:end].float()
            dx[start:end] = (d @ w[e].float().t()).to(x.dtype)
            dw[e] = (x[start:end].float().t() @ d).to(w.dtype)
        start = end
    return dx, dw


def differentiable_gmm(fwd, bwd):
    """An autograd.Function over the grouped matmul `fwd` (x, w,
    group_sizes -> out) with `bwd` (x, w, group_sizes, dy -> dx, dw) as
    its backward: the plain pair here, the kernels' pair in ops.  Applied
    as (x, w, group_sizes)."""

    class _Gmm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, group_sizes):
            ctx.save_for_backward(x, w, group_sizes)
            return fwd(x, w, group_sizes)

        @staticmethod
        def backward(ctx, dy):
            dx, dw = bwd(*ctx.saved_tensors, dy.contiguous())
            return dx, dw, None

    return _Gmm


_GmmRef = differentiable_gmm(gmm_ref, gmm_bwd_ref)


def gmm_grad_ref(x, w, group_sizes):
    """gmm_ref, differentiable by gmm_bwd_ref: the plain version of the
    training path's grouped matmul."""
    return _GmmRef.apply(x, w, group_sizes)


def scan_chunks(S: int, chunks: int):
    """The [t0, t1) steps of each of `chunks` time chunks of an S-step scan:
    chunk k covers [k L, (k + 1) L) clipped to S, L = ceil(S / chunks) (the
    selective-scan kernel's partition; a trailing chunk may be empty)."""
    L = -(-S // chunks)
    return [(min(S, k * L), min(S, (k + 1) * L)) for k in range(chunks)]


def selective_scan_fwd_ref(u, dt, A, B, C, D, h0=None, chunks=1):
    """selective_scan_ref's y and final state, and the state entering each
    of `chunks` time chunks (scan_chunks), (Bz, chunks, Di, N) float32:
    what the training forward keeps for the backward (carries[:, 0] is h0,
    or zeros)."""
    Bz, S, Di = u.shape
    h = (torch.zeros(Bz, Di, A.shape[1], device=u.device) if h0 is None
         else h0.float())
    ys, carries = [], []
    for t0, t1 in scan_chunks(S, chunks):
        carries.append(h)
        if t1 > t0:
            y, h = selective_scan_ref(u[:, t0:t1], dt[:, t0:t1], A,
                                      B[:, t0:t1], C[:, t0:t1], D, h)
            ys.append(y)
    return torch.cat(ys, dim=1), h, torch.stack(carries, dim=1).contiguous()


def selective_scan_bwd_ref(u, dt, A, B, C, D, carries, dy):
    """The gradient of the selective scan's y for dy (Bz, S, Di) float32,
    as the explicit reverse recurrence: the states are recomputed forward
    from each chunk's carry (selective_scan_fwd_ref), then from the last
    step back, with a_t = exp(dt_t A) and the state adjoint
    g_t = dy_t C_t + a_{t+1} g_{t+1}:
      dC_t = sum_d dy_t h_t,  dB_t = sum_d g_t dt_t u_t,
      du_t = dt_t (g_t . B_t) + D dy_t,
      d(dt)_t = u_t (g_t . B_t) + sum_n g_t h_{t-1} a_t A,
      dA = sum_{b,t} g_t h_{t-1} a_t dt_t,  dD = sum_{b,t} dy_t u_t.
    The final state carries no gradient (training discards it).  Returns
    (du, ddt, dA, dB, dC, dD) in the dtypes of u, dt, A, B, C, D."""
    Bz, S, Di = u.shape
    uf, dtf, Af = u.float(), dt.float(), A.float()
    Bf, Cf, dyf = B.float(), C.float(), dy.float()
    hprev = []                                  # h_{t-1} for each step t
    for k, (t0, t1) in enumerate(scan_chunks(S, carries.shape[1])):
        h = carries[:, k].float()
        for t in range(t0, t1):
            hprev.append(h)
            h = torch.exp(dtf[:, t, :, None] * Af) * h \
                + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
    du = torch.empty_like(uf)
    ddt = torch.empty_like(dtf)
    dB = torch.empty_like(Bf)
    dC = torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    G = torch.zeros_like(hprev[0]) if S else None   # a_{t+1} g_{t+1}
    for t in reversed(range(S)):
        a = torch.exp(dtf[:, t, :, None] * Af)                   # (Bz, Di, N)
        dtu = dtf[:, t] * uf[:, t]                               # (Bz, Di)
        h = a * hprev[t] + dtu[..., None] * Bf[:, t, None, :]
        g = dyf[:, t, :, None] * Cf[:, t, None, :] + G
        dC[:, t] = torch.einsum("bdn,bd->bn", h, dyf[:, t])
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dtu)
        gb = torch.einsum("bdn,bn->bd", g, Bf[:, t])
        gha = g * hprev[t] * a
        du[:, t] = dtf[:, t] * gb + D.float() * dyf[:, t]
        ddt[:, t] = uf[:, t] * gb + torch.einsum("bdn,dn->bd", gha, Af)
        dA += torch.einsum("bdn,bd->dn", gha, dtf[:, t])
        G = a * g
    dD = (dyf * uf).sum((0, 1))
    return (du.to(u.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype),
            dC.to(C.dtype), dD.to(D.dtype))


def differentiable_scan(fwd, bwd):
    """An autograd.Function over the selective scan's training forward
    `fwd` (u, dt, A, B, C, D, h0 -> y, final state, carries) with `bwd`
    (u, dt, A, B, C, D, carries, dy -> du, ddt, dA, dB, dC, dD) as its
    backward: the plain pair here, the kernels' pair in ops.  Applied as
    (u, dt, A, B, C, D, h0); returns (y, final state).  Neither h0 nor the
    final state carries a gradient: training scans from zeros and discards
    the final state (``repro/models/mamba.py``'s train mode)."""

    class _Scan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, u, dt, A, B, C, D, h0):
            y, h, carries = fwd(u, dt, A, B, C, D, h0)
            ctx.save_for_backward(u, dt, A, B, C, D, carries)
            ctx.mark_non_differentiable(h)
            return y, h

        @staticmethod
        def backward(ctx, dy, _dh):
            return (*bwd(*ctx.saved_tensors, dy.contiguous()), None)

    return _Scan


#: the time chunks of the plain training forward (any count gives the same
#: gradient; more than one exercises the carries)
SCAN_REF_CHUNKS = 4

_ScanRef = differentiable_scan(
    lambda *a: selective_scan_fwd_ref(*a, chunks=SCAN_REF_CHUNKS),
    selective_scan_bwd_ref)


def selective_scan_grad_ref(u, dt, A, B, C, D, h0=None, h_out=None):
    """selective_scan_ref, differentiable by selective_scan_bwd_ref: the
    plain version of the training path's scan.  `h0` must not require
    grad; `h_out` must be None (no in-place state under autograd)."""
    if h_out is not None or (h0 is not None and h0.requires_grad):
        raise ValueError("selective_scan: a differentiated scan takes no "
                         "h_out and no h0 that requires grad")
    return _ScanRef.apply(u, dt, A, B, C, D, h0)


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
