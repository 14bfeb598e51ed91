"""Plain PyTorch versions of the three Hopper kernels' functions.

They mirror ``repro/kernels/ref.py`` (``flash_attention_ref``,
``decode_attention_ref``, ``constrained_sample_ref``) but take the natural
layouts the CUDA kernels read directly — q ``(B, S, H, D)``, caches
``(B, L, KV, D)`` — so no GQA fold copy is made on either path.  The
wrappers in ``kernels/ops.py`` run these for CPU tensors; ``chip_smoke.py``
holds each kernel against them on the card.
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


def flash_attention_ref(q, k, v, q_positions, kv_positions, *, causal=True,
                        window=0, prefix_len=0):
    """q (B, Sq, H, D); k, v (B, Skv, KV, D); GQA via H = KV·G; positions
    (B, S) int.  fp32 softmax over the masked scores.  Returns
    (B, Sq, H, D) in q.dtype."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qf, k.float()) / math.sqrt(D)
    ok = attention_mask(q_positions, kv_positions, causal=causal,
                        window=window, prefix_len=prefix_len)
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqj,bjkd->bqkgd", p, v.float())
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
